"""Fused PDHG iteration for volumetric TV (counterpart of
``prost_tpu/ops/fused_vol.py``, whole-volume route).

Workload (examples/example_vol_tv.py): min_u c/2 ||u - f||^2 (or c |u - f|,
or the per-voxel weighted square) + ||grad3 u||_{2,1} on an (L, nx, ny)
volume, where grad3 = BlockGradient3D: x and y forward differences with a
Neumann boundary and a label-axis difference with a Dirichlet far boundary
(gl_{L-1} = -u_{L-1}).  For a lone gradient3d operator the alpha
preconditioners are the constants Sigma = 1/2, Tau = 1/6, so a PDHG
iteration is pointwise work plus three stencils and their adjoints, and the
dual is projected voxel by voxel onto a 3-component ball.

Three kernels carry the volumetric routes, hand-written CUDA in
``csrc/fused_vol.cu`` with a plain PyTorch version beside each wrapper here:

* ``vol_chunk`` (JAX ``vol_fused_chunk``): ``count`` iterations ending on a
  residual iteration, with the four squared preconditioned residual norms;
* ``vol_multichunk`` (JAX ``vol_fused_multichunk``): up to ``k_chunks``
  chunks with the boyd/goldstein adaptation and the stopping test on the
  device between chunks; its in-place form ``vol_multichunk_`` serves the
  route's light call ``VolMultichunk``, made once per route;
* ``vol_chunk_batched`` (JAX ``vol_fused_chunk_batched``): one chunk for
  each of B volumes in one launch, or one launch sequence, the batched
  ensembles' route (``parallel/ensemble.py``);
* ``vol_chunk_halo`` (JAX ``vol_fused_chunk_halo``): one chunk on a
  halo-extended shard of the nx axis, the spatially sharded route's
  (``parallel/spatial_fused.py``).

The chunk, its halo mode and the batched chunk have in-place forms,
``vol_chunk_``, ``vol_chunk_halo_`` and ``vol_chunk_batched_``, which the
whole-volume and sharded routes call through ``VolChunk`` and
``BatchedPDHG`` through ``VolBatchedChunk``, each made once per route.  On
a card each runs as one grid-resident cooperative launch (the batched
chunk's volumes one after another) where the shape rule (``resident_ok``,
on one volume or band) finds that the volume's planes fit in the shared
memory of one block per SM.  The multichunk likewise runs all its chunks
as one grid-resident launch where its own rule (``resident_ok(...,
multi=True)``: w_hat takes a window of its own) holds.  Where they do not
(512x512x8, the JAX package's banded size, and its one-shard halo band),
the chunk, its halo mode and the multichunk run as one tiled cooperative
launch a chunk (the JAX ``vol_fused_chunk_banded`` and
``vol_fused_multichunk_banded``: ``vol_route_of``, a grid barrier an
iteration, each iteration one pass over device memory through
overlapping windows of a tile and ``vol_tiled_halo`` pixel a side), and
beyond 8 labels (and the batched chunk where one volume does not fit) as
the streaming launch sequence; all are bit-equal.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel, or raises.  There is no fallback to the generic
path.

Layout contract (the JAX package's, at every public function): u, f, w
viewed (L, nx, ny) (label_first=False); y = [gx; gy; gl], each a whole
(L, nx, ny) volume, viewed q (3, L, nx, ny).  The dead dual coordinates of
the Neumann axes (q_x's last row and q_y's last column in every label
plane) are zeroed once per run and at every chunk entry, as on the ROF
route; the label axis is Dirichlet, so q_l has none: its last label plane
couples to -u_last and is kept whole, and its adjoint keeps the mask.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..backend.pdhg import PDHGState
from ..config import ProstError, dtype as config_dtype
from ..linop.base import LinearOperator
from ..linop.gradient import BlockGradient3D
from .pdhg_chunk import (CF, CI, N_HALO_SCAL, RES_RED_BYTES, S_CONV, S_LEN,
                         S_NORM, SOUT, STEPSIZES, VP, WHOLE_PLANE,
                         LightChunk, LightMultichunk, ball_scale,
                         canonical_duals, card_sms, check_buffers,
                         check_halo, check_path, chunk_state,
                         dual_ball_radius, dx, dy, entry_converged,
                         halo_copy, halo_into, halo_scal_rows,
                         check_inplace, instance_strides, label_sum, launch,
                         match_dataterm, multichunk_plain, multichunk_state,
                         own_vectors, pick_path,
                         resident_rows, run_pdhg_route, scalar_buffer,
                         typed_lib, vmap_plain)
from .phases import K_CHUNKS

_SQRT_S = 0.7071067811865476  # sqrt(Sigma) = sqrt(1/2)
_SQRT_T = 0.4082482904638631  # sqrt(Tau)   = sqrt(1/6)

DATATERMS = {"square": 0, "wsquare": 1, "abs": 2}

# launches of each kernel wrapper on the card (CPU calls do not count)
# (a tiled call also counts under its wrapper's name + "_tiled")
launch_counts = {"vol_chunk": 0, "vol_multichunk": 0,
                 "vol_chunk_batched": 0, "vol_chunk_halo": 0,
                 "vol_chunk_tiled": 0, "vol_multichunk_tiled": 0,
                 "vol_chunk_halo_tiled": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions of the chunk math
# ---------------------------------------------------------------------------

def dl(u):
    """Label-axis forward difference, Dirichlet: the last is -u_last."""
    return torch.cat([u[1:], torch.zeros_like(u[:1])]) - u


def dlt(p):
    """Adjoint of dl: p_{l-1}[l > 0] - p_l (masked; q_l has no dead
    coordinate)."""
    return torch.cat([torch.zeros_like(p[:1]), p[:-1]]) - p


def _vol_update(u, qx, qy, ql, gx, gy, gl, dt0, dt1, tau, sig_p, sig_t,
                radius, dataterm: str, rows=WHOLE_PLANE):
    """One preconditioned PDHG update (JAX ``_vol_update``).  tau arrives
    pre-multiplied by Tau = 1/6; sig_p = sigma*Sigma*(1+theta), sig_t =
    sigma*Sigma*theta; (gx, gy, gl) is grad3(u) carried from the previous
    iteration; ``rows`` is the volume's ``RowOps`` (along nx, and along ny
    in a window of the columns).  Returns the new state, the new gradient
    volumes and K^T of the old dual."""
    kty = rows.dxt(qx) + rows.dyt(qy) + dlt(ql)
    arg = u - tau * kty
    if dataterm in ("square", "wsquare"):
        u_new = (arg + dt0) * dt1
    else:  # abs: soft shrink toward f as arg - clamp(arg - f, -t, t)
        d = arg - dt0
        u_new = arg - torch.minimum(torch.maximum(d, -dt1), dt1)
    gx_n, gy_n, gl_n = rows.dx(u_new), rows.dy(u_new), dl(u_new)
    ax = qx + sig_p * gx_n - sig_t * gx
    ay = qy + sig_p * gy_n - sig_t * gy
    al = ql + sig_p * gl_n - sig_t * gl
    scale = ball_scale(ax * ax + ay * ay + al * al, radius)
    return (u_new, ax * scale, ay * scale, al * scale, gx_n, gy_n, gl_n,
            kty)


def _data_terms(tau, lmb, f, w, dataterm: str):
    """(dt0, dt1) of the data term's prox, hoisted as in
    ``_vol_chunk_core``; tau is tau * Tau."""
    if dataterm == "square":
        return (tau * lmb) * f, 1.0 / (1.0 + tau * lmb)
    if dataterm == "wsquare":
        tw = (tau * lmb) * w
        return tw * f, 1.0 / (1.0 + tw)
    return f, tau * lmb


def _steps(tau_raw, sigma_raw, theta):
    """(tau * Tau, sig_p, sig_t) of an update."""
    tau = tau_raw * (1.0 / 6.0)  # tau * Tau
    sigma_p = sigma_raw * 0.5    # sigma * Sigma
    return tau, sigma_p * (1.0 + theta), sigma_p * theta


def _residuals(tau_raw, sigma_raw, theta, u, q, u2, q2, g_prev, g_new,
               ktyp, kty2):
    """The preconditioned residuals of the aligned iteration from (u, q)
    to (u2, q2) (q and q2 the triples (q_x, q_y, q_l)), from grad3 of both
    iterates and K^T of both duals: pd (x, y, l), z_hat (x, y, l), dd and
    w_hat."""
    inv_s = 1.0 / (sigma_raw * _SQRT_S)
    zh = [(a - a2) * inv_s + _SQRT_S * ((1.0 + theta) * g2 - theta * gp)
          for a, a2, gp, g2 in zip(q, q2, g_prev, g_new)]
    pd = [z - _SQRT_S * g2 for z, g2 in zip(zh, g_new)]
    wh = (u - u2) * (1.0 / (tau_raw * _SQRT_T)) - _SQRT_T * ktyp
    dd = wh + _SQRT_T * kty2
    return (*pd, *zh, dd, wh)


def _vol_chunk_core(tau_raw, sigma_raw, theta, lmb, radius, u0, q0, f, w,
                    count: int, dataterm: str, g0=None, rows=WHOLE_PLANE):
    """One residual_iter-sized chunk (JAX ``_vol_chunk_core``, whole
    volume): ``count - 1`` plain iterations, then the aligned iteration with
    its four preconditioned residual norms (squared), each the sum of its
    x, y and label terms as three whole-volume sums.  ``g0`` seeds the
    carried gradient (a previous chunk's grad3(u2)); ``rows`` is the
    volume's ``RowOps`` along nx (a halo-extended shard's: owned-row norms).

    Returns (u2, q2, u_prev, q_prev, (n0, n1, n2, n3), (gx2, gy2, gl2))."""
    tau, sig_p, sig_t = _steps(tau_raw, sigma_raw, theta)
    dt0, dt1 = _data_terms(tau, lmb, f, w, dataterm)
    qx, qy = rows.project(q0[0], q0[1])
    ql = q0[2]
    u = u0
    gx, gy, gl = (rows.dx(u0), rows.dy(u0), dl(u0)) if g0 is None else g0
    args = (tau, sig_p, sig_t, radius, dataterm, rows)
    for _ in range(count - 1):
        u, qx, qy, ql, gx, gy, gl, _ = _vol_update(u, qx, qy, ql, gx, gy, gl,
                                                   dt0, dt1, *args)
    gxp, gyp, glp = gx, gy, gl
    # aligned iteration; (gxp, gyp, glp) is grad3(u_prev) carried for free
    u2, qx2, qy2, ql2, gx2, gy2, gl2, ktyp = _vol_update(
        u, qx, qy, ql, gxp, gyp, glp, dt0, dt1, *args)
    kty2 = rows.dxt(qx2) + rows.dyt(qy2) + dlt(ql2)
    res = _residuals(tau_raw, sigma_raw, theta, u, (qx, qy, ql), u2,
                     (qx2, qy2, ql2), (gxp, gyp, glp), (gx2, gy2, gl2), ktyp,
                     kty2)
    return (u2, torch.stack([qx2, qy2, ql2]), u, torch.stack([qx, qy, ql]),
            _norm_sums(res, rows.nsum), (gx2, gy2, gl2))


def _norm_sums(res, nsum):
    """The four squared norms of ``_residuals``' ``res``, each a sum of
    ``nsum``s: the x, y and label terms of |pd|^2 and |z_hat|^2 as three
    whole-volume sums."""
    pd_x, pd_y, pd_l, zh_x, zh_y, zh_l, dd, wh = res

    def ssq(a):
        return nsum(a * a)

    return (ssq(pd_x) + ssq(pd_y) + ssq(pd_l),
            ssq(zh_x) + ssq(zh_y) + ssq(zh_l), ssq(dd), ssq(wh))


def vol_chunk_plain(u, q, f, w, scal, count: int, dataterm: str = "square",
                    rows=WHOLE_PLANE, n_scal: int = 5):
    """Plain PyTorch version of ``vol_chunk`` (any device); with ``rows``
    and ``n_scal`` that of a halo chunk."""
    u2, q2, up, qp, norms, _ = _vol_chunk_core(
        scal[0], scal[1], scal[2], scal[3], scal[4], u, q, f, w, int(count),
        dataterm, rows=rows)
    n2 = torch.stack(norms)
    conv = entry_converged(scal, n_scal)
    return (torch.where(conv, u, u2), torch.where(conv, q, q2),
            torch.where(conv, u, up), torch.where(conv, q, qp),
            torch.where(conv, torch.zeros_like(n2), n2))


def vol_chunk_halo_plain(u, q, f, w, scal, count: int, nx_global: int,
                         dataterm: str = "square"):
    """Plain PyTorch version of ``vol_chunk_halo`` (any device; reads the
    row context of ``scal`` on the host)."""
    return vol_chunk_plain(u, q, f, w, scal, count, dataterm,
                           halo_scal_rows(scal, nx_global), N_HALO_SCAL)


def vol_chunk_batched_plain(u, q, f, w, scal, count: int,
                            dataterm: str = "square"):
    """Plain PyTorch version of ``vol_chunk_batched`` (any device):
    ``vol_chunk_plain`` vmapped over the instances."""
    return vmap_plain(vol_chunk_plain, (u, q, f, w), scal, int(count),
                      dataterm)


def vol_multichunk_plain(u, q, f, w, scal, count: int, k_chunks: int,
                         dataterm: str, stepsize: str, consts):
    """Plain PyTorch version of ``vol_multichunk`` (any device): every
    chunk is computed and kept only while not converged, where the JAX
    kernel branches around it with ``lax.cond``."""
    theta, lmb, radius = scal[2], scal[3], scal[4]

    def chunk(tau, sigma, p):
        *out, nrm, g2 = _vol_chunk_core(tau, sigma, theta, lmb, radius, p[0],
                                        p[1], f, w, int(count), dataterm,
                                        g0=p[4:])
        return (*out, *g2), nrm

    planes, norms, sout = multichunk_plain(
        chunk, (u, q, u, q, dx(u), dy(u), dl(u)), scal, count, k_chunks,
        stepsize, consts)
    return (*planes[:4], norms, sout)


def vol_tiled_halo() -> int:
    """The halo of the tiled chunk's window, in pixels on every side of a
    tile: an iteration's dual step at a pixel reads the new and the old u
    one row below and one column right, the new u there K^T q, which
    reads q_x one row up and q_y one column left (the label axis lies
    whole in the pixel's thread), so one pixel of the old state around the
    tile gives the owned pixels exactly; the next iteration loads its
    window anew."""
    return 1


def vol_chunk_tiled_plain(u, q, f, w, scal, count: int,
                          dataterm: str = "square", nx_global=None,
                          tile=(32, 32), halo=None, partials: bool = False):
    """The tiled chunk (``vol_chunk_`` and ``vol_chunk_halo_`` with
    ``path="tiled"``) window by window: each iteration ``_vol_update`` on
    every tile's window (the tile of ``tile`` rows and columns and
    ``halo`` pixels on every side, clamped at the volume's edges,
    ``vol_tiled_halo`` by default; every mask decided by the pixel's place
    in the volume, ``fused_rof.window_ops``), the carried gradient
    recomputed from the window's u, the owned pixels stitched into new
    volumes; then the norms of the stitched volumes, grad3 u and K^T q
    recomputed.  With ``nx_global`` the halo form (the row context read
    from ``scal``).  Returns ``vol_chunk_plain``'s outputs; with
    ``partials`` also the 32x8 tiles' partials (``fused_rof.tile_partials``)
    that the kernel's finish reduces."""
    from .fused_rof import tile_partials, window_ops

    L, nx, ny = u.shape
    if nx_global is None:
        n_scal, off, rows = 5, 0, WHOLE_PLANE
    else:
        n_scal, off = N_HALO_SCAL, int(scal[5])
        rows = halo_scal_rows(scal, nx_global)
    h = vol_tiled_halo() if halo is None else int(halo)
    tx, ty = (int(t) for t in tile)
    tau_raw, sigma_raw, theta, lmb, radius = (scal[k] for k in range(5))
    tau, sig_p, sig_t = _steps(tau_raw, sigma_raw, theta)
    dt0, dt1 = _data_terms(tau, lmb, f, w, dataterm)
    planes = (u, *rows.project(q[0], q[1]), q[2])
    for _ in range(int(count)):
        prev, planes = planes, tuple(torch.empty_like(a) for a in planes)
        for R0 in range(0, nx, tx):
            for C0 in range(0, ny, ty):
                R1, C1 = min(R0 + tx, nx), min(C0 + ty, ny)
                r0, c0 = max(R0 - h, 0), max(C0 - h, 0)
                r1, c1 = min(R1 + h, nx), min(C1 + h, ny)
                ops = window_ops(r0, c0, r1 - r0, c1 - c0, nx, ny, off,
                                 nx_global)
                win = (..., slice(r0, r1), slice(c0, c1))
                uw, qxw, qyw, qlw = (a[win] for a in prev)
                res = _vol_update(
                    uw, qxw, qyw, qlw, ops.dx(uw), ops.dy(uw), dl(uw),
                    *(d[win] if torch.is_tensor(d) and d.dim() else d
                      for d in (dt0, dt1)),
                    tau, sig_p, sig_t, radius, dataterm, ops)
                own = (..., slice(R0 - r0, R1 - r0), slice(C0 - c0, C1 - c0))
                for dst, src in zip(planes, res[:4]):
                    dst[..., R0:R1, C0:C1] = src[own]

    def k_of(a):
        x, qx, qy, ql = a
        return ((rows.dx(x), rows.dy(x), dl(x)),
                rows.dxt(qx) + rows.dyt(qy) + dlt(ql))

    (g_prev, ktyp), (g_new, kty2) = k_of(prev), k_of(planes)
    res = _residuals(tau_raw, sigma_raw, theta, prev[0], prev[1:], planes[0],
                     planes[1:], g_prev, g_new, ktyp, kty2)
    norms = torch.stack(_norm_sums(res, rows.nsum))
    conv = entry_converged(scal, n_scal)
    new_q, prev_q = torch.stack(planes[1:]), torch.stack(prev[1:])
    out = (torch.where(conv, u, planes[0]), torch.where(conv, q, new_q),
           torch.where(conv, u, prev[0]), torch.where(conv, q, prev_q),
           torch.where(conv, torch.zeros_like(norms), norms))
    if not partials:
        return out
    pd_x, pd_y, pd_l, zh_x, zh_y, zh_l, dd, wh = res
    terms = (label_sum((pd_x * pd_x + pd_y * pd_y) + pd_l * pd_l),
             label_sum((zh_x * zh_x + zh_y * zh_y) + zh_l * zh_l),
             label_sum(dd * dd), label_sum(wh * wh))
    if nx_global is not None:
        li = torch.arange(nx, device=u.device)[:, None]
        owned = (li >= int(scal[6])) & (li < int(scal[7]))
        terms = tuple(torch.where(owned, t, 0.0) for t in terms)
    return out + (tile_partials(terms),)


def vol_multichunk_tiled_plain(u, q, f, w, scal, count: int, k_chunks: int,
                               dataterm: str, stepsize: str, consts,
                               tile=(32, 32), halo=None):
    """The tiled multichunk (``vol_multichunk_`` with ``path="tiled"``):
    ``multichunk_plain``'s loop over ``vol_chunk_tiled_plain``, the
    gradient recomputed from u at each chunk (bit-equal to the carried
    one).  Returns ``vol_multichunk_plain``'s outputs."""
    theta, lmb, radius = scal[2], scal[3], scal[4]

    def chunk(tau, sigma, p):
        s5 = torch.stack([tau, sigma, theta, lmb, radius])
        *out, n2 = vol_chunk_tiled_plain(p[0], p[1], f, w, s5, count,
                                         dataterm, tile=tile, halo=halo)
        return out, n2

    planes, norms, sout = multichunk_plain(chunk, (u, q, u, q), scal, count,
                                           k_chunks, stepsize, consts)
    return (*planes, norms, sout)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(u, q, f, w, scal, n_scal: int, count: int, dataterm: str,
           batched: bool = False):
    if dataterm not in DATATERMS:
        raise ProstError(f"Unknown volumetric data term '{dataterm}'.")
    if int(count) < 1:
        raise ProstError("A chunk needs count >= 1.")
    lead = u.shape[:1] if batched else ()
    k = len(lead)
    if u.dim() != 3 + k or u.shape[k] < 1 or min(u.shape[k + 1:]) < 2:
        what = "a (B, L, nx, ny) stack" if batched else "an (L, nx, ny) volume"
        raise ProstError(f"u must be {what}, got {tuple(u.shape)}.")
    L, nx, ny = u.shape[k:]
    check_buffers("volumetric", (("u", u, (*lead, L, nx, ny)),
                                 ("q", q, (*lead, 3, L, nx, ny)),
                                 ("f", f, (*lead, L, nx, ny)),
                                 ("w", w, (*lead, L, nx, ny))),
                  scal, n_scal, lead[0] if batched else None)


def _lib():
    """The fused volumetric kernel library, built from csrc/fused_vol.cu on
    first use."""
    strides = [ctypes.c_longlong] * 2
    return typed_lib("fused_vol", "prost_vol_num_blocks", {
        "prost_vol_chunk": [VP] * 10 + [CI] * 5 + [VP],
        "prost_vol_chunk_batched": [VP] * 10 + [CI] * 3 + strides
                                   + [CI] * 3 + [VP],
        "prost_vol_chunk_batched_resident": [VP] * 9 + [CI] * 3 + strides
                                            + [CI] * 3 + [VP],
        "prost_vol_chunk_resident": [VP] * 9 + [CI] * 5 + [VP],
        "prost_vol_chunk_halo_resident": [VP] * 9 + [CI] * 6 + [VP],
        "prost_vol_resident_smem": [CI, CI],
        "prost_vol_chunk_halo": [VP] * 10 + [CI] * 6 + [VP],
        "prost_vol_multichunk": [VP] * 10 + [CI] * 7 + [CF] * 6 + [VP],
        "prost_vol_multichunk_resident": [VP] * 9 + [CI] * 7 + [CF] * 6
                                         + [VP],
        "prost_vol_chunk_tiled": [VP] * 9 + [CI] * 7 + [VP],
        "prost_vol_chunk_halo_tiled": [VP] * 9 + [CI] * 8 + [VP],
        "prost_vol_multichunk_tiled": [VP] * 9 + [CI] * 7 + [CF] * 6
                                      + [CI] * 2 + [VP],
        "prost_vol_tiled_smem": []})


def vol_chunk(u, q, f, w, scal, count: int, dataterm: str = "square"):
    """``count`` fused iterations ending on a residual iteration.

    u, f, w: (L, nx, ny); q: (3, L, nx, ny); scal: [tau, sigma, theta, lmb,
    radius] (+ an optional converged flag: when set, nothing runs and the
    inputs come back).  Returns (u2, q2, u_prev, q_prev, norms2), norms2
    the 4 SQUARED preconditioned residual norms, on the inputs' device.
    CPU tensors run the plain version; CUDA tensors run ``vol_chunk_`` on
    copies."""
    _check(u, q, f, w, scal, 5, count, dataterm)
    if u.device.type == "cpu":
        return vol_chunk_plain(u, q, f, w, scal, count, dataterm)
    return halo_copy(vol_chunk_, (u, q), f, w, scal, count, dataterm)


def _launch_chunk(what: str, state, prev, f, w, sc, partial, scratch,
                  route: tuple, count: int, dataterm: str,
                  nx_global=None):
    """One chunk on the card in place on ``state`` (u, q) and ``prev``:
    the grid-resident launch, the tiled launch or the streaming sequence
    (``route`` = (path, tile) of ``vol_pick_route``), of the whole volume
    or (with ``nx_global``) of a halo band, counted under ``what`` (and a
    tiled call also under ``what`` + "_tiled")."""
    u = state[0]
    L, nx, ny = u.shape
    path, tile = route
    fn = "prost_vol_chunk" + ("" if nx_global is None else "_halo")
    tail = (() if nx_global is None else (int(nx_global),)) + (
        int(count), DATATERMS[dataterm])
    if path == "streaming":
        bufs = [*state, *prev, *scratch, f, w, sc, partial]
    else:
        bufs = [*state, *prev, f, w, sc, partial, *scratch]
        fn += "_" + path
    launch(_lib(), fn, what, launch_counts, u.device, bufs, L, nx, ny,
           *tail, *(tile or ()))
    if path == "tiled":
        launch_counts[what + "_tiled"] += 1


def _inplace(what: str, state, prev, f, w, scal, n_scal: int, count: int,
             dataterm: str, nx_global, path):
    """One chunk on the card in place, its buffers made for this call;
    returns norms2."""
    u = state[0]
    L, nx, ny = u.shape
    dev = u.device
    route = vol_pick_route(path, L, nx, ny, dataterm, dev, False, what)
    sc = scalar_buffer(scal, n_scal, S_CONV, S_LEN)
    partial = torch.empty(4 * _lib().prost_vol_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_chunk(what, state, prev, f.contiguous(), w.contiguous(), sc,
                  partial, _scratch(route[0], 0, L, nx, ny, dev), route,
                  count, dataterm, nx_global)
    return sc[S_NORM:S_NORM + 4]


def vol_chunk_(u, q, u_prev, q_prev, f, w, scal, count: int,
               dataterm: str = "square", path=None):
    """``vol_chunk`` in place: (u, q) advance by ``count`` iterations and
    (u_prev, q_prev) take the iterate before the aligned one; with the
    converged flag set nothing changes.  Returns norms2.  On a card
    ``path`` None takes the shape rule's path (``vol_route_of``): one
    grid-resident launch (csrc/fused_vol.cu vol_resident) where the
    volume's planes fit on chip, else one tiled cooperative launch
    (vol_tiled: overlapping 2-D windows, a grid barrier an iteration) and
    the finish where a tile's window does, else the streaming launch
    sequence; "resident", "tiled" or "streaming" asks for one ("resident"
    and "tiled" raise where they cannot launch).  On the CPU every path
    runs the plain version."""
    _check(u, q, f, w, scal, 5, count, dataterm)
    check_path(path, "vol_chunk_")
    check_inplace((u, q), (u_prev, q_prev))
    if u.device.type == "cpu":
        return halo_into((u, q), (u_prev, q_prev), vol_chunk_plain(
            u, q, f, w, scal, count, dataterm), scal, 5)
    return _inplace("vol_chunk", (u, q), (u_prev, q_prev), f, w, scal, 5,
                    count, dataterm, None, path)


def vol_chunk_halo(u, q, f, w, scal, count: int, nx_global: int,
                   dataterm: str = "square"):
    """``vol_chunk`` on one halo-extended shard of the nx axis of a volume
    of ``nx_global`` rows.

    u, f, w: (L, nxb, ny); q: (3, L, nxb, ny), the shard's rows in the
    middle and its neighbours' halo rows (zeros beyond the volume) above
    and below; scal: [tau, sigma, theta, lmb, radius, row_offset, own_lo,
    own_hi] (+ an optional converged flag), row_offset the global row of
    local row 0 and [own_lo, own_hi) the owned local rows.  Returns the
    tuple of ``vol_chunk``, norms2 over the owned rows only.  The label
    axis keeps its Dirichlet ends.  CPU tensors run the plain version;
    CUDA tensors run ``vol_chunk_halo_`` on copies."""
    return halo_copy(vol_chunk_halo_, (u, q), f, w, scal, count, nx_global,
                     dataterm)


def vol_chunk_halo_(u, q, u_prev, q_prev, f, w, scal, count: int,
                    nx_global: int, dataterm: str = "square", path=None):
    """``vol_chunk_halo`` in place, on the sharded route's persistent
    buffers: (u, q) advance by ``count`` iterations and (u_prev, q_prev)
    take the iterate before the aligned one; with the converged flag set
    nothing changes.  Returns norms2.  ``path`` as for ``vol_chunk_``, the
    shape rule on the band's rows."""
    _check(u, q, f, w, scal, N_HALO_SCAL, count, dataterm)
    check_path(path, "vol_chunk_halo_")
    check_halo(nx_global, (u, q), (u_prev, q_prev))
    if u.device.type == "cpu":
        return halo_into((u, q), (u_prev, q_prev), vol_chunk_halo_plain(
            u, q, f, w, scal, count, nx_global, dataterm), scal)
    return _inplace("vol_chunk_halo", (u, q), (u_prev, q_prev), f, w, scal,
                    N_HALO_SCAL, count, dataterm, int(nx_global), path)


class VolChunk(LightChunk):
    """The volumetric routes' light chunk call: ``vol_chunk_`` (with
    ``band`` = (nx_global, rows, row_offset, own_lo, own_hi),
    ``vol_chunk_halo_`` on a band of ``rows`` rows) on the volumes a route
    holds, with what depends only on the shapes made once per route: the
    path (``route``: ``vol_pick_route``'s (path, tile), by the shape rule
    unless ``path`` asks for one), the scratch, the norm partials and the
    scalar buffer with ``m``'s lmb and radius (and the band's row
    context).  A call writes the step sizes and the flag into the scalar
    buffer and launches; on the CPU it runs the plain version."""

    def __init__(self, m, count: int, device, band=None, path=None):
        consts = (m["lmb"], m["radius"]) + tuple(band[2:] if band else ())
        super().__init__(consts, device)
        self.count, self.band = int(count), band
        self.dataterm = m["dataterm"]
        L, nx, ny = m["L"], m["nx"], m["ny"]
        if band is not None:
            nx = int(band[1])
        self.what = "vol_chunk" if band is None else "vol_chunk_halo"
        self.nx_global = None if band is None else int(band[0])
        self.route = None  # (path, tile) on a card
        if torch.device(device).type == "cuda":
            self.route = vol_pick_route(path, L, nx, ny, self.dataterm,
                                        device, False, self.what)
            self.partial = torch.empty(
                4 * _lib().prost_vol_num_blocks(nx, ny), dtype=torch.float32,
                device=device)
            self.scratch = _scratch(self.route[0], 0, L, nx, ny, device)

    @property
    def resident(self):
        """Whether the call runs grid-resident on a card; None on the
        CPU."""
        return None if self.route is None else self.route[0] == "resident"

    def __call__(self, state, prev, f, w, tau, sigma, theta, converged):
        """``count`` iterations on ``state`` (u, q) in place, the previous
        iterate into ``prev``; returns norms2."""
        self.scalars_(tau, sigma, theta, converged)
        if self.route is None:
            scal = self.scal()
            if self.band is None:
                out = vol_chunk_plain(*state, f, w, scal, self.count,
                                      self.dataterm)
            else:
                out = vol_chunk_halo_plain(*state, f, w, scal, self.count,
                                           self.nx_global, self.dataterm)
            return halo_into(state, prev, out, scal, self.n_scal)
        _launch_chunk(self.what, state, prev, f, w, self.sc, self.partial,
                      self.scratch, self.route, self.count, self.dataterm,
                      self.nx_global)
        return self.norms2()


def vol_chunk_batched(u, q, f, w, scal, count: int,
                      dataterm: str = "square"):
    """``vol_chunk`` for each of B volumes in one launch (sequence).

    u, f, w: (B, L, nx, ny); q: (B, 3, L, nx, ny); scal: (5, B), a row each
    of tau, sigma, theta, lmb and radius (+ an optional row of converged
    flags: an instance whose flag is set runs nothing and gets its inputs
    back).  Returns (u2, q2, u_prev, q_prev, norms2), norms2 (4, B) the
    SQUARED preconditioned residual norms of each volume.  Instance b comes
    out as ``vol_chunk`` on volume b alone.  CPU tensors run the plain
    version; CUDA tensors run ``vol_chunk_batched_`` on copies."""
    _check(u, q, f, w, scal, 5, count, dataterm, batched=True)
    if u.device.type == "cpu":
        return vol_chunk_batched_plain(u, q, f, w, scal, count, dataterm)
    return halo_copy(vol_chunk_batched_, (u, q), f, w, scal, count, dataterm)


# labels a grid-resident block unrolls its loops over (csrc/fused_vol.cu
# MAX_RES_L)
MAX_RESIDENT_L = 8


def resident_bytes(L: int, nx: int, ny: int, sms: int,
                   dataterm: str = "square", multi: bool = False) -> int:
    """The dynamic shared memory of one block of the grid-resident chunk
    on volumes (or halo bands) of ``nx`` rows over ``sms`` blocks:
    csrc/fused_vol.cu's VolRes for the largest band (vol_resident_floats:
    u with a row below, q_x with a row above, q_y, q_l, the three carried
    gradient volumes and f, and wsquare's w), at least the reductions'
    array; with ``multi`` the multichunk's, which adds w_hat's window (f
    is read again in the next chunk), at least the reductions' array that
    borrows it."""
    rmax = resident_rows(nx, sms)
    planes = 7 if dataterm == "wsquare" else 6
    floats = (2 * L * (rmax + 1) + planes * L * rmax) * int(ny)
    if multi:
        floats += max(L * rmax * int(ny), RES_RED_BYTES // 4)
    return max(4 * floats, RES_RED_BYTES)


def resident_ok(L: int, nx: int, ny: int, dataterm: str, sms: int,
                smem: int, multi: bool = False) -> bool:
    """The shape rule of ``vol_chunk_``, ``vol_chunk_halo_`` and
    ``vol_chunk_batched_`` (on one volume: the batched launch runs its
    volumes one after another, so B does not enter it), and with ``multi``
    of ``vol_multichunk_``: the chunk (multichunk) runs as one
    grid-resident launch (csrc/fused_vol.cu vol_resident,
    vol_resident_batched, vol_multichunk_resident, one block per SM) where
    L is at most ``MAX_RESIDENT_L`` and the planes of a volume's (or
    band's) largest band fit in ``smem`` bytes of a block's dynamic shared
    memory on a card of ``sms`` SMs, and as the streaming launch sequence
    otherwise."""
    return (1 <= int(L) <= MAX_RESIDENT_L
            and resident_bytes(L, nx, ny, sms, dataterm, multi) <= int(smem))


@functools.lru_cache(maxsize=None)
def card_limits(device, L: int, batched: bool = False,
                multi: bool = False) -> tuple:
    """(SMs, the dynamic shared memory a block of the grid-resident chunk
    of L labels, with ``batched`` the batched chunk's, with ``multi`` the
    multichunk's, may hold, 0 beyond ``MAX_RESIDENT_L``) of the card
    ``device``, read once."""
    if not 1 <= int(L) <= MAX_RESIDENT_L:
        return card_sms(device), 0
    lib = _lib()
    with torch.cuda.device(device):
        smem = lib.prost_vol_resident_smem(int(L), 2 if multi
                                           else int(bool(batched)))
    if smem < 0:
        raise ProstError(f"vol_chunk: no shared-memory limit for the "
                         f"resident chunk on {device} (CUDA error {-smem}).")
    return card_sms(device), smem


def vol_tiled_bytes(tx: int, ty: int, L: int) -> int:
    """The dynamic shared memory of one block of the tiled launch
    (csrc/fused_vol.cu vol_tiled_smem): 5L planes (u, q_x, q_y, q_l, f
    then the new u) of the window of a ``tx`` x ``ty`` tile with
    ``vol_tiled_halo`` pixel on every side and, for the last iteration's
    norms, one more row above and column left of it, and L planes of the
    tile (the last iteration's w_hat); at least the norm pass's reductions
    (wsquare's w is read from device memory)."""
    e = 2 * vol_tiled_halo() + 1
    tx, ty, L = int(tx), int(ty), int(L)
    return 4 * max(5 * L * (tx + e) * (ty + e) + L * tx * ty,
                   RES_RED_BYTES // 4)


@functools.lru_cache(maxsize=None)
def vol_tiled_tile(nx: int, ny: int, L: int, sms: int, smem: int):
    """The owned tile (rows, columns) of the tiled launch on (L, nx, ny)
    volumes on a card of ``sms`` SMs whose blocks may hold ``smem`` bytes
    of dynamic shared memory: of the tiles (rows a multiple of 8, columns
    of 32, so every 32x8 norm tile lies in one) whose window fits
    (``vol_tiled_bytes``), the one whose iteration moves the fewest window
    pixels through the SMs (``fused_rof.window_tile``'s rule); None where
    no tile's window fits."""
    from .fused_rof import window_tile

    return window_tile(nx, ny, 2 * vol_tiled_halo() + 1, sms,
                       lambda tx, ty: vol_tiled_bytes(tx, ty, L) <= smem)


def vol_tiled_ok(L: int, nx: int, ny: int, sms: int, smem: int) -> bool:
    """Whether the tiled launch takes (L, nx, ny) volumes: 1 to
    ``MAX_RESIDENT_L`` labels (a template instance each) and some tile's
    window fits in ``smem`` bytes."""
    return (1 <= int(L) <= MAX_RESIDENT_L
            and vol_tiled_tile(int(nx), int(ny), int(L), int(sms),
                               int(smem)) is not None)


def vol_route_of(L: int, nx: int, ny: int, dataterm: str, sms: int,
                 smem: int, tiled_smem: int, multi: bool = False) -> str:
    """The shape rule of ``vol_chunk_``, ``vol_chunk_halo_`` (on the band's
    rows) and, with ``multi``, ``vol_multichunk_`` on a card of ``sms``
    SMs whose grid-resident blocks may hold ``smem`` bytes and tiled blocks
    ``tiled_smem``: "resident" where the volume fits in the grid-resident
    launch (``resident_ok``: 256x256x8 on an H100), else "tiled" where a
    tile's window fits (``vol_tiled_ok``: 512x512x8 and its 556-row band),
    else "streaming" (beyond 8 labels)."""
    if resident_ok(L, nx, ny, dataterm, sms, smem, multi):
        return "resident"
    if vol_tiled_ok(L, nx, ny, sms, tiled_smem):
        return "tiled"
    return "streaming"


@functools.lru_cache(maxsize=None)
def vol_tiled_limit(device) -> int:
    """The dynamic shared memory a block of the tiled launch may hold on
    the card ``device``, read once."""
    with torch.cuda.device(device):
        smem = _lib().prost_vol_tiled_smem()
    if smem < 0:
        raise ProstError(f"vol_chunk: no shared-memory limit for the tiled "
                         f"chunk on {device} (CUDA error {-smem}).")
    return smem


def vol_pick_route(path, L: int, nx: int, ny: int, dataterm: str, device,
                   multi: bool, what: str) -> tuple:
    """(path, tile) of a single-volume chunk (with ``multi``, of the
    multichunk) on the card ``device``: by ``vol_route_of`` where ``path``
    is None, else the one asked for; "resident" where the volume does not
    fit, or "tiled" where no tile's window does, raises ``ProstError``.
    ``tile`` is the tiled launch's (rows, columns), else None."""
    check_path(path, what)
    sms, smem = card_limits(device, L, multi=multi)
    tsmem = vol_tiled_limit(device) if 1 <= int(L) <= MAX_RESIDENT_L else 0
    if path is None:
        path = vol_route_of(L, nx, ny, dataterm, sms, smem, tsmem, multi)
    if path == "resident" and not resident_ok(L, nx, ny, dataterm, sms,
                                              smem, multi):
        raise ProstError(f"{what}: the chunk's planes do not fit in the "
                         "shared memory of one block per SM.")
    tile = None
    if path == "tiled":
        if not vol_tiled_ok(L, nx, ny, sms, tsmem):
            raise ProstError(f"{what}: the tiled launch takes 1 to "
                             f"{MAX_RESIDENT_L} labels and a tile's window "
                             "in the shared memory of a block.")
        tile = vol_tiled_tile(int(nx), int(ny), int(L), int(sms), int(tsmem))
    return path, tile


def _scratch(path: str, B, L, nx, ny, device):
    """A launch's scratch on ``path``: the grid-resident chunk's norm terms
    (4 planes, which a batched launch's volumes share), the tiled launch's
    second slot of the state (u and q: 4L planes) and its norm terms (4
    planes), or the streaming sequence's carried gradient volumes (of this
    iterate and of the previous one; with ``B``, of every instance)."""
    lead = (B,) if B else ()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    if path == "resident":
        return [empty(4, nx, ny)]
    if path == "tiled":
        return [empty((4 * L + 4) * nx * ny)]
    return [empty(*lead, 3, L, nx, ny), empty(*lead, 3, L, nx, ny)]


def _launch_batched(state, prev, f, w, sc, partial, scratch, resident: bool,
                    count: int, dataterm: str, strides):
    """One batched chunk on the card in place on ``state`` (u, q) and
    ``prev``: the grid-resident launch (the volumes one after another) or
    the streaming sequence (all at once), counted under
    ``vol_chunk_batched``."""
    u = state[0]
    B, L, nx, ny = u.shape
    tail = (int(count), DATATERMS[dataterm], B)
    lib = _lib()
    if resident:
        launch(lib, "prost_vol_chunk_batched_resident", "vol_chunk_batched",
               launch_counts, u.device, [*state, *prev, f, w, sc, partial,
                                         *scratch], L, nx, ny, *strides,
               *tail)
    else:
        launch(lib, "prost_vol_chunk_batched", "vol_chunk_batched",
               launch_counts, u.device, [*state, *prev, *scratch, f, w, sc,
                                         partial], L, nx, ny, *strides,
               *tail)


def vol_chunk_batched_(u, q, u_prev, q_prev, f, w, scal, count: int,
                       dataterm: str = "square", path=None):
    """``vol_chunk_batched`` in place: every volume of (u, q) advances by
    ``count`` iterations and (u_prev, q_prev) take its iterate before the
    aligned one; a volume whose flag is set changes nothing.  u and q may
    be views of a route's flat x and y (see ``instance_strides``).
    Returns norms2 (4, B).  On a card ``path`` None takes the shape rule's
    path (``resident_ok`` on one volume, whatever B): one grid-resident
    launch (csrc/fused_vol.cu vol_resident_batched, the volumes one after
    another) where one volume's planes fit on chip, else the streaming
    launch sequence; "resident" or "streaming" asks for one ("resident"
    raises where it does not fit)."""
    state, prev = (u, q), (u_prev, q_prev)
    _check(u, q, f, w, scal, 5, count, dataterm, batched=True)
    strides = instance_strides(state, prev, "vol_chunk_batched_")
    if u.device.type == "cpu":
        return halo_into(state, prev, vol_chunk_batched_plain(
            u, q, f, w, scal, count, dataterm), scal, 5)
    B, L, nx, ny = u.shape
    dev = u.device
    resident = pick_path(path, resident_ok(L, nx, ny, dataterm,
                                           *card_limits(dev, L, True)),
                         "vol_chunk_batched")
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = torch.empty(4 * B * _lib().prost_vol_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_batched(state, prev, f.contiguous(), w.contiguous(), sc, partial,
                    _scratch("resident" if resident else "streaming", B, L,
                             nx, ny, dev), resident, count, dataterm,
                    strides)
    return sc[:, S_NORM:S_NORM + 4].T


class VolBatchedChunk(LightChunk):
    """``BatchedPDHG``'s light call of the batched volumetric chunk:
    ``vol_chunk_batched_`` on the views of the run's own flat x, y, x_prev
    and y_prev, with what depends only on the shapes made once per route:
    the path (``resident_ok`` on one volume), the scratch, the norm
    partials and the scalar buffer with every instance's lmb and radius.
    A call writes the step sizes and the flags into the scalar buffer and
    launches; on the CPU it runs the plain version."""

    def __init__(self, m, batch: int, count: int, device):
        super().__init__((m["lmb"], m["radius"]), device, batch)
        self.count, self.dataterm = int(count), m["dataterm"]
        B, L, nx, ny = int(batch), m["L"], m["nx"], m["ny"]
        self.resident = None  # the path on a card
        if torch.device(device).type == "cuda":
            self.resident = resident_ok(L, nx, ny, self.dataterm,
                                        *card_limits(device, L, True))
            self.partial = torch.empty(
                4 * B * _lib().prost_vol_num_blocks(nx, ny),
                dtype=torch.float32, device=device)
            self.scratch = _scratch(
                "resident" if self.resident else "streaming", B, L, nx, ny,
                device)

    def __call__(self, state, prev, f, w, tau, sigma, theta, converged):
        """``count`` iterations of every volume of ``state`` (u, q) in
        place, the previous iterate into ``prev``; ``converged`` sets every
        instance's flag; returns norms2 (4, B)."""
        self.scalars_(tau, sigma, theta, converged)
        if self.resident is None:
            scal = self.scal()
            out = vol_chunk_batched_plain(*state, f, w, scal, self.count,
                                          self.dataterm)
            return halo_into(state, prev, out, scal, self.n_scal)
        _launch_batched(state, prev, f, w, self.sc, self.partial,
                        self.scratch, self.resident, self.count,
                        self.dataterm,
                        instance_strides(state, prev, "vol_chunk_batched_"))
        return self.norms2()


def vol_multichunk(u, q, f, w, scal, count: int, k_chunks: int,
                   dataterm: str, stepsize: str, consts):
    """Up to ``k_chunks * count`` fused iterations with the adaptation and
    the stopping test on the device between chunks.

    ``scal`` holds 13 scalars: [tau, sigma, theta, lmb, radius, arg_alpha,
    arb_l, arb_u, it0, tol_rel_p, tol_rel_d, tol_abs_p, tol_abs_d] (+ an
    optional converged-at-entry flag).  Returns (u2, q2, u_prev, q_prev,
    norms, sout): norms the last executed chunk's sqrt'd residual norms,
    sout = [tau, sigma, arg_alpha, arb_l, arb_u, converged, chunks_done].
    CPU tensors run the plain version; CUDA tensors run ``vol_multichunk_``
    on copies."""
    _check(u, q, f, w, scal, 13, count, dataterm)
    if stepsize not in STEPSIZES:
        raise ProstError(f"No fused adaptation for stepsize '{stepsize}'.")
    if u.device.type == "cpu":
        return vol_multichunk_plain(u, q, f, w, scal, count, k_chunks,
                                    dataterm, stepsize, consts)
    *planes, (norms, sout) = halo_copy(vol_multichunk_, (u, q), f, w, scal,
                                       count, k_chunks, dataterm, stepsize,
                                       consts)
    return (*planes, norms, sout)


def _launch_multichunk(state, prev, f, w, sc, partial, scratch,
                       route: tuple, count: int, k_chunks: int,
                       dataterm: str, stepsize: str, consts) -> None:
    """One multichunk on the card in place on ``state`` (u, q) and
    ``prev``: the grid-resident launch, the tiled launches or the
    streaming sequence (``route`` = (path, tile) of ``vol_pick_route``),
    counted under ``vol_multichunk`` (and a tiled call also under
    ``vol_multichunk_tiled``)."""
    u = state[0]
    L, nx, ny = u.shape
    path, tile = route
    if path == "streaming":
        fn, bufs = "prost_vol_multichunk", [*state, *prev, *scratch, f, w,
                                            sc, partial]
    else:
        fn = "prost_vol_multichunk_" + path
        bufs = [*state, *prev, f, w, sc, partial, *scratch]
    launch(_lib(), fn, "vol_multichunk", launch_counts, u.device, bufs, L,
           nx, ny, int(count), int(k_chunks), DATATERMS[dataterm],
           STEPSIZES[stepsize], *[float(c) for c in consts], *(tile or ()))
    if path == "tiled":
        launch_counts["vol_multichunk_tiled"] += 1


def vol_multichunk_(u, q, u_prev, q_prev, f, w, scal, count: int,
                    k_chunks: int, dataterm: str, stepsize: str, consts,
                    path=None):
    """``vol_multichunk`` in place: (u, q) advance by up to ``k_chunks``
    chunks and (u_prev, q_prev) take the iterate before the last executed
    chunk's aligned iteration; with the converged flag set at entry nothing
    changes.  Returns (norms, sout).  On a card ``path`` None takes the
    shape rule's path (``vol_route_of(..., multi=True)``): one
    grid-resident launch for all the chunks (csrc/fused_vol.cu
    vol_multichunk_resident) where the volume's planes fit on chip, else a
    tiled launch (vol_tiled) and the finish's adaptation a chunk, (u, q)
    and the scratch taking turns, where a tile's window fits, else the
    streaming launch sequence; "resident", "tiled" or "streaming" asks for
    one ("resident" and "tiled" raise where they cannot launch)."""
    _check(u, q, f, w, scal, 13, count, dataterm)
    if stepsize not in STEPSIZES:
        raise ProstError(f"No fused adaptation for stepsize '{stepsize}'.")
    state, prev = (u, q), (u_prev, q_prev)
    check_inplace(state, prev)
    check_path(path, "vol_multichunk")
    if u.device.type == "cpu":
        out = vol_multichunk_plain(u, q, f, w, scal, count, k_chunks,
                                   dataterm, stepsize, consts)
        return halo_into(state, prev, out[:5], scal, 13), out[5]
    L, nx, ny = u.shape
    dev = u.device
    route = vol_pick_route(path, L, nx, ny, dataterm, dev, True,
                           "vol_multichunk")
    sc = scalar_buffer(scal, 13, S_CONV, S_LEN)
    partial = torch.empty(4 * _lib().prost_vol_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_multichunk(state, prev, f.contiguous(), w.contiguous(), sc,
                       partial, _scratch(route[0], 0, L, nx, ny, dev), route,
                       count, k_chunks, dataterm, stepsize, consts)
    return sc[S_NORM:S_NORM + 4], torch.stack([sc[i] for i in SOUT])


class VolMultichunk(LightMultichunk):
    """The volumetric route's light call of the multichunk:
    ``vol_multichunk_`` on the views (u, q) of the run's own x, y, x_prev
    and y_prev, its path ``vol_route_of(..., multi=True)`` unless ``path``
    asks for one (``route``: (path, tile)); ``resident`` whether that path
    is the grid-resident launch."""

    _inplace = staticmethod(vol_multichunk_)
    route = None  # (path, tile) on a card

    def __init__(self, m, count: int, k_chunks: int, stepsize: str, device,
                 path=None):
        self.path = path
        super().__init__(m, count, k_chunks, stepsize, device)

    def _card(self, device):
        m = self.m
        L, nx, ny = m["L"], m["nx"], m["ny"]
        self.route = vol_pick_route(self.path, L, nx, ny, m["dataterm"],
                                    device, True, "vol_multichunk")
        partial = torch.empty(4 * _lib().prost_vol_num_blocks(nx, ny),
                              dtype=torch.float32, device=device)
        return (self.route[0] == "resident", partial,
                _scratch(self.route[0], 0, L, nx, ny, device))

    def _launch(self, state, prev, f, w, sc, partial, scratch, resident,
                *args):
        _launch_multichunk(state, prev, f, w, sc, partial, scratch,
                           self.route, *args)


# ---------------------------------------------------------------------------
# structure matching and the route
# ---------------------------------------------------------------------------

def match_vol_structure(problem):
    """Detect the fusable volumetric-TV structure; returns dict(L, nx, ny,
    f, w, lmb, radius, dataterm) or None.  Conditions: a lone gradient3d
    block (label_first=False); prox_g a single 1D square or abs with coeffs
    (1, f, lmb, 0, 0), or a square with per-voxel a; prox_fstar a
    Moreau(norm2 abs, dim=3 planar, coeffs (1, 0, c, 0, 0)) or a dim-3
    norm2 ind_leq0 ball; alpha preconditioner (Sigma = 1/2, Tau = 1/6).
    The fused route is float32 only."""
    if config_dtype() != torch.float32:
        return None
    linop = problem.linop
    if not isinstance(linop, LinearOperator) or len(linop.blocks) != 1:
        return None
    blk = linop.blocks[0]
    if not isinstance(blk, BlockGradient3D) or blk.label_first:
        return None
    if len(problem.prox_g) != 1 or len(problem.prox_fstar) != 1:
        return None
    L, nx, ny = blk.L, blk.nx, blk.ny
    data = match_dataterm(problem.prox_g[0], (L, nx, ny),
                          problem.scaling_left.device)
    if data is None:
        return None
    dataterm, f, w, lmb = data
    radius = dual_ball_radius(problem.prox_fstar[0], dim=3)
    if radius is None:
        return None
    sl, sr = problem.scaling_left, problem.scaling_right
    if not (torch.allclose(sl, torch.full_like(sl, 0.5))
            and torch.allclose(sr, torch.full_like(sr, 1.0 / 6.0))):
        return None
    return {"L": L, "nx": nx, "ny": ny, "f": f, "w": w, "lmb": lmb,
            "radius": radius, "dataterm": dataterm}


def _volumes(v, x, y):
    """(u, q) views of the solver's flat x and y."""
    L, nx, ny = v["L"], v["nx"], v["ny"]
    return x.reshape(L, nx, ny), y.reshape(3, L, nx, ny)


def _multi_chunk(b, s: PDHGState) -> PDHGState:
    """One multichunk in place on the views of the run's own x, y, x_prev
    and y_prev (``own_vectors``) through the route's light call
    (``VolMultichunk``, made once per route)."""
    v, ri = b.vol, max(int(b.opts.residual_iter), 1)
    if "multi" not in v:
        v["multi"] = VolMultichunk(v, ri, K_CHUNKS, b.opts.stepsize,
                                   s.x.device)
    norms, sout = v["multi"](
        _volumes(v, s.x, s.y), _volumes(v, s.x_prev, s.y_prev), s.tau,
        s.sigma, s.theta, s.arg_alpha, s.arb_l, s.arb_u, s.iteration,
        s.converged)
    return multichunk_state(s, ri, s.x, s.y, s.x_prev, s.y_prev, norms,
                            sout)


def _fused_chunk(b, s: PDHGState) -> PDHGState:
    """One chunk in place on the views of the run's own x, y, x_prev and
    y_prev (``own_vectors``) through the route's light call."""
    v, ri = b.vol, max(int(b.opts.residual_iter), 1)
    if "call" not in v:
        v["call"] = VolChunk(v, ri, s.x.device)
    norms2 = v["call"](_volumes(v, s.x, s.y), _volumes(v, s.x_prev, s.y_prev),
                       v["f"], v["w"], s.tau, s.sigma, s.theta, s.converged)
    return chunk_state(b, s, ri, s.x, s.y, s.x_prev, s.y_prev, norms2)


def fused_vol_run(b, state: PDHGState, until: int, start: int) -> PDHGState:
    """``run_pdhg_route`` with the volumetric multichunks and chunks of
    ``FusedROFPDHG`` ``b``; the canonicalization zeroes the dead dual
    coordinates of y and y_prev (q_x's last row, q_y's last column) and
    leaves q_l, the segment after them, whole, on the run's own copies of
    the state's vectors, which the multichunks and chunks update in
    place."""
    v = b.vol
    canonical = canonical_duals(v["L"], v["nx"], v["ny"])
    return run_pdhg_route(b, state, until, start,
                          lambda s: _fused_chunk(b, s),
                          lambda s: own_vectors(canonical(s)),
                          lambda s: _multi_chunk(b, s))
