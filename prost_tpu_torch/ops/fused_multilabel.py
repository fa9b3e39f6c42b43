"""Fused PDHG iteration for the "fast" multilabel relaxation (counterpart of
``prost_tpu/ops/fused_multilabel.py``, whole-plane route).

Workload (examples/example_multilabel_fast.py):

    min_{u >= 0} <u, f> + lmb TV(u)   s.t.  sum_l u_l = 1 per pixel

in the saddle form with primal u (L label planes), duals q (2L gradient
planes inside one per-pixel radius-lmb ball over all 2L components) and s
(the sum-to-one multiplier plane):

    K = [ grad2d (2nL x nL) ; kron(ones(1, L), I_n) (n x nL) ]

With the Pock-Chambolle alpha preconditioner the diagonals are constant
per segment: Tau = 1/5 (column sums 4 + 1), Sigma_q = 1/2 (gradient rows),
Sigma_s = 1/L (the ones-row), so an iteration is stencils, pointwise work
and sums over the label axis.

Three kernels carry the multilabel routes, hand-written CUDA in
``csrc/fused_multilabel.cu`` with a plain PyTorch version beside each
wrapper here:

* ``ml_chunk`` (JAX ``ml_fused_chunk``): ``count`` iterations ending on a
  residual iteration, with the four squared preconditioned residual norms;
* ``ml_multichunk`` (JAX ``ml_fused_multichunk``): up to ``k_chunks``
  chunks with the boyd/goldstein adaptation and the stopping test on the
  device between chunks;
* ``ml_chunk_batched`` (JAX ``ml_fused_chunk_batched``): one chunk for each
  of B instances in one launch, or one launch sequence, the batched
  ensembles' route (``parallel/ensemble.py``);
* ``ml_chunk_halo`` (JAX ``ml_fused_chunk_halo``): one chunk on a
  halo-extended shard of a row-partitioned plane, the spatially sharded
  route's (``parallel/spatial_fused.py``).

The single-instance chunk, its halo mode, the batched chunk and the
multichunk have in-place forms, ``ml_chunk_``, ``ml_chunk_halo_``,
``ml_chunk_batched_`` and ``ml_multichunk_``, and the routes call them
through ``MLChunk``, ``MLBatchedChunk`` and ``MLMultichunk``, which make
their buffers once per route.  On a card each runs as one grid-resident
cooperative launch (the multichunk: all its chunks and their adaptation in
one) where the shape rule (``resident_ok``, on one instance: a batched
launch runs its instances one after another; with ``multi`` the
multichunk's) finds that one instance's planes fit in the shared memory of
one block per SM.  Where they do not (512x512x8, the JAX package's banded
size), the single-instance chunk, its halo mode and the multichunk run as
one tiled cooperative launch a chunk (the JAX ``ml_fused_chunk_banded`` and
``ml_fused_multichunk_banded``: ``ml_route_of``, a grid barrier an
iteration, each iteration one pass over device memory through overlapping
windows of a tile and ``ml_tiled_halo`` pixel a side), and beyond 8 labels
as the streaming launch sequence; all are bit-equal.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel, or raises.  As on the ROF route there is no fallback
to the generic path.

Layout contract (the JAX package's, at every public function): u and f
(L, nx, ny); q (2L, nx, ny) = [gx; gy] stacked label planes; s (nx, ny);
the solver's y = [q; s] flattened.  The dead dual coordinates (q_x's last
row and q_y's last column in every label plane) are zeroed once per run
and at every chunk entry, as on the ROF route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..backend.pdhg import PDHGState
from ..config import ProstError, dtype as config_dtype
from ..linop.base import LinearOperator
from ..linop.blocks import BlockKronId
from ..linop.gradient import BlockGradient2D
from ..prox.elemop import ProxElem1D, ProxElemNorm2
from .pdhg_chunk import (CF, CI, N_HALO_SCAL, RES_RED_BYTES, S_CONV,
                         S_LEN, S_NORM, SOUT, STEPSIZES, VP, WHOLE_PLANE,
                         LightChunk, LightMultichunk, ball_scale,
                         canonical_duals, card_sms,
                         check_buffers, check_halo, check_inplace,
                         check_path, chunk_state, coeff_vector, dx, dy,
                         entry_converged, halo_copy, halo_into,
                         halo_scal_rows, instance_strides, isscalar,
                         label_sum, launch,
                         leq0_ball_radius, multichunk_plain, multichunk_state,
                         own_vectors, pick_path, resident_rows,
                         run_pdhg_route, scalar_buffer, typed_lib,
                         vmap_plain)
from .phases import K_CHUNKS

_SQRT_T = 0.4472135954999579    # sqrt(Tau)     = sqrt(1/5)
_SQRT_S_Q = 0.7071067811865476  # sqrt(Sigma_q) = sqrt(1/2)

# launches of each kernel wrapper on the card (CPU calls do not count)
# (a tiled call also counts under its wrapper's name + "_tiled")
launch_counts = {"ml_chunk": 0, "ml_multichunk": 0, "ml_chunk_batched": 0,
                 "ml_chunk_halo": 0, "ml_chunk_tiled": 0,
                 "ml_multichunk_tiled": 0, "ml_chunk_halo_tiled": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions of the chunk math
# ---------------------------------------------------------------------------

def _ml_update(u, qx, qy, s, gx, gy, su, tf, tau, sig_q, sig_s, theta,
               radius, d_s, rows=WHOLE_PLANE):
    """One preconditioned PDHG update.  tau, sig_q and sig_s arrive
    pre-multiplied by Tau = 1/5, Sigma_q = 1/2 and Sigma_s = 1/L; tf is
    tau * f.  (gx, gy, su) = (dx(u), dy(u), sum_l u) carried from the
    previous iteration.  Returns the new state, the new carried planes and
    K^T of the old dual; ``rows`` is the planes' ``RowOps``."""
    kty = rows.dxt(qx) + rows.dyt(qy) + s
    # prox of ind_geq0(u) + <f, u>
    u2 = torch.clamp_min(u - tau * kty - tf, 0.0)
    gx2, gy2 = rows.dx(u2), rows.dy(u2)
    su2 = label_sum(u2)
    # per-pixel radius-lmb ball over all 2L gradient components
    axq = qx + sig_q * ((1.0 + theta) * gx2 - theta * gx)
    ayq = qy + sig_q * ((1.0 + theta) * gy2 - theta * gy)
    scale = ball_scale(label_sum(axq * axq + ayq * ayq), radius)
    # prox of <s, d_s> (linear: a shift)
    s2 = s + sig_s * ((1.0 + theta) * su2 - theta * su) - sig_s * d_s
    return u2, axq * scale, ayq * scale, s2, gx2, gy2, su2, kty


def _ml_chunk_core(tau_raw, sigma_raw, theta, radius, d_s, u0, qx0, qy0, s0,
                   f, count: int, g0=None, rows=WHOLE_PLANE):
    """One residual_iter-sized chunk: ``count - 1`` plain iterations, then
    the aligned iteration with its four preconditioned residual norms
    (squared).  ``g0`` seeds the carried planes (dx(u0), dy(u0),
    sum_l u0), a previous chunk's; ``rows`` is the planes' ``RowOps``.

    Returns ((u2, qx2, qy2, s2), (u_prev, qx_prev, qy_prev, s_prev),
    norms, (gx2, gy2, su2))."""
    L = u0.shape[0]
    tau = tau_raw * 0.2              # tau * Tau
    sig_q = sigma_raw * 0.5          # sigma * Sigma_q
    sig_s = sigma_raw * (1.0 / L)    # sigma * Sigma_s
    tf = tau * f
    qx, qy = rows.project(qx0, qy0)
    u, s = u0, s0
    gx, gy, su = ((rows.dx(u0), rows.dy(u0), label_sum(u0))
                  if g0 is None else g0)
    args = (tf, tau, sig_q, sig_s, theta, radius, d_s, rows)
    for _ in range(count - 1):
        u, qx, qy, s, gx, gy, su, _ = _ml_update(u, qx, qy, s, gx, gy, su,
                                                 *args)
    # aligned iteration; (gx, gy, su) = K x_prev carried for free
    u2, qx2, qy2, s2, gx2, gy2, su2, ktyp = _ml_update(u, qx, qy, s, gx, gy,
                                                       su, *args)
    kty2 = rows.dxt(qx2) + rows.dyt(qy2) + s2
    norms = _norm_sums(_residuals(tau_raw, sigma_raw, theta, (u, qx, qy, s),
                                  (u2, qx2, qy2, s2), (gx, gy, su),
                                  (gx2, gy2, su2), ktyp, kty2), rows.nsum)
    return ((u2, qx2, qy2, s2), (u, qx, qy, s), norms, (gx2, gy2, su2))


def _residuals(tau_raw, sigma_raw, theta, prev, new, g_prev, g_new, ktyp,
               kty2):
    """The preconditioned residuals of the aligned iteration from ``prev``
    (u, q_x, q_y, s) to ``new``: pd (x, y, s), z_hat (x, y, s), dd and
    w_hat, from K of both iterates (gx, gy, su) and K^T of both duals."""
    u, qx, qy, s = prev
    u2, qx2, qy2, s2 = new
    gx, gy, su = g_prev
    gx2, gy2, su2 = g_new
    L = u.shape[0]
    # preconditioned residuals, segment-wise sqrt(Sigma)
    sqrt_s_s = (1.0 / L) ** 0.5
    inv_q = 1.0 / (sigma_raw * _SQRT_S_Q)
    inv_s = 1.0 / (sigma_raw * sqrt_s_s)
    zh_x = (qx - qx2) * inv_q + _SQRT_S_Q * ((1.0 + theta) * gx2 - theta * gx)
    zh_y = (qy - qy2) * inv_q + _SQRT_S_Q * ((1.0 + theta) * gy2 - theta * gy)
    zh_s = (s - s2) * inv_s + sqrt_s_s * ((1.0 + theta) * su2 - theta * su)
    pd_x = zh_x - _SQRT_S_Q * gx2
    pd_y = zh_y - _SQRT_S_Q * gy2
    pd_s = zh_s - sqrt_s_s * su2
    wh = (u - u2) * (1.0 / (tau_raw * _SQRT_T)) - _SQRT_T * ktyp
    dd = wh + _SQRT_T * kty2
    return pd_x, pd_y, pd_s, zh_x, zh_y, zh_s, dd, wh


def _norm_sums(res, nsum):
    """The four squared norms of ``_residuals``' ``res``, each a sum of
    ``nsum``s."""
    pd_x, pd_y, pd_s, zh_x, zh_y, zh_s, dd, wh = res
    return (
        nsum(pd_x * pd_x) + nsum(pd_y * pd_y) + nsum(pd_s * pd_s),
        nsum(zh_x * zh_x) + nsum(zh_y * zh_y) + nsum(zh_s * zh_s),
        nsum(dd * dd),
        nsum(wh * wh),
    )


def ml_chunk_plain(u, q, s, f, scal, count: int, rows=WHOLE_PLANE,
                   n_scal: int = 5):
    """Plain PyTorch version of ``ml_chunk`` (any device); with ``rows``
    and ``n_scal`` that of a halo chunk."""
    L = u.shape[0]
    new, prev, norms, _ = _ml_chunk_core(
        scal[0], scal[1], scal[2], scal[3], scal[4], u, q[:L], q[L:], s, f,
        int(count), rows=rows)
    q2 = torch.cat([new[1], new[2]])
    qp = torch.cat([prev[1], prev[2]])
    n2 = torch.stack(norms)
    conv = entry_converged(scal, n_scal)
    return (torch.where(conv, u, new[0]), torch.where(conv, q, q2),
            torch.where(conv, s, new[3]), torch.where(conv, u, prev[0]),
            torch.where(conv, q, qp), torch.where(conv, s, prev[3]),
            torch.where(conv, torch.zeros_like(n2), n2))


def ml_chunk_halo_plain(u, q, s, f, scal, count: int, nx_global: int):
    """Plain PyTorch version of ``ml_chunk_halo`` (any device; reads the
    row context of ``scal`` on the host)."""
    return ml_chunk_plain(u, q, s, f, scal, count,
                          halo_scal_rows(scal, nx_global), N_HALO_SCAL)


def ml_chunk_batched_plain(u, q, s, f, scal, count: int):
    """Plain PyTorch version of ``ml_chunk_batched`` (any device):
    ``ml_chunk_plain`` vmapped over the instances."""
    return vmap_plain(ml_chunk_plain, (u, q, s, f), scal, int(count))


def ml_multichunk_plain(u, q, s, f, scal, count: int, k_chunks: int,
                        stepsize: str, consts):
    """Plain PyTorch version of ``ml_multichunk`` (any device): every chunk
    is computed and kept only while not converged, where the JAX kernel
    branches around it with ``lax.cond``."""
    L = u.shape[0]
    theta, radius, d_s = scal[2], scal[3], scal[4]

    def chunk(tau, sigma, p):
        new, prev, nrm, g2 = _ml_chunk_core(
            tau, sigma, theta, radius, d_s, p[0], p[1], p[2], p[3], f,
            int(count), g0=p[8:])
        return new + prev + g2, nrm

    qx, qy = q[:L], q[L:]
    planes, norms, sout = multichunk_plain(
        chunk, (u, qx, qy, s, u, qx, qy, s, dx(u), dy(u), label_sum(u)),
        scal, count, k_chunks, stepsize, consts)
    u2, qx2, qy2, s2, up, qxp, qyp, sp = planes[:8]
    return (u2, torch.cat([qx2, qy2]), s2, up, torch.cat([qxp, qyp]), sp,
            norms, sout)


def ml_tiled_halo() -> int:
    """The halo of the tiled chunk's window, in pixels on every side of a
    tile: an iteration's dual step at a pixel reads the new and the old u
    one row below and one column right, the new u there K^T q, which reads
    q_x one row up and q_y one column left, so one pixel of the old state
    around the tile gives the owned pixels exactly; the next iteration
    loads its window anew."""
    return 1


def ml_chunk_tiled_plain(u, q, s, f, scal, count: int, nx_global=None,
                         tile=(32, 32), halo=None, partials: bool = False):
    """The tiled chunk (``ml_chunk_`` and ``ml_chunk_halo_`` with
    ``path="tiled"``) window by window: each iteration ``_ml_update`` on
    every tile's window (the tile of ``tile`` rows and columns and
    ``halo`` pixels on every side, clamped at the plane's edges,
    ``ml_tiled_halo`` by default; every mask decided by the pixel's place
    in the plane, ``fused_rof.window_ops``), the carried gradient and label
    sum recomputed from the window's u, the owned pixels stitched into new
    planes; then the norms of the stitched planes, K u and K^T y
    recomputed.  With ``nx_global`` the halo form (the row context read
    from ``scal``).  Returns ``ml_chunk_plain``'s outputs; with
    ``partials`` also the 32x8 tiles' partials (``fused_rof.tile_partials``)
    that the kernel's finish reduces."""
    from .fused_rof import tile_partials, window_ops

    L, nx, ny = u.shape
    if nx_global is None:
        n_scal, off, rows = 5, 0, WHOLE_PLANE
    else:
        n_scal, off = N_HALO_SCAL, int(scal[5])
        rows = halo_scal_rows(scal, nx_global)
    h = ml_tiled_halo() if halo is None else int(halo)
    tx, ty = (int(t) for t in tile)
    tau_raw, sigma_raw, theta, radius, d_s = (scal[k] for k in range(5))
    tau = tau_raw * 0.2              # tau * Tau
    sig_q = sigma_raw * 0.5          # sigma * Sigma_q
    sig_s = sigma_raw * (1.0 / L)    # sigma * Sigma_s
    tf = tau * f
    planes = (u, *rows.project(q[:L], q[L:]), s)
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
                uw, qxw, qyw, sw = (a[win] for a in prev)
                res = _ml_update(uw, qxw, qyw, sw, ops.dx(uw), ops.dy(uw),
                                 label_sum(uw), tf[win], tau, sig_q,
                                 sig_s, theta, radius, d_s, ops)
                own = (..., slice(R0 - r0, R1 - r0), slice(C0 - c0, C1 - c0))
                for dst, src in zip(planes, res[:4]):
                    dst[..., R0:R1, C0:C1] = src[own]

    def k_of(a):
        x, qx, qy, sv = a
        return ((rows.dx(x), rows.dy(x), label_sum(x)),
                rows.dxt(qx) + rows.dyt(qy) + sv)

    (g_prev, ktyp), (g_new, kty2) = k_of(prev), k_of(planes)
    res = _residuals(tau_raw, sigma_raw, theta, prev, planes, g_prev, g_new,
                     ktyp, kty2)
    norms = torch.stack(_norm_sums(res, rows.nsum))
    conv = entry_converged(scal, n_scal)
    new_q = torch.cat([planes[1], planes[2]])
    prev_q = torch.cat([prev[1], prev[2]])
    out = (torch.where(conv, u, planes[0]), torch.where(conv, q, new_q),
           torch.where(conv, s, planes[3]), torch.where(conv, u, prev[0]),
           torch.where(conv, q, prev_q), torch.where(conv, s, prev[3]),
           torch.where(conv, torch.zeros_like(norms), norms))
    if not partials:
        return out
    pd_x, pd_y, pd_s, zh_x, zh_y, zh_s, dd, wh = res
    terms = (label_sum(pd_x * pd_x + pd_y * pd_y) + pd_s * pd_s,
             label_sum(zh_x * zh_x + zh_y * zh_y) + zh_s * zh_s,
             label_sum(dd * dd), label_sum(wh * wh))
    if nx_global is not None:
        li = torch.arange(nx, device=u.device)[:, None]
        owned = (li >= int(scal[6])) & (li < int(scal[7]))
        terms = tuple(torch.where(owned, t, 0.0) for t in terms)
    return out + (tile_partials(terms),)


def ml_multichunk_tiled_plain(u, q, s, f, scal, count: int, k_chunks: int,
                              stepsize: str, consts, tile=(32, 32),
                              halo=None):
    """The tiled multichunk (``ml_multichunk_`` with ``path="tiled"``):
    ``multichunk_plain``'s loop over ``ml_chunk_tiled_plain``, the
    gradient and the label sum recomputed from u at each chunk (bit-equal
    to the carried ones).  Returns ``ml_multichunk_plain``'s outputs."""
    L = u.shape[0]
    theta, radius, d_s = scal[2], scal[3], scal[4]

    def chunk(tau, sigma, p):
        s5 = torch.stack([tau, sigma, theta, radius, d_s])
        u2, q2, s2, up, qp, sp, n2 = ml_chunk_tiled_plain(
            p[0], torch.cat([p[1], p[2]]), p[3], f, s5, count, tile=tile,
            halo=halo)
        return (u2, q2[:L], q2[L:], s2, up, qp[:L], qp[L:], sp), n2

    qx, qy = q[:L], q[L:]
    planes, norms, sout = multichunk_plain(
        chunk, (u, qx, qy, s, u, qx, qy, s), scal, count, k_chunks, stepsize,
        consts)
    u2, qx2, qy2, s2, up, qxp, qyp, sp = planes
    return (u2, torch.cat([qx2, qy2]), s2, up, torch.cat([qxp, qyp]), sp,
            norms, sout)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(u, q, s, f, scal, n_scal: int, count: int,
           batched: bool = False):
    if int(count) < 1:
        raise ProstError("A chunk needs count >= 1.")
    lead = u.shape[:1] if batched else ()
    k = len(lead)
    if u.dim() != 3 + k or u.shape[k] < 1 or min(u.shape[k + 1:]) < 2:
        what = "a (B, L, nx, ny)" if batched else "an (L, nx, ny)"
        raise ProstError(f"u must be {what} stack, got {tuple(u.shape)}.")
    L, nx, ny = u.shape[k:]
    check_buffers("multilabel", (("u", u, (*lead, L, nx, ny)),
                                 ("q", q, (*lead, 2 * L, nx, ny)),
                                 ("s", s, (*lead, nx, ny)),
                                 ("f", f, (*lead, L, nx, ny))),
                  scal, n_scal, lead[0] if batched else None)


def _lib():
    """The fused multilabel kernel library, built from
    csrc/fused_multilabel.cu on first use."""
    head = [VP] * 13 + [CI] * 3 + [CF] * 2
    strides = [ctypes.c_longlong] * 3
    return typed_lib("fused_multilabel", "prost_ml_num_blocks", {
        "prost_ml_chunk": head + [CI, VP],
        "prost_ml_chunk_batched": head + strides + [CI, CI, VP],
        "prost_ml_chunk_halo": head + [CI, CI, VP],
        "prost_ml_chunk_resident": [VP] * 10 + [CI] * 3 + [CF] * 2
                                   + [CI, CI, VP],
        "prost_ml_chunk_batched_resident": [VP] * 10 + [CI] * 3 + [CF] * 2
                                           + strides + [CI, CI, VP],
        "prost_ml_resident_smem": [CI, CI],
        "prost_ml_multichunk": head + [CI] * 3 + [CF] * 6 + [VP],
        "prost_ml_multichunk_resident": [VP] * 10 + [CI] * 3 + [CF] * 2
                                        + [CI] * 3 + [CF] * 6 + [VP],
        "prost_ml_chunk_tiled": [VP] * 10 + [CI] * 3 + [CF] * 2
                                + [CI] * 3 + [VP],
        "prost_ml_chunk_halo_tiled": [VP] * 10 + [CI] * 3 + [CF] * 2
                                     + [CI] * 4 + [VP],
        "prost_ml_multichunk_tiled": [VP] * 10 + [CI] * 3 + [CF] * 2
                                     + [CI] * 3 + [CF] * 6 + [CI] * 2
                                     + [VP],
        "prost_ml_tiled_smem": []})


# labels a grid-resident block holds a pixel's components of in registers
# (csrc/fused_multilabel.cu MAX_REG_L)
MAX_RESIDENT_L = 8


def resident_bytes(L: int, nx: int, ny: int, sms: int,
                   multi: bool = False) -> int:
    """The dynamic shared memory of one block of the grid-resident chunk
    on ``nx`` rows (the whole plane's, or a halo band's) over ``sms``
    blocks: csrc/fused_multilabel.cu's MLRes for the largest band
    (ml_resident_floats: u with a row below, q_x with a row above, q_y,
    the carried gradient and f, L planes each; s and su), at least the
    reductions' array; with ``multi`` the multichunk's, which adds w_hat's
    window (f is read again in the next chunk), at least the reductions'
    array that borrows it."""
    rmax = resident_rows(nx, sms)
    floats = (2 * L * (rmax + 1) + 4 * L * rmax + 2 * rmax) * int(ny)
    if multi:
        floats += max(L * rmax * int(ny), RES_RED_BYTES // 4)
    return max(4 * floats, RES_RED_BYTES)


def resident_ok(L: int, nx: int, ny: int, sms: int, smem: int,
                multi: bool = False) -> bool:
    """The shape rule of ``ml_chunk_``, ``ml_chunk_halo_`` and
    ``ml_chunk_batched_``, and with ``multi`` of ``ml_multichunk_``: a
    chunk (multichunk) of L labels on ``nx`` rows runs as one grid-resident
    launch (csrc/fused_multilabel.cu ml_resident, ml_multichunk_resident,
    one block per SM) where L is at most ``MAX_RESIDENT_L`` and the planes
    of its largest band fit in ``smem`` bytes of a block's dynamic shared
    memory on a card of ``sms`` SMs, and as the streaming launch sequence
    otherwise."""
    return (1 <= int(L) <= MAX_RESIDENT_L
            and resident_bytes(L, nx, ny, sms, multi) <= int(smem))


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
        smem = lib.prost_ml_resident_smem(int(L), 2 if multi
                                          else int(bool(batched)))
    if smem < 0:
        raise ProstError(f"ml_chunk: no shared-memory limit for the "
                         f"resident chunk on {device} (CUDA error {-smem}).")
    return card_sms(device), smem


# bytes of the tiled launch's norm pass's reductions (two 32x8 tiles at a
# time: csrc/fused_multilabel.cu MT_RED)
_TILED_RED_BYTES = 4 * 2 * 4 * 256


def ml_tiled_bytes(tx: int, ty: int, L: int) -> int:
    """The dynamic shared memory of one block of the tiled launch
    (csrc/fused_multilabel.cu ml_tiled_smem): 4L + 1 planes (u, q_x, q_y,
    f, then the new u in f's place, and s) of the window of a ``tx`` x
    ``ty`` tile with ``ml_tiled_halo`` pixel on every side, at least the
    norm pass's reductions."""
    h = ml_tiled_halo()
    return max(4 * (4 * int(L) + 1) * (int(tx) + 2 * h) * (int(ty) + 2 * h),
               _TILED_RED_BYTES)


@functools.lru_cache(maxsize=None)
def ml_tiled_tile(nx: int, ny: int, L: int, sms: int, smem: int):
    """The owned tile (rows, columns) of the tiled launch on (L, nx, ny)
    planes on a card of ``sms`` SMs whose blocks may hold ``smem`` bytes of
    dynamic shared memory: of the tiles (rows a multiple of 8, columns of
    32, so every 32x8 norm tile lies in one) whose window fits
    (``ml_tiled_bytes``), the one whose iteration moves the fewest window
    pixels through the SMs (the rounds of one block per SM times a whole
    tile's window), the larger tile on a tie (``fused_rof.tiled_tile``'s
    rule); None where no tile's window fits."""
    from .fused_rof import window_tile

    return window_tile(nx, ny, 2 * ml_tiled_halo(), sms,
                       lambda tx, ty: ml_tiled_bytes(tx, ty, L) <= smem)


def ml_tiled_ok(L: int, nx: int, ny: int, sms: int, smem: int) -> bool:
    """Whether the tiled launch takes (L, nx, ny) planes: 1 to
    ``MAX_RESIDENT_L`` labels (a pixel's 2L dual components in registers)
    and some tile's window fits in ``smem`` bytes."""
    return (1 <= int(L) <= MAX_RESIDENT_L
            and ml_tiled_tile(int(nx), int(ny), int(L), int(sms),
                              int(smem)) is not None)


def ml_route_of(L: int, nx: int, ny: int, sms: int, smem: int,
                tiled_smem: int, multi: bool = False) -> str:
    """The shape rule of ``ml_chunk_``, ``ml_chunk_halo_`` (on the band's
    rows) and, with ``multi``, ``ml_multichunk_`` on a card of ``sms`` SMs
    whose grid-resident blocks may hold ``smem`` bytes and tiled blocks
    ``tiled_smem``: "resident" where the planes fit in the grid-resident
    launch (``resident_ok``: 256x256x8 on an H100), else "tiled" where a
    tile's window fits (``ml_tiled_ok``: 512x512x8), else "streaming"
    (beyond 8 labels)."""
    if resident_ok(L, nx, ny, sms, smem, multi):
        return "resident"
    if ml_tiled_ok(L, nx, ny, sms, tiled_smem):
        return "tiled"
    return "streaming"


@functools.lru_cache(maxsize=None)
def ml_tiled_limit(device) -> int:
    """The dynamic shared memory a block of the tiled launch may hold on
    the card ``device``, read once."""
    with torch.cuda.device(device):
        smem = _lib().prost_ml_tiled_smem()
    if smem < 0:
        raise ProstError(f"ml_chunk: no shared-memory limit for the tiled "
                         f"chunk on {device} (CUDA error {-smem}).")
    return smem


def ml_pick_route(path, L: int, nx: int, ny: int, device, multi: bool,
                  what: str) -> tuple:
    """(path, tile) of a single-instance chunk (with ``multi``, of the
    multichunk) on the card ``device``: by ``ml_route_of`` where ``path``
    is None, else the one asked for; "resident" where the planes do not
    fit, or "tiled" where no tile's window does, raises ``ProstError``.
    ``tile`` is the tiled launch's (rows, columns), else None."""
    check_path(path, what)
    sms, smem = card_limits(device, L, multi=multi)
    tsmem = ml_tiled_limit(device) if 1 <= int(L) <= MAX_RESIDENT_L else 0
    if path is None:
        path = ml_route_of(L, nx, ny, sms, smem, tsmem, multi)
    if path == "resident" and not resident_ok(L, nx, ny, sms, smem, multi):
        raise ProstError(f"{what}: the chunk's planes do not fit in the "
                         "shared memory of one block per SM.")
    tile = None
    if path == "tiled":
        if not ml_tiled_ok(L, nx, ny, sms, tsmem):
            raise ProstError(f"{what}: the tiled launch takes 1 to "
                             f"{MAX_RESIDENT_L} labels and a tile's window "
                             "in the shared memory of a block.")
        tile = ml_tiled_tile(int(nx), int(ny), int(L), int(sms), int(tsmem))
    return path, tile


def _scratch(path: str, L, nx, ny, device, batch: int = 0):
    """A chunk launch's scratch on ``path``: the grid-resident chunk's norm
    terms (4 planes, which a batched launch's instances share), the tiled
    launch's second slot of the state (u, q and s: 3L + 1 planes), or the
    streaming sequence's carried planes (the gradient and the label sum,
    of this iterate and of the previous one; with ``batch``, of every
    instance)."""
    lead = (batch,) if batch else ()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    if path == "resident":
        return [empty(4, nx, ny)]
    if path == "tiled":
        return [empty((3 * L + 1) * nx * ny)]
    return [empty(*lead, 2 * L, nx, ny), empty(*lead, 2 * L, nx, ny),
            empty(*lead, nx, ny), empty(*lead, nx, ny)]


def _launch_chunk(what: str, state, prev, f, sc, partial, scratch,
                  route: tuple, count: int, nx_global=None):
    """One chunk on the card in place on ``state`` (u, q, s) and ``prev``:
    the grid-resident launch, the tiled launch or the streaming sequence
    (``route`` = (path, tile) of ``ml_pick_route``), of the whole plane or
    (with ``nx_global``) of a halo band, counted under ``what`` (and a
    tiled call also under ``what`` + "_tiled")."""
    u = state[0]
    L, nx, ny = u.shape
    # 1/L and sqrt(1/L) rounded once from double, as the plain version
    # rounds its Python constants
    shape = (L, nx, ny, 1.0 / L, (1.0 / L) ** 0.5)
    lib = _lib()
    path, tile = route
    if path == "resident":
        launch(lib, "prost_ml_chunk_resident", what, launch_counts,
               u.device, [*state, *prev, f, sc, partial, *scratch], *shape,
               int(nx_global or 0), int(count))
    elif path == "tiled":
        fn, tail = (("prost_ml_chunk_tiled", ()) if nx_global is None else
                    ("prost_ml_chunk_halo_tiled", (int(nx_global),)))
        launch(lib, fn, what, launch_counts, u.device,
               [*state, *prev, f, sc, partial, *scratch], *shape, *tail,
               int(count), *tile)
        launch_counts[what + "_tiled"] += 1
    else:
        fn, tail = (("prost_ml_chunk", ()) if nx_global is None else
                    ("prost_ml_chunk_halo", (int(nx_global),)))
        launch(lib, fn, what, launch_counts, u.device,
               [*state, *prev, *scratch, f, sc, partial], *shape, *tail,
               int(count))


def _inplace(what: str, state, prev, f, scal, n_scal: int, count: int,
             nx_global, path):
    """One chunk on the card in place, its buffers made for this call;
    returns norms2."""
    u = state[0]
    L, nx, ny = u.shape
    dev = u.device
    route = ml_pick_route(path, L, nx, ny, dev, False, what)
    sc = scalar_buffer(scal, n_scal, S_CONV, S_LEN)
    partial = torch.empty(4 * _lib().prost_ml_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_chunk(what, state, prev, f.contiguous(), sc, partial,
                  _scratch(route[0], L, nx, ny, dev), route, count,
                  nx_global)
    return sc[S_NORM:S_NORM + 4]


def ml_chunk(u, q, s, f, scal, count: int):
    """``count`` fused iterations ending on a residual iteration.

    u, f: (L, nx, ny); q: (2L, nx, ny); s: (nx, ny); scal: [tau, sigma,
    theta, radius, d_s] (+ an optional converged flag: when set, nothing
    runs and the inputs come back).  Returns (u2, q2, s2, u_prev, q_prev,
    s_prev, norms2), norms2 the 4 SQUARED preconditioned residual norms, on
    the inputs' device.  CPU tensors run the plain version; CUDA tensors
    run ``ml_chunk_`` on copies."""
    _check(u, q, s, f, scal, 5, count)
    if u.device.type == "cpu":
        return ml_chunk_plain(u, q, s, f, scal, count)
    return halo_copy(ml_chunk_, (u, q, s), f, scal, count)


def ml_chunk_(u, q, s, u_prev, q_prev, s_prev, f, scal, count: int,
              path=None):
    """``ml_chunk`` in place: (u, q, s) advance by ``count`` iterations and
    the previous buffers take the iterate before the aligned one; with the
    converged flag set nothing changes.  Returns norms2.  On a card
    ``path`` None takes the shape rule's path (``ml_route_of``): one
    grid-resident launch (csrc/fused_multilabel.cu ml_resident) where the
    planes fit on chip, else one tiled cooperative launch (ml_tiled:
    overlapping 2-D windows, a grid barrier an iteration) and the finish
    where a tile's window does, else the streaming launch sequence;
    "resident", "tiled" or "streaming" asks for one ("resident" and
    "tiled" raise where they cannot launch).  On the CPU every path runs
    the plain version."""
    state, prev = (u, q, s), (u_prev, q_prev, s_prev)
    _check(u, q, s, f, scal, 5, count)
    check_path(path, "ml_chunk_")
    check_inplace(state, prev)
    if u.device.type == "cpu":
        return halo_into(state, prev, ml_chunk_plain(u, q, s, f, scal, count),
                         scal, 5)
    return _inplace("ml_chunk", state, prev, f, scal, 5, count, None, path)


def ml_chunk_halo(u, q, s, f, scal, count: int, nx_global: int):
    """``ml_chunk`` on one halo-extended shard of a row-partitioned plane
    of ``nx_global`` rows.

    u, f: (L, nxb, ny); q: (2L, nxb, ny); s: (nxb, ny), the shard's rows in
    the middle and its neighbours' halo rows (zeros beyond the plane) above
    and below; scal: [tau, sigma, theta, radius, d_s, row_offset, own_lo,
    own_hi] (+ an optional converged flag), row_offset the global row of
    local row 0 and [own_lo, own_hi) the owned local rows.  Returns the
    tuple of ``ml_chunk``, norms2 over the owned rows only.  CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    return halo_copy(ml_chunk_halo_, (u, q, s), f, scal, count, nx_global)


def ml_chunk_halo_(u, q, s, u_prev, q_prev, s_prev, f, scal, count: int,
                   nx_global: int, path=None):
    """``ml_chunk_halo`` in place, on the sharded route's persistent
    buffers: (u, q, s) advance by ``count`` iterations and the previous
    buffers take the iterate before the aligned one; with the converged
    flag set nothing changes.  Returns norms2.  ``path`` as for
    ``ml_chunk_``, the shape rule on the band's rows."""
    _check(u, q, s, f, scal, N_HALO_SCAL, count)
    check_path(path, "ml_chunk_halo_")
    check_halo(nx_global, (u, q, s), (u_prev, q_prev, s_prev))
    if u.device.type == "cpu":
        return halo_into((u, q, s), (u_prev, q_prev, s_prev),
                         ml_chunk_halo_plain(u, q, s, f, scal, count,
                                             nx_global), scal)
    return _inplace("ml_chunk_halo", (u, q, s), (u_prev, q_prev, s_prev), f,
                    scal, N_HALO_SCAL, count, int(nx_global), path)


class MLChunk(LightChunk):
    """The multilabel routes' light chunk call: ``ml_chunk_`` (with
    ``band`` = (nx_global, rows, row_offset, own_lo, own_hi),
    ``ml_chunk_halo_`` on a band of ``rows`` rows) on the planes a route
    holds, with what depends only on the shapes made once per route: the
    path (``route``: ``ml_pick_route``'s (path, tile), by the shape rule
    unless ``path`` asks for one), the scratch, the norm partials and the
    scalar buffer with ``m``'s radius and d_s (and the band's row context).
    A call writes the step sizes and the flag into the scalar buffer and
    launches; on the CPU it runs the plain version."""

    def __init__(self, m, count: int, device, band=None, path=None):
        consts = (m["radius"], m["d_s"]) + tuple(band[2:] if band else ())
        super().__init__(consts, device)
        self.count, self.band = int(count), band
        L, nx, ny = m["L"], m["nx"], m["ny"]
        if band is not None:
            nx = int(band[1])
        self.what = "ml_chunk" if band is None else "ml_chunk_halo"
        self.nx_global = None if band is None else int(band[0])
        self.route = None  # (path, tile) on a card
        if torch.device(device).type == "cuda":
            self.route = ml_pick_route(path, L, nx, ny, device, False,
                                       self.what)
            self.partial = torch.empty(4 * _lib().prost_ml_num_blocks(nx, ny),
                                       dtype=torch.float32, device=device)
            self.scratch = _scratch(self.route[0], L, nx, ny, device)

    @property
    def resident(self):
        """Whether the call runs grid-resident on a card; None on the
        CPU."""
        return None if self.route is None else self.route[0] == "resident"

    def __call__(self, state, prev, f, tau, sigma, theta, converged):
        """``count`` iterations on ``state`` (u, q, s) in place, the
        previous iterate into ``prev``; returns norms2."""
        self.scalars_(tau, sigma, theta, converged)
        if self.route is None:
            scal = self.scal()
            if self.band is None:
                out = ml_chunk_plain(*state, f, scal, self.count)
            else:
                out = ml_chunk_halo_plain(*state, f, scal, self.count,
                                          self.nx_global)
            return halo_into(state, prev, out, scal, self.n_scal)
        _launch_chunk(self.what, state, prev, f, self.sc, self.partial,
                      self.scratch, self.route, self.count, self.nx_global)
        return self.norms2()


def ml_chunk_batched(u, q, s, f, scal, count: int):
    """``ml_chunk`` for each of B instances in one launch (sequence).

    u, f: (B, L, nx, ny); q: (B, 2L, nx, ny); s: (B, nx, ny); scal: (5, B),
    a row each of tau, sigma, theta, radius and d_s (+ an optional row of
    converged flags: an instance whose flag is set runs nothing and gets
    its inputs back).  Returns (u2, q2, s2, u_prev, q_prev, s_prev, norms2),
    norms2 (4, B) the SQUARED preconditioned residual norms of each
    instance.  Instance b comes out as ``ml_chunk`` on instance b alone.
    CPU tensors run the plain version; CUDA tensors run
    ``ml_chunk_batched_`` on copies."""
    _check(u, q, s, f, scal, 5, count, batched=True)
    if u.device.type == "cpu":
        return ml_chunk_batched_plain(u, q, s, f, scal, count)
    return halo_copy(ml_chunk_batched_, (u, q, s), f, scal, count)


def _launch_batched(state, prev, f, sc, partial, scratch, resident: bool,
                    count: int, strides):
    """One batched chunk on the card in place on ``state`` (u, q, s) and
    ``prev``: the grid-resident launch (the instances one after another) or
    the streaming sequence (all at once), counted under
    ``ml_chunk_batched``."""
    u = state[0]
    B, L, nx, ny = u.shape
    shape = (L, nx, ny, 1.0 / L, (1.0 / L) ** 0.5, *strides)
    lib = _lib()
    if resident:
        launch(lib, "prost_ml_chunk_batched_resident", "ml_chunk_batched",
               launch_counts, u.device, [*state, *prev, f, sc, partial,
                                         *scratch], *shape, int(count), B)
    else:
        launch(lib, "prost_ml_chunk_batched", "ml_chunk_batched",
               launch_counts, u.device, [*state, *prev, *scratch, f, sc,
                                         partial], *shape, int(count), B)


def ml_chunk_batched_(u, q, s, u_prev, q_prev, s_prev, f, scal, count: int,
                      path=None):
    """``ml_chunk_batched`` in place: every instance of (u, q, s) advances
    by ``count`` iterations and the previous buffers take its iterate
    before the aligned one; an instance whose flag is set changes nothing.
    q and s may be views of a route's flat y (see ``instance_strides``).
    Returns norms2 (4, B).  On a card ``path`` None takes the shape rule's
    path (``resident_ok`` on one instance, whatever B): one grid-resident
    launch (csrc/fused_multilabel.cu ml_resident_batched, the instances one
    after another) where one instance's planes fit on chip, else the
    streaming launch sequence; "resident" or "streaming" asks for one
    ("resident" raises where it does not fit)."""
    state, prev = (u, q, s), (u_prev, q_prev, s_prev)
    _check(u, q, s, f, scal, 5, count, batched=True)
    strides = instance_strides(state, prev, "ml_chunk_batched_")
    if u.device.type == "cpu":
        return halo_into(state, prev,
                         ml_chunk_batched_plain(u, q, s, f, scal, count),
                         scal, 5)
    B, L, nx, ny = u.shape
    dev = u.device
    resident = pick_path(path, resident_ok(
        L, nx, ny, *card_limits(dev, L, True)), "ml_chunk_batched")
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = torch.empty(4 * B * _lib().prost_ml_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_batched(state, prev, f.contiguous(), sc, partial,
                    _scratch("resident" if resident else "streaming", L, nx,
                             ny, dev, B), resident, count, strides)
    return sc[:, S_NORM:S_NORM + 4].T


class MLBatchedChunk(LightChunk):
    """``BatchedPDHG``'s light call of the batched multilabel chunk:
    ``ml_chunk_batched_`` on the views of the run's own flat x, y, x_prev
    and y_prev, with what depends only on the shapes made once per route:
    the path (``resident_ok`` on one instance), the scratch, the norm
    partials and the scalar buffer with every instance's radius and d_s.
    A call writes the step sizes and the flags into the scalar buffer and
    launches; on the CPU it runs the plain version."""

    def __init__(self, m, batch: int, count: int, device):
        super().__init__((m["radius"], m["d_s"]), device, batch)
        self.count = int(count)
        B, L, nx, ny = int(batch), m["L"], m["nx"], m["ny"]
        self.resident = None  # the path on a card
        if torch.device(device).type == "cuda":
            self.resident = resident_ok(L, nx, ny,
                                        *card_limits(device, L, True))
            self.partial = torch.empty(
                4 * B * _lib().prost_ml_num_blocks(nx, ny),
                dtype=torch.float32, device=device)
            self.scratch = _scratch(
                "resident" if self.resident else "streaming", L, nx, ny,
                device, B)

    def __call__(self, state, prev, f, tau, sigma, theta, converged):
        """``count`` iterations of every instance of ``state`` (u, q, s)
        in place, the previous iterate into ``prev``; ``converged`` sets
        every instance's flag; returns norms2 (4, B)."""
        self.scalars_(tau, sigma, theta, converged)
        if self.resident is None:
            scal = self.scal()
            out = ml_chunk_batched_plain(*state, f, scal, self.count)
            return halo_into(state, prev, out, scal, self.n_scal)
        _launch_batched(state, prev, f, self.sc, self.partial, self.scratch,
                        self.resident, self.count,
                        instance_strides(state, prev, "ml_chunk_batched_"))
        return self.norms2()


def ml_multichunk(u, q, s, f, scal, count: int, k_chunks: int,
                  stepsize: str, consts):
    """Up to ``k_chunks * count`` fused iterations with the adaptation and
    the stopping test on the device between chunks.

    ``scal`` holds 13 scalars: [tau, sigma, theta, radius, d_s, arg_alpha,
    arb_l, arb_u, it0, tol_rel_p, tol_rel_d, tol_abs_p, tol_abs_d] (+ an
    optional converged-at-entry flag).  Returns (u2, q2, s2, u_prev,
    q_prev, s_prev, norms, sout): norms the last executed chunk's sqrt'd
    residual norms, sout = [tau, sigma, arg_alpha, arb_l, arb_u,
    converged, chunks_done].  CPU tensors run the plain version; CUDA
    tensors run ``ml_multichunk_`` on copies (the shape rule's path)."""
    _check(u, q, s, f, scal, 13, count)
    if stepsize not in STEPSIZES:
        raise ProstError(f"No fused adaptation for stepsize '{stepsize}'.")
    if u.device.type == "cpu":
        return ml_multichunk_plain(u, q, s, f, scal, count, k_chunks,
                                   stepsize, consts)
    *planes, (norms, sout) = halo_copy(ml_multichunk_, (u, q, s), f, scal,
                                       count, k_chunks, stepsize, consts)
    return (*planes, norms, sout)


def _launch_multichunk(state, prev, f, sc, partial, scratch, route: tuple,
                       count: int, k_chunks: int, stepsize: str,
                       consts) -> None:
    """One multichunk on the card in place on ``state`` (u, q, s) and
    ``prev``: the grid-resident launch, the tiled launches or the streaming
    sequence (``route`` = (path, tile) of ``ml_pick_route``), counted under
    ``ml_multichunk`` (and a tiled call also under
    ``ml_multichunk_tiled``)."""
    u = state[0]
    L, nx, ny = u.shape
    path, tile = route
    if path == "streaming":
        fn, bufs = "prost_ml_multichunk", [*state, *prev, *scratch, f, sc,
                                           partial]
    else:
        fn = "prost_ml_multichunk_" + path
        bufs = [*state, *prev, f, sc, partial, *scratch]
    # 1/L and sqrt(1/L) rounded once from double, as the plain version
    # rounds its Python constants
    launch(_lib(), fn, "ml_multichunk", launch_counts, u.device, bufs, L, nx,
           ny, 1.0 / L, (1.0 / L) ** 0.5, int(count), int(k_chunks),
           STEPSIZES[stepsize], *[float(c) for c in consts],
           *(tile or ()))
    if path == "tiled":
        launch_counts["ml_multichunk_tiled"] += 1


def ml_multichunk_(u, q, s, u_prev, q_prev, s_prev, f, scal, count: int,
                   k_chunks: int, stepsize: str, consts, path=None):
    """``ml_multichunk`` in place: (u, q, s) advance by up to ``k_chunks``
    chunks and the previous buffers take the iterate before the last
    executed chunk's aligned iteration; with the converged flag set at
    entry nothing changes.  Returns (norms, sout).  On a card ``path``
    None takes the shape rule's path (``ml_route_of(..., multi=True)``):
    one grid-resident launch for all the chunks (csrc/fused_multilabel.cu
    ml_multichunk_resident) where the planes fit on chip, else a tiled
    launch (ml_tiled) and the finish's adaptation a chunk, (u, q, s) and
    the scratch taking turns, where a tile's window fits, else the
    streaming launch sequence; "resident", "tiled" or "streaming" asks for
    one ("resident" and "tiled" raise where they cannot launch)."""
    _check(u, q, s, f, scal, 13, count)
    if stepsize not in STEPSIZES:
        raise ProstError(f"No fused adaptation for stepsize '{stepsize}'.")
    state, prev = (u, q, s), (u_prev, q_prev, s_prev)
    check_inplace(state, prev)
    check_path(path, "ml_multichunk")
    if u.device.type == "cpu":
        out = ml_multichunk_plain(u, q, s, f, scal, count, k_chunks,
                                  stepsize, consts)
        return halo_into(state, prev, out[:7], scal, 13), out[7]
    L, nx, ny = u.shape
    dev = u.device
    route = ml_pick_route(path, L, nx, ny, dev, True, "ml_multichunk")
    sc = scalar_buffer(scal, 13, S_CONV, S_LEN)
    partial = torch.empty(4 * _lib().prost_ml_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_multichunk(state, prev, f.contiguous(), sc, partial,
                       _scratch(route[0], L, nx, ny, dev), route, count,
                       k_chunks, stepsize, consts)
    return sc[S_NORM:S_NORM + 4], torch.stack([sc[i] for i in SOUT])


class MLMultichunk(LightMultichunk):
    """The multilabel route's light call of the multichunk:
    ``ml_multichunk_`` on the views (u, q, s) of the run's own x, y, x_prev
    and y_prev, its path ``ml_route_of(..., multi=True)`` unless ``path``
    asks for one (``route``: (path, tile)); ``resident`` whether that path
    is the grid-resident launch.  The family's scalars are radius and d_s,
    its one data plane f, and it has no data term."""

    _consts = ("radius_t", "d_s_t")
    _data = ("f",)
    _dataterm = False
    _inplace = staticmethod(ml_multichunk_)
    route = None  # (path, tile) on a card

    def __init__(self, m, count: int, k_chunks: int, stepsize: str, device,
                 path=None):
        self.path = path
        super().__init__(m, count, k_chunks, stepsize, device)

    def _card(self, device):
        m = self.m
        L, nx, ny = m["L"], m["nx"], m["ny"]
        self.route = ml_pick_route(self.path, L, nx, ny, device, True,
                                   "ml_multichunk")
        partial = torch.empty(4 * _lib().prost_ml_num_blocks(nx, ny),
                              dtype=torch.float32, device=device)
        return (self.route[0] == "resident", partial,
                _scratch(self.route[0], L, nx, ny, device))

    def _launch(self, state, prev, f, sc, partial, scratch, resident, *args):
        _launch_multichunk(state, prev, f, sc, partial, scratch, self.route,
                           *args)


# ---------------------------------------------------------------------------
# structure matching and the route
# ---------------------------------------------------------------------------

def _allclose(t, v) -> bool:
    return bool(torch.allclose(t, torch.full_like(t, v)))


def match_multilabel_structure(problem):
    """Detect the fusable fast-multilabel structure; returns dict(nx, ny,
    L, f, radius, d_s) or None.  Conditions (the model of
    examples/example_multilabel_fast.py):

    * linop = [BlockGradient2D(L, label_first=False) at (0, 0);
               kron(ones(1, L), I_n) at (2nL, 0)]
    * prox_g = one ProxElem1D ind_geq0 with a=1, b=0, c scalar > 0, d the
      unary costs (vector or scalar), e=0;
    * prox_fstar = ProxElemNorm2(dim=2L, planar, ind_leq0, scalar a, b;
      d=e=0) over the gradient rows (per-pixel radius-(b/a) ball) and one
      ProxElem1D zero (linear shift d_s) over the multiplier rows;
    * alpha preconditioner: Sigma = [1/2; 1/L], Tau = 1/5.

    The fused route is float32 only."""
    if config_dtype() != torch.float32:
        return None
    linop = problem.linop
    if not isinstance(linop, LinearOperator) or len(linop.blocks) != 2:
        return None
    grad = next((b for b in linop.blocks
                 if isinstance(b, BlockGradient2D)), None)
    kron = next((b for b in linop.blocks if isinstance(b, BlockKronId)), None)
    if grad is None or kron is None or grad.label_first or grad.L < 1:
        return None
    L, nx, ny = grad.L, grad.nx, grad.ny
    n = nx * ny
    if grad.row != 0 or grad.col != 0:
        return None
    if kron.row != 2 * n * L or kron.col != 0 or kron.diaglength != n:
        return None
    if tuple(kron.data.shape) != (1, L) or not bool(torch.all(kron.data
                                                              == 1.0)):
        return None

    # --- primal prox: positivity + linear unaries ---------------------------
    if len(problem.prox_g) != 1 or len(problem.prox_fstar) != 2:
        return None
    pg = problem.prox_g[0]
    if not isinstance(pg, ProxElem1D) or pg.fun != "ind_geq0":
        return None
    if pg.index != 0 or pg.size != n * L:
        return None
    a, b, c, d, e, _, _ = pg.coeffs
    if not (isscalar(a) and a == 1.0 and isscalar(b) and b == 0.0):
        return None
    if not (isscalar(c) and c > 0.0) or not (isscalar(e) and e == 0.0):
        return None
    f = coeff_vector(d, n * L, problem.scaling_left.device)
    f = f.reshape(L, nx, ny).contiguous()

    # --- dual proxes: 2L-ball over gradient rows + linear shift on s --------
    ball = shift = None
    for p in problem.prox_fstar:
        if isinstance(p, ProxElemNorm2) and p.index == 0:
            ball = p
        elif isinstance(p, ProxElem1D) and p.index == 2 * n * L:
            shift = p
    if ball is None or shift is None or ball.size != 2 * n * L:
        return None
    radius = leq0_ball_radius(ball, 2 * L)
    if radius is None:
        return None
    if shift.fun != "zero" or shift.size != n:
        return None
    _, _, _, sd, se, _, _ = shift.coeffs
    if not (isscalar(sd) and isscalar(se) and se == 0.0):
        return None

    # constant per-segment alpha preconditioner
    sl, sr = problem.scaling_left, problem.scaling_right
    if not (_allclose(sl[: 2 * n * L], 0.5) and _allclose(sl[2 * n * L:],
                                                          1.0 / L)
            and _allclose(sr, 0.2)):
        return None
    return {"nx": nx, "ny": ny, "L": L, "f": f, "radius": radius,
            "d_s": float(sd)}


def _planes(m, xf, yf):
    """(u, q, s) views of the solver's flat x and y."""
    L, nx, ny = m["L"], m["nx"], m["ny"]
    n2 = 2 * L * nx * ny
    return (xf.reshape(L, nx, ny), yf[:n2].reshape(2 * L, nx, ny),
            yf[n2:].reshape(nx, ny))


def _multi_chunk(b, s: PDHGState) -> PDHGState:
    """One multichunk in place on the views of the run's own x, y, x_prev
    and y_prev (``own_vectors``) through the route's light call
    (``MLMultichunk``, made once per route)."""
    m, ri = b.ml, max(int(b.opts.residual_iter), 1)
    if "multi" not in m:
        m["multi"] = MLMultichunk(m, ri, K_CHUNKS, b.opts.stepsize,
                                  s.x.device)
    norms, sout = m["multi"](
        _planes(m, s.x, s.y), _planes(m, s.x_prev, s.y_prev), s.tau, s.sigma,
        s.theta, s.arg_alpha, s.arb_l, s.arb_u, s.iteration, s.converged)
    return multichunk_state(s, ri, s.x, s.y, s.x_prev, s.y_prev, norms,
                            sout)


def _fused_chunk(b, s: PDHGState) -> PDHGState:
    """One chunk in place on the views of the run's own x, y, x_prev and
    y_prev (``own_vectors``) through the route's light call."""
    m, ri = b.ml, max(int(b.opts.residual_iter), 1)
    if "call" not in m:
        m["call"] = MLChunk(m, ri, s.x.device)
    norms2 = m["call"](_planes(m, s.x, s.y), _planes(m, s.x_prev, s.y_prev),
                       m["f"], s.tau, s.sigma, s.theta, s.converged)
    return chunk_state(b, s, ri, s.x, s.y, s.x_prev, s.y_prev, norms2)


def fused_ml_run(b, state: PDHGState, until: int, start: int) -> PDHGState:
    """``run_pdhg_route`` with the multilabel multichunks and chunks of
    ``FusedROFPDHG`` ``b``; the canonicalization zeroes the dead dual
    coordinates of y and y_prev, on the run's own copies of the state's
    vectors, which the multichunks and chunks update in place."""
    m = b.ml
    canonical = canonical_duals(m["L"], m["nx"], m["ny"])
    return run_pdhg_route(b, state, until, start,
                          lambda s: _fused_chunk(b, s),
                          lambda s: own_vectors(canonical(s)),
                          lambda s: _multi_chunk(b, s))
