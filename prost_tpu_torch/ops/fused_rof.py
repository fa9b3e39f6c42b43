"""Fused PDHG iteration for ROF-structured problems (counterpart of
``prost_tpu/ops/fused_rof.py``, whole-plane route).

Workload: min_u c/2 ||u - f||^2 + ||grad u||_{2,1} (and the TV-L1 ``abs``
and TV-inpainting ``wsquare`` data terms) with the Pock-Chambolle alpha
preconditioner.  For a lone gradient2d operator the preconditioners are
the constants Sigma = 1/2, Tau = 1/4, so a PDHG iteration is pointwise
work plus two stencils, and the mathematical state is just (x, q).

Four kernels carry the ROF routes, each a hand-written CUDA kernel set in
``csrc/fused_rof.cu`` with a plain PyTorch version beside its wrapper here:

* ``rof_chunk`` (JAX ``rof_fused_chunk``): ``count`` iterations ending on a
  residual iteration, with the four squared preconditioned residual norms;
  its in-place form ``rof_chunk_`` serves the route's light call
  ``ROFChunk``, made once per route;
* ``rof_multichunk`` (JAX ``rof_fused_multichunk``): up to ``k_chunks``
  chunks with the boyd/goldstein adaptation and the stopping test on the
  device between chunks; its in-place form ``rof_multichunk_`` serves the
  route's light call ``ROFMultichunk``;
* ``rof_chunk_batched`` (JAX ``rof_fused_chunk_batched``, and its banded
  variant ``rof_fused_chunk_banded_batched`` for large instances): one
  chunk for each of B instances, the batched ensembles' route
  (``parallel/ensemble.py``), by ``batched_route_of``: one cluster launch
  that holds each instance on chip in a thread-block cluster of
  ``cluster_size`` CTAs, or, for instances that no cluster of 8 holds, the
  tiled launch with the instances on the grid's z axis (its in-place form
  ``rof_chunk_batched_`` serves the ensembles' light call
  ``ROFBatchedChunk``), else the streaming launch sequence;
* ``rof_chunk_halo`` (JAX ``rof_fused_chunk_halo``): one chunk on a
  halo-extended shard of a row-partitioned plane, the spatially sharded
  route's (``parallel/spatial_fused.py``); its in-place form
  ``rof_chunk_halo_`` serves ``ROFChunk`` made with the band's rows.

On a card the chunk, its halo mode and the multichunk each run as one
grid-resident cooperative launch (one block per SM holding a band of rows
of every plane in shared memory) where the shape rule (``resident_ok``, on
the card's SMs and the shared memory a block may opt into) finds that the
planes fit, and otherwise tiled (``tiled_ok``: 2048x1536 and larger, and
the halo bands of 2048-wide planes): one launch a chunk over overlapping
2-D windows of the planes, each block holding its tile and a halo of
``count + 1`` rows and columns before it and ``count`` after it in shared
memory, the multichunk as that launch and the on-device finish chunk after
chunk (``route_of``).  The streaming launch sequence (seed, two launches
an iteration, norms, finish) runs only where ``path="streaming"`` asks for
it, or where no tile's window holds a chunk's halo (more than 40
iterations a chunk with wsquare, 47 without).  All three are bit-equal;
``path=`` forces one, and a path that cannot launch raises.
``rof_chunk_tiled_plain``, ``rof_multichunk_tiled_plain`` and
``rof_chunk_batched_tiled_plain`` are the tiled launches' plain twins,
window by window.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel, or raises.  There is no other route and no fallback:
unlike the JAX package, the fused route does not drop to the generic path
when a kernel fails to build or launch, and it is taken on any device (the
JAX package gates it off on the CPU unless ``interpret`` is set).

Layout contract (the JAX package's, at every public function): x viewed
(nx, ny) row-major, y = [gx; gy] stacked planes, q viewed (2, nx, ny).

Dead dual coordinates.  q_x's last row and q_y's last column multiply
structurally zero rows of K.  They are zeroed once per run and at every
chunk entry (``pdhg_chunk.project_dead_dual``); then the maskless adjoint
stencil is exact, and the CUDA kernels can read plain bounds-checked
neighbours.
"""

from __future__ import annotations

import functools

import torch

from ..backend.pdhg import BackendPDHG, PDHGState
from ..config import ProstError, dtype as config_dtype
from ..linop.base import LinearOperator
from ..linop.gradient import BlockGradient2D
from .fused_deblur import fused_deblur_run, match_deblur_structure
from .fused_multilabel import fused_ml_run, match_multilabel_structure
from .fused_tight import fused_tight_run, match_tight_structure
from .fused_vol import fused_vol_run, match_vol_structure
from .pdhg_chunk import (CF, CI, N_HALO_SCAL, RES_RED_BYTES, S_CONV, S_LEN,
                         S_NORM, SOUT, STEPSIZES, VP, WHOLE_PLANE,
                         LightChunk, LightMultichunk, RowOps,
                         ball_scale, canonical_duals, card_sms,
                         check_buffers, check_halo, check_inplace,
                         check_path, chunk_state, dual_ball_radius, dx, dy,
                         entry_converged, halo_copy, halo_into,
                         halo_scal_rows, launch, match_dataterm,
                         multichunk_plain, multichunk_state, own_vectors,
                         pdhg_adapt_consts, resident_rows, run_pdhg_route,
                         scalar_buffer, typed_lib, vmap_plain)
from .phases import K_CHUNKS

_SQRT_S = 0.7071067811865476  # sqrt(Sigma) = sqrt(1/2)
_SQRT_T = 0.5                 # sqrt(Tau)   = sqrt(1/4)

DATATERMS = {"square": 0, "wsquare": 1, "abs": 2}

# The batched chunk's clusters (csrc/fused_rof.cu rof_chunk_cluster): the
# dynamic shared memory one block can opt into on Hopper (227 KB; the
# kernel has no static shared memory), and the portable cluster sizes.
SMEM_BYTES = 232448
CLUSTER_SIZES = (1, 2, 4, 8)

# launches of each kernel wrapper on the card (CPU calls do not count);
# a tiled launch also counts under "rof_chunk_tiled" (a chunk's, whole plane
# or halo band), "rof_multichunk_tiled" or "rof_chunk_batched_tiled"
launch_counts = {"rof_chunk": 0, "rof_multichunk": 0,
                 "rof_chunk_batched": 0, "rof_chunk_halo": 0,
                 "rof_chunk_tiled": 0, "rof_multichunk_tiled": 0,
                 "rof_chunk_batched_tiled": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions of the chunk math
# ---------------------------------------------------------------------------

def _hoist_dataterm(f, w, tau, lmb, dataterm: str):
    """Constant planes/scalars of the primal prox within a chunk: square and
    wsquare share x_new = (arg + dt0) * dt1; abs keeps (f, shrink)."""
    if dataterm == "square":
        return (tau * lmb) * f, 1.0 / (1.0 + tau * lmb)
    if dataterm == "wsquare":
        tw = (tau * lmb) * w
        return tw * f, 1.0 / (1.0 + tw)
    return f, tau * lmb  # abs


def _rof_update(x, qx, qy, gx, gy, dt0, dt1, tau, sig_p, sig_t, radius,
                dataterm: str, rows=WHOLE_PLANE):
    """One preconditioned PDHG update.  tau arrives pre-multiplied by
    Tau = 1/4; sig_p = sigma*Sigma*(1+theta), sig_t = sigma*Sigma*theta;
    (gx, gy) is grad(x) carried from the previous iteration; ``rows`` the
    planes' ``RowOps``.  Returns the new state, the new gradient planes and
    K^T of the old dual."""
    kty = rows.dxt(qx) + rows.dyt(qy)
    arg = x - tau * kty
    if dataterm in ("square", "wsquare"):
        x_new = (arg + dt0) * dt1
    else:  # abs: soft shrink toward f as arg - clamp(arg - f, -t, t)
        d = arg - dt0
        x_new = arg - torch.minimum(torch.maximum(d, -dt1), dt1)
    gx_new = rows.dx(x_new)
    gy_new = rows.dy(x_new)
    ax = qx + sig_p * gx_new - sig_t * gx
    ay = qy + sig_p * gy_new - sig_t * gy
    scale = ball_scale(ax * ax + ay * ay, radius)
    return x_new, ax * scale, ay * scale, gx_new, gy_new, kty


def _chunk_core(tau_raw, sigma_raw, theta, lmb, radius, x0, qx0, qy0, f, w,
                count: int, dataterm: str, g0=None, return_g=False,
                rows=WHOLE_PLANE, terms=False):
    """One residual_iter-sized chunk: ``count - 1`` plain iterations, then
    the aligned iteration with its four preconditioned residual norms
    (squared).  ``g0`` seeds the carried gradient (a previous chunk's
    grad(x2)); ``return_g`` also returns grad(x2); ``rows`` is the planes'
    ``RowOps`` (a halo-extended shard's: owned-row norms; a window's).

    Returns (x2, qx2, qy2, x_prev, qx_prev, qy_prev, (n0, n1, n2, n3)
    [, (gx2, gy2)]); with ``terms``, in place of the norms the six planes
    they sum: pd_x^2, pd_y^2, z_hat_x^2, z_hat_y^2, dd^2, w_hat^2."""
    tau = tau_raw * 0.25       # tau * Tau
    sigma_p = sigma_raw * 0.5  # sigma * Sigma
    sig_p = sigma_p * (1.0 + theta)
    sig_t = sigma_p * theta
    dt0, dt1 = _hoist_dataterm(f, w if dataterm == "wsquare" else None, tau,
                               lmb, dataterm)
    qx, qy = rows.project(qx0, qy0)
    x = x0
    gx, gy = (rows.dx(x0), rows.dy(x0)) if g0 is None else g0
    for _ in range(count - 1):
        x, qx, qy, gx, gy, _ = _rof_update(x, qx, qy, gx, gy, dt0, dt1, tau,
                                           sig_p, sig_t, radius, dataterm,
                                           rows)
    gxp, gyp = gx, gy
    # aligned iteration; (gxp, gyp) is grad(x_prev) carried for free
    x2, qx2, qy2, gx2, gy2, ktyp = _rof_update(
        x, qx, qy, gxp, gyp, dt0, dt1, tau, sig_p, sig_t, radius, dataterm,
        rows)
    kty2 = rows.dxt(qx2) + rows.dyt(qy2)

    inv_s = 1.0 / (sigma_raw * _SQRT_S)
    zh_x = (qx - qx2) * inv_s + _SQRT_S * ((1.0 + theta) * gx2 - theta * gxp)
    zh_y = (qy - qy2) * inv_s + _SQRT_S * ((1.0 + theta) * gy2 - theta * gyp)
    pd_x = zh_x - _SQRT_S * gx2
    pd_y = zh_y - _SQRT_S * gy2
    wh = (x - x2) * (1.0 / (tau_raw * _SQRT_T)) - _SQRT_T * ktyp
    dd = wh + _SQRT_T * kty2

    squares = (pd_x * pd_x, pd_y * pd_y, zh_x * zh_x, zh_y * zh_y, dd * dd,
               wh * wh)
    if terms:
        return x2, qx2, qy2, x, qx, qy, squares
    norms = _norms_of(squares, rows.nsum)
    if return_g:
        return x2, qx2, qy2, x, qx, qy, norms, (gx2, gy2)
    return x2, qx2, qy2, x, qx, qy, norms


def _norms_of(squares, nsum):
    """The four squared norms from ``_chunk_core``'s six term planes."""
    pdx, pdy, zhx, zhy, dd, wh = squares
    return (nsum(pdx) + nsum(pdy), nsum(zhx) + nsum(zhy), nsum(dd),
            nsum(wh))


def rof_chunk_plain(x, q, f, w, scal, count: int, dataterm: str = "square",
                    rows=WHOLE_PLANE, n_scal: int = 5):
    """Plain PyTorch version of ``rof_chunk`` (any device); with
    ``rows`` and ``n_scal`` that of a halo chunk."""
    x2, qx2, qy2, xp, qxp, qyp, norms = _chunk_core(
        scal[0], scal[1], scal[2], scal[3], scal[4], x, q[0], q[1], f, w,
        int(count), dataterm, rows=rows)
    q2, qp = torch.stack([qx2, qy2]), torch.stack([qxp, qyp])
    n2 = torch.stack(norms)
    conv = entry_converged(scal, n_scal)
    return (torch.where(conv, x, x2), torch.where(conv, q, q2),
            torch.where(conv, x, xp), torch.where(conv, q, qp),
            torch.where(conv, torch.zeros_like(n2), n2))


def rof_chunk_halo_plain(x, q, f, w, scal, count: int, nx_global: int,
                         dataterm: str = "square"):
    """Plain PyTorch version of ``rof_chunk_halo`` (any device; reads the
    row context of ``scal`` on the host)."""
    return rof_chunk_plain(x, q, f, w, scal, count, dataterm,
                           halo_scal_rows(scal, nx_global), N_HALO_SCAL)


def rof_chunk_batched_plain(x, q, f, w, scal, count: int,
                            dataterm: str = "square"):
    """Plain PyTorch version of ``rof_chunk_batched`` (any device):
    ``rof_chunk_plain`` vmapped over the instances."""
    return vmap_plain(rof_chunk_plain, (x, q, f, w), scal, int(count),
                      dataterm)


def rof_multichunk_plain(x, q, f, w, scal, count: int, k_chunks: int,
                         dataterm: str, stepsize: str, consts):
    """Plain PyTorch version of ``rof_multichunk`` (any device): every
    chunk is computed and kept only while not converged, where the JAX
    kernel branches around it with ``lax.cond``."""
    theta, lmb, radius = scal[2], scal[3], scal[4]

    def chunk(tau, sigma, p):
        *out, nrm, g2 = _chunk_core(tau, sigma, theta, lmb, radius, p[0],
                                    p[1], p[2], f, w, int(count), dataterm,
                                    g0=p[6:], return_g=True)
        return (*out, *g2), nrm

    planes, norms, sout = multichunk_plain(
        chunk, (x, q[0], q[1], x, q[0], q[1], dx(x), dy(x)), scal, count,
        k_chunks, stepsize, consts)
    x2, qx2, qy2, xp, qxp, qyp = planes[:6]
    return (x2, torch.stack([qx2, qy2]), xp, torch.stack([qxp, qyp]), norms,
            sout)


# ---------------------------------------------------------------------------
# the tiled launches' plain twins, window by window
# ---------------------------------------------------------------------------

def tiled_halo(count: int) -> tuple:
    """The least halo of a tiled chunk of ``count`` iterations, (rows and
    columns before the tile, after it): the primal step reads q one row up
    and one column left, the dual step the new x one row down and one
    column right, so each iteration spoils one more pixel of x and q at a
    window side inside the plane, and the norms' K^T q of the new dual
    reads one row (and column) more before the tile."""
    return int(count) + 1, int(count)


def window_ops(r0: int, c0: int, wh: int, ww: int, nx: int, ny: int,
               row_offset: int = 0, nx_global=None) -> RowOps:
    """``RowOps`` of the window rows [r0, r0 + wh), columns [c0, c0 + ww)
    of an (nx, ny) plane (a halo band of a plane of ``nx_global`` rows
    whose row 0 is global row ``row_offset``): every mask decided by the
    pixel's place in the plane, as ``csrc/fused_rof.cu`` rof_tiled decides
    it, a neighbour outside the window taken as 0; the masked adjoints
    (``dxt_masked``, ``dyt_masked``, for the tight chunk's duals, which
    stay live on the global last row and column) read no plane's last row
    or column."""
    nxg = nx if nx_global is None else int(nx_global)

    def rows(a):
        li = torch.arange(a.shape[-2], device=a.device)
        return li, li + r0, li + r0 + row_offset

    def cols(a):
        lj = torch.arange(a.shape[-1], device=a.device)
        return lj, lj + c0

    def wdx(u):
        li, i, gi = rows(u)
        below = ((li < wh - 1) & (i < nx - 1) & (gi < nxg - 1))[:, None]
        return torch.where(below, torch.roll(u, -1, -2) - u, 0.0)

    def wdxt(p):
        li, i, gi = rows(p)
        above = ((li > 0) & (i > 0) & (gi > 0))[:, None]
        return torch.where(above, torch.roll(p, 1, -2), 0.0) - p

    def wdy(u):
        lj, j = cols(u)
        return torch.where((lj < ww - 1) & (j < ny - 1),
                           torch.roll(u, -1, -1) - u, 0.0)

    def wdyt(p):
        lj, j = cols(p)
        return torch.where((lj > 0) & (j > 0), torch.roll(p, 1, -1), 0.0) - p

    def wdxt_masked(p):
        li, i, gi = rows(p)
        above = ((li > 0) & (i > 0) & (gi > 0))[:, None]
        return (torch.where(above, torch.roll(p, 1, -2), 0.0)
                - torch.where((gi < nxg - 1)[:, None], p, 0.0))

    def wdyt_masked(p):
        lj, j = cols(p)
        return (torch.where((lj > 0) & (j > 0), torch.roll(p, 1, -1), 0.0)
                - torch.where(j < ny - 1, p, 0.0))

    def project(qx, qy):
        _, _, gi = rows(qx)
        _, j = cols(qy)
        return (torch.where((gi == nxg - 1)[:, None], 0.0, qx),
                torch.where(j == ny - 1, 0.0, qy))

    return RowOps(wdx, wdxt, wdxt_masked, project, torch.sum, wdy, wdyt,
                  wdyt_masked)


def tile_partials(terms):
    """The per-32x8-tile sums of the four (nx, ny) term planes ``terms``
    in ``csrc/pdhg_chunk.cuh`` block_partials' tree (zeros beyond the
    plane), numbered as grid_of numbers its blocks: (tiles, 4)."""
    nx, ny = terms[0].shape
    rows, cols = -(-nx // 8) * 8, -(-ny // 32) * 32
    v = torch.zeros((4, rows, cols), dtype=terms[0].dtype,
                    device=terms[0].device)
    for k, t in enumerate(terms):
        v[k, :nx, :ny] = t
    v = v.reshape(4, rows // 8, 8, cols // 32, 32).permute(0, 1, 3, 2, 4)
    s = ((v[..., 0, :] + v[..., 4, :]) + (v[..., 2, :] + v[..., 6, :])) + (
        (v[..., 1, :] + v[..., 5, :]) + (v[..., 3, :] + v[..., 7, :]))
    for o in (16, 8, 4, 2, 1):
        s = s[..., :o] + s[..., o:2 * o]
    return s.reshape(4, -1).T


def finish_sums(partial):
    """The four squared norms from (tiles, 4) partials in pdhg_finish's
    order: thread t of 512 sums tiles t, t + 512, ... in turn, then a tree
    over the threads."""
    n = partial.shape[0]
    acc = torch.zeros((512, 4), dtype=partial.dtype, device=partial.device)
    for base in range(0, n, 512):
        part = partial[base:base + 512]
        acc[:part.shape[0]] = acc[:part.shape[0]] + part
    for s in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        acc = acc[:s] + acc[s:2 * s]
    return acc[0]


def rof_chunk_tiled_plain(x, q, f, w, scal, count: int,
                          dataterm: str = "square", nx_global=None,
                          tile=(64, 64), halo=None, partials=False):
    """The tiled chunk (``rof_chunk_`` with ``path="tiled"``; with
    ``nx_global``, ``rof_chunk_halo_``'s, its row context in ``scal``)
    window by window: ``rof_chunk_plain``'s arithmetic on each tile's
    window (``window_ops``, ``halo`` rows and columns (before, after) the
    tile, ``tiled_halo`` by default), the owned pixels and their norm terms
    stitched into the plane.  Returns ``rof_chunk_plain``'s outputs, the
    norms summed as it sums them; with ``partials``, also the 32x8 tiles'
    partials (``tile_partials``), which the kernel's finish reduces."""
    nx, ny = x.shape
    tx, ty = (int(t) for t in tile)
    lead, trail = tiled_halo(count) if halo is None else halo
    if nx_global is None:
        n_scal, off, nsum = 5, 0, torch.sum
    else:
        n_scal, off = N_HALO_SCAL, int(scal[5])
        nsum = halo_scal_rows(scal, nx_global).nsum
    x2, xp = torch.empty_like(x), torch.empty_like(x)
    q2, qp = torch.empty_like(q), torch.empty_like(q)
    sq = torch.empty((6, nx, ny), dtype=x.dtype, device=x.device)
    for R0 in range(0, nx, tx):
        for C0 in range(0, ny, ty):
            R1, C1 = min(R0 + tx, nx), min(C0 + ty, ny)
            r0, c0 = max(R0 - lead, 0), max(C0 - lead, 0)
            r1, c1 = min(R1 + trail, nx), min(C1 + trail, ny)
            ops = window_ops(r0, c0, r1 - r0, c1 - c0, nx, ny, off,
                             nx_global)
            win = (slice(r0, r1), slice(c0, c1))
            *planes, terms = _chunk_core(
                scal[0], scal[1], scal[2], scal[3], scal[4], x[win],
                q[0][win], q[1][win], f[win], w[win], int(count), dataterm,
                rows=ops, terms=True)
            own = (slice(R0 - r0, R1 - r0), slice(C0 - c0, C1 - c0))
            at = (slice(R0, R1), slice(C0, C1))
            for dst, src in zip((x2, q2[0], q2[1], xp, qp[0], qp[1]),
                                planes):
                dst[at] = src[own]
            for k, t in enumerate(terms):
                sq[k][at] = t[own]
    conv = entry_converged(scal, n_scal)
    norms2 = torch.stack(_norms_of(sq, nsum))
    out = (torch.where(conv, x, x2), torch.where(conv, q, q2),
           torch.where(conv, x, xp), torch.where(conv, q, qp),
           torch.where(conv, torch.zeros_like(norms2), norms2))
    if not partials:
        return out
    li = torch.arange(nx, device=x.device)[:, None]
    if nx_global is not None:
        own_rows = (li >= int(scal[6])) & (li < int(scal[7]))
        sq = torch.where(own_rows, sq, 0.0)
    return (*out, tile_partials((sq[0] + sq[1], sq[2] + sq[3], sq[4],
                                 sq[5])))


def rof_chunk_batched_tiled_plain(x, q, f, w, scal, count: int,
                                  dataterm: str = "square", tile=(64, 64),
                                  halo=None, partials=False):
    """The batched tiled chunk (``rof_chunk_batched_`` with
    ``path="tiled"``) instance by instance: ``rof_chunk_tiled_plain`` on
    instance b with ``scal``'s column b (its flag respected).  Returns
    ``rof_chunk_batched_plain``'s outputs, norms2 (4, B); with
    ``partials``, also each instance's 32x8 tiles' partials (B, tiles, 4),
    those of a flagged instance too (the kernel leaves its own
    untouched)."""
    outs = [rof_chunk_tiled_plain(x[b], q[b], f[b], w[b], scal[:, b], count,
                                  dataterm, tile=tile, halo=halo,
                                  partials=partials)
            for b in range(x.shape[0])]
    planes = [torch.stack(t) for t in zip(*outs)]
    planes[4] = planes[4].T
    return tuple(planes)


def rof_multichunk_tiled_plain(x, q, f, w, scal, count: int, k_chunks: int,
                               dataterm: str, stepsize: str, consts,
                               tile=(64, 64), halo=None):
    """The tiled multichunk (``rof_multichunk_`` with ``path="tiled"``):
    ``multichunk_plain``'s loop over ``rof_chunk_tiled_plain``, the
    gradient recomputed from x at each chunk (bit-equal to the carried
    one).  Returns ``rof_multichunk_plain``'s outputs."""
    theta, lmb, radius = scal[2], scal[3], scal[4]

    def chunk(tau, sigma, p):
        s5 = torch.stack([tau, sigma, theta, lmb, radius])
        x2, q2, xp, qp, n2 = rof_chunk_tiled_plain(
            p[0], torch.stack(p[1:3]), f, w, s5, count, dataterm, tile=tile,
            halo=halo)
        return (x2, q2[0], q2[1], xp, qp[0], qp[1]), n2

    planes, norms, sout = multichunk_plain(
        chunk, (x, q[0], q[1], x, q[0], q[1]), scal, count, k_chunks,
        stepsize, consts)
    x2, qx2, qy2, xp, qxp, qyp = planes
    return (x2, torch.stack([qx2, qy2]), xp, torch.stack([qxp, qyp]), norms,
            sout)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(x, q, f, w, scal, n_scal: int, count: int, dataterm: str,
           batched: bool = False):
    if dataterm not in DATATERMS:
        raise ProstError(f"Unknown ROF data term '{dataterm}'.")
    if int(count) < 1:
        raise ProstError("A chunk needs count >= 1.")
    lead = x.shape[:1] if batched else ()
    if x.dim() != 2 + len(lead) or min(x.shape[len(lead):]) < 2:
        what = "a (B, nx, ny) stack" if batched else "an (nx, ny) plane"
        raise ProstError(f"x must be {what}, got {tuple(x.shape)}.")
    nx, ny = x.shape[len(lead):]
    check_buffers("ROF", (("x", x, (*lead, nx, ny)),
                          ("q", q, (*lead, 2, nx, ny)),
                          ("f", f, (*lead, nx, ny)),
                          ("w", w, (*lead, nx, ny))),
                  scal, n_scal, lead[0] if batched else None)


def cluster_planes(dataterm: str) -> int:
    """Planes a cluster CTA holds in shared memory for its band: x, q_x,
    q_y, the carried gradient (2) and f, and w for wsquare."""
    return 7 if dataterm == "wsquare" else 6


def cluster_band_rows(nx: int, csize: int) -> int:
    """Rows of each CTA's band in a cluster of ``csize``: ceil(nx / csize)
    rounded up to the 8 rows of a norm tile (the last band may be shorter
    or empty)."""
    rows = -(-int(nx) // int(csize))
    return -(-rows // 8) * 8


def cluster_size(nx: int, ny: int, dataterm: str = "square"):
    """The CTAs of the cluster that holds one (nx, ny) instance of
    ``rof_chunk_batched`` on chip: the smallest of ``CLUSTER_SIZES`` whose
    band's planes and two slack rows (the neighbours' q_x row above and x
    row below, copied in from their shared memory) fit in ``SMEM_BYTES``,
    or None where no cluster of 8 holds it and the tiled launch (or the
    streaming sequence) runs instead (``batched_route_of``)."""
    for csize in CLUSTER_SIZES:
        rows = cluster_planes(dataterm) * cluster_band_rows(nx, csize) + 2
        if rows * int(ny) * 4 <= SMEM_BYTES:
            return csize
    return None


def _lib():
    """The fused ROF kernel library, built from csrc/fused_rof.cu on first
    use."""
    return typed_lib("fused_rof", "prost_rof_num_blocks", {
        "prost_rof_chunk": [VP] * 10 + [CI] * 4 + [VP],
        "prost_rof_chunk_batched": [VP] * 10 + [CI] * 5 + [VP],
        "prost_rof_chunk_cluster": [VP] * 10 + [CI] * 6 + [VP],
        "prost_rof_cluster_occupancy": [CI] * 4,
        "prost_rof_chunk_halo": [VP] * 10 + [CI] * 5 + [VP],
        "prost_rof_multichunk": [VP] * 10 + [CI] * 6 + [CF] * 6 + [VP],
        "prost_rof_chunk_resident": [VP] * 9 + [CI] * 4 + [VP],
        "prost_rof_chunk_halo_resident": [VP] * 9 + [CI] * 5 + [VP],
        "prost_rof_multichunk_resident": [VP] * 9 + [CI] * 6 + [CF] * 6
                                         + [VP],
        "prost_rof_resident_smem": [CI],
        "prost_rof_chunk_tiled": [VP] * 9 + [CI] * 7 + [VP],
        "prost_rof_chunk_batched_tiled": [VP] * 9 + [CI] * 7 + [VP],
        "prost_rof_multichunk_tiled": [VP] * 9 + [CI] * 6 + [CF] * 6
                                      + [CI] * 2 + [VP],
        "prost_rof_tiled_smem": []})


def rof_chunk(x, q, f, w, scal, count: int, dataterm: str = "square"):
    """``count`` fused iterations ending on a residual iteration.

    x, f, w: (nx, ny); q: (2, nx, ny); scal: [tau, sigma, theta, lmb,
    radius] (+ an optional converged flag: when set, nothing runs and the
    inputs come back).  Returns (x2, q2, x_prev, q_prev, norms2), norms2
    the 4 SQUARED preconditioned residual norms, on the inputs' device.
    CPU tensors run the plain version; CUDA tensors run ``rof_chunk_`` on
    copies (the shape rule's path)."""
    _check(x, q, f, w, scal, 5, count, dataterm)
    if x.device.type == "cpu":
        return rof_chunk_plain(x, q, f, w, scal, count, dataterm)
    return halo_copy(rof_chunk_, (x, q), f, w, scal, count, dataterm)


def resident_bytes(nx: int, ny: int, sms: int, dataterm: str = "square",
                   multi: bool = False) -> int:
    """The dynamic shared memory of one block of the grid-resident chunk on
    planes of ``nx`` rows over ``sms`` blocks: csrc/fused_rof.cu's RofRes
    for the largest band (rof_resident_floats: x, q_y and f, and wsquare's
    w, with the row below, q_x with the rows above and below, and the two
    carried gradient planes), at least the reductions' array; with
    ``multi`` the multichunk's, which adds w_hat's window (f is read again
    in the next chunk), at least the reductions' array that borrows it."""
    rmax = resident_rows(nx, sms)
    planes = 7 if dataterm == "wsquare" else 6
    floats = (planes * (rmax + 1) - 1) * int(ny)
    if multi:
        floats += max(rmax * int(ny), RES_RED_BYTES // 4)
    return max(4 * floats, RES_RED_BYTES)


def resident_ok(nx: int, ny: int, dataterm: str, sms: int, smem: int,
                multi: bool = False) -> bool:
    """Whether ``rof_chunk_`` (with ``multi``, ``rof_multichunk_``) may run
    as one grid-resident launch (csrc/fused_rof.cu rof_resident,
    rof_multichunk_resident, one block per SM): the planes of the largest
    band fit in ``smem`` bytes of a block's dynamic shared memory on a card
    of ``sms`` SMs (``route_of`` takes the tiled launch otherwise)."""
    return resident_bytes(nx, ny, sms, dataterm, multi) <= int(smem)


# the tiled launch's owned tiles (csrc/fused_rof.cu rof_tiled): rows a
# multiple of 8 and columns of 32, so every 32x8 norm tile lies in one block
TILE_ROWS = tuple(range(8, 257, 8))
TILE_COLS = tuple(range(32, 257, 32))
# its thread map (csrc/fused_rof.cu TL_WARPS, TL_K, TL_MAX_CB): blocks of
# 32 columns (at most TILE_MAX_CB) by TILE_STRIP rows of a window, a warp
# each; TILE_HEAD floats of shared memory before the window's planes
TILE_WARPS, TILE_STRIP, TILE_MAX_CB, TILE_HEAD = 32, 13, 6, 40


def tiled_bytes(tx: int, ty: int, count: int, dataterm: str = "square") -> int:
    """The dynamic shared memory of one block of the tiled launch
    (csrc/fused_rof.cu tiled_smem): the window of a ``tx`` x ``ty`` tile
    with the halo of a ``count``-iteration chunk (``tiled_halo``: 2 count +
    1 rows and columns more) in x, q_x, q_y, f, and wsquare's w (5 planes,
    4 for the other data terms), their rows as wide as the map
    (``tiled_map``: 32 floats a block of columns), after the block's
    ``TILE_HEAD`` floats."""
    h = 2 * int(count) + 1
    planes = 5 if dataterm == "wsquare" else 4
    cb = tiled_map(tx, ty, count)[0]
    return 4 * (planes * (int(tx) + h) * 32 * cb + TILE_HEAD)


def tiled_map(tx: int, ty: int, count: int) -> tuple:
    """The thread map of the window of a ``tx`` x ``ty`` tile of a
    ``count``-iteration chunk (csrc/fused_rof.cu tiled_map_ok): (blocks
    of 32 columns, blocks of ``TILE_STRIP`` rows), a warp each."""
    h = 2 * int(count) + 1
    return -(-(int(ty) + h) // 32), -(-(int(tx) + h) // TILE_STRIP)


def tiled_fits(tx: int, ty: int, count: int, dataterm: str,
               smem: int) -> bool:
    """Whether the tiled launch takes a ``tx`` x ``ty`` tile: its window
    fits in ``smem`` bytes (``tiled_bytes``) and its map in the block's
    warps (``tiled_map``, at most ``TILE_MAX_CB`` blocks of columns)."""
    cb, rb = tiled_map(tx, ty, count)
    return (tiled_bytes(tx, ty, count, dataterm) <= int(smem)
            and cb <= TILE_MAX_CB and cb * rb <= TILE_WARPS)


def tiled_tile(nx: int, ny: int, count: int, dataterm: str, sms: int,
               smem: int, batch: int = 1):
    """The owned tile (rows, columns) of the tiled launch on ``batch``
    instances of (nx, ny) planes and ``count``-iteration chunks on a card
    of ``sms`` SMs whose blocks may hold ``smem`` bytes of dynamic shared
    memory: of the tiles of ``TILE_ROWS`` x ``TILE_COLS`` that the launch
    takes (``tiled_fits``), the one whose launch walks the fewest lane
    rows through the SMs (the rounds of one block per SM over every
    instance's tiles times a whole tile's window rows times its map's
    width, 32 lanes a block of columns (``tiled_map``) whether the window
    fills them or not), the larger tile on a tie; None where no tile
    fits.  (``window_tile``'s measure, the window's pixels, takes 104x64
    at 2048x2048, 1-6% slower than 72x96 on an H100: PERF.md.)"""
    h = 2 * int(count) + 1
    return window_tile(
        nx, ny, h, sms,
        lambda tx, ty: tiled_fits(tx, ty, count, dataterm, smem), batch,
        cost=lambda tx, ty: min(tx + h, nx) * 32 * -(-min(ty + h, ny) // 32))


def window_tile(nx: int, ny: int, h: int, sms: int, fits, batch: int = 1,
                lead: int = 0, fixed: int = 0, cost=None):
    """The owned tile (rows, columns) of a tiled launch on ``batch``
    instances of (nx, ny) planes on a card of ``sms`` SMs, the search of
    every tiled rule: of the tiles of ``TILE_ROWS`` x ``TILE_COLS`` (every
    32x8 norm tile in one) whose window fits (``fits(tx, ty)``, false
    beyond some rows for each column count), the one whose launch moves
    the fewest window pixels through the SMs (the rounds of one block per
    SM over the ``batch`` instances' tiles, and ``lead`` more, times a
    whole tile's window, ``h`` rows and columns more than the tile, and
    ``fixed`` pixels a window more; ``cost(tx, ty)``, where given, in
    place of that window's measure), the larger tile on a tie; None where
    no tile's window fits."""
    if cost is None:
        def cost(tx, ty):
            return (min(tx, nx) + h) * (min(ty, ny) + h) + int(fixed)
    best, least = None, None
    for ty in TILE_COLS:
        if ty - 32 >= ny:
            break
        for tx in TILE_ROWS:
            if tx - 8 >= nx or not fits(tx, ty):
                break
            tiles = int(batch) * -(-nx // tx) * -(-ny // ty)
            rounds = -(-tiles // int(sms)) + int(lead)
            c = rounds * cost(tx, ty)
            if best is None or c < least or (c == least and
                                             tx * ty > best[0] * best[1]):
                best, least = (tx, ty), c
    return best


def tiled_ok(nx: int, ny: int, count: int, dataterm: str, sms: int,
             smem: int, batch: int = 1) -> bool:
    """Whether the tiled launch takes (nx, ny) planes (``batch`` of
    them) in chunks of ``count`` iterations: some tile's window fits in
    ``smem`` bytes."""
    return tiled_tile(nx, ny, count, dataterm, sms, smem, batch) is not None


def route_of(nx: int, ny: int, dataterm: str, count: int, sms: int,
             smem: int, tiled_smem: int, multi: bool = False) -> str:
    """The shape rule of ``rof_chunk_``, ``rof_chunk_halo_`` (on the band's
    rows) and, with ``multi``, ``rof_multichunk_`` on a card of ``sms`` SMs
    whose resident blocks may hold ``smem`` bytes and tiled blocks
    ``tiled_smem``: "resident" where the planes fit in the grid-resident
    launch (``resident_ok``), else "tiled" where a tile's window holds the
    chunk's halo (``tiled_ok``), else "streaming"."""
    if resident_ok(nx, ny, dataterm, sms, smem, multi):
        return "resident"
    if tiled_ok(nx, ny, count, dataterm, sms, tiled_smem):
        return "tiled"
    return "streaming"


@functools.lru_cache(maxsize=None)
def tiled_limit(device) -> int:
    """The dynamic shared memory a block of the tiled launch may hold on
    the card ``device``, read once."""
    with torch.cuda.device(device):
        smem = _lib().prost_rof_tiled_smem()
    if smem < 0:
        raise ProstError(f"rof_chunk: no shared-memory limit for the tiled "
                         f"chunk on {device} (CUDA error {-smem}).")
    return smem


def pick_route(path, nx: int, ny: int, dataterm: str, count: int, device,
               multi: bool, what: str) -> tuple:
    """(path, tile) of a chunk on the card ``device``: by ``route_of``
    where ``path`` is None, else the one asked for; "resident" where the
    planes do not fit, or "tiled" where no tile's window holds the halo,
    raises ``ProstError``.  ``tile`` is the tiled launch's (rows, columns),
    else None."""
    check_path(path, what)
    sms, smem = card_limits(device, multi)
    tsmem = tiled_limit(device)
    if path is None:
        path = route_of(nx, ny, dataterm, count, sms, smem, tsmem, multi)
    if path == "resident" and not resident_ok(nx, ny, dataterm, sms, smem,
                                              multi):
        raise ProstError(f"{what}: the chunk's planes do not fit in the "
                         "shared memory of one block per SM.")
    tile = None
    if path == "tiled":
        tile = tiled_tile(nx, ny, count, dataterm, sms, tsmem)
        if tile is None:
            raise ProstError(f"{what}: no tile's window holds the halo of a "
                             f"{count}-iteration chunk in the shared memory "
                             "of a block.")
    return path, tile


@functools.lru_cache(maxsize=None)
def card_limits(device, multi: bool = False) -> tuple:
    """(SMs, the dynamic shared memory a block of the grid-resident chunk,
    with ``multi`` of the multichunk, may hold) of the card ``device``,
    read once."""
    with torch.cuda.device(device):
        smem = _lib().prost_rof_resident_smem(int(bool(multi)))
    if smem < 0:
        raise ProstError(f"rof_chunk: no shared-memory limit for the "
                         f"resident chunk on {device} (CUDA error {-smem}).")
    return card_sms(device), smem


def _scratch(path: str, nx: int, ny: int, device, batch: int = 1):
    """A launch's scratch: the grid-resident launch's norm terms and its
    exchange planes (8 planes), the tiled launch's second (x, q) (3
    planes an instance), or the streaming sequence's carried gradient
    planes (of this iterate and of the previous one, 2 planes an instance
    each)."""
    if path != "streaming":
        planes = 8 if path == "resident" else 3 * int(batch)
        return [torch.empty((planes, nx, ny), dtype=torch.float32,
                            device=device)]
    return [torch.empty((2 * int(batch), nx, ny), dtype=torch.float32,
                        device=device) for _ in range(2)]


def _launch_chunk(what: str, state, prev, f, w, sc, partial, scratch,
                  route: tuple, count: int, dataterm: str,
                  nx_global=None) -> None:
    """One chunk on the card in place on ``state`` (x, q) and ``prev``: the
    grid-resident launch, the tiled launch or the streaming sequence
    (``route`` = (path, tile) of ``pick_route``), of the whole plane or
    (with ``nx_global``) of a halo band, counted under ``what``."""
    x = state[0]
    nx, ny = x.shape
    path, tile = route
    tail = (int(count), DATATERMS[dataterm])
    if path == "tiled":
        launch(_lib(), "prost_rof_chunk_tiled", what, launch_counts,
               x.device, [*state, *prev, f, w, sc, partial, *scratch], nx,
               ny, int(nx_global or 0), *tail, *tile)
        launch_counts["rof_chunk_tiled"] += 1
        return
    fn = "prost_rof_chunk" + ("" if nx_global is None else "_halo")
    tail = (() if nx_global is None else (int(nx_global),)) + tail
    if path == "resident":
        fn, bufs = fn + "_resident", [*state, *prev, f, w, sc, partial,
                                      *scratch]
    else:
        bufs = [*state, *prev, *scratch, f, w, sc, partial]
    launch(_lib(), fn, what, launch_counts, x.device, bufs, nx, ny, *tail)


def _inplace(what: str, state, prev, f, w, scal, n_scal: int, count: int,
             dataterm: str, nx_global, path):
    """One chunk on the card in place, its buffers made for this call;
    returns norms2."""
    nx, ny = state[0].shape
    dev = state[0].device
    route = pick_route(path, nx, ny, dataterm, count, dev, False, what)
    sc = scalar_buffer(scal, n_scal, S_CONV, S_LEN)
    partial = torch.empty(4 * _lib().prost_rof_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_chunk(what, state, prev, f.contiguous(), w.contiguous(), sc,
                  partial, _scratch(route[0], nx, ny, dev), route, count,
                  dataterm, nx_global)
    return sc[S_NORM:S_NORM + 4]


def rof_chunk_(x, q, x_prev, q_prev, f, w, scal, count: int,
               dataterm: str = "square", path=None):
    """``rof_chunk`` in place: (x, q) advance by ``count`` iterations and
    (x_prev, q_prev) take the iterate before the aligned one; with the
    converged flag set nothing changes.  Returns norms2.  On a card
    ``path`` None takes the shape rule's path (``route_of``): one
    grid-resident launch (csrc/fused_rof.cu rof_resident) where the planes
    fit on chip, else one tiled launch (rof_tiled) with the finish and a
    copy back; "resident", "tiled" or "streaming" asks for one
    ("resident" and "tiled" raise where they cannot launch)."""
    _check(x, q, f, w, scal, 5, count, dataterm)
    check_inplace((x, q), (x_prev, q_prev))
    check_path(path, "rof_chunk")
    if x.device.type == "cpu":
        return halo_into((x, q), (x_prev, q_prev), rof_chunk_plain(
            x, q, f, w, scal, count, dataterm), scal, 5)
    return _inplace("rof_chunk", (x, q), (x_prev, q_prev), f, w, scal, 5,
                    count, dataterm, None, path)


class ROFChunk(LightChunk):
    """The ROF routes' light chunk call: ``rof_chunk_`` (with ``band`` =
    (nx_global, rows, row_offset, own_lo, own_hi), ``rof_chunk_halo_`` on a
    band of ``rows`` rows) on the planes (x, q) a route holds, with what
    depends only on the shapes made once per route: the path (``route``:
    ``pick_route``'s (path, tile), by the shape rule unless ``path`` asks
    for one), the scratch, the norm partials and the scalar buffer with
    ``m``'s lmb and radius (and the band's row context).  A call writes
    the step sizes and the flag into the scalar buffer and launches; on the
    CPU it runs the plain version."""

    def __init__(self, m, count: int, device, band=None, path=None):
        consts = (m["lmb"], m["radius"]) + tuple(band[2:] if band else ())
        super().__init__(consts, device)
        self.count, self.dataterm, self.band = int(count), m["dataterm"], band
        nx, ny = m["nx"], m["ny"]
        if band is not None:
            nx = int(band[1])
        self.what = "rof_chunk" if band is None else "rof_chunk_halo"
        self.nx_global = None if band is None else int(band[0])
        self.route = None  # (path, tile) on a card
        if torch.device(device).type == "cuda":
            self.route = pick_route(path, nx, ny, self.dataterm, self.count,
                                    device, False, self.what)
            self.partial = torch.empty(
                4 * _lib().prost_rof_num_blocks(nx, ny), dtype=torch.float32,
                device=device)
            self.scratch = _scratch(self.route[0], nx, ny, device)

    @property
    def resident(self):
        """Whether the call runs grid-resident on a card; None on the
        CPU."""
        return None if self.route is None else self.route[0] == "resident"

    def __call__(self, state, prev, f, w, tau, sigma, theta, converged):
        """``count`` iterations on ``state`` (x, q) in place, the previous
        iterate into ``prev``; returns norms2."""
        self.scalars_(tau, sigma, theta, converged)
        if self.route is None:
            scal = self.scal()
            if self.band is None:
                out = rof_chunk_plain(*state, f, w, scal, self.count,
                                      self.dataterm)
            else:
                out = rof_chunk_halo_plain(*state, f, w, scal, self.count,
                                           self.nx_global, self.dataterm)
            return halo_into(state, prev, out, scal, self.n_scal)
        _launch_chunk(self.what, state, prev, f, w, self.sc, self.partial,
                      self.scratch, self.route, self.count, self.dataterm,
                      self.nx_global)
        return self.norms2()


def rof_chunk_halo(x, q, f, w, scal, count: int, nx_global: int,
                   dataterm: str = "square"):
    """``rof_chunk`` on one halo-extended shard of a row-partitioned plane
    of ``nx_global`` rows.

    x, f, w: (nxb, ny) with the shard's rows in the middle and the halo
    rows of its neighbours (zeros beyond the plane) above and below; q:
    (2, nxb, ny); scal: [tau, sigma, theta, lmb, radius, row_offset,
    own_lo, own_hi] (+ an optional converged flag), row_offset the global
    row of local row 0 and [own_lo, own_hi) the owned local rows.  Returns
    (x2, q2, x_prev, q_prev, norms2) like ``rof_chunk``, norms2 over the
    owned rows only; the rows outside them are not the solution's.  CPU
    tensors run the plain version; CUDA tensors run ``rof_chunk_halo_``
    on copies (the shape rule's path)."""
    return halo_copy(rof_chunk_halo_, (x, q), f, w, scal, count, nx_global,
                     dataterm)


def rof_chunk_halo_(x, q, x_prev, q_prev, f, w, scal, count: int,
                    nx_global: int, dataterm: str = "square", path=None):
    """``rof_chunk_halo`` in place, on the sharded route's persistent
    buffers: (x, q) advance by ``count`` iterations and (x_prev, q_prev)
    take the iterate before the aligned one; with the converged flag set
    nothing changes.  Returns norms2.  ``path`` as for ``rof_chunk_``, the
    shape rule on the band's rows (csrc/fused_rof.cu rof_resident on the
    band where it fits, else rof_tiled on the band)."""
    _check(x, q, f, w, scal, N_HALO_SCAL, count, dataterm)
    check_halo(nx_global, (x, q), (x_prev, q_prev))
    check_path(path, "rof_chunk_halo")
    if x.device.type == "cpu":
        return halo_into((x, q), (x_prev, q_prev), rof_chunk_halo_plain(
            x, q, f, w, scal, count, nx_global, dataterm), scal)
    return _inplace("rof_chunk_halo", (x, q), (x_prev, q_prev), f, w, scal,
                    N_HALO_SCAL, count, dataterm, int(nx_global), path)


BATCHED_PATHS = (None, "cluster", "tiled", "streaming")


def batched_route_of(batch: int, nx: int, ny: int, dataterm: str,
                     count: int, sms: int, tiled_smem: int) -> str:
    """The shape rule of ``rof_chunk_batched`` on ``batch`` instances of
    (nx, ny) on a card of ``sms`` SMs whose tiled blocks may hold
    ``tiled_smem`` bytes: "cluster" where a cluster of at most 8 CTAs
    holds an instance (``cluster_size``), else "tiled" where a tile's
    window holds the chunk's halo (``tiled_ok`` with the batch), else
    "streaming"."""
    if cluster_size(nx, ny, dataterm) is not None:
        return "cluster"
    if tiled_ok(nx, ny, count, dataterm, sms, tiled_smem, batch):
        return "tiled"
    return "streaming"


def _check_batched_path(path, what: str) -> None:
    if path not in BATCHED_PATHS:
        raise ProstError(f"{what}: path must be one of {BATCHED_PATHS}, got "
                         f"{path!r}.")


def batched_pick_route(path, batch: int, nx: int, ny: int, dataterm: str,
                       count: int, device, what: str) -> tuple:
    """(path, tile) of a batched chunk on the card ``device``: by
    ``batched_route_of`` where ``path`` is None, else the one asked for;
    "cluster" where no cluster of 8 holds an instance, or "tiled" where no
    tile's window holds the halo, raises ``ProstError``.  ``tile`` is the
    tiled launch's (rows, columns), else None."""
    _check_batched_path(path, what)
    sms, tsmem = card_sms(device), tiled_limit(device)
    if path is None:
        path = batched_route_of(batch, nx, ny, dataterm, count, sms, tsmem)
    if path == "cluster" and cluster_size(nx, ny, dataterm) is None:
        raise ProstError(f"{what}: no cluster of {CLUSTER_SIZES[-1]} CTAs "
                         f"holds an instance of {nx}x{ny}.")
    tile = None
    if path == "tiled":
        tile = tiled_tile(nx, ny, count, dataterm, sms, tsmem, batch)
        if tile is None:
            raise ProstError(f"{what}: no tile's window holds the halo of a "
                             f"{count}-iteration chunk in the shared memory "
                             "of a block.")
    return path, tile


def rof_chunk_batched(x, q, f, w, scal, count: int,
                      dataterm: str = "square", path=None):
    """``rof_chunk`` for each of B instances.

    x, f, w: (B, nx, ny); q: (B, 2, nx, ny); scal: (5, B), a row each of
    tau, sigma, theta, lmb and radius (+ an optional row of converged
    flags: an instance whose flag is set runs nothing and gets its inputs
    back).  Returns (x2, q2, x_prev, q_prev, norms2), norms2 (4, B) the
    SQUARED preconditioned residual norms of each instance; the caller's
    x and q are left as they were.  Instance b comes out as ``rof_chunk``
    on instance b alone.  CPU tensors run the plain version; CUDA tensors
    launch the kernel on the path of ``batched_route_of`` unless ``path``
    ("cluster", "tiled" or "streaming") asks for one: the cluster launch
    (and the norms' finish) that reads the inputs and writes new outputs,
    or ``rof_chunk_batched_``'s tiled launch or streaming sequence on
    copies."""
    _check(x, q, f, w, scal, 5, count, dataterm, batched=True)
    _check_batched_path(path, "rof_chunk_batched")
    if x.device.type == "cpu":
        return rof_chunk_batched_plain(x, q, f, w, scal, count, dataterm)
    batch, nx, ny = x.shape
    route = batched_pick_route(path, batch, nx, ny, dataterm, count,
                               x.device, "rof_chunk_batched")
    if route[0] != "cluster":
        return halo_copy(rof_chunk_batched_, (x, q), f, w, scal, count,
                         dataterm, route[0])
    lib = _lib()
    ins = [t.contiguous() for t in (x, q, f, w)]
    outs = [torch.empty_like(t) for t in (ins[0], ins[1], ins[0], ins[1])]
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = torch.empty(4 * lib.prost_rof_num_blocks(nx, ny) * batch,
                          dtype=torch.float32, device=x.device)
    launch(lib, "prost_rof_chunk_cluster", "rof_chunk_batched",
           launch_counts, x.device, ins + outs + [sc, partial], nx, ny,
           int(count), DATATERMS[dataterm], batch,
           cluster_size(nx, ny, dataterm))
    return (*outs, sc[:, S_NORM:S_NORM + 4].T)


def _launch_batched(state, prev, f, w, sc, partial, scratch, route: tuple,
                    count: int, dataterm: str) -> None:
    """One batched chunk on the card in place on ``state`` (x, q) and
    ``prev``: the tiled launch or the streaming sequence (``route`` =
    (path, tile) of ``batched_pick_route``), counted under
    ``rof_chunk_batched`` (and a tiled one also under
    ``rof_chunk_batched_tiled``)."""
    x = state[0]
    batch, nx, ny = x.shape
    path, tile = route
    tail = (int(count), DATATERMS[dataterm], batch)
    if path == "tiled":
        launch(_lib(), "prost_rof_chunk_batched_tiled", "rof_chunk_batched",
               launch_counts, x.device, [*state, *prev, f, w, sc, partial,
                                         *scratch], nx, ny, *tail, *tile)
        launch_counts["rof_chunk_batched_tiled"] += 1
        return
    launch(_lib(), "prost_rof_chunk_batched", "rof_chunk_batched",
           launch_counts, x.device, [*state, *prev, *scratch, f, w, sc,
                                     partial], nx, ny, *tail)


def rof_chunk_batched_(x, q, x_prev, q_prev, f, w, scal, count: int,
                       dataterm: str = "square", path=None):
    """``rof_chunk_batched`` in place: every instance of (x, q) advances
    by ``count`` iterations and (x_prev, q_prev) take its iterate before
    the aligned one; an instance whose flag is set keeps all four.  Returns
    norms2 (4, B).  On a card ``path`` None takes the tiled launch
    (csrc/fused_rof.cu rof_tiled with the instances on blockIdx.z, the
    finish and the copy back) where a tile's window holds the chunk's halo,
    else the streaming launch sequence (seed, 2 ``count`` half-steps,
    norms, finish, every half-step streaming all the instances' planes
    through device memory); "tiled" or "streaming" asks for one ("tiled"
    raises where no window holds the halo; the cluster launch does not run
    in place)."""
    _check(x, q, f, w, scal, 5, count, dataterm, batched=True)
    check_buffers("ROF", (("x_prev", x_prev, tuple(x.shape)),
                          ("q_prev", q_prev, tuple(q.shape))), scal, 5,
                  x.shape[0])
    check_inplace((x, q), (x_prev, q_prev))
    if path not in (None, "tiled", "streaming"):
        raise ProstError(f"rof_chunk_batched_: path must be None, 'tiled' "
                         f"or 'streaming', got {path!r}.")
    if x.device.type == "cpu":
        return halo_into((x, q), (x_prev, q_prev), rof_chunk_batched_plain(
            x, q, f, w, scal, count, dataterm), scal, 5)
    batch, nx, ny = x.shape
    dev = x.device
    if path is None:
        path = ("tiled" if tiled_ok(nx, ny, count, dataterm, card_sms(dev),
                                    tiled_limit(dev), batch)
                else "streaming")
    route = batched_pick_route(path, batch, nx, ny, dataterm, count, dev,
                               "rof_chunk_batched_")
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = torch.empty(4 * batch * _lib().prost_rof_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_batched((x, q), (x_prev, q_prev), f.contiguous(), w.contiguous(),
                    sc, partial, _scratch(path, nx, ny, dev, batch), route,
                    count, dataterm)
    return sc[:, S_NORM:S_NORM + 4].T


def rof_chunk_batched_streaming_(x, q, x_prev, q_prev, f, w, scal,
                                 count: int, dataterm: str = "square"):
    """``rof_chunk_batched_`` with ``path="streaming"``, on CUDA tensors
    only: the launch sequence the tiled and cluster launches are held
    against.  Returns norms2 (4, B)."""
    if x.device.type != "cuda":
        raise ProstError("The streaming batched chunk runs on a card only.")
    return rof_chunk_batched_(x, q, x_prev, q_prev, f, w, scal, count,
                              dataterm, "streaming")


class ROFBatchedChunk(LightChunk):
    """``BatchedPDHG``'s light call of the batched ROF chunk:
    ``rof_chunk_batched_`` on the views (x, q) of the run's own flat x, y,
    x_prev and y_prev, with what depends only on the shapes made once per
    route: the path (``route``: ``batched_pick_route``'s (path, tile), by
    ``batched_route_of`` unless ``path`` asks for one), the scratch, the
    norm partials and the scalar buffer with every instance's lmb and
    radius.  ``inplace`` says whether the route calls it: not where a
    cluster holds an instance (on the CPU, by ``cluster_size`` unless
    ``path`` asks for "tiled" or "streaming"), since the cluster launch
    reads its inputs and writes new outputs and the route keeps
    ``rof_chunk_batched`` there.  A call writes the step sizes and the
    flags into the scalar buffer and launches; on the CPU it runs the
    plain version."""

    def __init__(self, m, batch: int, count: int, device, path=None):
        super().__init__((m["lmb"], m["radius"]), device, batch)
        _check_batched_path(path, "ROFBatchedChunk")
        self.count, self.dataterm = int(count), m["dataterm"]
        B, nx, ny = int(batch), m["nx"], m["ny"]
        self.route = None  # (path, tile) on a card
        if torch.device(device).type == "cuda":
            self.route = batched_pick_route(path, B, nx, ny, self.dataterm,
                                            self.count, device,
                                            "ROFBatchedChunk")
            self.inplace = self.route[0] != "cluster"
            if self.inplace:
                self.partial = torch.empty(
                    4 * B * _lib().prost_rof_num_blocks(nx, ny),
                    dtype=torch.float32, device=device)
                self.scratch = _scratch(self.route[0], nx, ny, device, B)
        else:
            self.inplace = (path in ("tiled", "streaming") or path is None
                            and cluster_size(nx, ny, self.dataterm) is None)

    def __call__(self, state, prev, f, w, tau, sigma, theta, converged):
        """``count`` iterations of every instance of ``state`` (x, q) in
        place, the previous iterate into ``prev``; ``converged`` sets
        every instance's flag; returns norms2 (4, B)."""
        if not self.inplace:
            raise ProstError("ROFBatchedChunk: the cluster launch does not "
                             "run in place; call rof_chunk_batched.")
        self.scalars_(tau, sigma, theta, converged)
        if self.route is None:
            scal = self.scal()
            out = rof_chunk_batched_plain(*state, f, w, scal, self.count,
                                          self.dataterm)
            return halo_into(state, prev, out, scal, self.n_scal)
        _launch_batched(state, prev, f, w, self.sc, self.partial,
                        self.scratch, self.route, self.count, self.dataterm)
        return self.norms2()


def rof_multichunk(x, q, f, w, scal, count: int, k_chunks: int,
                   dataterm: str, stepsize: str, consts):
    """Up to ``k_chunks * count`` fused iterations with the adaptation and
    the stopping test on the device between chunks.

    ``scal`` holds 13 scalars: [tau, sigma, theta, lmb, radius, arg_alpha,
    arb_l, arb_u, it0, tol_rel_p, tol_rel_d, tol_abs_p, tol_abs_d] (+ an
    optional converged-at-entry flag).  Returns (x2, q2, x_prev, q_prev,
    norms, sout): norms the last executed chunk's sqrt'd residual norms,
    sout = [tau, sigma, arg_alpha, arb_l, arb_u, converged, chunks_done].
    CPU tensors run the plain version; CUDA tensors run ``rof_multichunk_``
    on copies (the shape rule's path)."""
    _check(x, q, f, w, scal, 13, count, dataterm)
    if stepsize not in STEPSIZES:
        raise ProstError(f"No fused adaptation for stepsize '{stepsize}'.")
    if x.device.type == "cpu":
        return rof_multichunk_plain(x, q, f, w, scal, count, k_chunks,
                                    dataterm, stepsize, consts)
    *planes, (norms, sout) = halo_copy(rof_multichunk_, (x, q), f, w, scal,
                                       count, k_chunks, dataterm, stepsize,
                                       consts)
    return (*planes, norms, sout)


def _launch_multichunk(state, prev, f, w, sc, partial, scratch,
                       route: tuple, count: int, k_chunks: int,
                       dataterm: str, stepsize: str, consts) -> None:
    """One multichunk on the card in place on ``state`` (x, q) and
    ``prev``: the grid-resident launch, the tiled launches or the streaming
    sequence (``route`` = (path, tile) of ``pick_route``), counted under
    ``rof_multichunk``."""
    x = state[0]
    nx, ny = x.shape
    path, tile = route
    if path == "streaming":
        fn, bufs = "prost_rof_multichunk", [*state, *prev, *scratch, f, w,
                                            sc, partial]
    else:
        fn = "prost_rof_multichunk_" + path
        bufs = [*state, *prev, f, w, sc, partial, *scratch]
    launch(_lib(), fn, "rof_multichunk", launch_counts, x.device, bufs, nx,
           ny, int(count), int(k_chunks), DATATERMS[dataterm],
           STEPSIZES[stepsize], *[float(c) for c in consts],
           *(tile or ()))
    if path == "tiled":
        launch_counts["rof_multichunk_tiled"] += 1


def rof_multichunk_(x, q, x_prev, q_prev, f, w, scal, count: int,
                    k_chunks: int, dataterm: str, stepsize: str, consts,
                    path=None):
    """``rof_multichunk`` in place: (x, q) advance by up to ``k_chunks``
    chunks and (x_prev, q_prev) take the iterate before the last executed
    chunk's aligned iteration; with the converged flag set at entry nothing
    changes.  Returns (norms, sout).  On a card ``path`` None takes the
    shape rule's path (``route_of(..., multi=True)``): one grid-resident
    launch for all the chunks (csrc/fused_rof.cu rof_multichunk_resident)
    where the planes fit on chip, else a tiled launch (rof_tiled) and the
    finish a chunk, (x, q) and the scratch taking turns; "resident",
    "tiled" or "streaming" asks for one ("resident" and "tiled" raise
    where they cannot launch)."""
    _check(x, q, f, w, scal, 13, count, dataterm)
    if stepsize not in STEPSIZES:
        raise ProstError(f"No fused adaptation for stepsize '{stepsize}'.")
    state, prev = (x, q), (x_prev, q_prev)
    check_inplace(state, prev)
    check_path(path, "rof_multichunk")
    if x.device.type == "cpu":
        out = rof_multichunk_plain(x, q, f, w, scal, count, k_chunks,
                                   dataterm, stepsize, consts)
        return halo_into(state, prev, out[:5], scal, 13), out[5]
    nx, ny = x.shape
    dev = x.device
    route = pick_route(path, nx, ny, dataterm, count, dev, True,
                       "rof_multichunk")
    sc = scalar_buffer(scal, 13, S_CONV, S_LEN)
    partial = torch.empty(4 * _lib().prost_rof_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_multichunk(state, prev, f.contiguous(), w.contiguous(), sc,
                       partial, _scratch(route[0], nx, ny, dev), route,
                       count, k_chunks, dataterm, stepsize, consts)
    return sc[S_NORM:S_NORM + 4], torch.stack([sc[i] for i in SOUT])


class ROFMultichunk(LightMultichunk):
    """The ROF route's light call of the multichunk: ``rof_multichunk_`` on
    the views (x, q) of the run's own x, y, x_prev and y_prev, its path
    ``route_of(..., multi=True)`` unless ``path`` asks for one (``route``:
    (path, tile)); ``resident`` whether that path is the grid-resident
    launch."""

    _inplace = staticmethod(rof_multichunk_)
    route = None  # (path, tile) on a card

    def __init__(self, m, count: int, k_chunks: int, stepsize: str, device,
                 path=None):
        self.path = path
        super().__init__(m, count, k_chunks, stepsize, device)

    def _card(self, device):
        m = self.m
        nx, ny = m["nx"], m["ny"]
        self.route = pick_route(self.path, nx, ny, m["dataterm"], self.count,
                                device, True, "rof_multichunk")
        partial = torch.empty(4 * _lib().prost_rof_num_blocks(nx, ny),
                              dtype=torch.float32, device=device)
        return (self.route[0] == "resident", partial,
                _scratch(self.route[0], nx, ny, device))

    def _launch(self, state, prev, f, w, sc, partial, scratch, resident,
                *args):
        _launch_multichunk(state, prev, f, w, sc, partial, scratch,
                           self.route, *args)


# ---------------------------------------------------------------------------
# structure matching and the backend
# ---------------------------------------------------------------------------

def match_rof_structure(problem):
    """Detect the fusable ROF structure; returns dict(nx, ny, f, w, lmb,
    radius, dataterm) or None.  Conditions: single gradient2d block (L=1,
    label_first=False); prox_g a single 1D square or abs with coeffs
    (1, f, lmb, 0, 0), or a square with per-pixel a (the masked inpainting
    term); prox_fstar a Moreau(norm2 abs, dim=2 planar, coeffs
    (1, 0, c, 0, 0)) or a norm2 ind_leq0 ball; alpha preconditioner
    (Sigma = 1/2, Tau = 1/4).  The fused route is float32 only."""
    if config_dtype() != torch.float32:
        return None
    linop = problem.linop
    if not isinstance(linop, LinearOperator) or len(linop.blocks) != 1:
        return None
    blk = linop.blocks[0]
    if not isinstance(blk, BlockGradient2D) or blk.L != 1 or blk.label_first:
        return None
    if len(problem.prox_g) != 1 or len(problem.prox_fstar) != 1:
        return None
    nx, ny = blk.nx, blk.ny
    data = match_dataterm(problem.prox_g[0], (nx, ny),
                          problem.scaling_left.device)
    if data is None:
        return None
    dataterm, f, w, lmb = data

    # --- regularizer: per-pixel r-ball projection of the dual --------------
    radius = dual_ball_radius(problem.prox_fstar[0])
    if radius is None:
        return None

    # constant alpha preconditioner for a lone gradient2d block
    sl, sr = problem.scaling_left, problem.scaling_right
    if not (torch.allclose(sl, torch.full_like(sl, 0.5))
            and torch.allclose(sr, torch.full_like(sr, 0.25))):
        return None
    return {"nx": nx, "ny": ny, "f": f, "w": w, "lmb": lmb,
            "radius": radius, "dataterm": dataterm}


class FusedROFPDHG(BackendPDHG):
    """BackendPDHG that runs ROF-structured problems through the fused ROF
    chunk kernels, fast-multilabel problems through the fused multilabel
    kernels (``ops/fused_multilabel.py``), TV-deblurring problems through
    the fused deblur kernel (``ops/fused_deblur.py``), tight-multilabel
    problems through the fused tight kernel (``ops/fused_tight.py``) and
    volumetric-TV problems through the fused volumetric kernels
    (``ops/fused_vol.py``), trying the routes in that order as the JAX
    package does, and behaves exactly like BackendPDHG otherwise.  Residual iterations take their
    norms from the kernels, and the adaptation and stopping test follow
    the generic code's order of operations."""

    def __init__(self, problem, opts, solver_opts):
        super().__init__(problem, opts, solver_opts)
        # alg2 changes (tau, sigma, theta) every iteration while a chunk
        # holds them fixed; the reference-exact residual sequence needs the
        # generic path
        usable = opts.stepsize != "alg2" and not opts.reference_residuals
        self.rof = match_rof_structure(problem) if usable else None
        self.ml = self.deblur = self.tight = self.vol = None
        if usable and self.rof is None:
            self.ml = match_multilabel_structure(problem)
        if usable and not (self.rof or self.ml):
            # a MinProblem's data terms are prox_f: the deblur matcher reads
            # the prox_fstar the backend made from them by Moreau
            self.deblur = match_deblur_structure(problem, self.prox_g,
                                                 self.prox_fstar)
        if usable and not (self.rof or self.ml or self.deblur):
            self.tight = match_tight_structure(problem)
        if usable and not (self.rof or self.ml or self.deblur or self.tight):
            self.vol = match_vol_structure(problem)
        like = problem.scaling_left
        for r, names, kind in ((self.rof, ("lmb", "radius"), "ROF"),
                               (self.ml, ("radius", "d_s"), "multilabel"),
                               (self.deblur, ("lmb", "radius"), "deblur"),
                               (self.tight, ("radius", "d_s"),
                                "tight-multilabel"),
                               (self.vol, ("lmb", "radius"),
                                "volumetric-TV")):
            if r is None:
                continue
            for name in names:
                r[name + "_t"] = like.new_full((), r[name])
            r["tols_t"] = tuple(like.new_full((), float(t))
                                for t in self.tols)
            r["adapt_consts"] = pdhg_adapt_consts(problem, opts)
            if solver_opts.verbose:
                where = ("CUDA kernels" if like.device.type == "cuda"
                         else "plain PyTorch versions on the CPU")
                print(f"FusedROFPDHG: fused {kind} route ({where}).")

    def run(self, state: PDHGState, until_iter: int,
            start_iter: int) -> PDHGState:
        if self.rof is not None:
            return _fused_rof_run(self, state, until_iter, start_iter)
        if self.ml is not None:
            return fused_ml_run(self, state, until_iter, start_iter)
        if self.deblur is not None:
            return fused_deblur_run(self, state, until_iter, start_iter)
        if self.tight is not None:
            return fused_tight_run(self, state, until_iter, start_iter)
        if self.vol is not None:
            return fused_vol_run(self, state, until_iter, start_iter)
        return super().run(state, until_iter, start_iter)


def _planes(r, x, y):
    """(x, q) views of the solver's flat x and y."""
    nx, ny = r["nx"], r["ny"]
    return x.reshape(nx, ny), y.reshape(2, nx, ny)


def _multi_chunk(b: FusedROFPDHG, s: PDHGState) -> PDHGState:
    """One multichunk in place on the views of the run's own x, y, x_prev
    and y_prev (``own_vectors``) through the route's light call
    (``ROFMultichunk``, made once per route)."""
    r, ri = b.rof, max(int(b.opts.residual_iter), 1)
    if "multi" not in r:
        r["multi"] = ROFMultichunk(r, ri, K_CHUNKS, b.opts.stepsize,
                                   s.x.device)
    norms, sout = r["multi"](
        _planes(r, s.x, s.y), _planes(r, s.x_prev, s.y_prev), s.tau, s.sigma,
        s.theta, s.arg_alpha, s.arb_l, s.arb_u, s.iteration, s.converged)
    return multichunk_state(s, ri, s.x, s.y, s.x_prev, s.y_prev, norms,
                            sout)


def _fused_chunk(b: FusedROFPDHG, s: PDHGState) -> PDHGState:
    """One chunk in place on the views of the run's own x, y, x_prev and
    y_prev through the route's light call (``ROFChunk``)."""
    r, ri = b.rof, max(int(b.opts.residual_iter), 1)
    if "call" not in r:
        r["call"] = ROFChunk(r, ri, s.x.device)
    norms2 = r["call"](_planes(r, s.x, s.y), _planes(r, s.x_prev, s.y_prev),
                       r["f"], r["w"], s.tau, s.sigma, s.theta, s.converged)
    return chunk_state(b, s, ri, s.x, s.y, s.x_prev, s.y_prev, norms2)


def _fused_rof_run(b: FusedROFPDHG, state: PDHGState, until: int,
                   start: int) -> PDHGState:
    """``run_pdhg_route`` with the ROF multichunks and chunks; the
    canonicalization zeroes the dead dual coordinates of y and y_prev on
    the run's own copies of the state's vectors, which the multichunks and
    chunks update in place."""
    canonical = canonical_duals(1, b.rof["nx"], b.rof["ny"])
    return run_pdhg_route(b, state, until, start,
                          lambda s: _fused_chunk(b, s),
                          lambda s: own_vectors(canonical(s)),
                          lambda s: _multi_chunk(b, s))
