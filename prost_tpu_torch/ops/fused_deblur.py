"""Fused PDHG iteration for TV deblurring (counterpart of
``prost_tpu/ops/fused_deblur.py``, whole-plane route).

Workload (examples/example_deblurring.py, BASELINE config 2):

    min_u  lmb/2 ||B u - f||^2 + ||grad u||_{2,1}

in saddle form with primal u (one (nx, ny) plane), duals y_v (the blur
residual multiplier, one full-convolution (nx2, ny2) plane) and q = (qx,
qy) (the TV dual):

    K = [ B (full 2D convolution, m2 x n) ; grad2d (2n x n) ]

The alpha preconditioner is constant on the gradient rows (Sigma_q) and on
the columns (Tau), and a plane on the convolution rows (Sigma_v, the row
sums of |B|, which vary at the boundary).

Three kernels carry the route, hand-written CUDA in ``csrc/fused_deblur.cu``
with a plain PyTorch version beside each wrapper here:

* ``deblur_chunk`` (JAX ``deblur_fused_chunk``): ``count`` iterations
  ending on a residual iteration, with the four squared preconditioned
  residual norms;
* ``deblur_chunk_batched`` (JAX ``deblur_fused_chunk_batched``): one chunk
  for each of B frames that share one blur, in one launch, or one launch
  sequence, the batched ensembles' route (``parallel/ensemble.py``);
* ``deblur_chunk_halo`` (JAX ``deblur_fused_chunk_halo``): one chunk on a
  halo-extended band of the (nx2, ny2) grid's rows, x and q cut at the same
  global rows, the spatially sharded route's (``parallel/spatial_fused.py``).

The single-instance chunk, its halo mode and the batched chunk have
in-place forms, ``deblur_chunk_``, ``deblur_chunk_halo_`` and
``deblur_chunk_batched_``, and the routes call them through
``DeblurChunk`` and ``DeblurBatchedChunk``, which make their buffers once
per route.  On a card each runs as one grid-resident cooperative launch
where the shape rule (``resident_ok``, on one frame: a batched launch runs
its frames one after another) finds that one frame's planes fit in the
shared memory of one block per SM.  Where they do not, the single-instance
chunk and its halo mode run as one tiled cooperative launch (the JAX
package's ``deblur_fused_chunk_banded``, row 19 of the kernel table:
``deblur_route_of``, a tile's window of ``deblur_tiled_halo`` pixels a
side in the shared memory of a block, a grid barrier an iteration), and
the batched chunk, and any chunk whose window does not fit, as the
streaming launch sequence; all are bit-equal.  ``path=`` asks for one.

The JAX package has no multichunk kernel for this workload, and neither
has the port.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel, or raises.  There is no fallback to the
generic path and no VMEM gate.

Layout.  The JAX kernel holds every plane embedded in the (nx2, ny2)
full-convolution geometry, zero outside the (nx, ny) region, and the
padding stays zero.  The port's wrapper takes x as (nx, ny) and q as (2,
nx, ny), the solver's own layout, and y_v, f_b and Sigma_v as (nx2, ny2);
its kernel reads the missing padding as zero, which saves a pad and a crop
per chunk.  The plain version embeds, runs the JAX package's arithmetic on
the embedded planes and crops.  Its shifts fill with zeros where the JAX
package's rolls wrap around: on the whole plane the wrapped rows and
columns are padding or masked, so the values are the same, and on a halo
band the zeros are what the kernel reads beyond the band's rows.

Unlike the ROF and multilabel routes, nothing is canonicalized: the
gradient adjoint is masked to the (nx, ny) region, so mass on q_x's last
row or q_y's last column stays where it is and never enters K^T y, as in
the JAX package, which zeroes no dead dual coordinate on this route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..backend.pdhg import PDHGState
from ..common import to_numpy
from ..config import ProstError, dtype as config_dtype
from ..linop.base import LinearOperator
from ..linop.conv import BlockConv2D
from ..linop.gradient import BlockGradient2D
from ..prox.combinators import ProxMoreau
from ..prox.elemop import ProxElem1D
from ..prox.standalone import ProxZero
from .pdhg_chunk import (CF, CI, N_HALO_SCAL, RES_RED_BYTES, S_CONV, S_LEN,
                         S_NORM, VP, LightChunk, ball_scale, card_sms,
                         check_buffers, check_halo, check_inplace, check_path,
                         chunk_state, coeff_vector, dual_ball_radius,
                         entry_converged, halo_copy, halo_into,
                         instance_strides, isscalar, launch, own_vectors,
                         pick_path, resident_rows, run_pdhg_route,
                         scalar_buffer, segment_const, typed_lib,
                         vmap_plain)

MAX_TAPS = 96  # nonzero convolution taps the kernel takes

# launches of the kernel wrapper on the card (CPU calls do not count)
launch_counts = {"deblur_chunk": 0, "deblur_chunk_batched": 0,
                 "deblur_chunk_halo": 0, "deblur_chunk_tiled": 0,
                 "deblur_chunk_halo_tiled": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch version of the chunk math (the JAX package's, on embedded
# planes)
# ---------------------------------------------------------------------------

def ordered_taps(taps):
    """The taps in the order of the JAX package's sums: grouped by row
    shift dx in the order first met, then as given within a group."""
    groups = {}
    for dx, dy, w in taps:
        groups.setdefault(dx, []).append((dy, w))
    return [(dx, dy, w) for dx, g in groups.items() for dy, w in g]


def _tree_sum(terms):
    """Pairwise tree: neighbours added level by level, an odd last term
    carried up (the kernel's binary counter gives the same tree)."""
    while len(terms) > 1:
        nxt = [a + b for a, b in zip(terms[::2], terms[1::2])]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _shift(u, s: int, dim: int):
    """``u`` shifted by ``s`` along ``dim``: out[i] = u[i - s], zero where
    i - s lies outside."""
    n = u.shape[dim]
    if s == 0:
        return u
    if abs(s) >= n:
        return torch.zeros_like(u)
    zeros = torch.zeros_like(u.narrow(dim, 0, abs(s)))
    if s > 0:
        return torch.cat([zeros, u.narrow(dim, 0, n - s)], dim)
    return torch.cat([u.narrow(dim, -s, n + s), zeros], dim)


def _conv_ops(region, taps):
    """Forward full convolution and its adjoint (valid correlation) as
    shift stencils on planes embedded in the yv grid, zero outside the
    image: the forward needs no mask, the adjoint is masked to the
    image."""
    order = ordered_taps(taps)

    def terms(u, sign):
        out, shifted = [], {}
        for dx, dy, w in order:
            if dx not in shifted:
                shifted[dx] = _shift(u, sign * dx, -2)
            out.append(w * _shift(shifted[dx], sign * dy, -1))
        return out

    def fwd(u):
        return _tree_sum(terms(u, 1))

    def adj(v):
        return torch.where(region, _tree_sum(terms(v, -1)), 0.0)

    return fwd, adj


def _grad_ops(nx, ny, nrows, ny2, device, row_offset: int = 0,
              window=None):
    """Forward differences and their adjoint restricted to the image of
    ``nrows`` rows of the yv grid whose local row 0 is global row
    ``row_offset`` (0 for the whole plane, nrows = nx2), the image being
    global rows [0, nx) and columns [0, ny).  ``window`` = (r0, c0, wh,
    ww): the ops of the window of rows [r0, r0 + wh) and columns [c0, c0 +
    ww) of those rows, every mask decided by the pixel's place in them, a
    neighbour outside the window taken as 0 (None: the whole rows)."""
    r0, c0, wh, ww = (0, 0, nrows, ny2) if window is None else window
    li = torch.arange(wh, device=device)[:, None]
    bi = li + r0                       # the band's local row
    gi = bi + row_offset               # the global row
    lj = torch.arange(ww, device=device)[None, :]
    ci = lj + c0
    in_r = ((li < wh - 1) & (bi < nrows - 1) & (gi >= 0) & (gi < nx - 1))
    in_c = (lj < ww - 1) & (ci < ny - 1)
    region = (gi >= 0) & (gi < nx) & (ci < ny)

    def dx(u):
        return torch.where(in_r, _shift(u, -1, -2) - u, 0.0)

    def dy(u):
        return torch.where(in_c, _shift(u, -1, -1) - u, 0.0)

    def dxt(p):
        lead = torch.where(gi > 0, _shift(p, 1, -2), 0.0)
        return torch.where(region, lead - torch.where(in_r, p, 0.0), 0.0)

    def dyt(p):
        lead = torch.where(ci > 0, _shift(p, 1, -1), 0.0)
        return torch.where(region, lead - torch.where(in_c, p, 0.0), 0.0)

    return dx, dy, dxt, dyt, region


def _chunk_ops(nx, ny, nrows, ny2, taps, device, row_offset: int = 0,
               window=None):
    """(dx, dy, dxt, dyt, conv_fwd, conv_adj) of ``_grad_ops`` and
    ``_conv_ops`` on the same rows (or window)."""
    dx, dy, dxt, dyt, region = _grad_ops(nx, ny, nrows, ny2, device,
                                         row_offset, window)
    return (dx, dy, dxt, dyt) + _conv_ops(region, taps)


def _iteration(ops, tau_raw, sigma_raw, theta, lmb, radius, fb, sv,
               sig_q: float, tau_t: float):
    """``_chunk_core``'s iteration on planes of fb.shape (fb and sv cut
    like the state): (x, yv, qx, qy, bx, gx, gy) -> (x2, yv2, qx2, qy2,
    bx2, gx2, gy2, kty), (bx, gx, gy) = K x carried."""
    dx, dy, dxt, dyt, conv_fwd, conv_adj = ops
    tau_s = tau_raw * tau_t            # tau * Tau
    tsv = sigma_raw * sv               # sigma * Sigma_v (plane)
    sq = sigma_raw * sig_q             # sigma * Sigma_q
    sig_p = sq * (1.0 + theta)
    sig_t = sq * theta
    inv_l = 1.0 / lmb
    dual_v_den = 1.0 / (1.0 + tsv * inv_l)
    dual_v_sh = tsv * fb

    def update(x, yv, qx, qy, bx, gx, gy):
        kty = conv_adj(yv) + dxt(qx) + dyt(qy)
        x2 = x - tau_s * kty
        bx2 = conv_fwd(x2)
        gx2, gy2 = dx(x2), dy(x2)
        av = yv + tsv * ((1.0 + theta) * bx2 - theta * bx)
        yv2 = (av - dual_v_sh) * dual_v_den
        ax = qx + sig_p * gx2 - sig_t * gx
        ay = qy + sig_p * gy2 - sig_t * gy
        scale = ball_scale(ax * ax + ay * ay, radius)
        return x2, yv2, ax * scale, ay * scale, bx2, gx2, gy2, kty

    return update


def _residuals(ops, tau_raw, sigma_raw, theta, sv, sig_q: float,
               tau_t: float, old, new, kx_old, kx_new, ktyp):
    """The preconditioned residual planes of an aligned iteration from the
    iterate before it (``old``: x, yv, qx, qy) and after it (``new``), K x
    of each (``kx_old``, ``kx_new``: bx, gx, gy) and K^T y of ``old``
    (``ktyp``), segment-wise sqrt(Sigma): a plane for v, a constant for q.
    Returns (pd_v, pd_x, pd_y, zh_v, zh_x, zh_y, dd, wh)."""
    _, _, dxt, dyt, _, conv_adj = ops
    x, yv, qx, qy = old
    x2, yv2, qx2, qy2 = new
    bx, gx, gy = kx_old
    bx2, gx2, gy2 = kx_new
    kty2 = conv_adj(yv2) + dxt(qx2) + dyt(qy2)
    sqrt_sv = torch.sqrt(sv)
    sqrt_sq = sig_q ** 0.5
    sqrt_t = tau_t ** 0.5
    inv_v = 1.0 / (sigma_raw * sqrt_sv)
    inv_q = 1.0 / (sigma_raw * sqrt_sq)
    zh_v = (yv - yv2) * inv_v + sqrt_sv * ((1.0 + theta) * bx2 - theta * bx)
    zh_x = (qx - qx2) * inv_q + sqrt_sq * ((1.0 + theta) * gx2 - theta * gx)
    zh_y = (qy - qy2) * inv_q + sqrt_sq * ((1.0 + theta) * gy2 - theta * gy)
    pd_v = zh_v - sqrt_sv * bx2
    pd_x = zh_x - sqrt_sq * gx2
    pd_y = zh_y - sqrt_sq * gy2
    wh = (x - x2) * (1.0 / (tau_raw * sqrt_t)) - sqrt_t * ktyp
    dd = wh + sqrt_t * kty2
    return pd_v, pd_x, pd_y, zh_v, zh_x, zh_y, dd, wh


def _owned_rows(nrows: int, band, device):
    """The owned rows of ``band`` = (row_offset, own_lo, own_hi) of
    ``nrows`` as an (nrows, 1) mask."""
    li = torch.arange(nrows, device=device)[:, None]
    return (li >= band[1]) & (li < band[2])


def _owned_sum(nrows: int, band, device):
    """The sum of a plane over the owned rows of ``band`` (None: every
    row, ``torch.sum``)."""
    if band is None:
        return torch.sum
    owned = _owned_rows(nrows, band, device)

    def nsum(v):
        return torch.sum(torch.where(owned, v, 0.0))

    return nsum


def _norm_sums(res, nsum):
    """The four squared norms from ``_residuals``' planes."""
    pd_v, pd_x, pd_y, zh_v, zh_x, zh_y, dd, wh = res
    return (
        nsum(pd_v * pd_v) + nsum(pd_x * pd_x) + nsum(pd_y * pd_y),
        nsum(zh_v * zh_v) + nsum(zh_x * zh_x) + nsum(zh_y * zh_y),
        nsum(dd * dd),
        nsum(wh * wh),
    )


def chunk_core(tau_raw, sigma_raw, theta, lmb, radius, x0, yv0, qx0, qy0, fb,
               sv, count: int, nx: int, ny: int, taps, sig_q: float,
               tau_t: float, band=None):
    """``count - 1`` plain iterations, then the aligned iteration with its
    four preconditioned residual norms (squared), on planes embedded in
    fb.shape, the yv grid: the JAX package's ``_chunk_core``.  ``band`` =
    (row_offset, own_lo, own_hi) runs it on a halo-extended band of the yv
    grid's rows, its masks on global rows and its norms over the owned
    rows; None is the whole plane.

    Returns (x2, yv2, qx2, qy2, x_prev, yv_prev, qx_prev, qy_prev, norms),
    all embedded."""
    nrows, ny2 = fb.shape
    row_offset = 0 if band is None else band[0]
    ops = _chunk_ops(nx, ny, nrows, ny2, taps, fb.device, row_offset)
    update = _iteration(ops, tau_raw, sigma_raw, theta, lmb, radius, fb, sv,
                        sig_q, tau_t)
    conv_fwd, dx, dy = ops[4], ops[0], ops[1]
    x, yv, qx, qy = x0, yv0, qx0, qy0
    bx, gx, gy = conv_fwd(x0), dx(x0), dy(x0)
    for _ in range(count - 1):
        x, yv, qx, qy, bx, gx, gy, _ = update(x, yv, qx, qy, bx, gx, gy)
    # aligned iteration; (bx, gx, gy) = K x_prev carried for free
    x2, yv2, qx2, qy2, bx2, gx2, gy2, ktyp = update(x, yv, qx, qy, bx, gx,
                                                    gy)
    res = _residuals(ops, tau_raw, sigma_raw, theta, sv, sig_q, tau_t,
                     (x, yv, qx, qy), (x2, yv2, qx2, qy2), (bx, gx, gy),
                     (bx2, gx2, gy2), ktyp)
    norms = _norm_sums(res, _owned_sum(nrows, band, fb.device))
    return x2, yv2, qx2, qy2, x, yv, qx, qy, norms


def embed(a, nx2, ny2):
    """Zero-pad the last two axes of ``a`` to (nx2, ny2)."""
    return torch.nn.functional.pad(a, (0, ny2 - a.shape[-1],
                                       0, nx2 - a.shape[-2]))


def deblur_chunk_plain(x, yv, q, fb, sv, scal, count: int, taps,
                       sig_q: float, tau_t: float, nx_global=None):
    """Plain PyTorch version of ``deblur_chunk`` (any device); with
    ``nx_global``, the image's rows, that of ``deblur_chunk_halo`` (it reads
    the row context of ``scal`` on the host)."""
    nx, ny = x.shape
    nx2, ny2 = yv.shape
    band, n_scal, nx_img = None, 5, nx
    if nx_global is not None:
        band = tuple(int(v) for v in scal[5:N_HALO_SCAL].tolist())
        n_scal, nx_img = N_HALO_SCAL, int(nx_global)
    qe = embed(q, nx2, ny2)
    x2, yv2, qx2, qy2, xp, yvp, qxp, qyp, norms = chunk_core(
        scal[0], scal[1], scal[2], scal[3], scal[4], embed(x, nx2, ny2), yv,
        qe[0], qe[1], fb, sv, int(count), nx_img, ny, taps, sig_q, tau_t,
        band)
    crop = (..., slice(0, nx), slice(0, ny))
    n2 = torch.stack(norms)
    conv = entry_converged(scal, n_scal)
    return (torch.where(conv, x, x2[crop]), torch.where(conv, yv, yv2),
            torch.where(conv, q, torch.stack([qx2, qy2])[crop]),
            torch.where(conv, x, xp[crop]), torch.where(conv, yv, yvp),
            torch.where(conv, q, torch.stack([qxp, qyp])[crop]),
            torch.where(conv, torch.zeros_like(n2), n2))


def deblur_chunk_batched_plain(x, yv, q, fb, sv, scal, count: int, taps,
                               sig_q: float, tau_t: float):
    """Plain PyTorch version of ``deblur_chunk_batched`` (any device):
    ``deblur_chunk_plain`` vmapped over the frames."""
    return vmap_plain(deblur_chunk_plain, (x, yv, q, fb, sv), scal,
                      int(count), taps, sig_q, tau_t)


def deblur_tiled_halo(taps) -> int:
    """The least halo of the tiled chunk's window, in pixels on every side
    of a tile: the primal step at a pixel reads q one pixel up and left
    and yv up to the blur's reach down and right, the dual step reads the
    new x up to the reach up and left and one pixel down and right, so the
    owned pixels need the new x on the tile and reach pixels up and left,
    one down and right, which needs the state reach + 1 pixels out; reach
    = the taps' largest row or column shift, at least the gradient's 1."""
    reach = max(max(max(dx, dy) for dx, dy, _ in taps), 1)
    return reach + 1


def deblur_chunk_tiled_plain(x, yv, q, fb, sv, scal, count: int, taps,
                             sig_q: float, tau_t: float, nx_global=None,
                             tile=(64, 64), halo=None,
                             partials: bool = False):
    """The tiled chunk (``deblur_chunk_`` and ``deblur_chunk_halo_`` with
    ``path="tiled"``) window by window: each iteration ``chunk_core``'s
    arithmetic on every tile of the yv grid's window (the tile of ``tile``
    rows and columns and ``halo`` pixels on every side, clamped at the
    planes' edges, ``deblur_tiled_halo`` by default; every mask decided by
    the pixel's place in the planes), K x of the iterate recomputed in the
    window, the owned pixels stitched into new planes; then the norms of
    the stitched planes, K x and K^T y recomputed.  With ``nx_global``
    the halo form (the row context read from ``scal``).  Returns
    ``deblur_chunk_plain``'s outputs; with ``partials`` also the 32x8
    tiles' partials of the yv grid (``fused_rof.tile_partials``) that the
    kernel's finish reduces."""
    nx, ny = x.shape
    nx2, ny2 = yv.shape
    band, n_scal, nx_img = None, 5, nx
    if nx_global is not None:
        band = tuple(int(v) for v in scal[5:N_HALO_SCAL].tolist())
        n_scal, nx_img = N_HALO_SCAL, int(nx_global)
    row_offset = 0 if band is None else band[0]
    h = deblur_tiled_halo(taps) if halo is None else int(halo)
    tx, ty = (int(t) for t in tile)
    consts = (scal[0], scal[1], scal[2], scal[3], scal[4])
    qe = embed(q, nx2, ny2)
    planes = [embed(x, nx2, ny2), yv, qe[0], qe[1]]
    for _ in range(int(count)):
        prev, planes = planes, [torch.empty_like(a) for a in planes]
        for R0 in range(0, nx2, tx):
            for C0 in range(0, ny2, ty):
                R1, C1 = min(R0 + tx, nx2), min(C0 + ty, ny2)
                r0, c0 = max(R0 - h, 0), max(C0 - h, 0)
                r1, c1 = min(R1 + h, nx2), min(C1 + h, ny2)
                win = (slice(r0, r1), slice(c0, c1))
                ops = _chunk_ops(nx_img, ny, nx2, ny2, taps, fb.device,
                                 row_offset, (r0, c0, r1 - r0, c1 - c0))
                update = _iteration(ops, *consts, fb[win], sv[win], sig_q,
                                    tau_t)
                xw = prev[0][win]
                res = update(*(a[win] for a in prev), ops[4](xw), ops[0](xw),
                             ops[1](xw))
                own = (slice(R0 - r0, R1 - r0), slice(C0 - c0, C1 - c0))
                for dst, src in zip(planes, res[:4]):
                    dst[R0:R1, C0:C1] = src[own]
    ops = _chunk_ops(nx_img, ny, nx2, ny2, taps, fb.device, row_offset)
    dx, dy, dxt, dyt, conv_fwd, conv_adj = ops
    xp, yvp, qxp, qyp = prev
    x2 = planes[0]
    res = _residuals(ops, consts[0], consts[1], consts[2], sv, sig_q, tau_t,
                     prev, planes, (conv_fwd(xp), dx(xp), dy(xp)),
                     (conv_fwd(x2), dx(x2), dy(x2)),
                     conv_adj(yvp) + dxt(qxp) + dyt(qyp))
    norms = torch.stack(_norm_sums(res, _owned_sum(nx2, band, fb.device)))
    crop = (..., slice(0, nx), slice(0, ny))
    conv = entry_converged(scal, n_scal)
    out = (torch.where(conv, x, x2[crop]), torch.where(conv, yv, planes[1]),
           torch.where(conv, q, torch.stack(planes[2:])[crop]),
           torch.where(conv, x, xp[crop]), torch.where(conv, yv, yvp),
           torch.where(conv, q, torch.stack([qxp, qyp])[crop]),
           torch.where(conv, torch.zeros_like(norms), norms))
    if not partials:
        return out
    from .fused_rof import tile_partials

    pd_v, pd_x, pd_y, zh_v, zh_x, zh_y, dd, wh = res
    terms = (pd_v * pd_v + (pd_x * pd_x + pd_y * pd_y),
             zh_v * zh_v + (zh_x * zh_x + zh_y * zh_y), dd * dd, wh * wh)
    if band is not None:
        owned = _owned_rows(nx2, band, fb.device)
        terms = tuple(torch.where(owned, t, 0.0) for t in terms)
    return out + (tile_partials(terms),)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def host_taps(taps):
    """The taps as the tiled launch also takes them, on the host: a ctypes
    array of the (3, T) float32 values [dx; dy; w] in ``ordered_taps``
    order (made once per taps), which its kernel receives as a
    parameter."""
    vals = [float(v) for col in zip(*ordered_taps(taps)) for v in col]
    return (ctypes.c_float * len(vals))(*vals)


@functools.lru_cache(maxsize=16)
def taps_array(taps, device) -> torch.Tensor:
    """The taps as the kernel takes them: a (3, T) float32 array [dx; dy;
    w] on ``device``, in ``ordered_taps`` order (made once per taps and
    device)."""
    order = ordered_taps(taps)
    return torch.tensor([list(col) for col in zip(*order)],
                        dtype=torch.float32, device=device)


def _check(x, yv, q, fb, sv, scal, count: int, taps, batched: bool = False,
           halo: bool = False):
    if int(count) < 1:
        raise ProstError("A chunk needs count >= 1.")
    lead = x.shape[:1] if batched else ()
    k = len(lead)
    if x.dim() != 2 + k or min(x.shape[k:]) < 2:
        what = "a (B, nx, ny) stack" if batched else "an (nx, ny) plane"
        raise ProstError(f"x must be {what}, got {tuple(x.shape)}.")
    nx, ny = x.shape[k:]
    if yv.dim() != 2 + k or yv.shape[k] < nx or yv.shape[k + 1] < ny:
        what = "a (B, nx2, ny2) stack" if batched else "an (nx2, ny2) plane"
        raise ProstError(f"yv must be {what} with nx2 >= {nx}, ny2 >= {ny}, "
                         f"got {tuple(yv.shape)}.")
    nx2, ny2 = yv.shape[k:]
    if halo and nx2 != nx:
        raise ProstError(f"A halo band's x and yv have the same rows, got "
                         f"{nx} and {nx2}.")
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ProstError(f"The kernel takes 1 to {MAX_TAPS} taps, got "
                         f"{len(taps)}.")
    # a band's rows do not bound the row shifts, the image's do
    kx = nx2 - nx if not halo else max(dx for dx, _, _ in taps)
    for dx, dy, _ in taps:
        if not (0 <= dx <= kx and 0 <= dy <= ny2 - ny):
            raise ProstError(f"Tap ({dx}, {dy}) lies outside the "
                             f"{kx + 1}x{ny2 - ny + 1} kernel.")
    check_buffers("deblur", (("x", x, (*lead, nx, ny)),
                             ("yv", yv, (*lead, nx2, ny2)),
                             ("q", q, (*lead, 2, nx, ny)),
                             ("fb", fb, (*lead, nx2, ny2)),
                             ("sv", sv, (*lead, nx2, ny2))),
                  scal, N_HALO_SCAL if halo else 5,
                  lead[0] if batched else None)


def _lib():
    """The fused deblur kernel library, built from csrc/fused_deblur.cu on
    first use."""
    head = [VP] * 15 + [CI] * 5 + [CF] * 4
    resident = [VP] * 12 + [CI] * 6 + [CF] * 4
    strides = [ctypes.c_longlong] * 3
    return typed_lib("fused_deblur", "prost_deblur_num_blocks", {
        "prost_deblur_chunk": head + [CI, VP],
        "prost_deblur_chunk_batched": head + strides + [CI, CI, VP],
        "prost_deblur_chunk_halo": head + [CI, CI, VP],
        "prost_deblur_chunk_resident": resident + [CI, CI, VP],
        "prost_deblur_chunk_batched_resident": resident + strides
                                               + [CI, CI, CI, VP],
        "prost_deblur_resident_smem": [CI],
        "prost_deblur_chunk_tiled": resident + [CI] * 4 + [VP, VP],
        "prost_deblur_tiled_smem": [],
        "prost_deblur_tiled_bytes": [CI] * 3})


def taps_reach(taps) -> int:
    """The blur's largest row shift: the rows above and below its band
    that a grid-resident block copies from its neighbours."""
    return max(dx for dx, _, _ in taps)


def resident_bytes(nx2: int, ny: int, ny2: int, taps, sms: int) -> int:
    """The dynamic shared memory of one block of the grid-resident chunk
    on a yv grid of ``nx2`` rows (the whole plane's, or a halo band's) over
    ``sms`` blocks: csrc/fused_deblur.cu's DBRes for the largest band
    (deblur_resident_floats), at least the reductions' array."""
    rmax, reach = resident_rows(nx2, sms), taps_reach(taps)
    floats = ((6 * rmax + reach + 2) * int(ny)
              + (4 * rmax + reach) * int(ny2))
    return max(4 * floats, RES_RED_BYTES)


def resident_ok(nx2: int, ny: int, ny2: int, taps, sms: int,
                smem: int) -> bool:
    """The shape rule of ``deblur_chunk_``, ``deblur_chunk_halo_`` and, on
    one frame, ``deblur_chunk_batched_``: a chunk on a yv grid of ``nx2``
    rows runs as one grid-resident launch (csrc/fused_deblur.cu
    deblur_resident, deblur_resident_batched; one block per SM) where the
    planes of its largest band fit in ``smem`` bytes of a block's dynamic
    shared memory on a card of ``sms`` SMs, and as the streaming launch
    sequence otherwise."""
    return resident_bytes(nx2, ny, ny2, taps, sms) <= int(smem)


def pairs_ok(nx2: int, ny: int, ny2: int, taps, sms: int, smem: int) -> bool:
    """Whether the grid-resident batched chunk can run its frames two at a
    time (csrc/fused_deblur.cu deblur_resident_batched<N, 2>, two thread
    groups a block): two frames' bands fit in ``smem`` bytes of a block's
    dynamic shared memory."""
    return 2 * resident_bytes(nx2, ny, ny2, taps, sms) <= int(smem)


# the tiled launch's window planes (csrc/fused_deblur.cu deblur_tiled: x
# after the primal step, and two sets of x, yv, q_x and q_y, the next
# window's loaded under the current one's stencils; one set where two do
# not fit)
_TILED_PLANES = (9, 5)
# what a window costs beyond its pixels (its barriers and its walks'
# set-up), in pixels: with it the tile rule picks the fastest of the tiles
# tools/deblur_tiled_probe.py timed on an H100 at 2048x2048 (7 taps) and
# 1024x1024 (7 to 81 taps), where counting pixels alone picks tiles up to
# 1.3x slower
_TILED_FIXED = 500


def deblur_tiled_bytes(tx: int, ty: int, taps, smem=None) -> int:
    """The dynamic shared memory of one block of the tiled launch
    (csrc/fused_deblur.cu deblur_tiled_bytes, prost_deblur_tiled_bytes) on
    a card whose blocks may hold ``smem`` bytes: nine planes of the window
    of a ``tx`` x ``ty`` tile with ``deblur_tiled_halo(taps)`` pixels on
    every side where they fit (``smem`` None: always), else five.  f_b and
    Sigma_v are read pixel by pixel from device memory in the dual step,
    and the norm pass reduces its tiles in registers."""
    h = deblur_tiled_halo(taps)
    two = _window_bytes(int(tx), int(ty), h, _TILED_PLANES[0])
    if smem is None or two <= int(smem):
        return two
    return _window_bytes(int(tx), int(ty), h, _TILED_PLANES[1])


def _window_bytes(tx: int, ty: int, h: int, planes: int) -> int:
    return 4 * planes * (tx + 2 * h) * (ty + 2 * h)


def deblur_tiled_tile(nx2: int, ny2: int, taps, sms: int, smem: int):
    """The owned tile (rows, columns) of the tiled launch on a yv grid of
    (nx2, ny2) on a card of ``sms`` SMs whose blocks may hold ``smem``
    bytes of dynamic shared memory: of the tiles (rows a multiple of 8,
    columns of 32, so every 32x8 norm tile lies in one) whose window's two
    sets of planes fit (``deblur_tiled_bytes``), else of those whose one
    set fits, the one whose iteration moves the fewest window pixels
    through the SMs (the rounds of one block per SM times a whole tile's
    window and ``_TILED_FIXED`` pixels more, a window's barriers and set-up;
    with two sets one round more, a block's first window, whose loads no
    stencil hides), the larger tile on a tie; None where no tile's window
    fits."""
    return _tiled_tile(int(nx2), int(ny2), deblur_tiled_halo(taps),
                       int(sms), int(smem))


@functools.lru_cache(maxsize=None)
def _tiled_tile(nx2: int, ny2: int, h: int, sms: int, smem: int):
    """``deblur_tiled_tile`` for the halo ``h``, searched once per shape."""
    from .fused_rof import window_tile

    for planes, lead in zip(_TILED_PLANES, (1, 0)):
        tile = window_tile(nx2, ny2, 2 * h, sms, lambda tx, ty: _window_bytes(
            tx, ty, h, planes) <= smem, lead=lead, fixed=_TILED_FIXED)
        if tile is not None:
            return tile
    return None


def deblur_tiled_ok(nx2: int, ny2: int, taps, sms: int, smem: int) -> bool:
    """Whether the tiled launch takes a yv grid of (nx2, ny2): some tile's
    window fits in ``smem`` bytes, and twice its pixels stay within the
    kernel's int offsets."""
    return (2 * int(nx2) * int(ny2) < 2 ** 31
            and deblur_tiled_tile(nx2, ny2, taps, sms, smem) is not None)


def deblur_tiled_windows(nx: int, ny: int, nx2: int, ny2: int, tile,
                         h: int, off: int = 0, nx_global=None) -> tuple:
    """(interior, edge): the corners (R0, C0) of the tiled launch's tiles
    of ``tile`` with halo ``h`` on x planes of (nx, ny) and a yv grid of
    (nx2, ny2), split as csrc/fused_deblur.cu deblur_tiled_body splits
    them: a window within the image's and the x plane's rows and the
    image's columns runs its stencils untested, the others test every
    read.  A halo band's local row 0 is global row ``off`` of
    ``nx_global`` image rows."""
    tx, ty = (int(t) for t in tile)
    last = min(nx, int(nx if nx_global is None else nx_global) - off)
    inner, edge = [], []
    for R0 in range(0, nx2, tx):
        for C0 in range(0, ny2, ty):
            ok = (R0 - h >= 0 and R0 - h + off >= 0
                  and min(R0 + tx, nx2) + h <= last
                  and C0 - h >= 0 and min(C0 + ty, ny2) + h <= ny)
            (inner if ok else edge).append((R0, C0))
    return inner, edge


def deblur_route_of(nx2: int, ny: int, ny2: int, taps, sms: int, smem: int,
                    tiled_smem: int) -> str:
    """The shape rule of ``deblur_chunk_`` and ``deblur_chunk_halo_`` (on
    the band's rows) on a card of ``sms`` SMs whose grid-resident blocks
    may hold ``smem`` bytes and tiled blocks ``tiled_smem``: "resident"
    where the bands' planes fit (``resident_ok``: config 2 at 512x512 on an
    H100), else "tiled" where a tile's window fits (``deblur_tiled_ok``:
    2048x2048), else "streaming"."""
    if resident_ok(nx2, ny, ny2, taps, sms, smem):
        return "resident"
    if deblur_tiled_ok(nx2, ny2, taps, sms, tiled_smem):
        return "tiled"
    return "streaming"


@functools.lru_cache(maxsize=None)
def deblur_tiled_limit(device) -> int:
    """The dynamic shared memory a block of the tiled launch may hold on
    the card ``device``, read once."""
    with torch.cuda.device(device):
        smem = _lib().prost_deblur_tiled_smem()
    if smem < 0:
        raise ProstError(f"deblur_chunk: no shared-memory limit for the "
                         f"tiled chunk on {device} (CUDA error {-smem}).")
    return smem


def deblur_pick_route(path, nx2: int, ny: int, ny2: int, taps, device,
                      what: str) -> tuple:
    """(path, tile) of a single-instance chunk on the card ``device``: by
    ``deblur_route_of`` where ``path`` is None, else the one asked for;
    "resident" where the planes do not fit, or "tiled" where no tile's
    window does, raises ``ProstError``.  ``tile`` is the tiled launch's
    (rows, columns), else None."""
    check_path(path, what)
    sms, smem = card_limits(device)
    tsmem = deblur_tiled_limit(device)
    if path is None:
        path = deblur_route_of(nx2, ny, ny2, taps, sms, smem, tsmem)
    if path == "resident" and not resident_ok(nx2, ny, ny2, taps, sms, smem):
        raise ProstError(f"{what}: the chunk's planes do not fit in the "
                         "shared memory of one block per SM.")
    tile = None
    if path == "tiled":
        tile = deblur_tiled_tile(nx2, ny2, taps, sms, tsmem)
        if tile is None:
            raise ProstError(f"{what}: no tile's window holds the blur's "
                             "halo in the shared memory of a block.")
    return path, tile


# the kernels whose shared-memory limit card_limits reads
SINGLE, BATCHED, PAIRS = 0, 1, 2


@functools.lru_cache(maxsize=None)
def card_limits(device, kind: int = SINGLE) -> tuple:
    """(SMs, the dynamic shared memory a block of the grid-resident chunk,
    of kind ``SINGLE``, ``BATCHED`` or ``PAIRS``, may hold) of the card
    ``device``, read once."""
    lib = _lib()
    with torch.cuda.device(device):
        smem = lib.prost_deblur_resident_smem(int(kind))
    if smem < 0:
        raise ProstError(f"deblur_chunk: no shared-memory limit for the "
                         f"resident chunk on {device} (CUDA error {-smem}).")
    return card_sms(device), smem


def _scratch(path: str, nx, ny, nx2, ny2, device, batch: int = 0,
             pairs: bool = False):
    """A chunk launch's scratch on ``path``: the grid-resident chunk's norm
    terms (4 planes of the yv grid, which a batched launch's frames share;
    8 where it runs them two at a time), the tiled chunk's second slot of
    the state (x, yv and q: 3 nx ny + nx2 ny2 floats) and its last
    iteration's w_hat (a plane of the x grid), or the streaming
    sequence's carried planes (B x and grad x, of this iterate and of the
    previous one; with ``batch``, of every frame)."""
    lead = (batch,) if batch else ()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    if path == "resident":
        return [empty(8 if pairs else 4, nx2, ny2)]
    if path == "tiled":
        return [empty(4 * nx * ny + nx2 * ny2)]
    return [empty(*lead, nx2, ny2), empty(*lead, nx2, ny2),
            empty(*lead, 2, nx, ny), empty(*lead, 2, nx, ny)]


def _launch_chunk(what: str, state, prev, fb, sv, taps_t, sc, partial,
                  scratch, route: tuple, count: int, taps, sig_q: float,
                  tau_t: float, nx_global=None):
    """One chunk on the card in place on ``state`` (x, yv, q) and ``prev``:
    the grid-resident launch, the tiled launch or the streaming sequence,
    by ``route`` = (path, tile) of ``deblur_pick_route``, of the whole
    plane or (with ``nx_global``) of a halo band, counted under ``what``
    (and a tiled call also under ``what`` + "_tiled")."""
    x, yv = state[0], state[1]
    nx, ny = x.shape
    nx2, ny2 = yv.shape
    shape = (nx, ny, nx2, ny2, len(taps))
    # sqrt(Sigma_q) and sqrt(Tau) rounded once from double, as the plain
    # version rounds its Python constants
    roots = (sig_q, tau_t, sig_q ** 0.5, tau_t ** 0.5)
    lib = _lib()
    path, tile = route
    if path != "streaming":
        reach, tail = ((taps_reach(taps), ()) if path == "resident" else
                       (deblur_tiled_halo(taps),
                        (*tile, host_taps(tuple(map(tuple, taps))))))
        launch(lib, f"prost_deblur_chunk_{path}", what, launch_counts,
               x.device, [*state, *prev, fb, sv, taps_t, sc, partial,
                          *scratch], *shape, reach, *roots,
               int(nx_global or 0), int(count), *tail)
        if path == "tiled":
            launch_counts[what + "_tiled"] += 1
    else:
        fn, tail = (("prost_deblur_chunk", ()) if nx_global is None else
                    ("prost_deblur_chunk_halo", (int(nx_global),)))
        launch(lib, fn, what, launch_counts, x.device,
               [*state, *prev, *scratch, fb, sv, taps_t, sc, partial],
               *shape, *roots, *tail, int(count))


def _inplace(what: str, state, prev, fb, sv, scal, n_scal: int, count: int,
             taps, sig_q: float, tau_t: float, nx_global, path):
    """One chunk on the card in place, its buffers made for this call;
    returns norms2."""
    x, yv = state[0], state[1]
    nx, ny = x.shape
    nx2, ny2 = yv.shape
    dev = x.device
    route = deblur_pick_route(path, nx2, ny, ny2, taps, dev, what)
    sc = scalar_buffer(scal, n_scal, S_CONV, S_LEN)
    partial = torch.empty(4 * _lib().prost_deblur_num_blocks(nx2, ny2),
                          dtype=torch.float32, device=dev)
    _launch_chunk(what, state, prev, fb.contiguous(), sv.contiguous(),
                  taps_array(tuple(taps), dev), sc, partial,
                  _scratch(route[0], nx, ny, nx2, ny2, dev), route, count,
                  taps, sig_q, tau_t, nx_global)
    return sc[S_NORM:S_NORM + 4]


def deblur_chunk(x, yv, q, fb, sv, scal, count: int, taps, sig_q: float,
                 tau_t: float):
    """``count`` fused iterations ending on a residual iteration.

    x: (nx, ny); q: (2, nx, ny); yv, fb (the blurred data) and sv
    (Sigma_v): (nx2, ny2); taps: the nonzero (dx, dy, weight) of the
    (kx, ky) kernel, kx = nx2 - nx + 1; sig_q, tau_t: the constant Sigma
    of the gradient rows and Tau; scal: [tau, sigma, theta, lmb, radius]
    (+ an optional converged flag: when set, nothing runs and the inputs
    come back).  Returns (x2, yv2, q2, x_prev, yv_prev, q_prev, norms2),
    norms2 the 4 SQUARED preconditioned residual norms, on the inputs'
    device.  CPU tensors run the plain version; CUDA tensors run
    ``deblur_chunk_`` on copies."""
    _check(x, yv, q, fb, sv, scal, count, taps)
    if x.device.type == "cpu":
        return deblur_chunk_plain(x, yv, q, fb, sv, scal, count, taps, sig_q,
                                  tau_t)
    return halo_copy(deblur_chunk_, (x, yv, q), fb, sv, scal, count, taps,
                     sig_q, tau_t)


def deblur_chunk_(x, yv, q, x_prev, yv_prev, q_prev, fb, sv, scal,
                  count: int, taps, sig_q: float, tau_t: float, path=None):
    """``deblur_chunk`` in place: (x, yv, q) advance by ``count`` iterations
    and the previous buffers take the iterate before the aligned one; with
    the converged flag set nothing changes.  Returns norms2.  On a card
    ``path`` None takes the shape rule's path (``deblur_route_of``): one
    grid-resident launch (csrc/fused_deblur.cu deblur_resident) where the
    planes fit on chip, else one tiled cooperative launch (deblur_tiled:
    overlapping 2-D windows, a grid barrier an iteration) and the finish
    where a tile's window does, else the streaming launch sequence;
    "resident", "tiled" or "streaming" asks for one ("resident" and
    "tiled" raise where they cannot launch).  On the CPU every path runs
    the plain version."""
    state, prev = (x, yv, q), (x_prev, yv_prev, q_prev)
    _check(*state, fb, sv, scal, count, taps)
    check_path(path, "deblur_chunk_")
    check_inplace(state, prev)
    if x.device.type == "cpu":
        return halo_into(state, prev, deblur_chunk_plain(
            *state, fb, sv, scal, count, taps, sig_q, tau_t), scal, 5)
    return _inplace("deblur_chunk", state, prev, fb, sv, scal, 5, count,
                    taps, sig_q, tau_t, None, path)


def deblur_halo_rows(count: int, taps) -> int:
    """The halo of a deblur chunk on a band of the yv grid's rows: a chunk
    of ``count`` iterations applies 2 count + 2 operators along the rows,
    each spreading information by the blur's row reach (its largest row
    shift, at least the gradient's 1)."""
    reach = max(max(dx for dx, _, _ in taps), 1)
    return (2 * int(count) + 2) * reach


def deblur_chunk_halo(x, yv, q, fb, sv, scal, count: int, nx_global: int,
                      taps, sig_q: float, tau_t: float):
    """``deblur_chunk`` on one halo-extended band of the rows of the yv
    grid (nx2, ny2) of an image of ``nx_global`` rows.

    x: (nxb, ny); q: (2, nxb, ny); yv, fb, sv: (nxb, ny2): the band's rows
    of each plane at the same global rows of the yv grid, its neighbours'
    halo rows above and below, zeros beyond the planes (x and q have
    nx_global rows, the others nx2); scal: [tau, sigma, theta, lmb, radius,
    row_offset, own_lo, own_hi] (+ an optional converged flag), row_offset
    the global row of local row 0 and [own_lo, own_hi) the owned local
    rows.  Returns the tuple of ``deblur_chunk``, norms2 over the owned rows
    only.  CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    return halo_copy(deblur_chunk_halo_, (x, yv, q), fb, sv, scal, count,
                     nx_global, taps, sig_q, tau_t)


def deblur_chunk_halo_(x, yv, q, x_prev, yv_prev, q_prev, fb, sv, scal,
                       count: int, nx_global: int, taps, sig_q: float,
                       tau_t: float, path=None):
    """``deblur_chunk_halo`` in place, on the sharded route's persistent
    buffers: (x, yv, q) advance by ``count`` iterations and the previous
    buffers take the iterate before the aligned one; with the converged
    flag set nothing changes.  Returns norms2.  ``path`` as for
    ``deblur_chunk_``, the shape rule on the band's rows."""
    state, prev = (x, yv, q), (x_prev, yv_prev, q_prev)
    _check(*state, fb, sv, scal, count, taps, halo=True)
    check_path(path, "deblur_chunk_halo_")
    check_halo(nx_global, state, prev)
    if x.device.type == "cpu":
        return halo_into(state, prev, deblur_chunk_plain(
            *state, fb, sv, scal, count, taps, sig_q, tau_t, nx_global),
            scal)
    return _inplace("deblur_chunk_halo", state, prev, fb, sv, scal,
                    N_HALO_SCAL, count, taps, sig_q, tau_t, int(nx_global),
                    path)


class DeblurChunk(LightChunk):
    """The deblur routes' light chunk call: ``deblur_chunk_`` (with
    ``band`` = (nx_global, rows, row_offset, own_lo, own_hi),
    ``deblur_chunk_halo_`` on a band of ``rows`` rows) on the planes a route
    holds, with what depends only on the shapes made once per route: the
    path (``route``: ``deblur_pick_route``'s (path, tile), by the shape
    rule unless ``path`` asks for one), the taps' device array, the
    scratch, the norm partials and the scalar buffer with ``m``'s lmb and
    radius (and the band's row context).  A call writes the step sizes and
    the flag into the scalar buffer and launches; on the CPU it runs the
    plain version."""

    def __init__(self, m, count: int, device, band=None, path=None):
        consts = (m["lmb"], m["radius"]) + tuple(band[2:] if band else ())
        super().__init__(consts, device)
        self.m, self.count, self.band = m, int(count), band
        nx, ny, nx2, ny2 = (m[k] for k in ("nx", "ny", "nx2", "ny2"))
        if band is not None:
            nx = nx2 = int(band[1])
        self.what = "deblur_chunk" if band is None else "deblur_chunk_halo"
        self.nx_global = None if band is None else int(band[0])
        self.route = None  # (path, tile) on a card
        if torch.device(device).type == "cuda":
            self.route = deblur_pick_route(path, nx2, ny, ny2, m["taps"],
                                           device, self.what)
            self.taps_t = taps_array(m["taps"], device)
            self.partial = torch.empty(
                4 * _lib().prost_deblur_num_blocks(nx2, ny2),
                dtype=torch.float32, device=device)
            self.scratch = _scratch(self.route[0], nx, ny, nx2, ny2, device)

    @property
    def resident(self):
        """Whether the call runs grid-resident on a card; None on the
        CPU."""
        return None if self.route is None else self.route[0] == "resident"

    def __call__(self, state, prev, fb, sv, tau, sigma, theta, converged):
        """``count`` iterations on ``state`` (x, yv, q) in place, the
        previous iterate into ``prev``; returns norms2."""
        self.scalars_(tau, sigma, theta, converged)
        m = self.m
        if self.route is None:
            scal = self.scal()
            return halo_into(state, prev, deblur_chunk_plain(
                *state, fb, sv, scal, self.count, m["taps"], m["sig_q"],
                m["tau_t"], self.nx_global), scal, self.n_scal)
        _launch_chunk(self.what, state, prev, fb, sv, self.taps_t, self.sc,
                      self.partial, self.scratch, self.route, self.count,
                      m["taps"], m["sig_q"], m["tau_t"], self.nx_global)
        return self.norms2()


def deblur_chunk_batched(x, yv, q, fb, sv, scal, count: int, taps,
                         sig_q: float, tau_t: float):
    """``deblur_chunk`` for each of B frames that share one blur (the taps,
    sig_q and tau_t) in one launch (sequence).

    x: (B, nx, ny); q: (B, 2, nx, ny); yv, fb, sv: (B, nx2, ny2); scal: (5,
    B), a row each of tau, sigma, theta, lmb and radius (+ an optional row
    of converged flags: a frame whose flag is set runs nothing and gets its
    inputs back).  Returns (x2, yv2, q2, x_prev, yv_prev, q_prev, norms2),
    norms2 (4, B) the SQUARED preconditioned residual norms of each frame.
    Frame b comes out as ``deblur_chunk`` on frame b alone.  CPU tensors run
    the plain version; CUDA tensors run ``deblur_chunk_batched_`` on
    copies."""
    _check(x, yv, q, fb, sv, scal, count, taps, batched=True)
    if x.device.type == "cpu":
        return deblur_chunk_batched_plain(x, yv, q, fb, sv, scal, count,
                                          taps, sig_q, tau_t)
    return halo_copy(deblur_chunk_batched_, (x, yv, q), fb, sv, scal, count,
                     taps, sig_q, tau_t)


def _launch_batched(state, prev, fb, sv, taps_t, sc, partial, scratch,
                    resident: bool, count: int, taps, sig_q: float,
                    tau_t: float, strides, pairs: bool = False):
    """One batched chunk on the card in place on ``state`` (x, yv, q) and
    ``prev``: the grid-resident launch (the frames one after another, or
    with ``pairs`` two at a time) or the streaming sequence (all at once),
    counted under ``deblur_chunk_batched``."""
    x, yv = state[0], state[1]
    B, nx, ny = x.shape
    nx2, ny2 = yv.shape[-2:]
    shape = (nx, ny, nx2, ny2, len(taps))
    # sqrt(Sigma_q) and sqrt(Tau) rounded once from double, as the plain
    # version rounds its Python constants
    roots = (sig_q, tau_t, sig_q ** 0.5, tau_t ** 0.5)
    tail = (*strides, int(count), B)
    lib = _lib()
    if resident:
        launch(lib, "prost_deblur_chunk_batched_resident",
               "deblur_chunk_batched", launch_counts, x.device,
               [*state, *prev, fb, sv, taps_t, sc, partial, *scratch],
               *shape, taps_reach(taps), *roots, *strides, int(pairs),
               int(count), B)
    else:
        launch(lib, "prost_deblur_chunk_batched", "deblur_chunk_batched",
               launch_counts, x.device,
               [*state, *prev, *scratch, fb, sv, taps_t, sc, partial],
               *shape, *roots, *tail)


def deblur_chunk_batched_(x, yv, q, x_prev, yv_prev, q_prev, fb, sv, scal,
                          count: int, taps, sig_q: float, tau_t: float,
                          path=None):
    """``deblur_chunk_batched`` in place: every frame of (x, yv, q)
    advances by ``count`` iterations and the previous buffers take its
    iterate before the aligned one; a frame whose flag is set changes
    nothing.  yv and q may be views of a route's flat y (see
    ``instance_strides``).  Returns norms2 (4, B).  On a card ``path``
    None takes the shape rule's path (``resident_ok`` on one frame,
    whatever B): one grid-resident launch where one frame's planes fit on
    chip (csrc/fused_deblur.cu deblur_resident_batched<N, G>: G = 2 frames
    at a time side by side where two frames' bands fit in a block and
    B > 1, else one after another), else the streaming launch sequence;
    "resident" or "streaming" asks for one ("resident" raises where it
    does not fit)."""
    state, prev = (x, yv, q), (x_prev, yv_prev, q_prev)
    _check(*state, fb, sv, scal, count, taps, batched=True)
    strides = instance_strides(state, prev, "deblur_chunk_batched_")
    if x.device.type == "cpu":
        return halo_into(state, prev, deblur_chunk_batched_plain(
            *state, fb, sv, scal, count, taps, sig_q, tau_t), scal, 5)
    B, nx, ny = x.shape
    nx2, ny2 = yv.shape[-2:]
    dev = x.device
    resident = pick_path(path, resident_ok(nx2, ny, ny2, taps,
                                           *card_limits(dev, BATCHED)),
                         "deblur_chunk_batched")
    pairs = resident and _two_a_block(B, nx2, ny, ny2, taps, dev)
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = torch.empty(4 * B * _lib().prost_deblur_num_blocks(nx2, ny2),
                          dtype=torch.float32, device=dev)
    _launch_batched(state, prev, fb.contiguous(), sv.contiguous(),
                    taps_array(tuple(taps), dev), sc, partial,
                    _scratch("resident" if resident else "streaming", nx,
                             ny, nx2, ny2, dev, B, pairs),
                    resident, count, taps, sig_q, tau_t, strides, pairs)
    return sc[:, S_NORM:S_NORM + 4].T


def _two_a_block(B: int, nx2: int, ny: int, ny2: int, taps, device) -> bool:
    """Whether a grid-resident batched launch of B frames runs them two at
    a time (deblur_resident_batched<N, 2>): where two frames' bands fit in
    a block, from two frames on (one frame alone would run in both
    halves).  Two a block took 1.0183 ms a chunk of 8 frames of config 2
    against 1.1203-1.1219 one a block, in turns (NVIDIA H100 80GB HBM3,
    ``chip_smoke.py``'s ``deblur_pairs_turns``)."""
    return B > 1 and pairs_ok(nx2, ny, ny2, taps, *card_limits(device,
                                                               PAIRS))


class DeblurBatchedChunk(LightChunk):
    """``BatchedPDHG``'s light call of the batched deblur chunk:
    ``deblur_chunk_batched_`` on the views of the run's own flat x, y,
    x_prev and y_prev, with what depends only on the shapes made once per
    route: the path (``resident_ok`` on one frame; two frames a block
    where they fit), the taps' device array, the scratch, the norm
    partials and the scalar buffer with every frame's lmb and radius.  A
    call writes the step sizes and the flags into the scalar buffer and
    launches; on the CPU it runs the plain version."""

    def __init__(self, m, batch: int, count: int, device):
        super().__init__((m["lmb"], m["radius"]), device, batch)
        self.m, self.count = m, int(count)
        B = int(batch)
        nx, ny, nx2, ny2 = (m[k] for k in ("nx", "ny", "nx2", "ny2"))
        self.resident = None  # the path on a card
        if torch.device(device).type == "cuda":
            self.resident = resident_ok(nx2, ny, ny2, m["taps"],
                                        *card_limits(device, BATCHED))
            self.pairs = self.resident and _two_a_block(B, nx2, ny, ny2,
                                                        m["taps"], device)
            self.taps_t = taps_array(m["taps"], device)
            self.partial = torch.empty(
                4 * B * _lib().prost_deblur_num_blocks(nx2, ny2),
                dtype=torch.float32, device=device)
            self.scratch = _scratch(
                "resident" if self.resident else "streaming", nx, ny, nx2,
                ny2, device, B, self.pairs)

    def __call__(self, state, prev, fb, sv, tau, sigma, theta, converged):
        """``count`` iterations of every frame of ``state`` (x, yv, q) in
        place, the previous iterate into ``prev``; ``converged`` sets every
        frame's flag; returns norms2 (4, B)."""
        self.scalars_(tau, sigma, theta, converged)
        m = self.m
        if self.resident is None:
            scal = self.scal()
            out = deblur_chunk_batched_plain(*state, fb, sv, scal,
                                             self.count, m["taps"],
                                             m["sig_q"], m["tau_t"])
            return halo_into(state, prev, out, scal, self.n_scal)
        _launch_batched(state, prev, fb, sv, self.taps_t, self.sc,
                        self.partial, self.scratch, self.resident,
                        self.count, m["taps"], m["sig_q"], m["tau_t"],
                        instance_strides(state, prev,
                                         "deblur_chunk_batched_"),
                        self.pairs)
        return self.norms2()


# ---------------------------------------------------------------------------
# structure matching and the route
# ---------------------------------------------------------------------------

def kernel_taps(kernel):
    """(dx, dy, weight) of the nonzero taps of a (kx, ky) kernel, dx
    outermost, the weights the float32 values of the stored kernel."""
    k = to_numpy(kernel)
    return tuple((int(dx), int(dy), float(k[dx, dy]))
                 for dx in range(k.shape[0]) for dy in range(k.shape[1])
                 if k[dx, dy] != 0.0)


def match_deblur_structure(problem, prox_g, prox_fstar):
    """Detect the fusable deblurring structure; returns dict(nx, ny, nx2,
    ny2, taps, fb, sv, lmb, radius, sig_q, tau_t) or None.  ``prox_g`` and
    ``prox_fstar`` are the backend's lists (a MinProblem's data terms are
    prox_f, which the backend turns into prox_fstar by Moreau).

    Conditions (the model of examples/example_deblurring.py):

    * linop = [BlockConv2D(L=1) at (0, 0); BlockGradient2D(L=1,
      label_first=False) at (m2, 0)], the same (nx, ny), 1 to 96 taps;
    * prox_g = one ProxZero over the whole primal;
    * prox_fstar = Moreau(1D square, coeffs (1, fb, lmb > 0, 0, 0)) over
      the conv rows + Moreau(norm2 abs, dim-2 planar, coeffs (1, 0, r, 0,
      0)) or a norm2 ind_leq0 ball over the gradient rows;
    * alpha preconditioner: Tau and the gradient-row Sigma constant (the
      conv-row Sigma plane may vary at the boundary).

    The fused route is float32 only."""
    if config_dtype() != torch.float32:
        return None
    linop = problem.linop
    if not isinstance(linop, LinearOperator) or len(linop.blocks) != 2:
        return None
    conv = next((b for b in linop.blocks if isinstance(b, BlockConv2D)), None)
    grad = next((b for b in linop.blocks
                 if isinstance(b, BlockGradient2D)), None)
    if conv is None or grad is None:
        return None
    if conv.L != 1 or grad.L != 1 or grad.label_first:
        return None
    if conv.nx != grad.nx or conv.ny != grad.ny:
        return None
    nx, ny = conv.nx, conv.ny
    n, m2 = nx * ny, conv.nx2 * conv.ny2
    if conv.row != 0 or conv.col != 0 or grad.row != m2 or grad.col != 0:
        return None
    taps = kernel_taps(conv.kernel)
    if not taps or len(taps) > MAX_TAPS:
        return None

    # --- primal prox: zero (the data term lives on the dual side) ----------
    if len(prox_g) != 1 or not isinstance(prox_g[0], ProxZero):
        return None

    # --- dual proxes by index ----------------------------------------------
    if len(prox_fstar) != 2:
        return None
    pv = next((p for p in prox_fstar if p.index == 0), None)
    pq = next((p for p in prox_fstar if p.index == m2), None)
    if pv is None or pq is None or pv.size != m2 or pq.size != 2 * n:
        return None
    if not isinstance(pv, ProxMoreau) or not isinstance(pv.child, ProxElem1D):
        return None
    sq = pv.child
    if sq.fun != "square":
        return None
    a, b, c, d, e, _, _ = sq.coeffs
    if not (isscalar(a) and a == 1.0 and isscalar(c) and c > 0.0):
        return None
    if not (isscalar(d) and d == 0.0 and isscalar(e) and e == 0.0):
        return None
    fb = coeff_vector(b, m2, problem.scaling_left.device)
    radius = dual_ball_radius(pq)
    if radius is None:
        return None

    # --- preconditioner: Tau and gradient-Sigma constant, conv-Sigma plane -
    sl, sr = problem.scaling_left, problem.scaling_right
    sig_q, tau_t = segment_const(sl[m2:]), segment_const(sr)
    if sig_q is None or tau_t is None:
        return None
    shape = (conv.nx2, conv.ny2)
    return {"nx": nx, "ny": ny, "nx2": conv.nx2, "ny2": conv.ny2,
            "taps": taps, "fb": fb.reshape(shape).contiguous(),
            "sv": sl[:m2].to(torch.float32).reshape(shape).contiguous(),
            "lmb": float(c), "radius": radius, "sig_q": sig_q,
            "tau_t": tau_t}


def _planes(d, xf, yf):
    """(x, yv, q) views of the solver's flat x and y."""
    nx, ny, m2 = d["nx"], d["ny"], d["nx2"] * d["ny2"]
    return (xf.reshape(nx, ny), yf[:m2].reshape(d["nx2"], d["ny2"]),
            yf[m2:].reshape(2, nx, ny))


def _fused_chunk(b, s: PDHGState) -> PDHGState:
    """One chunk in place on the views of the run's own x, y, x_prev and
    y_prev (``own_vectors``) through the route's light call."""
    d, ri = b.deblur, max(int(b.opts.residual_iter), 1)
    if "call" not in d:
        d["call"] = DeblurChunk(d, ri, s.x.device)
    norms2 = d["call"](_planes(d, s.x, s.y), _planes(d, s.x_prev, s.y_prev),
                       d["fb"], d["sv"], s.tau, s.sigma, s.theta,
                       s.converged)
    return chunk_state(b, s, ri, s.x, s.y, s.x_prev, s.y_prev, norms2)


def fused_deblur_run(b, state: PDHGState, until: int,
                     start: int) -> PDHGState:
    """``run_pdhg_route`` with the deblur chunks of ``FusedROFPDHG`` ``b``:
    no multichunk (the JAX package has none) and no canonical form; the run
    takes its own copies of the state's vectors before the chunks, which
    update them in place."""
    return run_pdhg_route(b, state, until, start, lambda s: _fused_chunk(b, s),
                          own_vectors)
