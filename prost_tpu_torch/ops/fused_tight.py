"""Fused PDHG iteration for the tight multilabel relaxation (counterpart of
``prost_tpu/ops/fused_tight.py``, whole-plane route).

Workload (examples/example_multilabel_tight.py): on top of the fast
relaxation, pairwise multipliers v couple the gradient dual q through
per-pixel pairwise difference constraints:

    primal x = [u (L label planes) ; v (2k pair planes, k = L(L-1)/2)]
    dual   y = [q (2L gradient planes, free: no prox) ;
                p (2k planes, per-pixel dim-2 radius ball) ;
                s (the sum-to-one multiplier plane)]

    K = [ grad2d (2nL x nL)           kron(P^T, I_n) (2nL x 2nk) ]
        [ 0                           I (2nk x 2nk)              ]
        [ kron(1_L^T, I_n) (n x nL)   0                          ]

P^T's nonzeros (the taps, ±1 for the example) unroll to signed plane adds
over the label and pair axes.  Every preconditioner segment is a constant,
read from the problem at match time.

Two kernels carry the route, hand-written CUDA in ``csrc/fused_tight.cu``
with a plain PyTorch version beside each wrapper here:

* ``tight_chunk`` (JAX ``tight_fused_chunk``): ``count`` iterations ending
  on a residual iteration, with the four squared preconditioned residual
  norms;
* ``tight_chunk_batched`` (JAX ``tight_fused_chunk_batched``): one chunk
  for each of B instances that share (L, k, the taps, the constants), in
  one launch (sequence), the batched ensembles' route
  (``parallel/ensemble.py``);
* ``tight_chunk_halo`` (JAX ``tight_fused_chunk_halo``): one chunk on a
  halo-extended shard of a row-partitioned plane, the spatially sharded
  route's (``parallel/spatial_fused.py``).

The JAX package has no multichunk kernel for this workload, and neither
has the port.  Each kernel has an in-place form, ``tight_chunk_``,
``tight_chunk_halo_`` and ``tight_chunk_batched_``, which the whole-plane
and the sharded routes call through ``TightChunk`` and ``BatchedPDHG``'s
tight route through ``TightBatchedChunk``, each made once per route.  On a
card each runs as one grid-resident cooperative launch where the shape rule
(``resident_ok``; with ``batch``, on each instance's share of the SMs)
finds that the planes of a band fit in the shared memory of one block per
SM.  Where they do not (512x512x4 and its 556-row band, the sizes for which
the JAX package bands its kernel, ``tight_fused_chunk_banded``), the chunk
and its halo form run as one tiled cooperative launch a chunk
(``tight_route_of``: a grid barrier an iteration, each iteration one pass
over device memory through overlapping 2-D windows of a tile and
``tight_tiled_halo`` pixel a side), and beyond 5 labels, and for the
batched chunk, as the streaming launch sequence; all are bit-equal.  A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel, or raises.  There is no fallback.

Layout contract (the JAX package's, at every public function): u and f
(L, nx, ny); v and p (2k, nx, ny), pair planes [x parts (k); y parts (k)]
(the dim-2 ball pairs plane m with plane m + k); q (2L, nx, ny) = [gx;
gy]; s (nx, ny).  Nothing is canonicalized: q stays live at the boundary
through the kron coupling, so the gradient adjoint is the masked one and
no dual coordinate is zeroed, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..backend.pdhg import PDHGState
from ..common import to_numpy
from ..config import ProstError, dtype as config_dtype
from ..linop.base import LinearOperator
from ..linop.blocks import BlockDiags, BlockKronId
from ..linop.gradient import BlockGradient2D
from ..prox.elemop import ProxElem1D
from ..prox.standalone import ProxZero
from .pdhg_chunk import (CF, CI, N_HALO_SCAL, RES_RED_BYTES, S_CONV, S_LEN,
                         S_NORM, VP, WHOLE_PLANE, LightChunk, ball_scale,
                         card_sms, check_buffers, check_halo, check_inplace,
                         check_path, chunk_state, coeff_vector,
                         entry_converged, halo_copy, halo_into,
                         halo_scal_rows, instance_strides, isscalar,
                         label_sum, launch, leq0_ball_radius, own_vectors,
                         pick_path, resident_rows, run_pdhg_route,
                         scalar_buffer, segment_const, typed_lib, vmap_plain)

MAX_TAPS = 512  # nonzeros of P^T the route takes (the JAX package's bound)

# launches of the kernel wrapper on the card (CPU calls do not count; a
# tiled call also counts under its wrapper's name + "_tiled")
launch_counts = {"tight_chunk": 0, "tight_chunk_batched": 0,
                 "tight_chunk_halo": 0, "tight_chunk_tiled": 0,
                 "tight_chunk_halo_tiled": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch version of the chunk math
# ---------------------------------------------------------------------------

def _kron_ops(taps, nrows_out: int, ncols_out: int):
    """kron(P^T, I_n) as signed plane adds, each output folded left to
    right in the taps' (row, col) order: fwd maps (2k, nx, ny) -> (2L,
    nx, ny), adj the reverse."""

    def fold(src, n_out, key):
        acc = [None] * n_out
        for tap in taps:
            out, inp = key(tap)
            term = tap[2] * src[inp]
            acc[out] = term if acc[out] is None else acc[out] + term
        zero = torch.zeros_like(src[0])
        return torch.stack([a if a is not None else zero for a in acc])

    def fwd(v):
        return fold(v, nrows_out, lambda t: (t[0], t[1]))

    def adj(q):
        return fold(q, ncols_out, lambda t: (t[1], t[0]))

    return fwd, adj


def _kty_u(q, s, L, rows):
    """The u rows of K^T y: the masked gradient adjoint plus s."""
    return rows.dxt_masked(q[:L]) + rows.dyt_masked(q[L:]) + s[None]


def _kx(u, v, kp_fwd, rows):
    """K x's q and s rows: kxq = grad u + kron(P^T, I) v and su = sum_l u
    (left to right)."""
    return torch.cat([rows.dx(u), rows.dy(u)]) + kp_fwd(v), label_sum(u)


def _steps(tau_raw, sigma_raw, consts):
    """(tu, tv, sq, sp, ss): the step sizes times their preconditioner
    segments."""
    sig_q_c, sig_p_c, sig_s_c, tau_u_c, tau_v_c = consts
    return (tau_raw * tau_u_c, tau_raw * tau_v_c, sigma_raw * sig_q_c,
            sigma_raw * sig_p_c, sigma_raw * sig_s_c)


def _update(u, v, q, p, s, kxq, su, tf, steps, theta, radius, d_s, kron,
            rows):
    """One iteration on planes whose rows (and columns) ``rows`` describes;
    (kxq, su) = K x of the current primal (carried, or recomputed by
    ``_kx``), tf = tu f, ``kron`` = ``_kron_ops``' (fwd, adj).  Returns the
    new state, the new (kxq, su) and K^T of the old dual (ktyu, ktyv)."""
    tu, tv, sq, sp, ss = steps
    kp_fwd, kp_adj = kron
    k = v.shape[0] // 2
    ktyu = _kty_u(q, s, u.shape[0], rows)
    ktyv = kp_adj(q) + p
    u2 = torch.clamp_min(u - tu * ktyu - tf, 0.0)
    v2 = v - tv * ktyv
    kxq2, su2 = _kx(u2, v2, kp_fwd, rows)
    q2 = q + sq * ((1.0 + theta) * kxq2 - theta * kxq)  # free dual
    ap = p + sp * ((1.0 + theta) * v2 - theta * v)
    scale = ball_scale(ap[:k] * ap[:k] + ap[k:] * ap[k:], radius)
    p2 = torch.cat([ap[:k] * scale, ap[k:] * scale])
    s2 = s + ss * ((1.0 + theta) * su2 - theta * su) - ss * d_s
    return u2, v2, q2, p2, s2, kxq2, su2, ktyu, ktyv


def _residuals(tau_raw, sigma_raw, theta, consts, old, new, kx_old, kx_new,
               kty_old, kty_new):
    """The preconditioned residual planes of an aligned iteration from the
    iterate before it (``old``: u, v, q, p, s) to the one after it
    (``new``), K x of each (``kx_*``: kxq, su) and K^T y of each
    (``kty_*``: ktyu, ktyv), segment-wise constants.  Returns (pd_q, pd_p,
    pd_s, zh_q, zh_p, zh_s, dd_u, dd_v, wh_u, wh_v)."""
    sig_q_c, sig_p_c, sig_s_c, tau_u_c, tau_v_c = consts
    u, v, q, p, s = old
    u2, v2, q2, p2, s2 = new
    kxq, su = kx_old
    kxq2, su2 = kx_new
    ktyu_p, ktyv_p = kty_old
    ktyu2, ktyv2 = kty_new
    sqrt_sq, sqrt_sp, sqrt_ss = sig_q_c ** 0.5, sig_p_c ** 0.5, sig_s_c ** 0.5
    sqrt_tu, sqrt_tv = tau_u_c ** 0.5, tau_v_c ** 0.5
    zh_q = (q - q2) / (sigma_raw * sqrt_sq) + sqrt_sq * (
        (1.0 + theta) * kxq2 - theta * kxq)
    zh_p = (p - p2) / (sigma_raw * sqrt_sp) + sqrt_sp * (
        (1.0 + theta) * v2 - theta * v)
    zh_s = (s - s2) / (sigma_raw * sqrt_ss) + sqrt_ss * (
        (1.0 + theta) * su2 - theta * su)
    pd_q = zh_q - sqrt_sq * kxq2
    pd_p = zh_p - sqrt_sp * v2
    pd_s = zh_s - sqrt_ss * su2
    wh_u = (u - u2) / (tau_raw * sqrt_tu) - sqrt_tu * ktyu_p
    wh_v = (v - v2) / (tau_raw * sqrt_tv) - sqrt_tv * ktyv_p
    dd_u = wh_u + sqrt_tu * ktyu2
    dd_v = wh_v + sqrt_tv * ktyv2
    return pd_q, pd_p, pd_s, zh_q, zh_p, zh_s, dd_u, dd_v, wh_u, wh_v


def _norm_sums(res, nsum):
    """The four squared norms of ``_residuals``' ``res``, each a sum of
    ``nsum``s."""
    pd_q, pd_p, pd_s, zh_q, zh_p, zh_s, dd_u, dd_v, wh_u, wh_v = res

    def ssq(a):
        return nsum(a * a)

    return (ssq(pd_q) + ssq(pd_p) + ssq(pd_s),
            ssq(zh_q) + ssq(zh_p) + ssq(zh_s),
            ssq(dd_u) + ssq(dd_v),
            ssq(wh_u) + ssq(wh_v))


def chunk_core(tau_raw, sigma_raw, theta, radius, d_s, u0, v0, q0, p0, s0, f,
               count: int, taps, consts, rows=WHOLE_PLANE):
    """``count - 1`` plain iterations, then the aligned iteration with its
    four preconditioned residual norms (squared): the JAX package's
    ``_chunk_core``.  ``consts`` = (sig_q, sig_p, sig_s, tau_u, tau_v), the
    constant preconditioner segments; ``rows`` is the planes' ``RowOps``
    (a halo-extended shard's: owned-row norms).

    Returns ((u2, v2, q2, p2, s2), (u, v, q, p, s) before the aligned
    iteration, norms)."""
    L, k = u0.shape[0], v0.shape[0] // 2
    kron = _kron_ops(taps, 2 * L, 2 * k)
    steps = _steps(tau_raw, sigma_raw, consts)
    tf = steps[0] * f
    args = (tf, steps, theta, radius, d_s, kron, rows)
    state = (u0, v0, q0, p0, s0)
    kx = _kx(u0, v0, kron[0], rows)  # K x of the current primal, carried
    for _ in range(count - 1):
        *state, kxq, su, _, _ = _update(*state, *kx, *args)
        kx = (kxq, su)
    # aligned iteration; kx = K x_prev carried for free
    u2, v2, q2, p2, s2, kxq2, su2, ktyu_p, ktyv_p = _update(*state, *kx,
                                                            *args)
    new = (u2, v2, q2, p2, s2)
    kty2 = (_kty_u(q2, s2, L, rows), kron[1](q2) + p2)
    norms = _norm_sums(_residuals(tau_raw, sigma_raw, theta, consts,
                                  tuple(state), new, kx, (kxq2, su2),
                                  (ktyu_p, ktyv_p), kty2), rows.nsum)
    return new, tuple(state), norms


def tight_chunk_plain(u, v, q, p, s, f, scal, count: int, taps, consts,
                      rows=WHOLE_PLANE, n_scal: int = 5):
    """Plain PyTorch version of ``tight_chunk`` (any device); with ``rows``
    and ``n_scal`` that of a halo chunk."""
    new, prev, norms = chunk_core(scal[0], scal[1], scal[2], scal[3], scal[4],
                                  u, v, q, p, s, f, int(count), taps, consts,
                                  rows)
    n2 = torch.stack(norms)
    conv = entry_converged(scal, n_scal)
    state = (u, v, q, p, s)
    return (*(torch.where(conv, a, b) for a, b in zip(state, new)),
            *(torch.where(conv, a, b) for a, b in zip(state, prev)),
            torch.where(conv, torch.zeros_like(n2), n2))


def tight_chunk_halo_plain(u, v, q, p, s, f, scal, count: int,
                           nx_global: int, taps, consts):
    """Plain PyTorch version of ``tight_chunk_halo`` (any device; reads the
    row context of ``scal`` on the host)."""
    return tight_chunk_plain(u, v, q, p, s, f, scal, count, taps, consts,
                             halo_scal_rows(scal, nx_global), N_HALO_SCAL)


def tight_chunk_batched_plain(u, v, q, p, s, f, scal, count: int, taps,
                              consts):
    """Plain PyTorch version of ``tight_chunk_batched`` (any device):
    ``tight_chunk_plain`` vmapped over the instances."""
    return vmap_plain(tight_chunk_plain, (u, v, q, p, s, f), scal, int(count),
                      taps, consts)


def tight_tiled_halo() -> int:
    """The halo of the tiled chunk's window, in pixels on every side of a
    tile: an iteration's dual step at a pixel reads the new and the old u
    one row below and one column right, the new u there K^T q, which reads
    q_x one row up and q_y one column left (v, p, the kron coupling, the
    pair ball and the label sum are pointwise), so one pixel of the old
    state around the tile gives the owned pixels exactly; the next
    iteration loads its window anew."""
    return 1


def tight_chunk_tiled_plain(u, v, q, p, s, f, scal, count: int, taps,
                            consts, nx_global=None, tile=(32, 32), halo=None,
                            partials: bool = False):
    """The tiled chunk (``tight_chunk_`` and ``tight_chunk_halo_`` with
    ``path="tiled"``) window by window: each iteration ``chunk_core``'s
    arithmetic on every tile's window (the tile of ``tile`` rows and
    columns and ``halo`` pixels on every side, clamped at the plane's
    edges, ``tight_tiled_halo`` by default; every mask decided by the
    pixel's place in the plane, ``fused_rof.window_ops``), K x of the
    iterate (kxq and su) recomputed from the window, the owned pixels
    stitched into new planes; then the norms of the stitched planes, K x
    and K^T y recomputed.  With ``nx_global`` the halo form (the row
    context read from ``scal``).  Returns ``tight_chunk_plain``'s outputs;
    with ``partials`` also the 32x8 tiles' partials
    (``fused_rof.tile_partials``) that the kernel's finish reduces."""
    from .fused_rof import tile_partials, window_ops

    L, nx, ny = u.shape
    k = v.shape[0] // 2
    if nx_global is None:
        n_scal, off, rows = 5, 0, WHOLE_PLANE
    else:
        n_scal, off = N_HALO_SCAL, int(scal[5])
        rows = halo_scal_rows(scal, nx_global)
    h = tight_tiled_halo() if halo is None else int(halo)
    tx, ty = (int(t) for t in tile)
    tau_raw, sigma_raw, theta, radius, d_s = (scal[i] for i in range(5))
    kron = _kron_ops(taps, 2 * L, 2 * k)
    steps = _steps(tau_raw, sigma_raw, consts)
    tf = steps[0] * f
    planes = (u, v, q, p, s)
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
                w = [a[win] for a in prev]
                res = _update(*w, *_kx(w[0], w[1], kron[0], ops), tf[win],
                              steps, theta, radius, d_s, kron, ops)
                own = (..., slice(R0 - r0, R1 - r0), slice(C0 - c0, C1 - c0))
                for dst, src in zip(planes, res[:5]):
                    dst[..., R0:R1, C0:C1] = src[own]

    def k_of(a):
        return (_kx(a[0], a[1], kron[0], rows),
                (_kty_u(a[2], a[4], L, rows), kron[1](a[2]) + a[3]))

    (kx_prev, kty_prev), (kx_new, kty_new) = k_of(prev), k_of(planes)
    res = _residuals(tau_raw, sigma_raw, theta, consts, prev, planes,
                     kx_prev, kx_new, kty_prev, kty_new)
    norms = torch.stack(_norm_sums(res, rows.nsum))
    conv = entry_converged(scal, n_scal)
    state = (u, v, q, p, s)
    out = (*(torch.where(conv, a, b) for a, b in zip(state, planes)),
           *(torch.where(conv, a, b) for a, b in zip(state, prev)),
           torch.where(conv, torch.zeros_like(norms), norms))
    if not partials:
        return out

    def add(*planes):  # a pixel's terms, left to right as the kernel adds
        acc = 0.0
        for a in planes:
            for t in a:
                acc = acc + t * t
        return acc

    pd_q, pd_p, pd_s, zh_q, zh_p, zh_s, dd_u, dd_v, wh_u, wh_v = res
    terms = (add(pd_q, pd_p, pd_s[None]), add(zh_q, zh_p, zh_s[None]),
             add(dd_v, dd_u), add(wh_v, wh_u))
    if nx_global is not None:
        li = torch.arange(nx, device=u.device)[:, None]
        owned = (li >= int(scal[6])) & (li < int(scal[7]))
        terms = tuple(torch.where(owned, t, 0.0) for t in terms)
    return out + (tile_partials(terms),)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def kron_array(taps, L: int, k: int, device) -> torch.Tensor:
    """P^T's taps as the kernel takes them, one float32 array on
    ``device`` (made once per taps and device): by output row, [row_ptr
    (2L + 1); col (T); w (T)], then by output column, [col_ptr (2k + 1);
    row (T); w (T)], each run in the order of the plain version's folds."""
    by_row = sorted(taps, key=lambda t: t[0])      # stable: (r, m) order
    by_col = sorted(taps, key=lambda t: t[1])      # stable: r within m

    def ptr(key, n, order):
        out = [0] * (n + 1)
        for t in order:
            out[key(t) + 1] += 1
        for i in range(n):
            out[i + 1] += out[i]
        return out

    vals = (ptr(lambda t: t[0], 2 * L, by_row) + [t[1] for t in by_row]
            + [t[2] for t in by_row]
            + ptr(lambda t: t[1], 2 * k, by_col) + [t[0] for t in by_col]
            + [t[2] for t in by_col])
    return torch.tensor(vals, dtype=torch.float32, device=device)


def _check(u, v, q, p, s, f, scal, count: int, taps, consts,
           batched: bool = False, n_scal: int = 5):
    if int(count) < 1:
        raise ProstError("A chunk needs count >= 1.")
    lead = u.shape[:1] if batched else ()
    b = len(lead)
    if u.dim() != 3 + b or u.shape[b] < 1 or min(u.shape[b + 1:]) < 2:
        what = "a (B, L, nx, ny)" if batched else "an (L, nx, ny)"
        raise ProstError(f"u must be {what} stack, got {tuple(u.shape)}.")
    L, nx, ny = u.shape[b:]
    if (v.dim() != 3 + b or v.shape[b] % 2
            or tuple(v.shape[b + 1:]) != (nx, ny)):
        want = ", ".join(map(str, (*lead, "2k", nx, ny)))
        raise ProstError(f"v must be a ({want}) stack, got "
                         f"{tuple(v.shape)}.")
    k = v.shape[b] // 2
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ProstError(f"The kernel takes 1 to {MAX_TAPS} taps, got "
                         f"{len(taps)}.")
    if any(not (0 <= r < 2 * L and 0 <= m < 2 * k) for r, m, _ in taps):
        raise ProstError(f"A tap lies outside the ({2 * L}, {2 * k}) matrix.")
    if len(consts) != 5:
        raise ProstError("consts must hold (sig_q, sig_p, sig_s, tau_u, "
                         "tau_v).")
    check_buffers("tight", (("u", u, (*lead, L, nx, ny)),
                            ("v", v, (*lead, 2 * k, nx, ny)),
                            ("q", q, (*lead, 2 * L, nx, ny)),
                            ("p", p, (*lead, 2 * k, nx, ny)),
                            ("s", s, (*lead, nx, ny)),
                            ("f", f, (*lead, L, nx, ny))),
                  scal, n_scal, lead[0] if batched else None)


def _lib():
    """The fused tight kernel library, built from csrc/fused_tight.cu on
    first use."""
    head = [VP] * 18 + [CI] * 5 + [CF] * 10
    res = [VP] * 19 + [CI] * 5 + [CF] * 10
    tiled = [VP] * 15 + [CI] * 5 + [CF] * 10
    strides = [ctypes.c_longlong] * 5
    return typed_lib("fused_tight", "prost_tight_num_blocks", {
        "prost_tight_chunk": head + [CI, VP],
        "prost_tight_chunk_batched": head + strides + [CI, CI, VP],
        "prost_tight_chunk_batched_resident": res + strides + [CI, CI, VP],
        "prost_tight_chunk_halo": head + [CI, CI, VP],
        "prost_tight_chunk_resident": res + [CI, VP],
        "prost_tight_chunk_halo_resident": res + [CI, CI, VP],
        "prost_tight_resident_smem": [CI],
        "prost_tight_chunk_tiled": tiled + [CI] * 3 + [VP],
        "prost_tight_chunk_halo_tiled": tiled + [CI] * 4 + [VP],
        "prost_tight_tiled_smem": []})


def _consts10(consts):
    """The five preconditioner constants and their square roots, rounded
    once from double, as the plain version rounds its Python constants."""
    consts = [float(c) for c in consts]
    return consts + [c ** 0.5 for c in consts]


def resident_bytes(L: int, k: int, ntaps: int, nx: int, ny: int,
                   sms: int) -> int:
    """The dynamic shared memory of one block of the grid-resident chunk on
    ``nx`` rows (the whole plane's, or a halo band's) over ``sms`` blocks:
    csrc/fused_tight.cu's TightRes for the largest band
    (tight_resident_floats: u with a row below, q with a row above, v, p,
    the carried kxq, f, s and su, and the taps array), at least the
    reductions' array."""
    rmax = resident_rows(nx, sms)
    floats = ((3 * L * (rmax + 1) + (4 * k + 3 * L + 2) * rmax) * int(ny)
              + 2 * L + 2 * k + 2 + 4 * int(ntaps))
    return max(4 * floats, RES_RED_BYTES)


def resident_ok(L: int, k: int, ntaps: int, nx: int, ny: int, sms: int,
                smem: int, batch: int | None = None) -> bool:
    """The shape rule of ``tight_chunk_`` and ``tight_chunk_halo_``: a
    chunk on ``nx`` rows runs as one grid-resident launch
    (csrc/fused_tight.cu tight_resident, one block per SM) where the planes
    of its largest band and the taps fit in ``smem`` bytes of a block's
    dynamic shared memory on a card of ``sms`` SMs, and as the streaming
    launch sequence otherwise.  With ``batch`` = B, that of
    ``tight_chunk_batched_``: its B instances side by side in one launch
    (tight_resident_batched), each on sms // B blocks, where B <= sms and
    a band of ``nx`` rows over sms // B blocks fits."""
    if batch is not None:
        if not 1 <= int(batch) <= int(sms):
            return False
        sms = int(sms) // int(batch)
    return resident_bytes(L, k, ntaps, nx, ny, sms) <= int(smem)


@functools.lru_cache(maxsize=None)
def card_limits(device, batched: bool = False) -> tuple:
    """(SMs, the dynamic shared memory a block of the grid-resident chunk,
    with ``batched`` the batched chunk's, may hold) of the card ``device``,
    read once."""
    lib = _lib()
    with torch.cuda.device(device):
        smem = lib.prost_tight_resident_smem(int(bool(batched)))
    if smem < 0:
        raise ProstError(f"tight_chunk: no shared-memory limit for the "
                         f"resident chunk on {device} (CUDA error {-smem}).")
    return card_sms(device), smem


def _resident(L, k, ntaps, nx, ny, device, batch=None) -> bool:
    return resident_ok(L, k, ntaps, nx, ny,
                       *card_limits(device, batch is not None), batch)


# labels of the largest tiled instance (csrc/fused_tight.cu TT_MAX_L) and
# the threads of its blocks
TIGHT_TILED_MAX_L = 5
_TILED_THREADS = 512


def tight_tiled_bytes(tx: int, ty: int, L: int, k: int, ntaps: int) -> int:
    """The dynamic shared memory of one block of the tiled launch
    (csrc/fused_tight.cu tight_tiled_smem): the taps array (to 16 bytes),
    then 4L + 1 planes (u, q_x, q_y, f, then the new u in f's place, and
    s) of the window of a ``tx`` x ``ty`` tile with ``tight_tiled_halo``
    pixel on every side and each thread's old and new v (4k floats, which
    hold the norm pass's reductions: two 32x8 trees)."""
    h = tight_tiled_halo()
    kron = -(-(2 * L + 2 * k + 2 + 4 * int(ntaps)) // 4) * 4
    return 4 * (kron + (4 * int(L) + 1) * (int(tx) + 2 * h)
                * (int(ty) + 2 * h) + 4 * int(k) * _TILED_THREADS)


@functools.lru_cache(maxsize=None)
def tight_tiled_tile(nx: int, ny: int, L: int, k: int, ntaps: int, sms: int,
                     smem: int):
    """The owned tile (rows, columns) of the tiled launch on (L, nx, ny)
    planes with k pairs and ``ntaps`` taps on a card of ``sms`` SMs whose
    blocks may hold ``smem`` bytes of dynamic shared memory: of the tiles
    (rows a multiple of 8, columns of 32, so every 32x8 norm tile lies in
    one) whose window fits (``tight_tiled_bytes``), the one whose
    iteration moves the fewest window pixels through the SMs
    (``fused_rof.window_tile``); None where no tile's window fits."""
    from .fused_rof import window_tile

    return window_tile(nx, ny, 2 * tight_tiled_halo(), sms,
                       lambda tx, ty: tight_tiled_bytes(tx, ty, L, k, ntaps)
                       <= smem)


def tight_tiled_ok(L: int, k: int, ntaps: int, nx: int, ny: int, sms: int,
                   smem: int) -> bool:
    """Whether the tiled launch takes (L, nx, ny) planes: 2 to
    ``TIGHT_TILED_MAX_L`` labels (5: a pixel's 2k pair duals and
    multipliers in registers, the most that compile without a spill at
    128 registers a thread), k = L(L - 1)/2 pairs, and some tile's window
    fits in ``smem`` bytes."""
    return (2 <= int(L) <= TIGHT_TILED_MAX_L and int(k) == L * (L - 1) // 2
            and tight_tiled_tile(int(nx), int(ny), int(L), int(k),
                                 int(ntaps), int(sms), int(smem))
            is not None)


def tight_route_of(L: int, k: int, ntaps: int, nx: int, ny: int, sms: int,
                   smem: int, tiled_smem: int) -> str:
    """The shape rule of ``tight_chunk_`` and ``tight_chunk_halo_`` (on the
    band's rows) on a card of ``sms`` SMs whose grid-resident blocks may
    hold ``smem`` bytes and tiled blocks ``tiled_smem``: "resident" where
    the planes fit in the grid-resident launch (``resident_ok``: 128x128x4
    and its bands on an H100), else "tiled" where a tile's window fits
    (``tight_tiled_ok``: 512x512x4 and its 556-row band), else
    "streaming" (beyond 5 labels, or pairs other than L(L - 1)/2)."""
    if resident_ok(L, k, ntaps, nx, ny, sms, smem):
        return "resident"
    if tight_tiled_ok(L, k, ntaps, nx, ny, sms, tiled_smem):
        return "tiled"
    return "streaming"


@functools.lru_cache(maxsize=None)
def tight_tiled_limit(device) -> int:
    """The dynamic shared memory a block of the tiled launch may hold on
    the card ``device``, read once."""
    with torch.cuda.device(device):
        smem = _lib().prost_tight_tiled_smem()
    if smem < 0:
        raise ProstError(f"tight_chunk: no shared-memory limit for the tiled "
                         f"chunk on {device} (CUDA error {-smem}).")
    return smem


def tight_pick_route(path, L: int, k: int, ntaps: int, nx: int, ny: int,
                     device, what: str) -> tuple:
    """(path, tile) of a chunk on the card ``device``: by
    ``tight_route_of`` where ``path`` is None, else the one asked for;
    "resident" where the planes do not fit, or "tiled" where no tile's
    window does, raises ``ProstError``.  ``tile`` is the tiled launch's
    (rows, columns), else None."""
    check_path(path, what)
    sms, smem = card_limits(device)
    tsmem = tight_tiled_limit(device)
    if path is None:
        path = tight_route_of(L, k, ntaps, nx, ny, sms, smem, tsmem)
    if path == "resident" and not resident_ok(L, k, ntaps, nx, ny, sms,
                                              smem):
        raise ProstError(f"{what}: the chunk's planes do not fit in the "
                         "shared memory of one block per SM.")
    tile = None
    if path == "tiled":
        if not tight_tiled_ok(L, k, ntaps, nx, ny, sms, tsmem):
            raise ProstError(f"{what}: the tiled launch takes 2 to "
                             f"{TIGHT_TILED_MAX_L} labels with L(L - 1)/2 "
                             "pairs and a tile's window in the shared "
                             "memory of a block.")
        tile = tight_tiled_tile(int(nx), int(ny), int(L), int(k), int(ntaps),
                                int(sms), int(tsmem))
    return path, tile


def _route_scratch(path: str, L, nx, ny, device):
    """A single-instance chunk's scratch on ``path``: the tiled launch's
    second slot of u, q and s and its norm terms (3L + 5 planes), else
    ``_scratch``'s."""
    if path == "tiled":
        return [torch.empty((3 * L + 5) * nx * ny, dtype=torch.float32,
                            device=device)]
    return _scratch(path == "resident", L, nx, ny, device)


def _scratch(resident: bool, L, nx, ny, device, B=None):
    """A chunk launch's scratch: the carried planes kxq and su of this
    iterate and of the previous one (the grid-resident launch writes them
    on the aligned iteration only), and the grid-resident chunk's norm
    terms (4 planes); with ``B``, of every instance."""
    lead = () if B is None else (int(B),)

    def empty(*shape):
        return torch.empty(lead + shape, dtype=torch.float32, device=device)

    carried = [empty(2 * L, nx, ny), empty(2 * L, nx, ny), empty(nx, ny),
               empty(nx, ny)]
    return carried + ([empty(4, nx, ny)] if resident else [])


def _launch_chunk(what: str, state, prev, f, kron, sc, partial, scratch,
                  route: tuple, count: int, ntaps: int, consts,
                  nx_global=None):
    """One chunk on the card in place on ``state`` (u, v, q, p, s) and
    ``prev``: the grid-resident launch, the tiled launch or the streaming
    sequence (``route`` = (path, tile) of ``tight_pick_route``), of the
    whole plane or (with ``nx_global``) of a halo band, counted under
    ``what`` (and a tiled call also under ``what`` + "_tiled")."""
    u, v = state[0], state[1]
    L, nx, ny = u.shape
    k = v.shape[0] // 2
    fn = "prost_tight_chunk" + ("" if nx_global is None else "_halo")
    tail = () if nx_global is None else (int(nx_global),)
    shape = (L, k, nx, ny, int(ntaps), *consts, *tail, int(count))
    path, tile = route
    if path == "tiled":
        launch(_lib(), fn + "_tiled", what, launch_counts, u.device,
               [*state, *prev, f, kron, sc, partial, *scratch], *shape,
               *tile)
        launch_counts[what + "_tiled"] += 1
        return
    carried, terms = scratch[:4], scratch[4:]
    launch(_lib(), fn + ("_resident" if path == "resident" else ""), what,
           launch_counts, u.device,
           [*state, *prev, *carried, f, kron, sc, partial, *terms], *shape)


def _inplace(what: str, state, prev, f, scal, n_scal: int, count: int,
             taps, consts, nx_global, path):
    """One chunk on the card in place, its buffers made for this call;
    returns norms2."""
    u, v = state[0], state[1]
    L, nx, ny = u.shape
    k = v.shape[0] // 2
    dev = u.device
    route = tight_pick_route(path, L, k, len(taps), nx, ny, dev, what)
    sc = scalar_buffer(scal, n_scal, S_CONV, S_LEN)
    partial = torch.empty(4 * _lib().prost_tight_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_chunk(what, state, prev, f.contiguous(),
                  kron_array(tuple(taps), L, k, dev), sc, partial,
                  _route_scratch(route[0], L, nx, ny, dev), route, count,
                  len(taps), _consts10(consts), nx_global)
    return sc[S_NORM:S_NORM + 4]


def tight_chunk(u, v, q, p, s, f, scal, count: int, taps, consts):
    """``count`` fused iterations ending on a residual iteration.

    u, f: (L, nx, ny); v, p: (2k, nx, ny); q: (2L, nx, ny); s: (nx, ny);
    taps: the nonzero (row, col, weight) of the (2L, 2k) matrix P^T in
    (row, col) order; consts: (sig_q, sig_p, sig_s, tau_u, tau_v); scal:
    [tau, sigma, theta, radius, d_s] (+ an optional converged flag: when
    set, nothing runs and the inputs come back).  Returns (u2, v2, q2, p2,
    s2, u_prev, v_prev, q_prev, p_prev, s_prev, norms2), norms2 the 4
    SQUARED preconditioned residual norms, on the inputs' device.  CPU
    tensors run the plain version; CUDA tensors run ``tight_chunk_`` on
    copies."""
    _check(u, v, q, p, s, f, scal, count, taps, consts)
    if u.device.type == "cpu":
        return tight_chunk_plain(u, v, q, p, s, f, scal, count, taps, consts)
    return halo_copy(tight_chunk_, (u, v, q, p, s), f, scal, count, taps,
                     consts)


def tight_chunk_(u, v, q, p, s, u_prev, v_prev, q_prev, p_prev, s_prev, f,
                 scal, count: int, taps, consts, path=None):
    """``tight_chunk`` in place: (u, v, q, p, s) advance by ``count``
    iterations and the previous buffers take the iterate before the aligned
    one; with the converged flag set nothing changes.  Returns norms2.  On
    a card ``path`` None takes the shape rule's path (``tight_route_of``):
    one grid-resident launch (csrc/fused_tight.cu tight_resident) where the
    planes fit on chip, else one tiled cooperative launch (tight_tiled:
    overlapping 2-D windows, a grid barrier an iteration) and the finish
    where a tile's window does, else the streaming launch sequence;
    "resident", "tiled" or "streaming" asks for one ("resident" and
    "tiled" raise where they cannot launch).  On the CPU every path runs
    the plain version."""
    state, prev = (u, v, q, p, s), (u_prev, v_prev, q_prev, p_prev, s_prev)
    _check(*state, f, scal, count, taps, consts)
    check_path(path, "tight_chunk_")
    check_inplace(state, prev)
    if u.device.type == "cpu":
        return halo_into(state, prev, tight_chunk_plain(
            *state, f, scal, count, taps, consts), scal, 5)
    return _inplace("tight_chunk", state, prev, f, scal, 5, count, taps,
                    consts, None, path)


def tight_chunk_halo(u, v, q, p, s, f, scal, count: int, nx_global: int,
                     taps, consts):
    """``tight_chunk`` on one halo-extended shard of a row-partitioned plane
    of ``nx_global`` rows.

    u, f: (L, nxb, ny); v, p: (2k, nxb, ny); q: (2L, nxb, ny); s: (nxb,
    ny), the shard's rows in the middle and its neighbours' halo rows
    (zeros beyond the plane) above and below; scal: [tau, sigma, theta,
    radius, d_s, row_offset, own_lo, own_hi] (+ an optional converged
    flag), row_offset the global row of local row 0 and [own_lo, own_hi)
    the owned local rows.  Returns the tuple of ``tight_chunk``, norms2
    over the owned rows only.  CPU tensors run the plain version; CUDA
    tensors run ``tight_chunk_halo_`` on copies."""
    return halo_copy(tight_chunk_halo_, (u, v, q, p, s), f, scal, count,
                     nx_global, taps, consts)


def tight_chunk_halo_(u, v, q, p, s, u_prev, v_prev, q_prev, p_prev, s_prev,
                      f, scal, count: int, nx_global: int, taps, consts,
                      path=None):
    """``tight_chunk_halo`` in place, on the sharded route's persistent
    buffers: (u, v, q, p, s) advance by ``count`` iterations and the
    previous buffers take the iterate before the aligned one; with the
    converged flag set nothing changes.  Returns norms2.  ``path`` as for
    ``tight_chunk_``, the shape rule on the band's rows."""
    state, prev = (u, v, q, p, s), (u_prev, v_prev, q_prev, p_prev, s_prev)
    _check(*state, f, scal, count, taps, consts, n_scal=N_HALO_SCAL)
    check_path(path, "tight_chunk_halo_")
    check_halo(nx_global, state, prev)
    if u.device.type == "cpu":
        return halo_into(state, prev, tight_chunk_halo_plain(
            *state, f, scal, count, nx_global, taps, consts), scal)
    return _inplace("tight_chunk_halo", state, prev, f, scal, N_HALO_SCAL,
                    count, taps, consts, int(nx_global), path)


class TightChunk(LightChunk):
    """The tight routes' light chunk call: ``tight_chunk_`` (with ``band``
    = (nx_global, rows, row_offset, own_lo, own_hi), ``tight_chunk_halo_``
    on a band of ``rows`` rows) on the planes a route holds, with what
    depends only on the shapes made once per route: the path (``route``:
    ``tight_pick_route``'s (path, tile), by the shape rule unless ``path``
    asks for one), the scratch, the norm partials, the taps array, the
    constants and the scalar buffer with ``m``'s radius and d_s (and the
    band's row context).  A call writes the step sizes and the flag into
    the scalar buffer and launches; on the CPU it runs the plain version."""

    def __init__(self, m, count: int, device, band=None, path=None):
        consts = (m["radius"], m["d_s"]) + tuple(band[2:] if band else ())
        super().__init__(consts, device)
        self.count, self.band = int(count), band
        self.taps, self.consts = m["taps"], m["consts"]
        L, k, nx, ny = m["L"], m["k"], m["nx"], m["ny"]
        if band is not None:
            nx = int(band[1])
        self.what = "tight_chunk" if band is None else "tight_chunk_halo"
        self.nx_global = None if band is None else int(band[0])
        self.route = None  # (path, tile) on a card
        if torch.device(device).type == "cuda":
            self.route = tight_pick_route(path, L, k, len(self.taps), nx, ny,
                                          device, self.what)
            self.partial = torch.empty(
                4 * _lib().prost_tight_num_blocks(nx, ny),
                dtype=torch.float32, device=device)
            self.scratch = _route_scratch(self.route[0], L, nx, ny, device)
            self.kron = kron_array(tuple(self.taps), L, k, device)
            self.consts10 = _consts10(self.consts)

    @property
    def resident(self):
        """Whether the call runs grid-resident on a card; None on the
        CPU."""
        return None if self.route is None else self.route[0] == "resident"

    def __call__(self, state, prev, f, tau, sigma, theta, converged):
        """``count`` iterations on ``state`` (u, v, q, p, s) in place, the
        previous iterate into ``prev``; returns norms2."""
        self.scalars_(tau, sigma, theta, converged)
        if self.route is None:
            scal = self.scal()
            if self.band is None:
                out = tight_chunk_plain(*state, f, scal, self.count,
                                        self.taps, self.consts)
            else:
                out = tight_chunk_halo_plain(*state, f, scal, self.count,
                                             self.nx_global, self.taps,
                                             self.consts)
            return halo_into(state, prev, out, scal, self.n_scal)
        _launch_chunk(self.what, state, prev, f, self.kron, self.sc,
                      self.partial, self.scratch, self.route, self.count,
                      len(self.taps), self.consts10, self.nx_global)
        return self.norms2()


def tight_chunk_batched(u, v, q, p, s, f, scal, count: int, taps, consts):
    """``tight_chunk`` for each of B instances that share (L, k, taps,
    consts) in one launch (sequence).

    u, f: (B, L, nx, ny); v, p: (B, 2k, nx, ny); q: (B, 2L, nx, ny); s: (B,
    nx, ny); scal: (5, B), a row each of tau, sigma, theta, radius and d_s
    (+ an optional row of converged flags: an instance whose flag is set
    runs nothing and gets its inputs back).  Returns (u2, v2, q2, p2, s2,
    u_prev, v_prev, q_prev, p_prev, s_prev, norms2), norms2 (4, B) the
    SQUARED preconditioned residual norms of each instance.  Instance b
    comes out as ``tight_chunk`` on instance b alone.  CPU tensors run the
    plain version; CUDA tensors run ``tight_chunk_batched_`` on copies."""
    _check(u, v, q, p, s, f, scal, count, taps, consts, batched=True)
    if u.device.type == "cpu":
        return tight_chunk_batched_plain(u, v, q, p, s, f, scal, count, taps,
                                         consts)
    return halo_copy(tight_chunk_batched_, (u, v, q, p, s), f, scal, count,
                     taps, consts)


def _launch_batched(state, prev, f, kron, sc, partial, scratch,
                    resident: bool, count: int, ntaps: int, consts,
                    strides) -> None:
    """One batched chunk on the card in place on ``state`` (u, v, q, p, s)
    and ``prev``: the grid-resident launch (the instances side by side) or
    the streaming sequence, counted under ``tight_chunk_batched``."""
    u, v = state[0], state[1]
    B, L, nx, ny = u.shape
    k = v.shape[1] // 2
    carried, terms = scratch[:4], scratch[4:]
    fn = "prost_tight_chunk_batched" + ("_resident" if resident else "")
    launch(_lib(), fn, "tight_chunk_batched", launch_counts, u.device,
           [*state, *prev, *carried, f, kron, sc, partial, *terms], L, k, nx,
           ny, int(ntaps), *consts, *strides, int(count), B)


def tight_chunk_batched_(u, v, q, p, s, u_prev, v_prev, q_prev, p_prev,
                         s_prev, f, scal, count: int, taps, consts,
                         path=None):
    """``tight_chunk_batched`` in place: every instance of (u, v, q, p, s)
    advances by ``count`` iterations and the previous buffers take its
    iterate before the aligned one; an instance whose flag is set changes
    nothing.  u and v may be views of a route's flat x, q, p and s of its
    flat y (see ``instance_strides``).  Returns norms2 (4, B).  On a card
    ``path`` None takes the shape rule's path (``resident_ok`` with
    ``batch``): one grid-resident launch (csrc/fused_tight.cu
    tight_resident_batched, the instances side by side) where a band of
    each instance's share of the SMs fits on chip, else the streaming
    launch sequence; "resident" or "streaming" asks for one ("resident"
    raises where it does not fit)."""
    state, prev = (u, v, q, p, s), (u_prev, v_prev, q_prev, p_prev, s_prev)
    _check(*state, f, scal, count, taps, consts, batched=True)
    strides = instance_strides(state, prev, "tight_chunk_batched_")
    if u.device.type == "cpu":
        return halo_into(state, prev, tight_chunk_batched_plain(
            *state, f, scal, count, taps, consts), scal, 5)
    B, L, nx, ny = u.shape
    k = v.shape[1] // 2
    dev = u.device
    resident = pick_path(path, _resident(L, k, len(taps), nx, ny, dev, B),
                         "tight_chunk_batched")
    sc = scalar_buffer(scal, 5, S_CONV, S_LEN)
    partial = torch.empty(4 * B * _lib().prost_tight_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _launch_batched(state, prev, f.contiguous(),
                    kron_array(tuple(taps), L, k, dev), sc, partial,
                    _scratch(resident, L, nx, ny, dev, B), resident, count,
                    len(taps), _consts10(consts), strides)
    return sc[:, S_NORM:S_NORM + 4].T


class TightBatchedChunk(LightChunk):
    """``BatchedPDHG``'s light call of the batched tight chunk:
    ``tight_chunk_batched_`` on the views of the run's own flat x, y,
    x_prev and y_prev, with what depends only on the shapes made once per
    route: the path (``resident_ok`` with ``batch``), the scratch, the norm
    partials, the taps array, the constants and the scalar buffer with
    every instance's radius and d_s.  A call writes the step sizes and the
    flags into the scalar buffer and launches; on the CPU it runs the plain
    version."""

    def __init__(self, m, batch: int, count: int, device):
        super().__init__((m["radius"], m["d_s"]), device, batch)
        self.count = int(count)
        self.taps, self.consts = m["taps"], m["consts"]
        B, L, k, nx, ny = int(batch), m["L"], m["k"], m["nx"], m["ny"]
        self.resident = None  # the path on a card
        if torch.device(device).type == "cuda":
            self.resident = _resident(L, k, len(self.taps), nx, ny, device,
                                      B)
            self.partial = torch.empty(
                4 * B * _lib().prost_tight_num_blocks(nx, ny),
                dtype=torch.float32, device=device)
            self.scratch = _scratch(self.resident, L, nx, ny, device, B)
            self.kron = kron_array(tuple(self.taps), L, k, device)
            self.consts10 = _consts10(self.consts)

    def __call__(self, state, prev, f, tau, sigma, theta, converged):
        """``count`` iterations of every instance of ``state`` (u, v, q,
        p, s) in place, the previous iterate into ``prev``; ``converged``
        sets every instance's flag; returns norms2 (4, B)."""
        self.scalars_(tau, sigma, theta, converged)
        if self.resident is None:
            scal = self.scal()
            out = tight_chunk_batched_plain(*state, f, scal, self.count,
                                            self.taps, self.consts)
            return halo_into(state, prev, out, scal, self.n_scal)
        _launch_batched(state, prev, f, self.kron, self.sc, self.partial,
                        self.scratch, self.resident, self.count,
                        len(self.taps), self.consts10,
                        instance_strides(state, prev, "tight_chunk_batched_"))
        return self.norms2()


# ---------------------------------------------------------------------------
# structure matching and the route
# ---------------------------------------------------------------------------

def match_tight_structure(problem):
    """Detect the fusable tight-multilabel structure; returns dict(nx, ny,
    L, k, taps, f, radius, d_s, consts) or None.  Conditions (the model of
    examples/example_multilabel_tight.py):

    * linop = [grad2d(L >= 2) at (0, 0); kron(P^T, I_n) at (0, nL), 1 to
      512 nonzeros; identity diags at (2nL, nL); kron(ones(1, L), I_n) at
      (2nL + 2nk, 0)];
    * prox_g = ind_geq0 with linear unaries over u + zero over v;
    * prox_fstar = zero over q + dim-2 planar ball over p + linear shift
      over s;
    * every preconditioner segment constant.

    The fused route is float32 only."""
    if config_dtype() != torch.float32:
        return None
    linop = problem.linop
    if not isinstance(linop, LinearOperator) or len(linop.blocks) != 4:
        return None
    grad = next((b for b in linop.blocks
                 if isinstance(b, BlockGradient2D)), None)
    ident = next((b for b in linop.blocks if isinstance(b, BlockDiags)), None)
    krons = [b for b in linop.blocks if isinstance(b, BlockKronId)]
    if grad is None or ident is None or len(krons) != 2:
        return None
    if grad.label_first or grad.row != 0 or grad.col != 0 or grad.L < 2:
        return None
    L, nx, ny = grad.L, grad.nx, grad.ny
    n = nx * ny
    nL = n * L

    pair = next((b for b in krons if b.col == nL), None)
    lsum = next((b for b in krons if b.col == 0), None)
    if pair is None or lsum is None:
        return None
    pmat = to_numpy(pair.data)
    if pmat.shape[0] != 2 * L or pmat.shape[1] % 2 or pair.row != 0:
        return None
    k = pmat.shape[1] // 2
    if pair.diaglength != n:
        return None
    taps = tuple((int(r), int(m), float(pmat[r, m]))
                 for r in range(2 * L) for m in range(2 * k)
                 if pmat[r, m] != 0.0)
    if not taps or len(taps) > MAX_TAPS:
        return None
    m_sum = to_numpy(lsum.data)
    if (lsum.row != 2 * nL + 2 * n * k or lsum.diaglength != n
            or m_sum.shape != (1, L) or not (m_sum == 1.0).all()):
        return None
    if (ident.row != 2 * nL or ident.col != nL
            or ident.nrows != 2 * n * k or ident.ncols != 2 * n * k):
        return None
    if ident.offsets != (0,) or not bool(torch.allclose(
            ident.factors, torch.ones_like(ident.factors))):
        return None

    # --- primal proxes: positivity + unaries over u, zero over v -----------
    if len(problem.prox_g) != 2 or len(problem.prox_fstar) != 3:
        return None
    pg_u = next((p for p in problem.prox_g if p.index == 0), None)
    pg_v = next((p for p in problem.prox_g if p.index == nL), None)
    if not isinstance(pg_u, ProxElem1D) or pg_u.fun != "ind_geq0":
        return None
    if pg_u.size != nL or not isinstance(pg_v, ProxZero):
        return None
    a, b, c, d, e, _, _ = pg_u.coeffs
    if not (isscalar(a) and a == 1.0 and isscalar(b) and b == 0.0):
        return None
    if not (isscalar(c) and c > 0.0) or not (isscalar(e) and e == 0.0):
        return None
    f = coeff_vector(d, nL, problem.scaling_left.device)

    # --- dual proxes: free q, dim-2 ball on p, linear shift on s -----------
    pf_q = next((p for p in problem.prox_fstar if p.index == 0), None)
    pf_p = next((p for p in problem.prox_fstar if p.index == 2 * nL), None)
    pf_s = next((p for p in problem.prox_fstar
                 if p.index == 2 * nL + 2 * n * k), None)
    if not isinstance(pf_q, ProxZero) or pf_q.size != 2 * nL:
        return None
    radius = leq0_ball_radius(pf_p, 2)
    if radius is None or pf_p.size != 2 * n * k:
        return None
    if not isinstance(pf_s, ProxElem1D) or pf_s.fun != "zero":
        return None
    _, _, _, sd, se, _, _ = pf_s.coeffs
    if not (isscalar(sd) and isscalar(se) and se == 0.0):
        return None

    # --- constant per-segment preconditioner --------------------------------
    sl, sr = problem.scaling_left, problem.scaling_right
    consts = (segment_const(sl[:2 * nL]),
              segment_const(sl[2 * nL:2 * nL + 2 * n * k]),
              segment_const(sl[2 * nL + 2 * n * k:]),
              segment_const(sr[:nL]),
              segment_const(sr[nL:]))
    if any(c is None for c in consts):
        return None
    return {"nx": nx, "ny": ny, "L": L, "k": k, "taps": taps,
            "f": f.reshape(L, nx, ny).contiguous(), "radius": radius,
            "d_s": float(sd), "consts": consts}


def _planes(t, xf, yf):
    """(u, v, q, p, s) views of the solver's flat x and y."""
    L, k, nx, ny = t["L"], t["k"], t["nx"], t["ny"]
    nL, nk2 = nx * ny * L, 2 * nx * ny * k
    return (xf[:nL].reshape(L, nx, ny), xf[nL:].reshape(2 * k, nx, ny),
            yf[:2 * nL].reshape(2 * L, nx, ny),
            yf[2 * nL:2 * nL + nk2].reshape(2 * k, nx, ny),
            yf[2 * nL + nk2:].reshape(nx, ny))


def _fused_chunk(b, st: PDHGState) -> PDHGState:
    """One chunk in place on the views of the run's own x, y, x_prev and
    y_prev (``own_vectors``) through the route's light call."""
    t, ri = b.tight, max(int(b.opts.residual_iter), 1)
    if "call" not in t:
        t["call"] = TightChunk(t, ri, st.x.device)
    norms2 = t["call"](_planes(t, st.x, st.y),
                       _planes(t, st.x_prev, st.y_prev), t["f"], st.tau,
                       st.sigma, st.theta, st.converged)
    return chunk_state(b, st, ri, st.x, st.y, st.x_prev, st.y_prev, norms2)


def fused_tight_run(b, state: PDHGState, until: int,
                    start: int) -> PDHGState:
    """``run_pdhg_route`` with the tight chunks of ``FusedROFPDHG`` ``b``:
    no multichunk (the JAX package has none) and no canonical form; the run
    takes its own copies of the state's vectors, which the chunks update in
    place."""
    return run_pdhg_route(b, state, until, start, lambda s: _fused_chunk(b, s),
                          own_vectors)
