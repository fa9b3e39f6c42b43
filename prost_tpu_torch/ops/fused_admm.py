"""Fused graph-projection ADMM for ROF-structured problems (counterpart of
``prost_tpu/ops/fused_admm.py``).

Same workload family as ``ops/fused_rof.py`` (a lone gradient2d operator,
square / wsquare / abs data term, norm2 dual coupling, recognized by the
same ``match_rof_structure``), solved with the ADMM backend.  With the
constant alpha preconditioners (Sigma = 1/2, Tau = 1/4) the scaled
operator is a multiple of the gradient, K~ = c_K grad with
c_K = 1/(2 sqrt 2), so a whole outer iteration, inner projection
included, is stencils, pointwise work and a few scalar reductions.

Three kernels carry the routes, each a hand-written CUDA kernel set in
``csrc/fused_admm.cu`` with a plain PyTorch version beside its wrapper here:

* ``admm_chunk`` (JAX ``admm_fused_chunk``): ``count`` ADMM iterations, the
  inner projection by masked CGLS or by a degree-d Chebyshev iteration,
  and the four squared residual norms of the last one; with the Chebyshev
  projection on a card one grid-resident cooperative launch where
  ``admm_resident_ok`` holds (512x512), else one tiled cooperative launch
  where ``admm_tiled_ok`` holds (2048x2048: JAX ``admm_banded_chunk``),
  else the launch sequence (and always with CGLS), bit-equal; its
  in-place form ``admm_chunk_`` serves the route's light call
  ``ADMMChunk``, made once per route;
* ``admm_multichunk`` (JAX ``admm_fused_multichunk``): up to ``k_chunks``
  Chebyshev chunks with the Boyd rho adaptation, the dual rescale and the
  stopping test on the device between chunks; on a card one grid-resident
  cooperative launch where its planes fit in the shared memory of one
  block per SM, else a tiled launch a chunk with the adaptation between
  them on the device, else the launch sequence (the shape rule
  ``admm_route_of``), bit-equal; its in-place form ``admm_multichunk_``
  serves the route's light call ``ADMMMultichunk``, made once per route;
* ``admm_iter_halo`` (JAX ``admm_banded_iter`` on a shard): one Chebyshev
  iteration in place on a halo-extended shard of a row-partitioned plane,
  with the owned rows' norms or without, the spatially sharded route's
  (``parallel/spatial_fused.py``), as one cooperative launch.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel, or raises.  There is no other route and no fallback,
and the route is taken on any device.  The tiled launch (``path="tiled"``)
is the counterpart of the JAX package's banded chunk for planes beyond a
TPU core's VMEM: each iteration is one pass over device memory, a block
per SM walking overlapping 2-D windows of the planes (a tile and
``admm_tiled_halo(degree)`` pixels on every side) with a grid barrier
between iterations; its plain twins, ``admm_chunk_tiled_plain`` and
``admm_multichunk_tiled_plain``, run the plain arithmetic window by
window.

The inner projection solves (I + c_K^2 grad^T grad) u = c_K grad^T d.  The
Neumann-Laplacian spectrum [0, 8) puts that operator's spectrum in
[1, 2), so a fixed-coefficient Chebyshev iteration converges at the same
per-step rate as CGLS with no dot products.  ``projection="auto"`` (the
default) resolves to it; ``"cgls"`` keeps the reference's inner algebra.

Layout contract (the JAX package's): x-like planes (nx, ny), z-like
arrays (2, nx, ny).  The z arrays' dead coordinates (x component's last
row, y component's last column) are zeroed at run entry and at every
launch, which makes the maskless adjoint stencils exact.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..backend.admm import (ADMMState, BackendADMM, admm_residual_adapt,
                            cg_tolerance, dct_projection_plan)
from ..backend.pdhg import hold_if
from ..config import ProstError
from .fused_rof import (DATATERMS, _SQRT_S, _SQRT_T, match_rof_structure,
                        tile_partials, window_ops, window_tile)
from .pdhg_chunk import (CF, CI, VP, WHOLE_PLANE, card_sms, check_buffers,
                         check_halo, check_path, dead_dual_flat, dx, dxt,
                         dy, dyt, entry_converged, halo_row_ops, launch, ptr,
                         resident_rows, scalar_buffer, typed_lib)
from .phases import K_CHUNKS, run_phases

_C_K = _SQRT_S * _SQRT_T  # K~ = c_K * grad
_INV_SQRT_S = 1.0 / _SQRT_S
_INV_SQRT_T = 1.0 / _SQRT_T

# Chebyshev iteration on (I + c_K^2 grad^T grad), spectrum in [1, 2)
_CHEB_THETA = 1.5   # interval midpoint
_CHEB_DELTA = 0.5   # interval half-width
_CHEB_SIGMA1 = _CHEB_THETA / _CHEB_DELTA

# slots of the kernels' device scalar buffer (csrc/fused_admm.cu, enum S_*)
_S_CONV, _S_DONE, _S_NORM, _S_LEN = 11, 12, 13, 24
_SOUT = (0, 3, 4, 5, _S_CONV, _S_DONE)  # rho delta arb_l arb_u conv done

# launches of each kernel wrapper on the card (CPU calls do not count); a
# tiled call also counts under "admm_chunk_tiled" / "admm_multichunk_tiled"
launch_counts = {"admm_chunk": 0, "admm_multichunk": 0,
                 "admm_iter_halo": 0, "admm_chunk_tiled": 0,
                 "admm_multichunk_tiled": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions of the chunk math
# ---------------------------------------------------------------------------

def _cgls_masked(d_x, d_y, u0, tol, maxit: int):
    """``backend.cgls.cgls_solve`` on A = c_K grad, shift = 1, as a fixed
    trip of ``maxit`` steps with every update predicated on the pre-step
    ``done`` flag.  ``tol`` arrives clamped to 10 eps by the caller."""
    eps = torch.finfo(d_x.dtype).eps

    def A(u):
        return _C_K * dx(u), _C_K * dy(u)

    def At(vx, vy):
        return _C_K * (dxt(vx) + dyt(vy))

    ax, ay = A(u0)
    rx, ry = d_x - ax, d_y - ay
    s = At(rx, ry) - u0
    p = s
    gamma = torch.sum(s * s)
    norms0 = torch.sqrt(gamma)
    done = norms0 < eps
    x = u0
    for _ in range(int(maxit)):
        qx, qy = A(p)
        delta = torch.sum(qx * qx) + torch.sum(qy * qy) + torch.sum(p * p)
        delta = torch.where(delta <= 0, torch.full_like(delta, eps), delta)
        alpha = gamma / delta
        x_n = x + alpha * p
        rx_n = rx - alpha * qx
        ry_n = ry - alpha * qy
        s = At(rx_n, ry_n) - x_n
        gamma_n = torch.sum(s * s)
        beta = gamma_n / torch.where(gamma > 0, gamma, torch.ones_like(gamma))
        p_n = s + beta * p
        normx = torch.sqrt(torch.sum(x_n * x_n))
        conv = (torch.sqrt(gamma_n) <= norms0 * tol) | (normx * tol >= 1.0)
        x = torch.where(done, x, x_n)
        rx = torch.where(done, rx, rx_n)
        ry = torch.where(done, ry, ry_n)
        p = torch.where(done, p, p_n)
        gamma = torch.where(done, gamma, gamma_n)
        done = done | conv
    return x


def cheby_coeffs(degree: int) -> list:
    """The (c_prev, c_r) pairs of the ``degree - 1`` Chebyshev steps,
    d <- c_prev d + c_r r, as Python floats (the kernels take them as f32
    launch arguments, rounded as torch rounds a Python scalar)."""
    out = []
    rho_prev = 1.0 / _CHEB_SIGMA1
    for _ in range(int(degree) - 1):
        rho_k = 1.0 / (2.0 * _CHEB_SIGMA1 - rho_prev)
        out.append((rho_k * rho_prev, 2.0 * rho_k / _CHEB_DELTA))
        rho_prev = rho_k
    return out


def admm_cheby_halo_rows(degree: int) -> int:
    """The halo of one Chebyshev-ADMM iteration on a shard: the rows one
    outer iteration moves information, 2 degree + 4 as the JAX package
    counts them (the degree - 1 steps, the right-hand side, the warm
    start's M, x_proj's gradient, the norms' stencils), rounded up to 8
    as the JAX package's DMA windows need, so that both packages exchange
    the same rows."""
    return -(-(2 * int(degree) + 4) // 8) * 8


def _cheby_project(d_x, d_y, u0, degree: int, rows=WHOLE_PLANE):
    """Solve min ||A u - d||^2 + ||u||^2 (A = c_K grad) by ``degree`` steps
    of the classical Chebyshev iteration on (I + A^T A) u = A^T d,
    warm-started from u0; no reductions.  Degree 10 reaches about 4e-8
    relative to the warm-start residual, the f32 floor.  ``rows`` is the
    planes' ``RowOps``."""
    c2 = _C_K * _C_K

    def M(u):
        return u + c2 * (rows.dxt(rows.dx(u)) + rows.dyt(rows.dy(u)))

    b = _C_K * (rows.dxt(d_x) + rows.dyt(d_y))
    r = b - M(u0)
    x = u0
    d = r * (1.0 / _CHEB_THETA)
    for c_prev, c_r in cheby_coeffs(degree):
        x = x + d
        r = r - M(d)
        d = c_prev * d + c_r * r
    return x + d


def _admm_iter(xh, xp, xd, zh, zp, zd, warm, f, w, project, rho, lmb,
               radius, alpha: float, dataterm: str, rows=WHOLE_PLANE):
    """One graph-projection ADMM iteration (``backend.admm.admm_step``
    specialized to Sigma = 1/2, Tau = 1/4).  ``project(d_x, d_y, warm)``
    is the inner least-squares solver.  z-like values travel as (zx, zy)
    plane pairs; ``rows`` is the planes' ``RowOps``."""
    # relaxed arguments (scaled space)
    t1 = (alpha * xh + (1.0 - alpha) * xp + xd) * _INV_SQRT_T
    t2_x = _SQRT_S * (zh[0] + zd[0])
    t2_y = _SQRT_S * (zh[1] + zd[1])

    # graph projection: min ||K~ u - d||^2 + ||u||^2, warm-started
    d_x = t2_x - _C_K * rows.dx(t1)
    d_y = t2_y - _C_K * rows.dy(t1)
    u = project(d_x, d_y, warm)

    xp_n = _SQRT_T * (u + t1)
    zp_nx = rows.dx(xp_n)
    zp_ny = rows.dy(xp_n)
    xd_n = _SQRT_T * t1 - xp_n
    zd_nx = t2_x * _INV_SQRT_S - zp_nx
    zd_ny = t2_y * _INV_SQRT_S - zp_ny

    # prox_g with effective step Tau/rho = 1/(4 rho)
    te = 0.25 / rho
    tl = te * lmb
    arg = xp_n - xd_n
    if dataterm == "square":
        xh_n = (arg + tl * f) * (1.0 / (1.0 + tl))
    elif dataterm == "wsquare":
        tw = tl * w
        xh_n = (arg + tw * f) / (1.0 + tw)
    else:  # abs: soft shrink toward f as arg - clamp(arg - f, -t, t)
        dv = arg - f
        xh_n = arg - torch.minimum(torch.maximum(dv, -tl), tl)

    # prox_f: shrinkage of the per-pixel 2-vector magnitude by radius *
    # step, inverted step 1/(rho Sigma) = 2/rho
    za_x = zp_nx - zd_nx
    za_y = zp_ny - zd_ny
    shrink = radius * (2.0 / rho)
    nrm = torch.sqrt(za_x * za_x + za_y * za_y)
    scale = (torch.clamp(nrm - shrink, min=0.0)
             / torch.where(nrm > 0, nrm, torch.ones_like(nrm)))
    return (xh_n, xp_n, xd_n, (za_x * scale, za_y * scale), (zp_nx, zp_ny),
            (zd_nx, zd_ny), u)


def _admm_norm_terms(xh, xp, xd, zh, zp, zd, rho, rows=WHOLE_PLANE):
    """The per-pixel terms of the four squared residual norms of an ADMM
    iterate with Sigma = 1/2, Tau = 1/4: |pr_x|^2, |pr_y|^2, |pn_x|^2,
    |pn_y|^2, |dr|^2, |dn|^2 as planes."""
    pr_x = _SQRT_S * (rows.dx(xh) - zh[0])
    pr_y = _SQRT_S * (rows.dy(xh) - zh[1])
    pn_x = _SQRT_S * zh[0]
    pn_y = _SQRT_S * zh[1]
    wv = (-rho * 4.0) * (xh - xp + xd)             # -rho / Tau
    y_x = (-rho * 0.5) * (zh[0] - zp[0] + zd[0])   # -rho * Sigma
    y_y = (-rho * 0.5) * (zh[1] - zp[1] + zd[1])
    kty = rows.dxt(y_x) + rows.dyt(y_y)
    dn = _SQRT_T * wv
    dr = _SQRT_T * (wv + kty)
    return (pr_x * pr_x, pr_y * pr_y, pn_x * pn_x, pn_y * pn_y, dr * dr,
            dn * dn)


def _admm_norms(xh, xp, xd, zh, zp, zd, rho, rows=WHOLE_PLANE):
    """The four SQUARED preconditioned residual norms of an ADMM iterate
    with Sigma = 1/2, Tau = 1/4: |pr|^2, |pn|^2, |dr|^2, |dn|^2, summed by
    ``rows.nsum`` (a halo-extended shard's: the owned rows)."""
    t = _admm_norm_terms(xh, xp, xd, zh, zp, zd, rho, rows)
    nsum = rows.nsum
    return (nsum(t[0]) + nsum(t[1]), nsum(t[2]) + nsum(t[3]), nsum(t[4]),
            nsum(t[5]))


def admm_adapt_scalars(consts, tols4, it, rho, delta, arb_l, arb_u,
                       pr, pn, dr, dn):
    """The scalar math of ``backend.admm.admm_residual_adapt`` as the
    multichunk kernel runs it between chunks: same f32 operations in the
    same order on 0-d tensors.  ``consts`` = (sqrt_nrows, sqrt_ncols,
    arb_tau, arb_gamma) are Python floats; ``it`` is the post-increment
    counter of the chunk's last iteration as f32.

    Returns (rho, delta, arb_l, arb_u, dual_rescale_fac, converged)."""
    trp, trd, tap, tad = tols4
    sqrt_nrows, sqrt_ncols, arb_tau, arb_gamma = consts
    eps_pri = sqrt_nrows * tap + trp * pn
    eps_dua = sqrt_ncols * tad + trd * dn
    c1 = (dr < eps_dua) & (arb_tau * it > arb_l)
    c2 = (pr < eps_pri) & (arb_tau * it > arb_u) & ~c1
    rho_new = torch.where(c1, rho * delta, torch.where(c2, rho / delta, rho))
    delta_new = torch.where(c1 | c2, delta * arb_gamma, delta)
    arb_u = torch.where(c1, it, arb_u)
    arb_l = torch.where(c2, it, arb_l)
    fac = rho / rho_new
    conv = (pr < eps_pri) & (dr < eps_dua)
    return rho_new, delta_new, arb_l, arb_u, fac, conv


def admm_adapt_consts(problem, opts) -> tuple:
    """The constant tuple for ``admm_adapt_scalars``."""
    return (math.sqrt(float(problem.nrows)), math.sqrt(float(problem.ncols)),
            float(opts.arb_tau), float(opts.arb_gamma))


def _chunk_planes(planes, f, w, rho, lmb, radius, count, alpha, dataterm,
                  project):
    """``count`` iterations on the 7 state planes; ``project(k)`` gives
    the inner solver of the chunk's k-th iteration."""
    xh, xp, xd, zh, zp, zd, warm = planes
    for k in range(int(count)):
        xh, xp, xd, zh, zp, zd, warm = _admm_iter(
            xh, xp, xd, zh, zp, zd, warm, f, w, project(k), rho, lmb,
            radius, alpha, dataterm)
    return xh, xp, xd, zh, zp, zd, warm


def _entry_planes(xh, xp, xd, zh, zp, zd, warm, rows=WHOLE_PLANE):
    """The state as the kernels start from it: z dead coordinates zeroed,
    z-like arrays split into plane pairs."""
    zs = tuple(rows.project(z[0], z[1]) for z in (zh, zp, zd))
    return (xh, xp, xd) + zs + (warm,)


def _stack_z(planes):
    xh, xp, xd, zh, zp, zd, warm = planes
    return (xh, xp, xd, torch.stack(zh), torch.stack(zp), torch.stack(zd),
            warm)


def admm_chunk_plain(xh, xp, xd, zh, zp, zd, warm, f, w, scal, cg_tols,
                     count: int, maxit: int, alpha: float,
                     dataterm: str = "square", cheby_degree=None):
    """Plain PyTorch version of ``admm_chunk`` (any device)."""
    rho, lmb, radius = scal[0], scal[1], scal[2]
    if cheby_degree is not None:
        def project(k):
            return lambda dx_, dy_, u0: _cheby_project(dx_, dy_, u0,
                                                       int(cheby_degree))
    else:
        def project(k):
            return lambda dx_, dy_, u0: _cgls_masked(dx_, dy_, u0,
                                                     cg_tols[k], maxit)
    planes = _chunk_planes(_entry_planes(xh, xp, xd, zh, zp, zd, warm), f, w,
                           rho, lmb, radius, count, alpha, dataterm, project)
    norms2 = torch.stack(_admm_norms(*planes[:6], rho))
    conv = entry_converged(scal, 3)
    ins = (xh, xp, xd, zh, zp, zd, warm)
    outs = tuple(torch.where(conv, a, b) for a, b in zip(ins,
                                                         _stack_z(planes)))
    return outs + (torch.where(conv, torch.zeros_like(norms2), norms2),)


def admm_iter_halo_plain(xh, xp, xd, zh, zp, zd, warm, f, w, scal,
                         degree: int, alpha: float, nx_global: int,
                         row_offset: int, own_lo: int, own_hi: int,
                         dataterm: str = "square", with_norms: bool = True):
    """Plain PyTorch version of ``admm_iter_halo`` (any device): the 7
    state arrays after one Chebyshev iteration on the shard, and the owned
    rows' 4 squared norms (zeros without ``with_norms``)."""
    rows = halo_row_ops(row_offset, nx_global, own_lo, own_hi)
    rho, lmb, radius = scal[0], scal[1], scal[2]

    def project(d_x, d_y, u0):
        return _cheby_project(d_x, d_y, u0, int(degree), rows)

    planes = _admm_iter(*_entry_planes(xh, xp, xd, zh, zp, zd, warm, rows),
                        f, w, project, rho, lmb, radius, alpha, dataterm,
                        rows)
    norms2 = (torch.stack(_admm_norms(*planes[:6], rho, rows)) if with_norms
              else torch.zeros(4, dtype=xh.dtype, device=xh.device))
    conv = entry_converged(scal, 3)
    ins = (xh, xp, xd, zh, zp, zd, warm)
    outs = tuple(torch.where(conv, a, b) for a, b in zip(ins,
                                                         _stack_z(planes)))
    return outs + (torch.where(conv, torch.zeros_like(norms2), norms2),)


def _rescaled(planes, fac):
    """The Boyd dual rescale of a chunk's planes: x_dual and z_dual times
    ``fac`` (``csrc/fused_admm.cu`` admm_rescale)."""
    xh, xp, xd, zh, zp, zd, warm = planes
    return xh, xp, xd * fac, zh, zp, (zd[0] * fac, zd[1] * fac), warm


def _multichunk_loop(ins, scal, count: int, k_chunks: int, consts, chunk,
                     owed: bool = False):
    """``admm_multichunk_plain``'s loop over ``chunk(planes, rho, fac)``,
    which returns the planes after one chunk from ``planes`` owing the
    dual rescale ``fac`` (None: nothing owed).  Without ``owed`` each
    chunk's rescale is applied at once; with it, carried as the next
    chunk's pending factor and applied after the last executed chunk, as
    the tiled launches carry it (bit-equal: the same multiplications)."""
    xh = ins[0]
    it0 = scal[6]
    tols4 = (scal[7], scal[8], scal[9], scal[10])
    zero = torch.zeros((), dtype=xh.dtype, device=xh.device)
    conv0 = entry_converged(scal, 11)
    planes = _entry_planes(*ins)
    sc = (scal[0], scal[3], scal[4], scal[5], conv0, zero)
    norms = (zero, zero, zero, zero)
    pend = None
    for c in range(int(k_chunks)):
        rho, delta, arb_l, arb_u, conv, done = sc
        p2 = chunk(planes, rho, pend)
        nrm = _admm_norms(*p2[:6], rho)
        pr, pn = torch.sqrt(nrm[0]), torch.sqrt(nrm[1])
        dr, dn = torch.sqrt(nrm[2]), torch.sqrt(nrm[3])
        it = it0 + float((c + 1) * int(count))
        rho2, delta2, al2, au2, fac, cv = admm_adapt_scalars(
            consts, tols4, it, rho, delta, arb_l, arb_u, pr, pn, dr, dn)
        if owed:
            pend = fac if pend is None else torch.where(conv, pend, fac)
        else:
            p2 = _rescaled(p2, fac)
        planes = tuple(
            (torch.where(conv, a[0], b[0]), torch.where(conv, a[1], b[1]))
            if isinstance(a, tuple) else torch.where(conv, a, b)
            for a, b in zip(planes, p2))
        new_sc = (rho2, delta2, al2, au2, cv, done + 1.0)
        sc = tuple(torch.where(conv, a, b) for a, b in zip(sc, new_sc))
        norms = tuple(torch.where(conv, a, b)
                      for a, b in zip(norms, (pr, pn, dr, dn)))
    if pend is not None:  # the last executed chunk's rescale
        planes = _rescaled(planes, pend)
    rho, delta, arb_l, arb_u, conv, done = sc
    sout = torch.stack([rho, delta, arb_l, arb_u, conv.to(xh.dtype), done])
    # converged at entry: nothing ran, the inputs come back as they were
    outs = tuple(torch.where(conv0, a, b)
                 for a, b in zip(ins, _stack_z(planes)))
    return outs + (torch.stack(norms), sout)


def admm_multichunk_plain(xh, xp, xd, zh, zp, zd, warm, f, w, scal,
                          count: int, k_chunks: int, alpha: float,
                          cheby_degree: int, consts,
                          dataterm: str = "square"):
    """Plain PyTorch version of ``admm_multichunk`` (any device): every
    chunk is computed and kept only while not converged, where the JAX
    kernel branches around it with ``lax.cond``."""
    lmb, radius = scal[1], scal[2]

    def project(k):
        return lambda dx_, dy_, u0: _cheby_project(dx_, dy_, u0,
                                                   int(cheby_degree))

    def chunk(planes, rho, fac):
        return _chunk_planes(planes, f, w, rho, lmb, radius, count, alpha,
                             dataterm, project)

    return _multichunk_loop((xh, xp, xd, zh, zp, zd, warm), scal, count,
                            k_chunks, consts, chunk)


# ---------------------------------------------------------------------------
# the tiled launches' plain twins, window by window
# ---------------------------------------------------------------------------

def admm_tiled_halo(degree: int) -> int:
    """The least halo of the tiled Chebyshev iteration, in pixels on every
    side of a tile: r = c_K grad^T d - M(warm) reads t1 (through d), d and
    warm one pixel each way, and each of the ``degree - 1`` Chebyshev
    steps reads the direction one pixel further, so u = x + v is exact
    ``degree`` pixels inside a window side that lies in the plane; z_proj
    = grad x_proj reads x_proj one pixel further down and right: degree +
    1.  The norms read the stitched planes after the last iteration (a
    pass of their own in ``csrc/fused_admm.cu`` admm_tiled), so they add
    nothing; the JAX package's 2 degree + 4 rows, rounded to 8, is an
    upper bound."""
    return int(degree) + 1


def _tiled_iteration(planes, f, w, rho, lmb, radius, alpha: float,
                     dataterm: str, degree: int, tile, halo: int):
    """One Chebyshev iteration window by window: ``_admm_iter`` on each
    tile's window (the tile and ``halo`` pixels on every side, clamped at
    the plane's edges; ``window_ops``: every mask decided by the pixel's
    place in the plane), the owned pixels stitched into new planes."""
    flat = [planes[0], planes[1], planes[2], *planes[3], *planes[4],
            *planes[5], planes[6]]
    nx, ny = flat[0].shape
    tx, ty = (int(t) for t in tile)
    out = [torch.empty_like(a) for a in flat]
    for R0 in range(0, nx, tx):
        for C0 in range(0, ny, ty):
            R1, C1 = min(R0 + tx, nx), min(C0 + ty, ny)
            r0, c0 = max(R0 - halo, 0), max(C0 - halo, 0)
            r1, c1 = min(R1 + halo, nx), min(C1 + halo, ny)
            ops = window_ops(r0, c0, r1 - r0, c1 - c0, nx, ny)
            win = (slice(r0, r1), slice(c0, c1))
            a = [t[win] for t in flat]

            def project(d_x, d_y, u0, ops=ops):
                return _cheby_project(d_x, d_y, u0, int(degree), ops)

            res = _admm_iter(a[0], a[1], a[2], (a[3], a[4]), (a[5], a[6]),
                             (a[7], a[8]), a[9], f[win], w[win], project,
                             rho, lmb, radius, alpha, dataterm, ops)
            res = [res[0], res[1], res[2], *res[3], *res[4], *res[5], res[6]]
            own = (slice(R0 - r0, R1 - r0), slice(C0 - c0, C1 - c0))
            at = (slice(R0, R1), slice(C0, C1))
            for dst, src in zip(out, res):
                dst[at] = src[own]
    return (out[0], out[1], out[2], (out[3], out[4]), (out[5], out[6]),
            (out[7], out[8]), out[9])


def _tiled_chunk_planes(planes, f, w, rho, lmb, radius, count: int,
                        alpha: float, dataterm: str, degree: int, tile,
                        halo, fac=None):
    """``count`` tiled iterations from ``planes`` owing the dual rescale
    ``fac`` (None: nothing), which the first iteration's loads apply."""
    h = admm_tiled_halo(degree) if halo is None else int(halo)
    if fac is not None:
        planes = _rescaled(planes, fac)
    for _ in range(int(count)):
        planes = _tiled_iteration(planes, f, w, rho, lmb, radius, alpha,
                                  dataterm, degree, tile, h)
    return planes


def admm_chunk_tiled_plain(xh, xp, xd, zh, zp, zd, warm, f, w, scal,
                           count: int, alpha: float, dataterm: str = "square",
                           cheby_degree: int = 10, tile=(64, 64), halo=None,
                           fac=None, partials: bool = False):
    """The tiled Chebyshev chunk (``admm_chunk_`` with ``path="tiled"``)
    window by window: each iteration ``_admm_iter``'s arithmetic on every
    tile's window (``halo`` pixels on every side, ``admm_tiled_halo`` by
    default) and the owned pixels stitched into the other slot; the norms
    of the stitched planes after the last.  ``fac`` is a dual rescale the
    state still owes (the JAX banded chunk's pending factor), applied to
    x_dual and z_dual as the first iteration loads them.  Returns
    ``admm_chunk_plain``'s outputs; with ``partials`` also the 32x8 tiles'
    partials (``tile_partials``) that the kernel's finish reduces."""
    rho, lmb, radius = scal[0], scal[1], scal[2]
    ins = (xh, xp, xd, zh, zp, zd, warm)
    planes = _tiled_chunk_planes(_entry_planes(*ins), f, w, rho, lmb, radius,
                                 count, alpha, dataterm, int(cheby_degree),
                                 tile, halo, fac)
    terms = _admm_norm_terms(*planes[:6], rho)
    norms2 = torch.stack((torch.sum(terms[0]) + torch.sum(terms[1]),
                          torch.sum(terms[2]) + torch.sum(terms[3]),
                          torch.sum(terms[4]), torch.sum(terms[5])))
    conv = entry_converged(scal, 3)
    outs = tuple(torch.where(conv, a, b) for a, b in zip(ins,
                                                         _stack_z(planes)))
    out = outs + (torch.where(conv, torch.zeros_like(norms2), norms2),)
    if not partials:
        return out
    return out + (tile_partials((terms[0] + terms[1], terms[2] + terms[3],
                                 terms[4], terms[5])),)


def admm_multichunk_tiled_plain(xh, xp, xd, zh, zp, zd, warm, f, w, scal,
                                count: int, k_chunks: int, alpha: float,
                                cheby_degree: int, consts,
                                dataterm: str = "square", tile=(64, 64),
                                halo=None):
    """The tiled multichunk (``admm_multichunk_`` with ``path="tiled"``):
    ``admm_multichunk_plain``'s loop over the tiled chunk, each chunk's
    dual rescale carried as the next chunk's pending factor and the last
    executed chunk's applied at the end, as the launches carry it.
    Returns ``admm_multichunk_plain``'s outputs."""
    lmb, radius = scal[1], scal[2]

    def chunk(planes, rho, fac):
        return _tiled_chunk_planes(planes, f, w, rho, lmb, radius, count,
                                   alpha, dataterm, int(cheby_degree), tile,
                                   halo, fac)

    return _multichunk_loop((xh, xp, xd, zh, zp, zd, warm), scal, count,
                            k_chunks, consts, chunk, owed=True)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(planes, f, w, scal, n_scal: int, count: int, dataterm: str):
    if dataterm not in DATATERMS:
        raise ProstError(f"Unknown ROF data term '{dataterm}'.")
    if int(count) < 1:
        raise ProstError("A chunk needs count >= 1.")
    xh = planes[0]
    if xh.dim() != 2 or min(xh.shape) < 2:
        raise ProstError(
            f"x_half must be an (nx, ny) plane, got {tuple(xh.shape)}.")
    nx, ny = xh.shape
    names = ("x_half", "x_proj", "x_dual", "z_half", "z_proj", "z_dual",
             "warm", "f", "w")
    check_buffers("ADMM", [(name, t, (2, nx, ny) if name.startswith("z")
                            else (nx, ny))
                           for name, t in zip(names, tuple(planes) + (f, w))],
                  scal, n_scal)


class _Work:
    """The buffers one kernel call works on in place: the caller's 7 state
    planes, 8 scratch planes, the scalar buffer and the reduction
    partials."""

    def __init__(self, lib, planes, scal, n_scal: int):
        self.planes = list(planes)
        nx, ny = self.planes[0].shape
        dev = self.planes[0].device
        self.scratch = torch.empty(8 * nx * ny, dtype=torch.float32,
                                   device=dev)
        self.sc = scalar_buffer(scal, n_scal, _S_CONV, _S_LEN)
        nblocks = lib.prost_admm_num_blocks(nx, ny)
        self.partial = torch.empty(4 * nblocks, dtype=torch.float32,
                                   device=dev)

    def buffers(self, f, w):
        return self.planes + [f.contiguous(), w.contiguous(), self.scratch,
                              self.sc, self.partial]


def _lib():
    """The fused ADMM kernel library, built from csrc/fused_admm.cu on
    first use."""
    return typed_lib("fused_admm", "prost_admm_num_blocks", {
        # 12 buffers, nx, ny, cg_tols, count, dataterm, degree, coeffs,
        # maxit, alpha, 1 - alpha, stream
        "prost_admm_chunk": [VP] * 12 + [CI, CI, VP, CI, CI, CI, VP, CI, CF,
                                         CF, VP],
        # 12 buffers, nx, ny, count, k_chunks, dataterm, degree, coeffs,
        # alpha, 1 - alpha, 4 adaptation constants, stream
        "prost_admm_multichunk": [VP] * 12 + [CI] * 6 + [VP] + [CF] * 6
                                 + [VP],
        # 12 buffers, nx, ny, dataterm, degree, coeffs, alpha, 1 - alpha,
        # nx_global, row_offset, own_lo, own_hi, with_norms, stream
        "prost_admm_iter_halo": [VP] * 12 + [CI] * 4 + [VP, CF, CF]
                                + [CI] * 5 + [VP],
        "prost_admm_coop_blocks": [],
        # as prost_admm_multichunk, coeffs a device array
        "prost_admm_multichunk_resident": [VP] * 12 + [CI] * 6 + [VP]
                                          + [CF] * 6 + [VP],
        # 12 buffers, nx, ny, count, dataterm, degree, coeffs (a device
        # array), alpha, 1 - alpha, stream
        "prost_admm_chunk_resident": [VP] * 12 + [CI] * 5 + [VP, CF, CF,
                                                             VP],
        "prost_admm_resident_smem": [],
        # 12 buffers, nx, ny, count, dataterm, degree, coeffs (a device
        # array), alpha, 1 - alpha, the tile's rows and columns, stream
        "prost_admm_chunk_tiled": [VP] * 12 + [CI] * 5 + [VP, CF, CF, CI, CI,
                                                          VP],
        # as prost_admm_multichunk_resident, then the tile
        "prost_admm_multichunk_tiled": [VP] * 12 + [CI] * 6 + [VP]
                                       + [CF] * 6 + [CI] * 2 + [VP],
        "prost_admm_tiled_smem": [],
        # tx, ty, degree
        "prost_admm_tiled_bytes": [CI] * 3})


def admm_bands(nx: int, blocks: int) -> list:
    """The rows [lo, hi) that each block of ``admm_iter_halo``'s
    cooperative launch owns in every pixel stage (csrc/fused_admm.cu
    band_of): block b of ``blocks`` takes rows [b nx // blocks, (b + 1) nx
    // blocks), so every row lies in exactly one band and the bands' sizes
    differ by one at most (a band is empty where blocks > nx)."""
    return [(b * int(nx) // int(blocks), (b + 1) * int(nx) // int(blocks))
            for b in range(int(blocks))]


# floats of a grid-resident multichunk block's reductions
# (csrc/fused_admm.cu RES_RED)
_RES_RED = 4 * 512


def admm_resident_bytes(nx: int, ny: int, sms: int, dataterm: str) -> int:
    """The dynamic shared memory of one block of the grid-resident
    multichunk or chunk over ``sms`` blocks (csrc/fused_admm.cu
    admm_resident_floats): for the largest band of R rows, R + 2 rows of
    xh, xp, xd, warm and the two directions, R + 1 of t1, x and of both
    parts of zh, zp, zd and dd, R of f, r and (wsquare) w, and the
    reductions' array."""
    r = resident_rows(nx, sms)
    wsq = 1 if dataterm == "wsquare" else 0
    return 4 * ((6 * (r + 2) + 10 * (r + 1) + (2 + wsq) * r) * int(ny)
                + _RES_RED)


def admm_resident_ok(nx: int, ny: int, dataterm: str, sms: int,
                     smem: int) -> bool:
    """The shape rule of ``admm_multichunk_`` and of ``admm_chunk_``'s
    Chebyshev chunk: each runs as one grid-resident launch
    (csrc/fused_admm.cu admm_multichunk_resident, admm_chunk_resident, one
    block per SM, the same layout) where the bands' planes fit in ``smem``
    bytes of a block's dynamic shared memory on a card of ``sms`` SMs
    (512x512 on an H100, not 2048x2048), and as the launch sequence
    otherwise."""
    return admm_resident_bytes(nx, ny, sms, dataterm) <= int(smem)


@functools.lru_cache(maxsize=None)
def admm_card_limits(device) -> tuple:
    """(SMs, the dynamic shared memory a block of the grid-resident
    multichunk and chunk may hold) of the card ``device``, read once."""
    lib = _lib()
    with torch.cuda.device(device):
        smem = lib.prost_admm_resident_smem()
    if smem < 0:
        raise ProstError(f"admm_multichunk: no shared-memory limit for the "
                         f"resident launch on {device} (CUDA error "
                         f"{-smem}).")
    return card_sms(device), smem


# the tiled launch's map (csrc/fused_admm.cu admm_tiled): warps of a block,
# rows of a thread's strip, the most column blocks (a kernel for each of 2
# to 6), shared planes (four, which hold xh, xp, xd, warm, t1, t2, d, the
# direction and x_proj in turn), and the bytes beside them of the
# launch's 17 plane pointers, the tile's corner and the tile counts
# (Planes)
_TILED_WARPS, _TILED_K, _TILED_MAX_CB = 24, 16, 6
_TILED_PLANES, _TILED_PTR_BYTES = 4, 152


def admm_tiled_map(tx: int, ty: int, degree: int) -> tuple:
    """(cb, rb): the tiled launch's window map for ``tx`` x ``ty`` tiles
    at Chebyshev degree ``degree`` (csrc/fused_admm.cu admm_tiled_map): cb
    blocks of 32 columns by rb blocks of 16 rows, a warp to a block, each
    thread a column of 16 rows, at least the tile and
    ``admm_tiled_halo(degree)`` pixels on every side."""
    h2 = 2 * admm_tiled_halo(degree)
    return -(-(int(ty) + h2) // 32), -(-(int(tx) + h2) // _TILED_K)


def admm_tiled_bytes(tx: int, ty: int, degree: int) -> int:
    """The dynamic shared memory of one block of the tiled launch
    (csrc/fused_admm.cu admm_tiled_smem): four planes of the map
    (``admm_tiled_map``) with a ring of one pixel, and the launch's plane
    pointers, the tile's corner and the tile counts.  The Chebyshev
    iterate and residual stay in registers, f and wsquare's w in device
    memory (read pixel by pixel)."""
    cb, rb = admm_tiled_map(tx, ty, degree)
    return (4 * _TILED_PLANES * (rb * _TILED_K + 2) * (cb * 32 + 2)
            + _TILED_PTR_BYTES)


def admm_tiled_fits(tx: int, ty: int, degree: int, smem: int) -> bool:
    """Whether the tiled launch takes ``tx`` x ``ty`` tiles at Chebyshev
    degree ``degree``: the map needs at most a block's 24 warps and 6
    column blocks, and its planes fit in ``smem`` bytes."""
    cb, rb = admm_tiled_map(tx, ty, degree)
    return (cb * rb <= _TILED_WARPS and cb <= _TILED_MAX_CB
            and admm_tiled_bytes(tx, ty, degree) <= int(smem))


def admm_tiled_tile(nx: int, ny: int, degree: int, sms: int, smem: int):
    """The owned tile (rows, columns) of the tiled launch on (nx, ny)
    planes at Chebyshev degree ``degree`` on a card of ``sms`` SMs whose
    blocks may hold ``smem`` bytes of dynamic shared memory: of the tiles
    (rows a multiple of 8, columns of 32) that the launch takes
    (``admm_tiled_fits``), the one whose iteration moves the fewest window
    pixels through the SMs (the rounds of one block per SM times a whole
    tile's window, the pixels the launch loads), the larger tile on a tie;
    None where none fits (degree 44 and above)."""
    return window_tile(nx, ny, 2 * admm_tiled_halo(degree), sms,
                       lambda tx, ty: admm_tiled_fits(tx, ty, degree, smem))


def admm_tiled_ok(nx: int, ny: int, degree: int, sms: int,
                  smem: int) -> bool:
    """Whether the tiled launch takes (nx, ny) planes at Chebyshev degree
    ``degree``: some tile's window fits in ``smem`` bytes."""
    return admm_tiled_tile(nx, ny, degree, sms, smem) is not None


def admm_route_of(nx: int, ny: int, dataterm: str, degree: int, sms: int,
                  smem: int, tiled_smem: int) -> str:
    """The shape rule of ``admm_chunk_``'s Chebyshev chunk and of
    ``admm_multichunk_`` on a card of ``sms`` SMs whose grid-resident
    blocks may hold ``smem`` bytes and tiled blocks ``tiled_smem``:
    "resident" where the bands' planes fit (``admm_resident_ok``: 512x512
    on an H100), else "tiled" where a tile's window fits
    (``admm_tiled_ok``: 2048x2048), else "streaming"."""
    if admm_resident_ok(nx, ny, dataterm, sms, smem):
        return "resident"
    if admm_tiled_ok(nx, ny, degree, sms, tiled_smem):
        return "tiled"
    return "streaming"


@functools.lru_cache(maxsize=None)
def admm_tiled_limit(device) -> int:
    """The dynamic shared memory a block of the tiled launch may hold on
    the card ``device``, read once."""
    with torch.cuda.device(device):
        smem = _lib().prost_admm_tiled_smem()
    if smem < 0:
        raise ProstError(f"admm_chunk: no shared-memory limit for the tiled "
                         f"launch on {device} (CUDA error {-smem}).")
    return smem


def admm_pick_route(path, nx: int, ny: int, dataterm: str, degree,
                    device, what: str) -> tuple:
    """(path, tile) of a chunk or multichunk on the card ``device``: by
    ``admm_route_of`` where ``path`` is None, else the one asked for;
    "resident" where the bands do not fit, or "tiled" where no tile's
    window does, raises ``ProstError``.  ``degree`` None (the CGLS
    projection) streams.  ``tile`` is the tiled launch's (rows, columns),
    else None."""
    check_path(path, what)
    if degree is None:
        if path in ("resident", "tiled"):
            raise ProstError(f"{what}: the CGLS projection runs as the "
                             "launch sequence only.")
        return "streaming", None
    sms, smem = admm_card_limits(device)
    tsmem = admm_tiled_limit(device)
    if path is None:
        path = admm_route_of(nx, ny, dataterm, degree, sms, smem, tsmem)
    if path == "resident" and not admm_resident_ok(nx, ny, dataterm, sms,
                                                   smem):
        raise ProstError(f"{what}: the chunk's planes do not fit in the "
                         "shared memory of one block per SM.")
    tile = None
    if path == "tiled":
        tile = admm_tiled_tile(nx, ny, degree, sms, tsmem)
        if tile is None:
            raise ProstError(f"{what}: no tile's window holds the halo of a "
                             f"degree-{degree} iteration in the shared "
                             "memory of a block.")
    return path, tile


@functools.lru_cache(maxsize=None)
def _coeff_array(degree):
    """The Chebyshev step coefficients as a host float array (c_prev, c_r
    per step), or None for the CGLS projection; made once per degree."""
    if degree is None:
        return None
    flat = [c for pair in cheby_coeffs(int(degree)) for c in pair]
    return (ctypes.c_float * max(len(flat), 1))(*flat)


@functools.lru_cache(maxsize=None)
def _coeff_tensor(degree: int, device) -> torch.Tensor:
    """``_coeff_array(degree)`` as a float32 array on ``device``, which
    the cooperative and grid-resident launches read: made once per degree
    and device, so any degree runs."""
    return torch.tensor(list(_coeff_array(degree)), dtype=torch.float32,
                        device=device)


def admm_chunk(xh, xp, xd, zh, zp, zd, warm, f, w, scal, cg_tols,
               count: int, maxit: int, alpha: float,
               dataterm: str = "square", cheby_degree=None):
    """``count`` fused ADMM iterations ending on a residual iteration.

    x-like planes (nx, ny), z-like (2, nx, ny); scal: [rho, lmb, radius]
    (+ an optional converged flag: when set, nothing runs and the inputs
    come back); cg_tols: the (count,) CG tolerance schedule, clamped to 10
    eps (ignored, and may be None, when ``cheby_degree`` selects the
    Chebyshev projection).  Returns the 7 updated state arrays and the 4
    SQUARED residual norms, on the inputs' device.  CPU tensors run the
    plain version; CUDA tensors run ``admm_chunk_`` on copies."""
    planes = [t.contiguous().clone() for t in (xh, xp, xd, zh, zp, zd, warm)]
    norms2 = admm_chunk_(*planes, f, w, scal, cg_tols, count, maxit, alpha,
                         dataterm, cheby_degree)
    return tuple(planes) + (norms2,)


def _scratch(path: str, nx: int, ny: int, device):
    """The scratch of a chunk or multichunk launch: the launch sequence's 8
    planes, which the tiled launch uses as its second slot of the state
    (xh, xp, xd, zh, zd, warm), and for the grid-resident launch 4 more,
    its norms' terms."""
    return torch.empty((12 if path == "resident" else 8) * nx * ny,
                       dtype=torch.float32, device=device)


def _chunk_card(planes, f, w, sc, partial, scratch, route: tuple, tols,
                count: int, maxit: int, alpha: float, degree,
                dataterm: str) -> None:
    """One chunk on the card in place on ``planes`` with the scalar buffer
    ``sc``: the grid-resident launch, the tiled launches (Chebyshev only)
    or the launch sequence (``degree`` None: CGLS with the tolerances
    ``tols``), by ``route`` = (path, tile) of ``admm_pick_route``, counted
    under ``admm_chunk`` (and a tiled call also under
    ``admm_chunk_tiled``)."""
    xh = planes[0]
    nx, ny = xh.shape
    path, tile = route
    bufs = [*planes, f, w, scratch, sc, partial]
    if path != "streaming":
        tail = (*tile,) if path == "tiled" else ()
        launch(_lib(), f"prost_admm_chunk_{path}", "admm_chunk",
               launch_counts, xh.device, bufs, nx, ny, int(count),
               DATATERMS[dataterm], int(degree),
               ptr(_coeff_tensor(int(degree), xh.device)), float(alpha),
               1.0 - float(alpha), *tail)
        if path == "tiled":
            launch_counts["admm_chunk_tiled"] += 1
        return
    launch(_lib(), "prost_admm_chunk", "admm_chunk", launch_counts,
           xh.device, bufs, nx, ny, None if tols is None else ptr(tols),
           int(count), DATATERMS[dataterm],
           0 if degree is None else int(degree), _coeff_array(degree),
           int(maxit), float(alpha), 1.0 - float(alpha))


def admm_chunk_(xh, xp, xd, zh, zp, zd, warm, f, w, scal, cg_tols,
                count: int, maxit: int, alpha: float,
                dataterm: str = "square", cheby_degree=None, path=None):
    """``admm_chunk`` in place: the 7 state arrays advance by ``count``
    iterations (with the converged flag set nothing changes).  Returns the
    4 SQUARED residual norms.  On a card ``path`` None takes the shape
    rule's path (``admm_route_of``): with the Chebyshev projection one
    grid-resident cooperative launch (csrc/fused_admm.cu
    admm_chunk_resident) where the bands fit on chip, else one tiled
    cooperative launch (admm_tiled: overlapping 2-D windows, a grid
    barrier an iteration), the finish and, after a count of 1, the copy
    back; "resident", "tiled" or "streaming" asks for one ("resident" and
    "tiled" raise where they cannot launch).  The CGLS projection
    (``cheby_degree`` None) runs as the launch sequence only: its CG steps
    reduce across the grid several times an iteration."""
    planes = (xh, xp, xd, zh, zp, zd, warm)
    _check(planes, f, w, scal, 3, count, dataterm)
    check_path(path, "admm_chunk")
    if cheby_degree is None:
        if cg_tols is None or cg_tols.numel() < int(count):
            raise ProstError("The CGLS projection needs count CG "
                             "tolerances.")
        if cg_tols.device != xh.device:
            raise ProstError("All tensors must be on one device.")
        if path in ("resident", "tiled"):
            raise ProstError("admm_chunk: the CGLS projection runs as the "
                             "launch sequence only.")
    elif int(cheby_degree) < 1:
        raise ProstError("The Chebyshev projection needs a degree >= 1.")
    if not all(t.is_contiguous() for t in planes):
        raise ProstError("admm_chunk_ takes contiguous planes only.")
    if xh.device.type == "cpu":
        out = admm_chunk_plain(*planes, f, w, scal, cg_tols, count, maxit,
                               alpha, dataterm, cheby_degree)
        for t, v in zip(planes, out):
            t.copy_(v)
        return out[7]
    nx, ny = xh.shape
    dev = xh.device
    route = admm_pick_route(path, nx, ny, dataterm, cheby_degree, dev,
                            "admm_chunk")
    sc = scalar_buffer(scal, 3, _S_CONV, _S_LEN)
    partial = torch.empty(4 * _lib().prost_admm_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    tols = (None if cheby_degree is not None
            else cg_tols.to(torch.float32).contiguous())
    _chunk_card(planes, f.contiguous(), w.contiguous(), sc, partial,
                _scratch(route[0], nx, ny, dev), route, tols, count,
                maxit, alpha, cheby_degree, dataterm)
    return sc[_S_NORM:_S_NORM + 4]


class ADMMChunk:
    """``FusedROFADMM``'s light call of the Chebyshev chunk: ``admm_chunk_``
    on the run's own state arrays, with what depends only on the shapes
    and the route made once per route: the path (``route``: (path, tile)
    of ``admm_pick_route``, by the shape rule unless ``path`` asks for
    one), the scratch, the norm partials and the scalar buffer with lmb
    and radius.  A call writes rho and the flag into the scalar buffer in
    place (and zeros into its norms, which a flagged call leaves), in one
    stack and one indexed copy, launches, and returns the squared norms, a
    view of the buffer that the next call overwrites; on the CPU it runs
    the plain version."""

    # the slots a call writes: rho, the converged flag, the 4 norms
    _IN = (0, _S_CONV) + tuple(range(_S_NORM, _S_NORM + 4))

    def __init__(self, r, count: int, alpha: float, degree: int, device,
                 path=None):
        self.r, self.count = r, int(count)
        self.alpha, self.degree = float(alpha), int(degree)
        nx, ny = r["nx"], r["ny"]
        self.sc = torch.zeros(_S_LEN, dtype=torch.float32, device=device)
        self.sc[1] = r["lmb_t"]
        self.sc[2] = r["radius_t"]
        self.stage = torch.zeros(len(self._IN), dtype=torch.float32,
                                 device=device)
        self.slots_in = torch.tensor(self._IN, device=device)
        self.route = None  # (path, tile) on a card
        if torch.device(device).type == "cuda":
            self.route = admm_pick_route(path, nx, ny, r["dataterm"],
                                         self.degree, device, "admm_chunk")
            self.partial = torch.empty(
                4 * _lib().prost_admm_num_blocks(nx, ny),
                dtype=torch.float32, device=device)
            self.scratch = _scratch(self.route[0], nx, ny, device)

    @property
    def resident(self):
        """Whether the call runs grid-resident on a card; None on the
        CPU."""
        return None if self.route is None else self.route[0] == "resident"

    def __call__(self, planes, rho, converged):
        """``count`` iterations on ``planes`` in place; returns the 4
        squared norms."""
        torch.stack([rho, converged.to(self.sc.dtype)],
                    out=self.stage[:2])
        self.sc.index_copy_(0, self.slots_in, self.stage)
        r = self.r
        if self.route is None:
            return admm_chunk_(*planes, r["f"], r["w"],
                               self.sc[[0, 1, 2, _S_CONV]], None, self.count,
                               0, self.alpha, r["dataterm"], self.degree)
        _chunk_card(planes, r["f"], r["w"], self.sc, self.partial,
                    self.scratch, self.route, None, self.count, 0,
                    self.alpha, self.degree, r["dataterm"])
        return self.sc[_S_NORM:_S_NORM + 4]


def admm_iter_halo(xh, xp, xd, zh, zp, zd, warm, f, w, scal, degree: int,
                   alpha: float, nx_global: int, row_offset: int,
                   own_lo: int, own_hi: int, dataterm: str = "square",
                   with_norms: bool = True):
    """One Chebyshev ADMM iteration on one halo-extended shard of a
    row-partitioned plane of ``nx_global`` rows (JAX ``admm_banded_iter``
    with one band, own_lo, out_rows, nx_global and row_offset0).

    x-like planes (nxb, ny), z-like (2, nxb, ny), the shard's rows in the
    middle and its neighbours' halo rows (zeros beyond the plane) above and
    below; local row 0 is global row ``row_offset``, [own_lo, own_hi) are
    the owned local rows; scal: [rho, lmb, radius] (+ an optional converged
    flag: when set, nothing runs and the inputs come back).  Returns the 7
    state arrays and the 4 SQUARED residual norms of the owned rows (zeros
    without ``with_norms``).  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    planes = [t.contiguous().clone() for t in (xh, xp, xd, zh, zp, zd, warm)]
    norms2 = admm_iter_halo_(*planes, f, w, scal, degree, alpha, nx_global,
                             row_offset, own_lo, own_hi, dataterm, with_norms)
    return tuple(planes) + (norms2,)


def admm_iter_halo_(xh, xp, xd, zh, zp, zd, warm, f, w, scal, degree: int,
                    alpha: float, nx_global: int, row_offset: int,
                    own_lo: int, own_hi: int, dataterm: str = "square",
                    with_norms: bool = True):
    """``admm_iter_halo`` in place, on the sharded route's persistent
    buffers: the 7 state arrays advance by one iteration (with the
    converged flag set nothing changes).  Returns norms2.  On a card it is
    one cooperative launch (csrc/fused_admm.cu admm_iter_coop: the
    iteration's steps as stages between grid barriers, each block on its
    band of ``admm_bands``), or raises ``ProstError`` where the card cannot
    hold the launch at once."""
    planes = (xh, xp, xd, zh, zp, zd, warm)
    _check(planes, f, w, scal, 3, 1, dataterm)
    check_halo(nx_global, planes)
    if int(degree) < 1:
        raise ProstError(f"The halo iteration needs a Chebyshev degree >= 1, "
                         f"got {degree}.")
    if not 0 <= own_lo < own_hi <= xh.shape[0]:
        raise ProstError(f"The owned rows [{own_lo}, {own_hi}) must lie in "
                         f"the shard's {xh.shape[0]} rows.")
    if xh.device.type == "cpu":
        out = admm_iter_halo_plain(*planes, f, w, scal, degree, alpha,
                                   nx_global, row_offset, own_lo, own_hi,
                                   dataterm, with_norms)
        for t, v in zip(planes, out):
            t.copy_(v)
        return out[-1]
    lib = _lib()
    wk = _Work(lib, planes, scal, 3)
    nx, ny = xh.shape
    launch(lib, "prost_admm_iter_halo", "admm_iter_halo", launch_counts,
           xh.device, wk.buffers(f, w), nx, ny, DATATERMS[dataterm],
           int(degree), ptr(_coeff_tensor(int(degree), xh.device)),
           float(alpha),
           1.0 - float(alpha), int(nx_global), int(row_offset), int(own_lo),
           int(own_hi), int(bool(with_norms)))
    return wk.sc[_S_NORM:_S_NORM + 4]


def admm_multichunk(xh, xp, xd, zh, zp, zd, warm, f, w, scal, count: int,
                    k_chunks: int, alpha: float, cheby_degree: int, consts,
                    dataterm: str = "square"):
    """Up to ``k_chunks * count`` fused Chebyshev-ADMM iterations with the
    rho adaptation, the dual rescale and the stopping test on the device
    between chunks.

    ``scal`` holds 11 scalars: [rho, lmb, radius, delta, arb_l, arb_u, it0,
    tol_rel_p, tol_rel_d, tol_abs_p, tol_abs_d] (+ an optional
    converged-at-entry flag).  Returns the 7 state arrays, norms (the last
    executed chunk's sqrt'd residual norms) and sout = [rho, delta, arb_l,
    arb_u, converged, chunks_done].  CPU tensors run the plain version;
    CUDA tensors run ``admm_multichunk_`` on copies."""
    planes = [t.contiguous().clone() for t in (xh, xp, xd, zh, zp, zd, warm)]
    norms, sout = admm_multichunk_(*planes, f, w, scal, count, k_chunks,
                                   alpha, cheby_degree, consts, dataterm)
    return tuple(planes) + (norms, sout)


def _multichunk_card(planes, f, w, sc, partial, scratch, route: tuple,
                     count: int, k_chunks: int, alpha: float, degree: int,
                     consts, dataterm: str) -> None:
    """One multichunk on the card in place on ``planes`` with the scalar
    buffer ``sc``: the grid-resident launch, the tiled launches or the
    launch sequence, by ``route`` = (path, tile) of ``admm_pick_route``,
    counted under ``admm_multichunk`` (and a tiled call also under
    ``admm_multichunk_tiled``)."""
    xh = planes[0]
    nx, ny = xh.shape
    path, tile = route
    coeffs = (_coeff_array(degree) if path == "streaming"
              else ptr(_coeff_tensor(int(degree), xh.device)))
    fn = ("prost_admm_multichunk" if path == "streaming"
          else f"prost_admm_multichunk_{path}")
    launch(_lib(), fn, "admm_multichunk", launch_counts, xh.device,
           [*planes, f, w, scratch, sc, partial], nx, ny, int(count),
           int(k_chunks), DATATERMS[dataterm], int(degree), coeffs,
           float(alpha), 1.0 - float(alpha), *[float(c) for c in consts],
           *(tile or ()))
    if path == "tiled":
        launch_counts["admm_multichunk_tiled"] += 1


def admm_multichunk_(xh, xp, xd, zh, zp, zd, warm, f, w, scal, count: int,
                     k_chunks: int, alpha: float, cheby_degree: int, consts,
                     dataterm: str = "square", path=None):
    """``admm_multichunk`` in place: the 7 state arrays advance (with the
    converged flag set at entry nothing changes).  Returns (norms, sout).
    On a card ``path`` None takes the shape rule's path
    (``admm_route_of``): one grid-resident cooperative launch
    (csrc/fused_admm.cu admm_multichunk_resident) where the bands fit on
    chip, else a tiled cooperative launch (admm_tiled) and the finish's
    adaptation a chunk, each chunk's dual rescale folded into the next
    chunk's loads and the last one's applied with the copy back (about 2
    k_chunks + 1 launches); "resident", "tiled" or "streaming" asks for
    one ("resident" and "tiled" raise where they cannot launch)."""
    planes = (xh, xp, xd, zh, zp, zd, warm)
    _check(planes, f, w, scal, 11, count, dataterm)
    if int(cheby_degree) < 1:
        raise ProstError("The multichunk needs a Chebyshev degree >= 1.")
    if not all(t.is_contiguous() for t in planes):
        raise ProstError("admm_multichunk_ takes contiguous planes only.")
    check_path(path, "admm_multichunk")
    if xh.device.type == "cpu":
        out = admm_multichunk_plain(*planes, f, w, scal, count, k_chunks,
                                    alpha, cheby_degree, consts, dataterm)
        for t, v in zip(planes, out):
            t.copy_(v)
        return out[7], out[8]
    nx, ny = xh.shape
    dev = xh.device
    route = admm_pick_route(path, nx, ny, dataterm, int(cheby_degree), dev,
                            "admm_multichunk")
    sc = scalar_buffer(scal, 11, _S_CONV, _S_LEN)
    partial = torch.empty(4 * _lib().prost_admm_num_blocks(nx, ny),
                          dtype=torch.float32, device=dev)
    _multichunk_card(planes, f.contiguous(), w.contiguous(), sc, partial,
                     _scratch(route[0], nx, ny, dev), route,
                     count, k_chunks, alpha, cheby_degree, consts, dataterm)
    return sc[_S_NORM:_S_NORM + 4], torch.stack([sc[i] for i in _SOUT])


class ADMMMultichunk:
    """``FusedROFADMM``'s light call of the multichunk: ``admm_multichunk_``
    on the run's own state arrays, with what depends only on the shapes
    and the route made once per route: the path (``route``: (path, tile)
    of ``admm_pick_route``, by the shape rule unless ``path`` asks for
    one), the scratch, the norm partials and the scalar buffer with lmb,
    radius and the tolerances.  A call writes rho, delta, arb_l, arb_u,
    the iteration counter and the flag into the scalar buffer in place
    (one stack and one indexed copy), launches, and reads the norms and
    sout out of it in one gather; on the CPU it runs the plain version."""

    # the slots a call writes: rho, delta, arb_l, arb_u, it, converged, and
    # the chunk count, which the launch advances from 0
    _IN = (0, 3, 4, 5, 6, _S_CONV, _S_DONE)

    def __init__(self, r, count: int, k_chunks: int, alpha: float,
                 degree: int, device, path=None):
        self.r, self.count, self.k_chunks = r, int(count), int(k_chunks)
        self.alpha, self.degree = float(alpha), int(degree)
        nx, ny = r["nx"], r["ny"]
        self.sc = torch.zeros(_S_LEN, dtype=torch.float32, device=device)
        self.sc[1] = r["lmb_t"]
        self.sc[2] = r["radius_t"]
        self.sc[7:11] = torch.stack(r["tols_t"])
        self.stage = torch.empty(len(self._IN), dtype=torch.float32,
                                 device=device)
        self.zero = torch.zeros((), dtype=torch.float32, device=device)
        self.slots_in = torch.tensor(self._IN, device=device)
        self.slots_out = torch.tensor(
            tuple(range(_S_NORM, _S_NORM + 4)) + _SOUT, device=device)
        self.route = None  # (path, tile) on a card
        if torch.device(device).type == "cuda":
            self.route = admm_pick_route(path, nx, ny, r["dataterm"],
                                         self.degree, device,
                                         "admm_multichunk")
            self.partial = torch.empty(
                4 * _lib().prost_admm_num_blocks(nx, ny),
                dtype=torch.float32, device=device)
            self.scratch = _scratch(self.route[0], nx, ny, device)

    @property
    def resident(self):
        """Whether the call runs grid-resident on a card; None on the
        CPU."""
        return None if self.route is None else self.route[0] == "resident"

    def __call__(self, planes, rho, delta, arb_l, arb_u, it, converged):
        """Up to k_chunks chunks on ``planes`` in place from the state's
        scalars (``it`` its iteration counter); returns (norms, sout)."""
        dt = self.sc.dtype
        torch.stack([rho, delta, arb_l, arb_u, it.to(dt),
                     converged.to(dt), self.zero], out=self.stage)
        self.sc.index_copy_(0, self.slots_in, self.stage)
        r = self.r
        if self.route is None:
            scal = self.sc[:_S_CONV + 1]
            out = admm_multichunk_plain(*planes, r["f"], r["w"], scal,
                                        self.count, self.k_chunks,
                                        self.alpha, self.degree,
                                        r["consts"], r["dataterm"])
            for t, v in zip(planes, out):
                t.copy_(v)
            return out[7], out[8]
        _multichunk_card(planes, r["f"], r["w"], self.sc, self.partial,
                         self.scratch, self.route, self.count,
                         self.k_chunks, self.alpha, self.degree,
                         r["consts"], r["dataterm"])
        out = self.sc.index_select(0, self.slots_out)
        return out[:4], out[4:]


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------

class FusedROFADMM(BackendADMM):
    """BackendADMM that runs ROF-structured problems through the fused
    chunk kernels and behaves exactly like BackendADMM otherwise.  Inner
    projection by ``opts.projection``:

    * "auto" (default) and "cheby": the Chebyshev projection, in the
      kernels and in the generic phases around them (one inner solver for
      the whole run), with multichunk launches (phase B0);
    * "cgls": the reference's inner algebra, chunk launches only;
    * "dct": the exact projection, generic path only.
    """

    def __init__(self, problem, opts, solver_opts):
        super().__init__(problem, opts, solver_opts)
        usable = opts.projection in ("auto", "cgls", "cheby")
        self.rof = match_rof_structure(problem) if usable else None
        self.mode = None
        if self.rof is not None:
            self.mode = "cgls" if opts.projection == "cgls" else "cheby"
            like = problem.scaling_left
            r = self.rof
            r["lmb_t"] = like.new_full((), r["lmb"])
            r["radius_t"] = like.new_full((), r["radius"])
            r["tols_t"] = tuple(like.new_full((), float(t))
                                for t in self.tols)
            r["consts"] = admm_adapt_consts(problem, opts)
            r["steps"] = torch.arange(max(int(opts.residual_iter), 1),
                                      dtype=torch.int32, device=like.device)
            if self.mode == "cheby":
                # the generic phases run the same Chebyshev projection
                self.run_opts = dataclasses.replace(opts,
                                                    projection="cheby")
                self.proj_plan = dct_projection_plan(problem)
            if solver_opts.verbose:
                where = ("CUDA kernels" if like.device.type == "cuda"
                         else "plain PyTorch versions on the CPU")
                print(f"FusedROFADMM: fused ROF route, {self.mode} "
                      f"projection ({where}).")

    def run(self, state: ADMMState, until_iter: int,
            start_iter: int) -> ADMMState:
        if self.rof is not None:
            return _fused_admm_run(self, state, until_iter, start_iter)
        return super().run(state, until_iter, start_iter)


def _planes_of(s: ADMMState, nx, ny):
    return (s.x_half.reshape(nx, ny), s.x_proj.reshape(nx, ny),
            s.x_dual.reshape(nx, ny), s.z_half.reshape(2, nx, ny),
            s.z_proj.reshape(2, nx, ny), s.z_dual.reshape(2, nx, ny),
            s.cg_warm.reshape(nx, ny))


def _with_planes(s: ADMMState, outs, **kw) -> ADMMState:
    xh, xp, xd, zh, zp, zd, warm = outs[:7]
    return dataclasses.replace(
        s, x_half=xh.reshape(-1), x_proj=xp.reshape(-1),
        x_dual=xd.reshape(-1), z_half=zh.reshape(-1), z_proj=zp.reshape(-1),
        z_dual=zd.reshape(-1), cg_warm=warm.reshape(-1), **kw)


def _fused_chunk(b: FusedROFADMM, s: ADMMState) -> ADMMState:
    """One chunk: in Chebyshev mode in place on the views of the run's own
    state arrays (``_fused_admm_run``'s canonicalization copies them once
    per run) through the route's light call (``ADMMChunk``, made once per
    route); in CGLS mode ``admm_chunk`` on copies, the launch sequence."""
    r, opts = b.rof, b.run_opts
    ri, dt = max(int(opts.residual_iter), 1), s.x_half.dtype
    if b.mode == "cheby":
        if "chunk" not in r:
            r["chunk"] = ADMMChunk(r, ri, opts.alpha, opts.cheby_degree,
                                   s.x_half.device)
        norms = torch.sqrt(r["chunk"](_planes_of(s, r["nx"], r["ny"]),
                                      s.rho, s.converged))
        new = dataclasses.replace(s, iteration=s.iteration + ri)
    else:
        # the chunk's CG tolerance schedule with cgls_solve's 10 eps clamp
        it_f = (s.iteration + 1 + r["steps"]).to(dt)
        cg_tols = torch.clamp(cg_tolerance(it_f, opts),
                              min=10.0 * torch.finfo(dt).eps)
        scal = torch.stack([s.rho, r["lmb_t"], r["radius_t"],
                            s.converged.to(dt)])
        outs = admm_chunk(*_planes_of(s, r["nx"], r["ny"]), r["f"], r["w"],
                          scal, cg_tols, ri, opts.cg_max_iter, opts.alpha,
                          r["dataterm"])
        norms = torch.sqrt(outs[7])
        new = _with_planes(s, outs, iteration=s.iteration + ri)
    # adaptation sees the post-increment counter of the chunk's last
    # iteration, which is new.iteration
    new = admm_residual_adapt(b.problem, opts, b.tols, new, norms[0],
                              norms[1], norms[2], norms[3])
    return hold_if(s.converged, s, new)


def _multi_chunk(b: FusedROFADMM, s: ADMMState) -> ADMMState:
    """One multichunk in place on the views of the run's own state arrays
    (``_fused_admm_run``'s canonicalization copies them once per run)
    through the route's light call (``ADMMMultichunk``, made once per
    route)."""
    r, opts = b.rof, b.run_opts
    ri = max(int(opts.residual_iter), 1)
    if "call" not in r:
        r["call"] = ADMMMultichunk(r, ri, K_CHUNKS, opts.alpha,
                                   opts.cheby_degree, s.x_half.device)
    norms, sc = r["call"](_planes_of(s, r["nx"], r["ny"]), s.rho, s.delta,
                          s.arb_l, s.arb_u, s.iteration, s.converged)
    done = sc[5].to(torch.int32)
    new = dataclasses.replace(
        s, rho=sc[0], delta=sc[1], arb_l=sc[2], arb_u=sc[3],
        converged=sc[4] > 0.5,
        primal_residual=norms[0], primal_var_norm=norms[1],
        dual_residual=norms[2], dual_var_norm=norms[3],
        iteration=s.iteration + done * ri)
    return hold_if(s.converged, s, new)


def _fused_admm_run(b: FusedROFADMM, state: ADMMState, until: int,
                    start: int) -> ADMMState:
    """The phases of ``ops.phases.run_phases`` around the fused chunks.
    The generic step computes residuals where the post-increment counter
    is a multiple of ri, so a chunk starts where iteration % ri == 0; the
    canonicalization zeroes the dead coordinates of the three z arrays;
    there is no epilogue (the chunks carry the whole state).  Multichunk
    launches (phase B0) run in Chebyshev mode only: the CG tolerance
    schedule is per iteration.  The canonicalization also gives the run
    its own copies of the state arrays, which the Chebyshev chunks' and
    the multichunks' light calls update in place."""
    nx, ny = b.rof["nx"], b.rof["ny"]
    ri = max(int(b.run_opts.residual_iter), 1)

    def canonicalize(s):
        # new z arrays and copies of the x-like ones: the run's own state
        # arrays, which the Chebyshev chunks and multichunks update in
        # place
        return dataclasses.replace(
            s, x_half=s.x_half.clone(), x_proj=s.x_proj.clone(),
            x_dual=s.x_dual.clone(), cg_warm=s.cg_warm.clone(),
            z_half=dead_dual_flat(s.z_half, 1, nx, ny),
            z_proj=dead_dual_flat(s.z_proj, 1, nx, ny),
            z_dual=dead_dual_flat(s.z_dual, 1, nx, ny))

    multichunk = None
    if b.mode == "cheby":
        def multichunk(s):
            return _multi_chunk(b, s)

    return run_phases(state, start, until, ri, 0, b.generic_step,
                      canonicalize, lambda s: _fused_chunk(b, s),
                      multichunk=multichunk)
