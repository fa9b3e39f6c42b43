"""Fused PDHG iteration for ROF-structured problems (counterpart of
``prost_tpu/ops/fused_rof.py``, whole-plane route).

Workload: min_u c/2 ||u - f||^2 + ||grad u||_{2,1} (and the TV-L1 ``abs``
and TV-inpainting ``wsquare`` data terms) with the Pock-Chambolle alpha
preconditioner.  For a lone gradient2d operator the preconditioners are
the constants Sigma = 1/2, Tau = 1/4, so a PDHG iteration is pointwise
work plus two stencils, and the mathematical state is just (x, q).

Two kernels carry the route, each a hand-written CUDA kernel set in
``csrc/fused_rof.cu`` with a plain PyTorch version beside its wrapper here:

* ``rof_chunk`` (JAX ``rof_fused_chunk``): ``count`` iterations ending on a
  residual iteration, with the four squared preconditioned residual norms;
* ``rof_multichunk`` (JAX ``rof_fused_multichunk``): up to ``k_chunks``
  chunks with the boyd/goldstein adaptation and the stopping test on the
  device between chunks.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel, or raises.  There is no other route and no fallback:
unlike the JAX package, the fused route does not drop to the generic path
when a kernel fails to build or launch, and it is taken on any device (the
JAX package gates it off on the CPU unless ``interpret`` is set).

Layout contract (the JAX package's, at every public function): x viewed
(nx, ny) row-major, y = [gx; gy] stacked planes, q viewed (2, nx, ny).

Dead dual coordinates.  q_x's last row and q_y's last column multiply
structurally zero rows of K.  They are zeroed once per run and at every
chunk entry (``_project_dead_dual``); then the maskless adjoint stencil is
exact, and the CUDA kernels can read plain bounds-checked neighbours.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..backend.pdhg import BackendPDHG, PDHGState, hold_if, residual_and_adapt
from ..config import ProstError, dtype as config_dtype
from ..linop.base import LinearOperator
from ..linop.gradient import BlockGradient2D
from ..prox.combinators import ProxMoreau
from ..prox.elemop import ProxElem1D, ProxElemNorm2
from .phases import K_CHUNKS, run_phases

_SQRT_S = 0.7071067811865476  # sqrt(Sigma) = sqrt(1/2)
_SQRT_T = 0.5                 # sqrt(Tau)   = sqrt(1/4)

DATATERMS = {"square": 0, "wsquare": 1, "abs": 2}
# alg2 never reaches the fused route; alg1 runs the stopping test only
STEPSIZES = {"alg1": 0, "goldstein": 1, "boyd": 2}

# slots of the kernels' device scalar buffer (csrc/fused_rof.cu, enum S_*)
_S_CONV, _S_DONE, _S_NORM, _S_LEN = 13, 14, 15, 19
_SOUT = (0, 1, 5, 6, 7, _S_CONV, _S_DONE)  # tau sigma aa arb_l arb_u conv done

# launches of each kernel wrapper on the card (CPU calls do not count)
launch_counts = {"rof_chunk": 0, "rof_multichunk": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions of the chunk math
# ---------------------------------------------------------------------------

def _dx(u):
    """Forward difference along rows, Neumann (zero last row)."""
    return torch.cat([u[1:] - u[:-1], torch.zeros_like(u[:1])], dim=0)


def _dy(u):
    """Forward difference along columns, Neumann (zero last column)."""
    return torch.cat([u[:, 1:] - u[:, :-1], torch.zeros_like(u[:, :1])],
                     dim=1)


def _dxt(p):
    """Maskless adjoint of _dx, exact given p[-1, :] == 0."""
    return torch.roll(p, 1, 0) - p


def _dyt(p):
    """Maskless adjoint of _dy, exact given p[:, -1] == 0."""
    return torch.roll(p, 1, 1) - p


def _project_dead_dual(qx, qy):
    """Zero the dead dual coordinates: q_x's last row and q_y's last
    column never enter K^T y, the ball projection maps zeros to zeros, so
    this is a no-op on every state the solver produces from y0 = 0.  A warm
    start with mass there is projected off it (the generic path lets it
    decay instead; tests pin this deviation)."""
    qx, qy = qx.clone(), qy.clone()
    qx[-1, :] = 0.0
    qy[:, -1] = 0.0
    return qx, qy


def _hoist_dataterm(f, w, tau, lmb, dataterm: str):
    """Constant planes/scalars of the primal prox within a chunk: square and
    wsquare share x_new = (arg + dt0) * dt1; abs keeps (f, shrink)."""
    if dataterm == "square":
        return (tau * lmb) * f, 1.0 / (1.0 + tau * lmb)
    if dataterm == "wsquare":
        tw = (tau * lmb) * w
        return tw * f, 1.0 / (1.0 + tw)
    return f, tau * lmb  # abs


def _ball_scale(ax, ay, radius):
    """min(1, r / |a|) for the r-ball projection.  A zero vector keeps scale
    1 (its projection is itself): rsqrt(0) = inf would make radius * inf
    NaN for radius == 0, where the JAX package's form gives NaN."""
    nn = ax * ax + ay * ay
    s = torch.clamp(radius * torch.rsqrt(nn), max=1.0)
    return torch.where(nn > 0, s, torch.ones_like(s))


def _rof_update(x, qx, qy, gx, gy, dt0, dt1, tau, sig_p, sig_t, radius,
                dataterm: str):
    """One preconditioned PDHG update.  tau arrives pre-multiplied by
    Tau = 1/4; sig_p = sigma*Sigma*(1+theta), sig_t = sigma*Sigma*theta;
    (gx, gy) is grad(x) carried from the previous iteration.  Returns the
    new state, the new gradient planes and K^T of the old dual."""
    kty = _dxt(qx) + _dyt(qy)
    arg = x - tau * kty
    if dataterm in ("square", "wsquare"):
        x_new = (arg + dt0) * dt1
    else:  # abs: soft shrink toward f as arg - clamp(arg - f, -t, t)
        d = arg - dt0
        x_new = arg - torch.minimum(torch.maximum(d, -dt1), dt1)
    gx_new = _dx(x_new)
    gy_new = _dy(x_new)
    ax = qx + sig_p * gx_new - sig_t * gx
    ay = qy + sig_p * gy_new - sig_t * gy
    scale = _ball_scale(ax, ay, radius)
    return x_new, ax * scale, ay * scale, gx_new, gy_new, kty


def _chunk_core(tau_raw, sigma_raw, theta, lmb, radius, x0, qx0, qy0, f, w,
                count: int, dataterm: str, g0=None, return_g=False):
    """One residual_iter-sized chunk: ``count - 1`` plain iterations, then
    the aligned iteration with its four preconditioned residual norms
    (squared).  ``g0`` seeds the carried gradient (a previous chunk's
    grad(x2)); ``return_g`` also returns grad(x2).

    Returns (x2, qx2, qy2, x_prev, qx_prev, qy_prev, (n0, n1, n2, n3)
    [, (gx2, gy2)])."""
    tau = tau_raw * 0.25       # tau * Tau
    sigma_p = sigma_raw * 0.5  # sigma * Sigma
    sig_p = sigma_p * (1.0 + theta)
    sig_t = sigma_p * theta
    dt0, dt1 = _hoist_dataterm(f, w if dataterm == "wsquare" else None, tau,
                               lmb, dataterm)
    qx, qy = _project_dead_dual(qx0, qy0)
    x = x0
    gx, gy = (_dx(x0), _dy(x0)) if g0 is None else g0
    for _ in range(count - 1):
        x, qx, qy, gx, gy, _ = _rof_update(x, qx, qy, gx, gy, dt0, dt1, tau,
                                           sig_p, sig_t, radius, dataterm)
    gxp, gyp = gx, gy
    # aligned iteration; (gxp, gyp) is grad(x_prev) carried for free
    x2, qx2, qy2, gx2, gy2, ktyp = _rof_update(
        x, qx, qy, gxp, gyp, dt0, dt1, tau, sig_p, sig_t, radius, dataterm)
    kty2 = _dxt(qx2) + _dyt(qy2)

    inv_s = 1.0 / (sigma_raw * _SQRT_S)
    zh_x = (qx - qx2) * inv_s + _SQRT_S * ((1.0 + theta) * gx2 - theta * gxp)
    zh_y = (qy - qy2) * inv_s + _SQRT_S * ((1.0 + theta) * gy2 - theta * gyp)
    pd_x = zh_x - _SQRT_S * gx2
    pd_y = zh_y - _SQRT_S * gy2
    wh = (x - x2) * (1.0 / (tau_raw * _SQRT_T)) - _SQRT_T * ktyp
    dd = wh + _SQRT_T * kty2

    norms = (
        torch.sum(pd_x * pd_x) + torch.sum(pd_y * pd_y),
        torch.sum(zh_x * zh_x) + torch.sum(zh_y * zh_y),
        torch.sum(dd * dd),
        torch.sum(wh * wh),
    )
    if return_g:
        return x2, qx2, qy2, x, qx, qy, norms, (gx2, gy2)
    return x2, qx2, qy2, x, qx, qy, norms


def adapt_scalars(stepsize: str, consts, tols4, it, tau, sigma, arg_alpha,
                  arb_l, arb_u, pr, pn, dr, dn):
    """The scalar math of ``backend.pdhg.residual_and_adapt`` as the
    multichunk kernel runs it between chunks: same operations in the same
    order on f32 0-d tensors.  ``consts`` = (sqrt_nrows, sqrt_ncols,
    arg_delta, arg_nu, arb_delta, arb_tau) are Python floats; ``it`` is the
    pre-increment counter of the residual iteration as f32.

    Returns (tau, sigma, arg_alpha, arb_l, arb_u, converged)."""
    trp, trd, tap, tad = tols4
    sqrt_nrows, sqrt_ncols, arg_delta, arg_nu, arb_delta, arb_tau = consts
    eps_pri = sqrt_nrows * tap + trp * pn
    eps_dua = sqrt_ncols * tad + trd * dn
    conv = (pr < eps_pri) & (dr < eps_dua)
    if stepsize == "goldstein":
        scale = eps_dua / eps_pri
        up = dr > scale * pr * arg_delta
        dn_ = dr < scale * pr / arg_delta
        fac = 1.0 - arg_alpha
        tau = torch.where(up, tau / fac, torch.where(dn_, tau * fac, tau))
        sigma = torch.where(up, sigma * fac,
                            torch.where(dn_, sigma / fac, sigma))
        arg_alpha = torch.where(up | dn_, arg_alpha * arg_nu, arg_alpha)
    elif stepsize == "boyd":
        c1 = (dr < eps_dua) & (arb_tau * it > arb_l)
        c2 = (pr < eps_pri) & (arb_tau * it > arb_u) & ~c1
        tau = torch.where(c1, tau / arb_delta,
                          torch.where(c2, tau * arb_delta, tau))
        sigma = torch.where(c1, sigma * arb_delta,
                            torch.where(c2, sigma / arb_delta, sigma))
        arb_u = torch.where(c1, it, arb_u)
        arb_l = torch.where(c2, it, arb_l)
    return tau, sigma, arg_alpha, arb_l, arb_u, conv


def pdhg_adapt_consts(problem, opts) -> tuple:
    """The constant tuple for ``adapt_scalars``."""
    return (math.sqrt(float(problem.nrows)), math.sqrt(float(problem.ncols)),
            float(opts.arg_delta), float(opts.arg_nu),
            float(opts.arb_delta), float(opts.arb_tau))


def _entry_converged(scal, n: int):
    """The optional converged-at-entry flag after the first ``n`` scalars."""
    if scal.numel() > n:
        return scal[n] != 0
    return torch.zeros((), dtype=torch.bool, device=scal.device)


def rof_chunk_plain(x, q, f, w, scal, count: int, dataterm: str = "square"):
    """Plain PyTorch version of ``rof_chunk`` (any device)."""
    x2, qx2, qy2, xp, qxp, qyp, norms = _chunk_core(
        scal[0], scal[1], scal[2], scal[3], scal[4], x, q[0], q[1], f, w,
        int(count), dataterm)
    q2, qp = torch.stack([qx2, qy2]), torch.stack([qxp, qyp])
    n2 = torch.stack(norms)
    conv = _entry_converged(scal, 5)
    return (torch.where(conv, x, x2), torch.where(conv, q, q2),
            torch.where(conv, x, xp), torch.where(conv, q, qp),
            torch.where(conv, torch.zeros_like(n2), n2))


def rof_multichunk_plain(x, q, f, w, scal, count: int, k_chunks: int,
                         dataterm: str, stepsize: str, consts):
    """Plain PyTorch version of ``rof_multichunk`` (any device): every
    chunk is computed and kept only while not converged, where the JAX
    kernel branches around it with ``lax.cond``."""
    theta, lmb, radius = scal[2], scal[3], scal[4]
    it0 = scal[8]
    tols4 = (scal[9], scal[10], scal[11], scal[12])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    planes = (x, q[0], q[1], x, q[0], q[1], _dx(x), _dy(x))
    sc = (scal[0], scal[1], scal[5], scal[6], scal[7],
          _entry_converged(scal, 13), zero)
    norms = (zero, zero, zero, zero)
    for c in range(int(k_chunks)):
        xc, qx, qy, _, _, _, gx, gy = planes
        tau, sigma, aa, al, au, conv, done = sc
        x2, qx2, qy2, xpn, qxpn, qypn, nrm, g2 = _chunk_core(
            tau, sigma, theta, lmb, radius, xc, qx, qy, f, w, int(count),
            dataterm, g0=(gx, gy), return_g=True)
        pr, pn = torch.sqrt(nrm[0]), torch.sqrt(nrm[1])
        dr, dn = torch.sqrt(nrm[2]), torch.sqrt(nrm[3])
        it = it0 + float((c + 1) * int(count) - 1)
        tau2, sigma2, aa2, al2, au2, cv = adapt_scalars(
            stepsize, consts, tols4, it, tau, sigma, aa, al, au,
            pr, pn, dr, dn)
        new_planes = (x2, qx2, qy2, xpn, qxpn, qypn, g2[0], g2[1])
        new_sc = (tau2, sigma2, aa2, al2, au2, cv, done + 1.0)
        planes = tuple(torch.where(conv, a, b)
                       for a, b in zip(planes, new_planes))
        sc = tuple(torch.where(conv, a, b) for a, b in zip(sc, new_sc))
        norms = tuple(torch.where(conv, a, b)
                      for a, b in zip(norms, (pr, pn, dr, dn)))
    x2, qx2, qy2, xp, qxp, qyp, _, _ = planes
    tau, sigma, aa, al, au, conv, done = sc
    sout = torch.stack([tau, sigma, aa, al, au, conv.to(x.dtype), done])
    return (x2, torch.stack([qx2, qy2]), xp, torch.stack([qxp, qyp]),
            torch.stack(norms), sout)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(x, q, f, w, scal, n_scal: int, count: int, dataterm: str):
    if dataterm not in DATATERMS:
        raise ProstError(f"Unknown ROF data term '{dataterm}'.")
    if int(count) < 1:
        raise ProstError("A chunk needs count >= 1.")
    if x.dim() != 2 or min(x.shape) < 2:
        raise ProstError(f"x must be an (nx, ny) plane, got {tuple(x.shape)}.")
    nx, ny = x.shape
    for name, t, shape in (("q", q, (2, nx, ny)), ("f", f, (nx, ny)),
                           ("w", w, (nx, ny))):
        if tuple(t.shape) != shape:
            raise ProstError(f"{name} must be {shape}, got {tuple(t.shape)}.")
    if scal.numel() not in (n_scal, n_scal + 1):
        raise ProstError(f"scal must hold {n_scal} scalars "
                         f"(+1 converged flag), got {scal.numel()}.")
    dev = x.device
    for t in (x, q, f, w, scal):
        if t.device != dev:
            raise ProstError("All tensors must be on one device.")
        if dev.type == "cuda" and t.dtype != torch.float32:
            raise ProstError("The CUDA ROF kernels take float32 only.")
    if dev.type not in ("cpu", "cuda"):
        raise ProstError(f"No ROF kernel for device {dev}.")


class _Work:
    """The buffers one kernel call works on in place: the state planes
    (copies of the inputs, so a call that returns at once hands its inputs
    back), the carried gradients, the scalar buffer and the norm partials."""

    def __init__(self, x, q, scal, n_scal: int):
        self.x, self.q = x.contiguous().clone(), q.contiguous().clone()
        self.xp, self.qp = self.x.clone(), self.q.clone()
        self.g, self.gp = torch.empty_like(self.q), torch.empty_like(self.q)
        self.sc = torch.zeros(_S_LEN, dtype=torch.float32, device=x.device)
        self.sc[:n_scal] = scal[:n_scal]
        if scal.numel() > n_scal:
            self.sc[_S_CONV] = scal[n_scal]

    def args(self, lib, f, w):
        nx, ny = self.x.shape
        nblocks = lib.prost_rof_num_blocks(nx, ny)
        self.partial = torch.empty(4 * nblocks, dtype=torch.float32,
                                   device=self.x.device)
        ptrs = (self.x, self.q, self.xp, self.qp, self.g, self.gp,
                f.contiguous(), w.contiguous(), self.sc, self.partial)
        self._keep = ptrs  # alive until the launches are queued
        return [_ptr(t) for t in ptrs] + [nx, ny]


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _lib():
    """The fused ROF kernel library, built from csrc/fused_rof.cu on first
    use."""
    from .cuda_build import load

    lib = load("fused_rof").lib
    if not getattr(lib, "_prost_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.prost_rof_num_blocks.argtypes = [ci, ci]
        lib.prost_rof_num_blocks.restype = ci
        lib.prost_error_string.argtypes = [ci]
        lib.prost_error_string.restype = ctypes.c_char_p
        lib.prost_rof_chunk.argtypes = [vp] * 10 + [ci] * 4 + [vp]
        lib.prost_rof_chunk.restype = ci
        lib.prost_rof_multichunk.argtypes = ([vp] * 10 + [ci] * 6 + [cf] * 6
                                             + [vp])
        lib.prost_rof_multichunk.restype = ci
        lib._prost_typed = True
    return lib


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.prost_error_string(rc).decode()
        raise ProstError(f"{what}: CUDA launch failed ({rc}: {msg}).")


def rof_chunk(x, q, f, w, scal, count: int, dataterm: str = "square"):
    """``count`` fused iterations ending on a residual iteration.

    x, f, w: (nx, ny); q: (2, nx, ny); scal: [tau, sigma, theta, lmb,
    radius] (+ an optional converged flag: when set, nothing runs and the
    inputs come back).  Returns (x2, q2, x_prev, q_prev, norms2), norms2
    the 4 SQUARED preconditioned residual norms, on the inputs' device.
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    _check(x, q, f, w, scal, 5, count, dataterm)
    if x.device.type == "cpu":
        return rof_chunk_plain(x, q, f, w, scal, count, dataterm)
    lib = _lib()
    with torch.cuda.device(x.device):
        wk = _Work(x, q, scal, 5)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.prost_rof_chunk(*wk.args(lib, f, w), int(count),
                                 DATATERMS[dataterm], stream)
        _raise_on(lib, rc, "rof_chunk")
        launch_counts["rof_chunk"] += 1
    return wk.x, wk.q, wk.xp, wk.qp, wk.sc[_S_NORM:_S_NORM + 4]


def rof_multichunk(x, q, f, w, scal, count: int, k_chunks: int,
                   dataterm: str, stepsize: str, consts):
    """Up to ``k_chunks * count`` fused iterations with the adaptation and
    the stopping test on the device between chunks.

    ``scal`` holds 13 scalars: [tau, sigma, theta, lmb, radius, arg_alpha,
    arb_l, arb_u, it0, tol_rel_p, tol_rel_d, tol_abs_p, tol_abs_d] (+ an
    optional converged-at-entry flag).  Returns (x2, q2, x_prev, q_prev,
    norms, sout): norms the last executed chunk's sqrt'd residual norms,
    sout = [tau, sigma, arg_alpha, arb_l, arb_u, converged, chunks_done].
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    _check(x, q, f, w, scal, 13, count, dataterm)
    if stepsize not in STEPSIZES:
        raise ProstError(f"No fused adaptation for stepsize '{stepsize}'.")
    if x.device.type == "cpu":
        return rof_multichunk_plain(x, q, f, w, scal, count, k_chunks,
                                    dataterm, stepsize, consts)
    lib = _lib()
    with torch.cuda.device(x.device):
        wk = _Work(x, q, scal, 13)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.prost_rof_multichunk(
            *wk.args(lib, f, w), int(count), int(k_chunks),
            DATATERMS[dataterm], STEPSIZES[stepsize],
            *[float(c) for c in consts], stream)
        _raise_on(lib, rc, "rof_multichunk")
        launch_counts["rof_multichunk"] += 1
    sout = torch.stack([wk.sc[i] for i in _SOUT])
    return wk.x, wk.q, wk.xp, wk.qp, wk.sc[_S_NORM:_S_NORM + 4], sout


# ---------------------------------------------------------------------------
# structure matching and the backend
# ---------------------------------------------------------------------------

def _isscalar(v) -> bool:
    return isinstance(v, (int, float))


def _plane(v, nx, ny, dev):
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).reshape(nx, ny).contiguous()
    return torch.full((nx, ny), float(v), dtype=torch.float32, device=dev)


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
    dev = problem.scaling_left.device
    nx, ny = blk.nx, blk.ny
    # --- data term ---------------------------------------------------------
    pg = problem.prox_g[0]
    if not isinstance(pg, ProxElem1D) or pg.fun not in ("square", "abs"):
        return None
    a, b, c, d, e, _, _ = pg.coeffs
    if not (_isscalar(c) and _isscalar(d) and d == 0.0
            and _isscalar(e) and e == 0.0):
        return None
    if _isscalar(a) and a == 1.0:
        dataterm = "square" if pg.fun == "square" else "abs"
        f = _plane(b, nx, ny, dev)
        w = f  # ignored placeholder (keeps the kernel arity fixed)
    elif (pg.fun == "square" and isinstance(a, torch.Tensor)
          and a.numel() == nx * ny):
        # weighted quadratic lmb/2 (a u - b)^2 == lmb/2 a^2 (u - b/a)^2:
        # the masked data term of TV inpainting
        dataterm = "wsquare"
        a64 = a.to(torch.float64).reshape(-1)
        b64 = (b.to(torch.float64).reshape(-1) if isinstance(b, torch.Tensor)
               else torch.full_like(a64, float(b)))
        b64 = torch.broadcast_to(b64, a64.shape)
        safe = torch.where(a64 != 0, a64, torch.ones_like(a64))
        f = _plane(torch.where(a64 != 0, b64 / safe, torch.zeros_like(a64)),
                   nx, ny, dev)
        w = _plane(a64 ** 2, nx, ny, dev)
    else:
        return None

    # --- regularizer: per-pixel r-ball projection of the dual --------------
    pf = problem.prox_fstar[0]
    if isinstance(pf, ProxMoreau):
        inner = pf.child
        if not isinstance(inner, ProxElemNorm2) or inner.fun != "abs":
            return None
        if inner.dim != 2 or inner.interleaved:
            return None
        ia, ib, ic, idd, ie, _, _ = inner.coeffs
        for v, want in ((ia, 1.0), (ib, 0.0), (idd, 0.0), (ie, 0.0)):
            if not (_isscalar(v) and v == want):
                return None
        if not _isscalar(ic):
            return None
        radius = float(ic)  # conjugate of c|x| -> radius-c ball
    elif isinstance(pf, ProxElemNorm2) and pf.fun == "ind_leq0":
        if pf.dim != 2 or pf.interleaved:
            return None
        ia, ib, ic, idd, ie, _, _ = pf.coeffs
        for v in (ia, ib, ic):
            if not _isscalar(v):
                return None
        if idd != 0.0 or ie != 0.0 or ia <= 0:
            return None
        radius = float(ib) / float(ia)  # I(a|x| - b <= 0) -> b/a ball
    else:
        return None

    # constant alpha preconditioner for a lone gradient2d block
    sl, sr = problem.scaling_left, problem.scaling_right
    if not (torch.allclose(sl, torch.full_like(sl, 0.5))
            and torch.allclose(sr, torch.full_like(sr, 0.25))):
        return None
    return {"nx": nx, "ny": ny, "f": f, "w": w, "lmb": float(c),
            "radius": radius, "dataterm": dataterm}


class FusedROFPDHG(BackendPDHG):
    """BackendPDHG that runs ROF-structured problems through the fused
    chunk kernels and behaves exactly like BackendPDHG otherwise.  Residual
    iterations take their norms from the kernels, and the adaptation and
    stopping test follow the generic code's order of operations."""

    def __init__(self, problem, opts, solver_opts):
        super().__init__(problem, opts, solver_opts)
        # alg2 changes (tau, sigma, theta) every iteration while a chunk
        # holds them fixed; the reference-exact residual sequence needs the
        # generic path
        usable = opts.stepsize != "alg2" and not opts.reference_residuals
        self.rof = match_rof_structure(problem) if usable else None
        if self.rof is not None:
            like = problem.scaling_left
            r = self.rof
            r["lmb_t"] = like.new_full((), r["lmb"])
            r["radius_t"] = like.new_full((), r["radius"])
            r["tols_t"] = tuple(like.new_full((), float(t))
                                for t in self.tols)
            r["consts"] = pdhg_adapt_consts(problem, opts)
            if solver_opts.verbose:
                where = ("CUDA kernels" if like.device.type == "cuda"
                         else "plain PyTorch versions on the CPU")
                print(f"FusedROFPDHG: fused ROF route ({where}).")

    def run(self, state: PDHGState, until_iter: int,
            start_iter: int) -> PDHGState:
        if self.rof is not None:
            return _fused_rof_run(self, state, until_iter, start_iter)
        return super().run(state, until_iter, start_iter)


def _dead_dual_flat(yf, nx, ny):
    q = yf.reshape(2, nx, ny)
    qx, qy = _project_dead_dual(q[0], q[1])
    return torch.stack([qx, qy]).reshape(-1)


def _multi_chunk(b: FusedROFPDHG, s: PDHGState) -> PDHGState:
    r, ri = b.rof, max(int(b.opts.residual_iter), 1)
    nx, ny, dt = r["nx"], r["ny"], s.x.dtype
    scal = torch.stack([
        s.tau, s.sigma, s.theta, r["lmb_t"], r["radius_t"],
        s.arg_alpha, s.arb_l, s.arb_u, s.iteration.to(dt), *r["tols_t"],
        s.converged.to(dt)])
    x2, q2, xp, qp, norms, sc = rof_multichunk(
        s.x.reshape(nx, ny), s.y.reshape(2, nx, ny), r["f"], r["w"], scal,
        ri, K_CHUNKS, r["dataterm"], b.opts.stepsize, r["consts"])
    done = sc[6].to(torch.int32)
    new = dataclasses.replace(
        s,
        x=x2.reshape(-1), y=q2.reshape(-1),
        x_prev=xp.reshape(-1), y_prev=qp.reshape(-1),
        tau=sc[0], sigma=sc[1], arg_alpha=sc[2], arb_l=sc[3], arb_u=sc[4],
        converged=sc[5] > 0.5,
        primal_residual=norms[0], primal_var_norm=norms[1],
        dual_residual=norms[2], dual_var_norm=norms[3],
        iteration=s.iteration + done * ri,
    )
    return hold_if(s.converged, s, new)


def _fused_chunk(b: FusedROFPDHG, s: PDHGState) -> PDHGState:
    r, ri = b.rof, max(int(b.opts.residual_iter), 1)
    nx, ny, dt = r["nx"], r["ny"], s.x.dtype
    scal = torch.stack([s.tau, s.sigma, s.theta, r["lmb_t"], r["radius_t"],
                        s.converged.to(dt)])
    x2, q2, xp, qp, norms2 = rof_chunk(
        s.x.reshape(nx, ny), s.y.reshape(2, nx, ny), r["f"], r["w"], scal,
        ri, r["dataterm"])
    norms = torch.sqrt(norms2)
    new = dataclasses.replace(
        s, x=x2.reshape(-1), y=q2.reshape(-1),
        x_prev=xp.reshape(-1), y_prev=qp.reshape(-1))
    # the chunk covers iterations s.iteration .. s.iteration + ri - 1; the
    # residual iteration's pre-increment counter is the last of them
    new = residual_and_adapt(b.problem, b.opts, b.tols, new,
                             norms[0], norms[1], norms[2], norms[3],
                             s.iteration + (ri - 1))
    new = dataclasses.replace(new, iteration=new.iteration + ri)
    return hold_if(s.converged, s, new)


def _fused_rof_run(b: FusedROFPDHG, state: PDHGState, until: int,
                   start: int) -> PDHGState:
    """The phases of ``ops.phases.run_phases`` around the fused chunks.
    A chunk starts where iteration % ri == 1 (pre-increment counter), so
    it ends on a residual iteration; the canonicalization zeroes the dead
    dual coordinates of y and y_prev; the epilogue refreshes kx, kty,
    kx_prev and kty_prev, which the chunks do not carry."""
    r, lin = b.rof, b.problem.linop
    nx, ny = r["nx"], r["ny"]
    ri = max(int(b.opts.residual_iter), 1)

    def canonicalize(s):
        return dataclasses.replace(s, y=_dead_dual_flat(s.y, nx, ny),
                                   y_prev=_dead_dual_flat(s.y_prev, nx, ny))

    def epilogue(s):
        return dataclasses.replace(
            s, kx=lin.apply(s.x), kty=lin.apply_adjoint(s.y),
            kx_prev=lin.apply(s.x_prev),
            kty_prev=lin.apply_adjoint(s.y_prev))

    return run_phases(state, start, until, ri, 1 % ri, b.generic_step,
                      canonicalize, lambda s: _fused_chunk(b, s),
                      multichunk=lambda s: _multi_chunk(b, s),
                      epilogue=epilogue)
