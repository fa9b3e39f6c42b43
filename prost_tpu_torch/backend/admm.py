"""Graph-projection ADMM backend, generic path (counterpart of
``prost_tpu/backend/admm.py``).

The algorithm solves the graph-form problem

    min_{x,z} g(x) + f(z)   s.t.  z = K x

by ADMM on the scaled variables x~ = Tau^{-1/2} x, z~ = Sigma^{1/2} z with
K~ = Sigma^{1/2} K Tau^{1/2}.  Per iteration, with x_half/x_proj/x_dual,
z_half/z_proj/z_dual kept in unscaled space:

    t1 = Tau^{-1/2} (alpha x_half + (1-alpha) x_proj + x_dual)
    t2 = Sigma^{1/2} (z_half + z_dual)
    u  = argmin ||K~ u - (t2 - K~ t1)||^2 + ||u||^2    (warm-started)
    x_proj = Tau^{1/2} (u + t1);   z_proj = K x_proj
    x_dual = Tau^{1/2} t1 - x_proj
    z_dual = Sigma^{-1/2} t2 - z_proj
    x_half = prox_g(x_proj - x_dual; tau_diag=Tau,  tau_scal=1/rho)
    z_half = prox_f(z_proj - z_dual; tau_diag=Sigma, tau_scal=rho, invert)

Residuals every ``residual_iter`` iterations:

    primal_res = ||Sigma^{1/2} (K x_half - z_half)||
    primal_var = ||Sigma^{1/2} z_half||
    w = -rho Tau^{-1}  (x_half - x_proj + x_dual)
    y = -rho Sigma     (z_half - z_proj + z_dual)
    dual_var   = ||Tau^{1/2} w||
    dual_res   = ||Tau^{1/2} (w + K^T y)||

rho adapts a la Boyd with delta growth and a rho_prev/rho rescale of both
dual variables.  The CG tolerance tightens as cg_tol_min /
(iter+1)^cg_tol_pow, floored at cg_tol_max.

The inner projection is warm-started CGLS (the reference's), the exact DCT
solve, or a fixed-degree Chebyshev iteration; the last two need a lone
gradient2d operator with a constant preconditioner.

No host reads in ``run``: as ``BackendPDHG.run``, it issues the
iterations the host planned from ``start_iter`` and holds the state on the
device once ``converged`` is set (``hold_if``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import ProstError
from ..problem import Problem
from ..prox.base import apply_proxs
from ..prox.combinators import ProxMoreau
from .cgls import cgls_solve
from .pdhg import hold_if


@dataclasses.dataclass(frozen=True)
class ADMMOptions:
    """Mirror of BackendADMM<T>::Options with the MATLAB defaults."""

    rho0: float = 1.0
    residual_iter: int = 1
    arb_delta: float = 1.05
    arb_tau: float = 0.8
    arb_gamma: float = 1.01
    alpha: float = 1.7
    cg_max_iter: int = 10
    cg_tol_pow: float = 1.3
    cg_tol_min: float = 1e-5
    cg_tol_max: float = 1e-8
    # "cgls" = the reference's warm-started approximate projection;
    # "dct"  = exact graph projection for lone-gradient2d problems with a
    # constant preconditioner (a screened Neumann-Laplacian solve,
    # diagonalized by DCT-II);
    # "cheby" = fixed-coefficient Chebyshev iteration on the same system
    # (spectrum [1, 1 + 8 c^2]), no dot products;
    # "auto" = cgls here; the fused backend (FusedROFADMM) resolves it to
    # Chebyshev.
    projection: str = "auto"
    cheby_degree: int = 10


@dataclasses.dataclass(eq=False)
class ADMMState:
    x_half: torch.Tensor = None
    x_proj: torch.Tensor = None
    x_dual: torch.Tensor = None
    z_half: torch.Tensor = None
    z_proj: torch.Tensor = None
    z_dual: torch.Tensor = None
    cg_warm: torch.Tensor = None  # previous projection solution (scaled)
    rho: torch.Tensor = None
    delta: torch.Tensor = None
    arb_l: torch.Tensor = None
    arb_u: torch.Tensor = None
    iteration: torch.Tensor = None  # int32
    primal_residual: torch.Tensor = None
    dual_residual: torch.Tensor = None
    primal_var_norm: torch.Tensor = None
    dual_var_norm: torch.Tensor = None
    converged: torch.Tensor = None  # bool


class BackendADMM:
    """Host-side object holding static config; the math is in the free
    functions below.  ``run_opts`` and ``proj_plan`` are what the generic
    step runs with (the fused backend points them at its Chebyshev
    projection)."""

    def __init__(self, problem: Problem, opts: ADMMOptions, solver_opts):
        self.problem = problem
        self.opts = opts
        self.run_opts = opts
        self.solver_opts = solver_opts

        # synthesize missing proxes via Moreau
        if problem.prox_g:
            self.prox_g = problem.prox_g
        elif problem.prox_gstar:
            self.prox_g = tuple(ProxMoreau(index=p.index, size=p.size, child=p)
                                for p in problem.prox_gstar)
        else:
            raise ProstError("Neither prox_g nor prox_gstar specified.")

        if problem.prox_f:
            self.prox_f = problem.prox_f
        elif problem.prox_fstar:
            self.prox_f = tuple(ProxMoreau(index=p.index, size=p.size, child=p)
                                for p in problem.prox_fstar)
        else:
            raise ProstError("Neither prox_f nor prox_fstar specified.")

        if opts.projection in ("dct", "cheby"):
            self.proj_plan = dct_projection_plan(problem)
            if self.proj_plan is None:
                raise ProstError(
                    f"ADMMOptions(projection='{opts.projection}') requires "
                    "a lone gradient2d operator with constant "
                    "preconditioner.")
        elif opts.projection in ("cgls", "auto"):
            self.proj_plan = None
        else:
            raise ProstError(f"Unknown projection '{opts.projection}'.")

    @property
    def tols(self):
        s = self.solver_opts
        return (s.tol_rel_primal, s.tol_rel_dual, s.tol_abs_primal,
                s.tol_abs_dual)

    # ------------------------------------------------------------------
    def initial_state(self) -> ADMMState:
        p = self.problem
        dt = p.scaling_left.dtype
        dev = p.scaling_left.device

        def zeros(n):
            return torch.zeros(n, dtype=dt, device=dev)

        def scalar(v=0.0):
            return torch.full((), v, dtype=dt, device=dev)

        x0 = self.solver_opts.x0
        if x0 is None:
            x_half, z_half = zeros(p.ncols), zeros(p.nrows)
        else:
            x_half = torch.as_tensor(x0, dtype=dt).reshape(-1).to(dev)
            if x_half.shape[0] != p.ncols:
                raise ProstError("Initial primal solution has wrong size.")
            z_half = p.linop.apply(x_half)

        return ADMMState(
            x_half=x_half, x_proj=zeros(p.ncols), x_dual=zeros(p.ncols),
            z_half=z_half, z_proj=zeros(p.nrows), z_dual=zeros(p.nrows),
            cg_warm=zeros(p.ncols),
            rho=scalar(self.opts.rho0), delta=scalar(self.opts.arb_delta),
            arb_l=scalar(), arb_u=scalar(),
            iteration=torch.zeros((), dtype=torch.int32, device=dev),
            primal_residual=scalar(), dual_residual=scalar(),
            primal_var_norm=scalar(), dual_var_norm=scalar(),
            converged=torch.zeros((), dtype=torch.bool, device=dev),
        )

    # ------------------------------------------------------------------
    def generic_step(self, s: ADMMState, it: int) -> ADMMState:
        """One generic iteration, held fixed once ``s.converged`` is set;
        ``it`` is the host's count of the iteration (pre-increment): the
        residuals run when the post-increment count ``it + 1`` is a
        multiple of residual_iter."""
        ri = max(int(self.run_opts.residual_iter), 1)
        new = admm_step(self.problem, self.prox_g, self.prox_f,
                        self.run_opts, self.tols, s, (it + 1) % ri == 0,
                        self.proj_plan)
        return hold_if(s.converged, s, new)

    def run(self, state: ADMMState, until_iter: int,
            start_iter: int) -> ADMMState:
        """Run iterations from ``start_iter`` (the host's copy of
        ``state.iteration``) until ``until_iter`` (exclusive) or
        convergence, whichever comes first, without a host read."""
        for it in range(start_iter, until_iter):
            state = self.generic_step(state, it)
        return state

    # ------------------------------------------------------------------
    def current_solution(self, state: ADMMState):
        """(x, z, y, w): primal halves plus duals recovered as
        -rho Sigma^{+1}/Tau^{-1} (half - proj + dual)."""
        p = self.problem
        s = state
        w = -s.rho / p.scaling_right * (s.x_half - s.x_proj + s.x_dual)
        y = -s.rho * p.scaling_left * (s.z_half - s.z_proj + s.z_dual)
        return s.x_half, s.z_half, y, w


def dct_projection_plan(problem):
    """Exact graph-projection plan for a lone BlockGradient2D with constant
    diagonal preconditioner: the tuple (L, nx, ny, c2) with c2 = Sigma*Tau
    (K~^T K~ = c2 G^T G is a scaled Neumann Laplacian, diagonalized by
    DCT-II), or None when the structure does not apply.  Reads the
    preconditioner on the host, once, at backend construction."""
    from ..linop.gradient import BlockGradient2D

    blocks = getattr(problem.linop, "blocks", ())
    if len(blocks) != 1 or not isinstance(blocks[0], BlockGradient2D):
        return None
    b = blocks[0]
    if b.label_first:
        return None
    sl = problem.scaling_left.cpu().numpy()
    sr = problem.scaling_right.cpu().numpy()
    if not (np.allclose(sl, sl[0]) and np.allclose(sr, sr[0])):
        return None
    c2 = float(sl[0]) * float(sr[0])
    return b.L, b.nx, b.ny, c2


def _dct_denom(plan, like):
    """denom[i, j] = 1 + c2*(lam_x[i] + lam_y[j]), the DCT-II eigenvalues
    of I + K~^T K~, made in float64 on the host and cast to ``like``."""
    _, nx, ny, c2 = plan
    lam_x = 4.0 * np.sin(np.pi * np.arange(nx) / (2 * nx)) ** 2
    lam_y = 4.0 * np.sin(np.pi * np.arange(ny) / (2 * ny)) ** 2
    denom = 1.0 + c2 * (lam_x[:, None] + lam_y[None, :])
    return torch.as_tensor(denom, dtype=like.dtype).to(like.device)


def _dct_twiddle(n: int, like):
    """exp(-i pi k / (2n)) for k < n, in ``like``'s complex type."""
    k = torch.arange(n, dtype=torch.float64)
    w = torch.exp(-1j * math.pi * k / (2 * n))
    ctype = torch.complex128 if like.dtype == torch.float64 else \
        torch.complex64
    return w.to(ctype).to(like.device)


def _ortho_scale(n: int, like):
    s = torch.full((n,), math.sqrt(2.0 / n), dtype=like.dtype)
    s[0] = math.sqrt(1.0 / n)
    return s.to(like.device)


def dct2(x, dim: int):
    """Orthonormal DCT-II along ``dim`` (scipy's ``dct(type=2,
    norm='ortho')``) by one FFT of the even/odd reordering (Makhoul):
    y[k] = s_k Re(exp(-i pi k / 2n) FFT(v)[k]), v = [x[0::2], x[1::2]
    reversed]."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
    y = torch.real(torch.fft.fft(v, dim=-1) * _dct_twiddle(n, x))
    return (y * _ortho_scale(n, x)).movedim(-1, dim)


def idct2(y, dim: int):
    """Inverse of ``dct2`` (the orthonormal DCT-III) by one inverse FFT:
    V[k] = (Y[k] - i Y[n-k]) exp(i pi k / 2n) with Y[n] = 0 and
    Y = y / s = Re(exp(-i pi k / 2n) V[k]), then x[2m] = v[m], x[2m+1] =
    v[n-1-m]."""
    y = y.movedim(dim, -1)
    n = y.shape[-1]
    yy = y / _ortho_scale(n, y)
    rev = torch.cat([torch.zeros_like(yy[..., :1]), yy[..., 1:].flip(-1)],
                    dim=-1)  # Y[n-k], Y[n] = 0
    spec = torch.complex(yy, -rev) * torch.conj(_dct_twiddle(n, y))
    v = torch.real(torch.fft.ifft(spec, dim=-1))
    x = torch.empty_like(v)
    half = (n + 1) // 2
    x[..., 0::2] = v[..., :half]
    x[..., 1::2] = v[..., half:].flip(-1)
    return x.movedim(-1, dim)


def _dct_project(plan, rhs):
    """Solve (I + K~^T K~) u = rhs exactly in DCT space."""
    L, nx, ny, _ = plan
    u = rhs.reshape(L, nx, ny)
    spec = dct2(dct2(u, 1), 2)
    spec = spec / _dct_denom(plan, rhs)[None]
    return idct2(idct2(spec, 1), 2).reshape(-1)


def _cheby_project_generic(plan, k_tilde, k_tilde_adj, d, u0, degree: int):
    """Solve min ||K~ u - d||^2 + ||u||^2 by ``degree`` steps of the
    classical Chebyshev iteration on (I + K~^T K~) u = K~^T d, warm-started
    from u0.  The spectrum bound 1 + 8*c2 (Neumann-Laplacian eigenvalues in
    [0, 8) scaled by c2 = Sigma*Tau) gives host-constant coefficients, so
    the solve has no reductions."""
    _, _, _, c2 = plan
    hi = 1.0 + 8.0 * c2
    theta = (hi + 1.0) / 2.0
    delta = (hi - 1.0) / 2.0
    sigma1 = theta / delta

    def M(u):
        return u + k_tilde_adj(k_tilde(u))

    b = k_tilde_adj(d)
    r = b - M(u0)
    x = u0
    dv = r * (1.0 / theta)
    rho_prev = 1.0 / sigma1
    for _ in range(int(degree) - 1):
        x = x + dv
        r = r - M(dv)
        rho_k = 1.0 / (2.0 * sigma1 - rho_prev)
        dv = rho_k * rho_prev * dv + (2.0 * rho_k / delta) * r
        rho_prev = rho_k
    return x + dv


def cg_tolerance(it_f, opts: ADMMOptions):
    """The CG tolerance of the iteration whose post-increment counter is
    ``it_f`` (a float tensor): cg_tol_min / it_f^cg_tol_pow, floored at
    cg_tol_max."""
    num = it_f.new_full((), opts.cg_tol_min)
    return torch.clamp(num / torch.pow(it_f, opts.cg_tol_pow),
                       min=opts.cg_tol_max)


def _sqrt_size(like, n: int):
    return torch.sqrt(like.new_full((), float(n)))


def admm_residual_adapt(problem, opts: ADMMOptions, tols, q: ADMMState,
                        primal_res, primal_norm, dual_res, dual_norm):
    """Store residual norms, test convergence, and run the Boyd
    rho-adaptation with its dual-variable rescale.  ``q.iteration`` is the
    post-increment counter of the residual iteration.  Shared by the
    generic path and the fused path, which computes the norms in its
    kernel."""
    q, fac = admm_adapt(problem, opts, tols, q, primal_res, primal_norm,
                        dual_res, dual_norm)
    return dataclasses.replace(q, x_dual=q.x_dual * fac,
                               z_dual=q.z_dual * fac)


def admm_adapt(problem, opts: ADMMOptions, tols, q: ADMMState, primal_res,
               primal_norm, dual_res, dual_norm):
    """``admm_residual_adapt`` without the rescale of the duals: the state
    with its new scalars, and the factor rho / rho_new by which the duals
    are to be rescaled (the sharded route's duals live in its buffers)."""
    tol_rel_p, tol_rel_d, tol_abs_p, tol_abs_d = tols
    eps_pri = (_sqrt_size(primal_norm, problem.nrows) * tol_abs_p
               + tol_rel_p * primal_norm)
    eps_dua = (_sqrt_size(dual_norm, problem.ncols) * tol_abs_d
               + tol_rel_d * dual_norm)

    it = q.iteration.to(q.rho.dtype)
    c1 = (dual_res < eps_dua) & (opts.arb_tau * it > q.arb_l)
    c2 = (primal_res < eps_pri) & (opts.arb_tau * it > q.arb_u) & ~c1
    rho_new = torch.where(c1, q.rho * q.delta,
                          torch.where(c2, q.rho / q.delta, q.rho))
    delta_new = torch.where(c1 | c2, q.delta * opts.arb_gamma, q.delta)
    arb_u = torch.where(c1, it, q.arb_u)
    arb_l = torch.where(c2, it, q.arb_l)

    # rescale dual variables on rho change
    fac = q.rho / rho_new
    return dataclasses.replace(
        q,
        rho=rho_new, delta=delta_new, arb_l=arb_l, arb_u=arb_u,
        primal_residual=primal_res, primal_var_norm=primal_norm,
        dual_residual=dual_res, dual_var_norm=dual_norm,
        converged=(primal_res < eps_pri) & (dual_res < eps_dua),
    ), fac


def admm_step(problem, prox_g, prox_f, opts: ADMMOptions, tols, s: ADMMState,
              do_res: bool, proj_plan=None) -> ADMMState:
    """One graph-projection ADMM iteration as a function on the state.
    ``do_res`` says whether the post-increment counter is a multiple of
    residual_iter; the caller knows it from its iteration count, where the
    JAX package branches on the device with ``lax.cond``."""
    Sigma = problem.scaling_left
    Tau = problem.scaling_right
    sqrt_S = torch.sqrt(Sigma)
    sqrt_T = torch.sqrt(Tau)
    K = problem.linop

    def k_tilde(u):
        return sqrt_S * K.apply(sqrt_T * u)

    def k_tilde_adj(v):
        return sqrt_T * K.apply_adjoint(sqrt_S * v)

    # relaxed arguments
    t1 = (opts.alpha * s.x_half + (1.0 - opts.alpha) * s.x_proj
          + s.x_dual) / sqrt_T
    t2 = sqrt_S * (s.z_half + s.z_dual)

    # graph projection: min ||K~ u - d||^2 + ||u||^2
    d = t2 - k_tilde(t1)
    if opts.projection == "dct":
        u = _dct_project(proj_plan, k_tilde_adj(d))
    elif opts.projection == "cheby":
        u = _cheby_project_generic(proj_plan, k_tilde, k_tilde_adj, d,
                                   s.cg_warm, opts.cheby_degree)
    else:
        # the reference's warm-started CGLS with its tolerance schedule
        cg_tol = cg_tolerance((s.iteration + 1).to(t1.dtype), opts)
        u, _ = cgls_solve(k_tilde, k_tilde_adj, d, s.cg_warm, 1.0, cg_tol,
                          opts.cg_max_iter)

    x_proj = sqrt_T * (u + t1)
    z_proj = K.apply(x_proj)
    x_dual = sqrt_T * t1 - x_proj
    z_dual = t2 / sqrt_S - z_proj

    # prox steps: g with step Tau/rho, f with inverted step 1/(rho Sigma)
    x_half = apply_proxs(prox_g, x_proj - x_dual, Tau, 1.0 / s.rho, False)
    z_half = apply_proxs(prox_f, z_proj - z_dual, Sigma, s.rho, True)

    s = dataclasses.replace(
        s,
        x_half=x_half, x_proj=x_proj, x_dual=x_dual,
        z_half=z_half, z_proj=z_proj, z_dual=z_dual,
        cg_warm=u, iteration=s.iteration + 1,
    )
    if not do_res:
        return s

    primal_res = torch.linalg.vector_norm(sqrt_S * (K.apply(s.x_half)
                                                    - s.z_half))
    primal_norm = torch.linalg.vector_norm(sqrt_S * s.z_half)
    w = -s.rho / Tau * (s.x_half - s.x_proj + s.x_dual)
    y = -s.rho * Sigma * (s.z_half - s.z_proj + s.z_dual)
    dual_norm = torch.linalg.vector_norm(sqrt_T * w)
    dual_res = torch.linalg.vector_norm(sqrt_T * (w + K.apply_adjoint(y)))
    return admm_residual_adapt(problem, opts, tols, s, primal_res,
                               primal_norm, dual_res, dual_norm)
