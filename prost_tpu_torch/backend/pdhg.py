"""Primal-dual hybrid gradient (PDHG / Chambolle-Pock) backend, generic path
(counterpart of ``prost_tpu/backend/pdhg.py``).

Iteration (on the preconditioned problem; Sigma = scaling_left diag,
Tau = scaling_right diag):

    x^{k+1} = prox_g^{tau Tau}  (x^k - tau Tau K^T y^k)
    y^{k+1} = prox_f*^{sigma Sigma}(y^k + sigma Sigma ((1+theta) K x^{k+1} - theta K x^k))

Residuals (preconditioned, every ``residual_iter`` iterations):

    z_hat = (y^k - y^{k+1})/(sigma sqrt(Sigma)) + sqrt(Sigma)((1+theta)Kx^{k+1} - theta Kx^k)
    primal_residual = || z_hat - sqrt(Sigma) Kx^{k+1} ||,  primal_var_norm = ||z_hat||
    w_hat = (x^k - x^{k+1})/(tau sqrt(Tau)) - sqrt(Tau) K^T y^k
    dual_residual = || w_hat + sqrt(Tau) K^T y^{k+1} ||,   dual_var_norm = ||w_hat||

As in the JAX package, the default mode computes K^T y^{k+1} before the
residual and persists the ``*_prev`` iterates only on residual iterations;
``reference_residuals=True`` reproduces the reference's exact sequence
(stale K^T y pair, prevs rotated every iteration).

Step-size schemes: alg1 (constant), alg2 (accelerated), goldstein
(residual balancing) and boyd (residual converging).

No host reads in ``run``.  Every field of ``PDHGState`` is a device
tensor, 0-d for the scalars.  The JAX path loops in ``lax.while_loop`` and
stops at convergence; PyTorch runs eagerly, so ``run`` instead issues the
iterations the host planned from ``start_iter`` (the caller's copy of
``state.iteration``, read at its last sync) and holds the state fixed on
the device once ``converged`` is set (``hold_if``).  The solver reads the
state only at callback epochs, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ProstError
from ..problem import Problem
from ..prox.base import apply_proxs
from ..prox.combinators import ProxMoreau


@dataclasses.dataclass(frozen=True)
class PDHGOptions:
    """Mirror of BackendPDHG<T>::Options with the MATLAB defaults."""

    tau0: float = 1.0
    sigma0: float = 1.0
    residual_iter: int = 1
    scale_steps_operator: bool = True
    alg2_gamma: float = 0.0
    arg_alpha0: float = 0.5
    arg_nu: float = 0.95
    arg_delta: float = 1.5
    arb_delta: float = 1.05
    arb_tau: float = 0.8
    stepsize: str = "boyd"  # alg1 | alg2 | goldstein | boyd
    # reproduce the reference's exact residual sequence (stale-kty dual
    # residual + every-iteration prev rotation)
    reference_residuals: bool = False


@dataclasses.dataclass(eq=False)
class PDHGState:
    x: torch.Tensor = None
    y: torch.Tensor = None
    kx: torch.Tensor = None
    kty: torch.Tensor = None
    x_prev: torch.Tensor = None
    y_prev: torch.Tensor = None
    kx_prev: torch.Tensor = None
    kty_prev: torch.Tensor = None
    tau: torch.Tensor = None
    sigma: torch.Tensor = None
    theta: torch.Tensor = None
    arg_alpha: torch.Tensor = None  # goldstein state
    arb_l: torch.Tensor = None      # boyd state
    arb_u: torch.Tensor = None
    iteration: torch.Tensor = None  # int32
    primal_residual: torch.Tensor = None
    dual_residual: torch.Tensor = None
    primal_var_norm: torch.Tensor = None
    dual_var_norm: torch.Tensor = None
    converged: torch.Tensor = None  # bool


def hold_if(cond, old: PDHGState, new: PDHGState) -> PDHGState:
    """``new``, with every field it changed put back to ``old``'s value
    where the 0-d bool ``cond`` is set: an iteration issued after
    convergence leaves the state as it was, without a host read."""
    changes = {}
    for f in dataclasses.fields(new):
        a, b = getattr(old, f.name), getattr(new, f.name)
        if b is not a:
            changes[f.name] = torch.where(cond, a, b)
    return dataclasses.replace(new, **changes)


class BackendPDHG:
    """Host-side object holding static config; the math is in the free
    functions below."""

    def __init__(self, problem: Problem, opts: PDHGOptions, solver_opts):
        self.problem = problem
        self.opts = opts
        self.solver_opts = solver_opts

        # synthesize missing proxes via Moreau
        if problem.prox_g:
            self.prox_g = problem.prox_g
        elif problem.prox_gstar:
            self.prox_g = tuple(ProxMoreau(index=p.index, size=p.size, child=p)
                                for p in problem.prox_gstar)
        else:
            raise ProstError("Neither prox_g nor prox_gstar specified.")

        if problem.prox_fstar:
            self.prox_fstar = problem.prox_fstar
        elif problem.prox_f:
            self.prox_fstar = tuple(
                ProxMoreau(index=p.index, size=p.size, child=p)
                for p in problem.prox_f)
        else:
            raise ProstError("Neither prox_f nor prox_fstar specified.")

    @property
    def tols(self):
        s = self.solver_opts
        return (s.tol_rel_primal, s.tol_rel_dual, s.tol_abs_primal,
                s.tol_abs_dual)

    # ------------------------------------------------------------------
    def initial_state(self) -> PDHGState:
        p = self.problem
        dt = p.scaling_left.dtype
        dev = p.scaling_left.device
        tau, sigma = self.opts.tau0, self.opts.sigma0

        if self.opts.scale_steps_operator:
            norm = float(p.normest())
            if abs(norm - 1.0) > 0.1:
                tau /= norm
                sigma /= norm
                if self.solver_opts.verbose:
                    print(f"|K|={norm:.6g} => Rescaled tau={tau:.6g}, "
                          f"sigma={sigma:.6g}.")

        def vec(v, n):
            if v is None:
                return torch.zeros(n, dtype=dt, device=dev)
            return torch.as_tensor(v, dtype=dt).reshape(-1).to(dev)

        x0, y0 = self.solver_opts.x0, self.solver_opts.y0
        x, y = vec(x0, p.ncols), vec(y0, p.nrows)
        if x.shape[0] != p.ncols:
            raise ProstError("Initial primal solution has wrong size.")
        if y.shape[0] != p.nrows:
            raise ProstError("Initial dual solution has wrong size.")
        kx = p.linop.apply(x) if x0 is not None else torch.zeros(
            p.nrows, dtype=dt, device=dev)
        kty = p.linop.apply_adjoint(y) if y0 is not None else torch.zeros(
            p.ncols, dtype=dt, device=dev)

        def scalar(v=0.0):
            return torch.full((), v, dtype=dt, device=dev)

        return PDHGState(
            x=x, y=y, kx=kx, kty=kty,
            x_prev=x.clone(), y_prev=y.clone(),
            kx_prev=kx.clone(), kty_prev=kty.clone(),
            tau=scalar(tau), sigma=scalar(sigma), theta=scalar(1.0),
            arg_alpha=scalar(self.opts.arg_alpha0),
            arb_l=scalar(), arb_u=scalar(),
            iteration=torch.zeros((), dtype=torch.int32, device=dev),
            primal_residual=scalar(), dual_residual=scalar(),
            primal_var_norm=scalar(), dual_var_norm=scalar(),
            converged=torch.zeros((), dtype=torch.bool, device=dev),
        )

    # ------------------------------------------------------------------
    def generic_step(self, s: PDHGState, it: int) -> PDHGState:
        """One generic iteration, held fixed once ``s.converged`` is set;
        ``it`` is the host's count of the iteration, which decides whether
        it is a residual iteration."""
        ri = max(int(self.opts.residual_iter), 1)
        new = pdhg_step(self.problem, self.prox_g, self.prox_fstar,
                        self.opts, self.tols, s, it % ri == 0)
        return hold_if(s.converged, s, new)

    def run(self, state: PDHGState, until_iter: int,
            start_iter: int) -> PDHGState:
        """Run iterations from ``start_iter`` (the host's copy of
        ``state.iteration``) until ``until_iter`` (exclusive) or
        convergence, whichever comes first, without a host read."""
        for it in range(start_iter, until_iter):
            state = self.generic_step(state, it)
        return state

    # ------------------------------------------------------------------
    def current_solution(self, state: PDHGState):
        """(x, z, y, w) with z, w reconstructed from finite differences of
        the iterates (exact at residual_iter=1; with residual_iter > 1 the
        *_prev iterates date from the latest residual iteration)."""
        p = self.problem
        w = ((state.x_prev - state.x) / (p.scaling_right * state.tau)
             - state.kty_prev)
        z = (state.y_prev - state.y) / (state.sigma * p.scaling_left) + (
            1.0 + state.theta) * state.kx - state.theta * state.kx_prev
        return state.x, z, state.y, w


def _sqrt_size(like, n: int):
    """sqrt(n) computed in ``like``'s dtype on its device (as the JAX
    package's jnp.sqrt(float(n))), made by a fill, not a host copy."""
    return torch.sqrt(like.new_full((), float(n)))


def _eps_primal(problem, tols, primal_var_norm):
    tol_rel_primal, _, tol_abs_primal, _ = tols
    return (_sqrt_size(primal_var_norm, problem.nrows) * tol_abs_primal
            + tol_rel_primal * primal_var_norm)


def _eps_dual(problem, tols, dual_var_norm):
    _, tol_rel_dual, _, tol_abs_dual = tols
    return (_sqrt_size(dual_var_norm, problem.ncols) * tol_abs_dual
            + tol_rel_dual * dual_var_norm)


def residual_and_adapt(problem, opts: PDHGOptions, tols, s: PDHGState,
                       primal_res, primal_norm, dual_res, dual_norm, it):
    """Store residual norms, test convergence, and run the residual-based
    step-size adaptation (goldstein / boyd).  ``it`` is the pre-increment
    iteration counter of the residual iteration (a device tensor).  Shared
    by the generic path and the fused path, which computes the norms in
    its kernel."""
    s = dataclasses.replace(
        s,
        primal_residual=primal_res, primal_var_norm=primal_norm,
        dual_residual=dual_res, dual_var_norm=dual_norm,
    )
    eps_pri = _eps_primal(problem, tols, primal_norm)
    eps_dua = _eps_dual(problem, tols, dual_norm)
    s = dataclasses.replace(
        s, converged=(primal_res < eps_pri) & (dual_res < eps_dua))

    if opts.stepsize == "goldstein":
        scale = eps_dua / eps_pri
        up = s.dual_residual > scale * s.primal_residual * opts.arg_delta
        dn = s.dual_residual < scale * s.primal_residual / opts.arg_delta
        fac = 1.0 - s.arg_alpha
        tau = torch.where(up, s.tau / fac,
                          torch.where(dn, s.tau * fac, s.tau))
        sigma = torch.where(up, s.sigma * fac,
                            torch.where(dn, s.sigma / fac, s.sigma))
        arg_alpha = torch.where(up | dn, s.arg_alpha * opts.arg_nu,
                                s.arg_alpha)
        s = dataclasses.replace(s, tau=tau, sigma=sigma, arg_alpha=arg_alpha)
    elif opts.stepsize == "boyd":
        it = it.to(s.tau.dtype)
        c1 = (s.dual_residual < eps_dua) & (opts.arb_tau * it > s.arb_l)
        c2 = ((s.primal_residual < eps_pri) & (opts.arb_tau * it > s.arb_u)
              & ~c1)
        tau = torch.where(c1, s.tau / opts.arb_delta,
                          torch.where(c2, s.tau * opts.arb_delta, s.tau))
        sigma = torch.where(c1, s.sigma * opts.arb_delta,
                            torch.where(c2, s.sigma / opts.arb_delta,
                                        s.sigma))
        arb_u = torch.where(c1, it, s.arb_u)
        arb_l = torch.where(c2, it, s.arb_l)
        s = dataclasses.replace(s, tau=tau, sigma=sigma, arb_l=arb_l,
                                arb_u=arb_u)
    return s


def pdhg_step(problem, prox_g, prox_fstar, opts: PDHGOptions, tols,
              state: PDHGState, do_res: bool) -> PDHGState:
    """One PDHG iteration as a function on the state.  ``do_res`` says
    whether this is a residual iteration (iteration % residual_iter == 0);
    the caller knows it from its iteration count, where the JAX package
    branches on the device with ``lax.cond``."""
    s = state
    Sigma = problem.scaling_left
    Tau = problem.scaling_right

    # primal step
    arg = s.x - s.tau * Tau * s.kty
    x_new = apply_proxs(prox_g, arg, Tau, s.tau, False)
    kx_new = problem.linop.apply(x_new)

    # dual step (extrapolated Kx folded into the prox argument)
    arg_y = s.y + s.sigma * Sigma * ((1.0 + s.theta) * kx_new
                                     - s.theta * s.kx)
    y_new = apply_proxs(prox_fstar, arg_y, Sigma, s.sigma, False)
    kty_new = problem.linop.apply_adjoint(y_new)

    new = dataclasses.replace(s, x=x_new, y=y_new, kx=kx_new, kty=kty_new)

    if opts.reference_residuals:
        # reference-exact sequence: prevs rotate EVERY iteration and the
        # dual residual uses the stale pair (K^T y^{k-1}, K^T y^k)
        new = dataclasses.replace(new, x_prev=s.x, y_prev=s.y,
                                  kx_prev=s.kx, kty_prev=s.kty)
        if do_res:
            sqrt_S, sqrt_T = torch.sqrt(Sigma), torch.sqrt(Tau)
            q = new
            z_hat = (q.y_prev - q.y) / (q.sigma * sqrt_S) + sqrt_S * (
                (1.0 + q.theta) * q.kx - q.theta * q.kx_prev)
            p_diff = z_hat - sqrt_S * q.kx
            w_hat = (q.x_prev - q.x) / (q.tau * sqrt_T) - sqrt_T * s.kty_prev
            d_diff = w_hat + sqrt_T * s.kty
            new = residual_and_adapt(
                problem, opts, tols, q,
                torch.linalg.vector_norm(p_diff),
                torch.linalg.vector_norm(z_hat),
                torch.linalg.vector_norm(d_diff),
                torch.linalg.vector_norm(w_hat),
                q.iteration)
    elif do_res:
        # default mode: residuals + step adaptation every residual_iter
        # iterations from consistent iterates; the previous iterates are
        # persisted only here
        new = dataclasses.replace(new, x_prev=s.x, y_prev=s.y,
                                  kx_prev=s.kx, kty_prev=s.kty)
        sqrt_S, sqrt_T = torch.sqrt(Sigma), torch.sqrt(Tau)
        z_hat = (new.y_prev - new.y) / (new.sigma * sqrt_S) + sqrt_S * (
            (1.0 + new.theta) * new.kx - new.theta * new.kx_prev)
        p_diff = z_hat - sqrt_S * new.kx
        w_hat = ((new.x_prev - new.x) / (new.tau * sqrt_T)
                 - sqrt_T * new.kty_prev)
        d_diff = w_hat + sqrt_T * new.kty
        new = residual_and_adapt(
            problem, opts, tols, new,
            torch.linalg.vector_norm(p_diff),
            torch.linalg.vector_norm(z_hat),
            torch.linalg.vector_norm(d_diff),
            torch.linalg.vector_norm(w_hat),
            new.iteration)

    # alg2 acceleration runs every iteration
    if opts.stepsize == "alg2":
        theta = 1.0 / torch.sqrt(1.0 + 2.0 * opts.alg2_gamma * new.tau)
        new = dataclasses.replace(new, theta=theta, tau=theta * new.tau,
                                  sigma=new.sigma / theta)

    return dataclasses.replace(new, iteration=new.iteration + 1)
