"""Element-wise prox operations: 1d, norm2, ind_simplex and ind_sum
(counterpart of ``prost_tpu/prox/elemop.py``).  Each is one vectorized
torch expression over the (dim, count) view of its segment.

Coefficients follow the reference's broadcast contract: each of the 7
coefficients is a Python float or a per-vector tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import ProxSeparableSum, effective_tau
from .fun1d import FUN_1D


def _where(cond, a, b, like):
    """``where(cond, a, b)`` for any mix of Python and tensor operands; a
    Python ``cond`` selects without computing, the scalars of a tensor
    ``cond`` take ``like``'s dtype."""
    if isinstance(cond, bool):
        return a if cond else b

    def t(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.tensor(float(v), dtype=like.dtype, device=like.device)

    return torch.where(cond, t(a), t(b))


def scaled_fun_1d(fun, arg, tau, coeffs):
    """Apply prox of x -> c*f(a*x - b) + d*x + (e/2)*x^2 built from the prox
    of f alone, via the argument/step rescaling identities:

        prox_arg = (a*(arg - d*tau))/(1 + tau*e) - b
        step     = (c*a^2*tau)/(1 + tau*e)
        result   = (f.prox(prox_arg, step) + b) / a

    Where c == 0 or a == 0 the function degenerates to the quadratic-plus-
    linear part: result = (arg - tau*d)/(1 + tau*e).
    """
    a, b, c, d, e, alpha, beta = coeffs
    degenerate = (a == 0.0) | (c == 0.0)
    safe_a = _where(degenerate, 1.0, a, arg)

    denom = 1.0 + tau * e
    lin = (arg - tau * d) / denom

    prox_arg = (safe_a * (arg - d * tau)) / denom - b
    step = (c * safe_a * safe_a * tau) / denom
    full = (fun(prox_arg, step, alpha, beta) + b) / safe_a

    return _where(degenerate, lin, full, arg)


@dataclasses.dataclass(eq=False)
class ProxElem1D(ProxSeparableSum):
    """Separable sum of scalar proxes with the 7-coefficient
    parametrization (elem_operation:1d:<fun>)."""

    index: int
    size: int
    fun: str
    coeffs: tuple = ()

    # dim=1, count=size, layout irrelevant
    @property
    def count(self):
        return self.size

    @property
    def dim(self):
        return 1

    @property
    def interleaved(self):
        return False

    @property
    def diagsteps(self) -> bool:
        return True

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        tau = effective_tau(tau_diag, tau_scal, invert_tau)
        return scaled_fun_1d(FUN_1D[self.fun], arg, tau, self.coeffs)


@dataclasses.dataclass(eq=False)
class ProxElemNorm2(ProxSeparableSum):
    """Sum of h(||x_i||_2) over dim-dimensional vectors, h parametrized by
    the 7 coefficients (elem_operation:norm2:<fun>)."""

    index: int
    size: int
    count: int
    dim: int
    interleaved: bool
    fun: str
    coeffs: tuple = ()

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (dim, count)
        tau = effective_tau(self.vector_tau(tau_diag), tau_scal, invert_tau)

        norm_sq = torch.sum(vecs * vecs, dim=0)
        norm = torch.sqrt(norm_sq)
        safe_norm = torch.where(norm > 0, norm, torch.ones_like(norm))

        prox_norm = scaled_fun_1d(FUN_1D[self.fun], norm, tau, self.coeffs)
        scale = torch.where(norm > 0, prox_norm / safe_norm,
                            torch.zeros_like(norm))
        return self.from_vectors(vecs * scale[None, :])


@dataclasses.dataclass(eq=False)
class ProxElemIndSimplex(ProxSeparableSum):
    """Projection onto the unit simplex per dim-vector
    (elem_operation:ind_simplex; algorithm of Chen & Ye, arXiv:1101.6081):
    one batched descending sort along the dim axis, with no size cap."""

    index: int
    size: int
    count: int
    dim: int
    interleaved: bool

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (dim, count)
        u = torch.sort(vecs, dim=0, descending=True).values
        ks = torch.arange(1, self.dim + 1, dtype=vecs.dtype,
                          device=vecs.device)
        css = (torch.cumsum(u, dim=0) - 1.0) / ks[:, None]
        # rho = largest k (1-based) with u_k > css_k; tmax = css_rho
        rho = torch.clamp(torch.sum(u > css, dim=0) - 1, min=0)
        tmax = torch.gather(css, 0, rho[None, :])[0]
        return self.from_vectors(torch.clamp(vecs - tmax[None, :], min=0.0))


@dataclasses.dataclass(eq=False)
class ProxElemIndSum(ProxSeparableSum):
    """Projection onto the affine set {sum_i x_i = 1} per dim-vector
    (elem_operation:ind_sum)."""

    index: int
    size: int
    count: int
    dim: int
    interleaved: bool

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)
        shift = (torch.sum(vecs, dim=0) - 1.0) / self.dim
        return self.from_vectors(vecs - shift[None, :])
