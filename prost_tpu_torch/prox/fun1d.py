"""Scalar (1D) proximal operators (counterpart of ``prost_tpu/prox/fun1d.py``).

Each function computes ``prox_{tau f}(x0) = argmin_x f(x) + (1/(2 tau))(x-x0)^2``
for a family of scalar functions f parametrized by (alpha, beta), as one
vectorized torch expression: x0 is a tensor, tau/alpha/beta are tensors that
broadcast against it or Python floats.

  zero        f(z) = 0
  abs         f(z) = |z|                      (soft shrinkage)
  square      f(z) = z^2 / 2
  ind_leq0    f(z) = I(z <= 0)
  ind_geq0    f(z) = I(z >= 0)
  ind_eq0     f(z) = I(z == 0)
  ind_box01   f(z) = I(0 <= z <= 1)
  max_pos0    f(z) = max(0, z)
  l0          f(z) = #nonzero(z)              (hard threshold)
  huber       f(z) = z^2/(2 alpha) if |z|<=alpha else |z|-alpha/2
  lq          f(z) = |z|^alpha, alpha >= 0    (incl. nonconvex alpha<1)
  truncquad   f(z) = min(alpha z^2, beta)     (Mumford-Shah)
  trunclin    f(z) = min(alpha |z|, beta)
  lq_plus_eps f(z) = (|z|+beta)^alpha         (Newton solve)

Every branch is computed and selected with ``torch.where``, as the JAX
package does, so the functions stay free of host reads.
"""

from __future__ import annotations

import math

import torch


def _as(v, like):
    """``v`` as a tensor of ``like``'s dtype and device, broadcast to it."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v.to(like.dtype), like.shape)
    return torch.full_like(like, float(v))


def fun_zero(x0, tau, alpha, beta):
    return x0


def fun_abs(x0, tau, alpha, beta):
    # soft-thresholding
    return torch.sign(x0) * torch.clamp(torch.abs(x0) - tau, min=0.0)


def fun_square(x0, tau, alpha, beta):
    return x0 / (1.0 + tau)


def fun_ind_leq0(x0, tau, alpha, beta):
    return torch.clamp(x0, max=0.0)


def fun_ind_geq0(x0, tau, alpha, beta):
    return torch.clamp(x0, min=0.0)


def fun_ind_eq0(x0, tau, alpha, beta):
    return torch.zeros_like(x0)


def fun_ind_box01(x0, tau, alpha, beta):
    return torch.clamp(x0, 0.0, 1.0)


def fun_max_pos0(x0, tau, alpha, beta):
    # prox of z -> max(0, z): shift positive part by tau, keep negatives.
    return torch.where(x0 > tau, x0 - tau, torch.clamp(x0, max=0.0))


def fun_l0(x0, tau, alpha, beta):
    # hard thresholding: keep x0 where x0^2 > 2 tau
    return torch.where(x0 * x0 > 2.0 * tau, x0, torch.zeros_like(x0))


def fun_huber(x0, tau, alpha, beta):
    # prox of the Huber function with parameter alpha
    r = (x0 / tau) / (1.0 + alpha / tau)
    r = r / torch.clamp(torch.abs(r), min=1.0)
    return x0 - tau * r


def _lq_newton(t0, factor, q, num_iters: int = 30):
    """Newton iterations for min_t 0.5 (t-1)^2 + factor * t^q, t in (0, 1],
    a fixed count from t=1 (far past convergence in float64)."""
    t = t0
    for _ in range(num_iters):
        p = torch.pow(t, q)
        d1 = t - 1.0 + factor * q * p / t
        d2 = 1.0 + factor * q * (q - 1.0) * p / (t * t)
        t = t - d1 / d2
    return t


def _lq_half_analytic(factor):
    """Closed form for q = 1/2 (depressed-cubic root, trigonometric form)."""
    sqrt3 = torch.sqrt(torch.tensor(3.0, dtype=factor.dtype,
                                    device=factor.device))
    arg = torch.clamp(factor * 3.0 * sqrt3 / 4.0, -1.0, 1.0)
    s = 2.0 * torch.sin((torch.arccos(arg) + math.pi / 2.0) / 3.0) / sqrt3
    return s * s


def fun_lq(x0, tau, alpha, beta):
    """prox of |z|^alpha for alpha >= 0 (nonconvex for alpha < 1); the
    special cases alpha == 0, 1/2, 1 are selected element-wise."""
    absx = torch.abs(x0)
    alpha = _as(alpha, x0)
    one = torch.ones_like(x0)
    zero = torch.zeros_like(x0)
    safe_absx = torch.where(absx > 0, absx, one)
    factor = tau * torch.pow(safe_absx, alpha - 2.0)

    # stationary point via Newton from t=1 (scaled problem on t = x/|x0|)
    t_newton = _lq_newton(one, factor, alpha)
    t_half = _lq_half_analytic(factor)

    # nonconvex case: check the boundary condition before accepting the
    # stationary point
    t2 = 2.0 * (alpha - 1.0) / (alpha - 2.0)
    thresh = 0.5 * (1.0 - (t2 - 1.0) ** 2) / torch.pow(t2, alpha)
    nonconvex_keep = factor < thresh

    t_general = torch.where(
        alpha < 1.0,
        torch.where(nonconvex_keep,
                    torch.where(alpha == 0.5, t_half, t_newton), zero),
        t_newton,
    )
    t_general = torch.where(absx > 0, t_general, zero)
    general = t_general * absx * torch.sign(x0)

    return torch.where(
        alpha == 1.0,
        fun_abs(x0, tau, alpha, beta),
        torch.where(alpha == 0.0, fun_l0(x0, tau, alpha, beta), general),
    )


def fun_truncquad(x0, tau, alpha, beta):
    # prox of min(alpha z^2, beta): compare quadratic-prox energy vs beta
    x_sq = x0 / (1.0 + 2.0 * tau * alpha)
    en_sq = alpha * x_sq * x_sq + (x_sq - x0) ** 2 / (2.0 * tau)
    return torch.where(en_sq < beta, x_sq, x0)


def fun_trunclin(x0, tau, alpha, beta):
    # prox of min(alpha |z|, beta): compare shrinkage energy vs beta
    x_sh = torch.sign(x0) * torch.clamp(torch.abs(x0) - tau * alpha, min=0.0)
    en_sh = (x_sh - x0) ** 2 / (2.0 * tau) + alpha * torch.abs(x_sh)
    return torch.where(en_sh < beta, x_sh, x0)


def fun_lq_plus_eps(x0, tau, alpha, beta):
    """prox of (|z| + beta)^alpha, alpha >= 1, beta >= 0, by Newton on the
    optimality condition z - |x0| + tau alpha (z + beta)^(alpha-1) = 0 from
    z = |x0|, clipped to [0, |x0|]; z = 0 when the derivative at 0+ is
    nonnegative.  alpha < 1 falls back to ``fun_lq``."""
    absx = torch.abs(x0)
    alpha = _as(alpha, x0)
    beta = _as(beta, x0)

    z = absx
    for _ in range(30):
        zb = torch.clamp(z + beta, min=1e-20)
        p = torch.pow(zb, alpha - 1.0)
        d1 = z - absx + tau * alpha * p
        d2 = 1.0 + tau * alpha * (alpha - 1.0) * p / zb
        z = torch.minimum(torch.clamp(z - d1 / d2, min=0.0), absx)
    # subgradient check at z = 0: stay at 0 if |x0| <= tau a b^(a-1)
    slope0 = tau * alpha * torch.pow(torch.clamp(beta, min=1e-20), alpha - 1.0)
    z = torch.where(absx <= slope0, torch.zeros_like(z), z)
    convex = z * torch.sign(x0)
    return torch.where(alpha >= 1.0, convex, fun_lq(x0, tau, alpha, beta))


FUN_1D = {
    "zero": fun_zero,
    "abs": fun_abs,
    "square": fun_square,
    "ind_leq0": fun_ind_leq0,
    "ind_geq0": fun_ind_geq0,
    "ind_eq0": fun_ind_eq0,
    "ind_box01": fun_ind_box01,
    "max_pos0": fun_max_pos0,
    "l0": fun_l0,
    "huber": fun_huber,
    "lq": fun_lq,
    "lq_plus_eps": fun_lq_plus_eps,
    "truncquad": fun_truncquad,
    "trunclin": fun_trunclin,
}
