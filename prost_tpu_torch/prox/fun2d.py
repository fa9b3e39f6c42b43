"""2D prox functions operating on pairs, e.g. the two singular values of an
N x 2 matrix (counterpart of ``prost_tpu/prox/fun2d.py``; function_2d.hpp
of the reference): each is a vectorized function
(y1, y2, tau, alpha, beta) -> (x1, x2).
"""

from __future__ import annotations

import torch

from .fun1d import FUN_1D


def _make_sum_1d(fun1d):
    def fun(y1, y2, tau, alpha, beta):
        return fun1d(y1, tau, alpha, beta), fun1d(y2, tau, alpha, beta)

    return fun


def fun2d_ind_l1_ball(y1, y2, tau, alpha, beta):
    """Projection of (y1, y2) onto the l1-ball of radius alpha
    (function_2d.hpp:42-83): project (|y1|, |y2|) onto the simplex of size
    alpha, restore signs; pass-through when already inside."""
    v1, v2 = torch.abs(y1), torch.abs(y2)
    inside = v1 + v2 <= alpha

    mu1 = torch.maximum(v1, v2)
    mu2 = torch.minimum(v1, v2)
    l = 0.5 * (mu2 - mu1 + alpha)
    # rho = 1 active coordinate where l <= 0, else 2
    theta = torch.where(l <= 0.0, mu1 - alpha, (mu1 + mu2 - alpha) / 2.0)

    p1 = torch.clamp(v1 - theta, min=0.0)
    p2 = torch.clamp(v2 - theta, min=0.0)
    x1 = torch.where(inside, y1, torch.sign(y1) * p1)
    x2 = torch.where(inside, y2, torch.sign(y2) * p2)
    return x1, x2


def _make_moreau(fun2d):
    def fun(y1, y2, tau, alpha, beta):
        r1, r2 = fun2d(y1 / tau, y2 / tau, 1.0 / tau, alpha, beta)
        return y1 - tau * r1, y2 - tau * r2

    return fun


FUN_2D = {f"sum_1d:{name}": _make_sum_1d(f) for name, f in FUN_1D.items()}
FUN_2D["ind_l1_ball"] = fun2d_ind_l1_ball
FUN_2D["moreau:ind_l1_ball"] = _make_moreau(fun2d_ind_l1_ball)
