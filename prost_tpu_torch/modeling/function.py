"""Function factories: each returns a closure ``(idx, count) -> Prox``
(counterpart of ``prost_tpu/modeling/function.py``: the factories slice 1
needs).  The 7-coefficient parametrization is

    c * f_{alpha,beta}(a x - b) + d x + (e/2) x^2

with each coefficient a scalar or a per-instance vector (sum_1d.m).
Array coefficients stay numpy here; ``Problem.create`` turns them into
tensors of the working dtype.
"""

from __future__ import annotations

import numpy as np

from ..config import ProstError
from ..prox import ProxElem1D, ProxElemNorm2, ProxMoreau, ProxZero


def _coeffs(a, b, c, d, e, alpha, beta):
    def conv(v):
        v = np.asarray(v)
        return float(v) if v.ndim == 0 else v
    return tuple(conv(v) for v in (a, b, c, d, e, alpha, beta))


def zero():
    """f = 0 (prox is the identity)."""
    return lambda idx, count: ProxZero(index=idx, size=count)


def sum_1d(fun, a=1.0, b=0.0, c=1.0, d=0.0, e=0.0, alpha=0.0, beta=0.0):
    """Separable sum of 1D functions (sum_1d.m)."""
    cf = _coeffs(a, b, c, d, e, alpha, beta)
    return lambda idx, count: ProxElem1D(index=idx, size=count, fun=fun,
                                         coeffs=cf)


def sum_norm2(dim, interleaved, fun, a=1.0, b=0.0, c=1.0, d=0.0, e=0.0,
              alpha=0.0, beta=0.0):
    """Separable sum of h(||x||_2) over dim-vectors (sum_norm2.m)."""
    cf = _coeffs(a, b, c, d, e, alpha, beta)

    def make(idx, count):
        if count % dim:
            raise ProstError("sum_norm2: count not divisible by dim.")
        return ProxElemNorm2(index=idx, size=count, count=count // dim,
                             dim=dim, interleaved=interleaved, fun=fun,
                             coeffs=cf)
    return make


def conjugate(fun):
    """Convex conjugate via Moreau's identity (conjugate.m)."""
    def make(idx, count):
        inner = fun(idx, count)
        return ProxMoreau(index=idx, size=count, child=inner)
    return make
