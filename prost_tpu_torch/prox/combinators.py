"""Prox combinators (counterpart of ``prost_tpu/prox/combinators.py``):
Moreau conjugation, affine transform and permutation, as plain function
composition around an inner prox."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ProstError
from .base import Prox


@dataclasses.dataclass(eq=False)
class ProxMoreau(Prox):
    """prox of f* via Moreau's identity:

        prox_{tau f*}(u) = u - tau . prox_{f / tau}(u / tau)

    with diagonal tau = tau_scal * tau_diag.  The inner prox is called with
    the same (tau_diag, tau_scal) but invert_tau flipped, on the prescaled
    argument.
    """

    index: int
    size: int
    child: Prox = None

    @property
    def diagsteps(self) -> bool:
        return self.child.diagsteps

    def get_separable_structure(self):
        return self.child.get_separable_structure()

    def average_precond(self, seg):
        return self.child.average_precond(seg)

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        tau = tau_scal * tau_diag
        scaled_arg = arg * tau if invert_tau else arg / tau
        inner = self.child.eval_local(scaled_arg, tau_diag, tau_scal,
                                      not invert_tau)
        if invert_tau:
            return arg - inner / tau
        return arg - tau * inner


def _has_zero(v) -> bool:
    """Whether a scalar, array or tensor coefficient holds a zero (read
    once, when the prox is made or moved)."""
    if isinstance(v, torch.Tensor):
        return bool(torch.any(v == 0))
    return bool(np.any(np.asarray(v) == 0))


@dataclasses.dataclass(eq=False)
class ProxTransform(Prox):
    """prox of c*f(a*x - b) + d*x + (e/2)*x^2 around an arbitrary inner
    prox of f (prox_transform.cu): prescale the argument and the
    per-element step, call the inner prox with tau_scal=1 and the scaled
    per-element step as tau_diag (and invert_tau False: the inversion is
    folded into the scaled step), then postscale.

    Coefficients a, b, c, d, e are scalars or per-element arrays."""

    index: int
    size: int
    child: Prox = None
    a: object = 1.0
    b: object = 0.0
    c: object = 1.0
    d: object = 0.0
    e: object = 0.0

    def __post_init__(self):
        if _has_zero(self.a):
            raise ProstError(
                "ProxTransform: coefficient 'a' must not contain zeros.")

    @property
    def diagsteps(self) -> bool:
        return self.child.diagsteps

    def get_separable_structure(self):
        return self.child.get_separable_structure()

    def average_precond(self, seg):
        return self.child.average_precond(seg)

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        a, b, c, d, e = self.a, self.b, self.c, self.d, self.e
        tau = tau_scal * tau_diag
        if invert_tau:
            tau = 1.0 / tau
        denom = 1.0 + tau * e
        scaled_arg = (a * (arg - tau * d)) / denom - b
        scaled_tau = (a * a * c * tau) / denom
        inner = self.child.eval_local(
            scaled_arg, torch.broadcast_to(scaled_tau, arg.shape), 1.0, False)
        return (inner + b) / a


@dataclasses.dataclass(eq=False)
class ProxPermute(Prox):
    """prox of f(Px) for a permutation P: gather, inner prox, scatter back
    (prox_permute.cu).  perm holds local indices (0-based)."""

    index: int
    size: int
    child: Prox = None
    perm: torch.Tensor = None

    @property
    def diagsteps(self) -> bool:
        return self.child.diagsteps

    def average_precond(self, seg):
        inv = torch.argsort(self.perm)
        return self.child.average_precond(seg[self.perm])[inv]

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        perm = self.perm
        inner = self.child.eval_local(arg[perm], tau_diag[perm], tau_scal,
                                      invert_tau)
        return inner[torch.argsort(perm)]
