"""Standalone prox operators (counterpart of ``prost_tpu/prox/standalone.py``):
the zero function.  SOC, halfspace, quadratic epigraph, index-set sums and
range projection come with a later slice."""

from __future__ import annotations

import dataclasses

from .base import Prox


@dataclasses.dataclass(eq=False)
class ProxZero(Prox):
    """Identity: prox of the zero function."""

    index: int
    size: int

    @property
    def diagsteps(self) -> bool:
        return True

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        return arg
