"""Prox combinators (counterpart of ``prost_tpu/prox/combinators.py``):
Moreau conjugation.  Transform and Permute come with a later slice."""

from __future__ import annotations

import dataclasses

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
