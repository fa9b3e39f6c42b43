"""Prox operator base machinery (counterpart of ``prost_tpu/prox/base.py``).

A prox operator owns the contiguous range ``[index, index+size)`` of a flat
variable vector and is a pure function

    eval_local(arg, tau_diag, tau_scal, invert_tau) -> result

on that segment.  ``ProxSeparableSum`` adds the (count, dim, interleaved)
structure: each elem-op receives its segment viewed as ``(dim, count)``,
component i of all vectors in row i, so one vectorized torch expression
covers every vector at once.

``diagsteps`` says whether the operator can take per-coordinate step sizes.
Where it cannot, the Problem averages the preconditioner over each vector,
so reading the first component of tau per vector is exact.
"""

from __future__ import annotations

import torch

from ..config import ProstError


class Prox:
    """Base: subclasses are dataclasses with at least index/size."""

    index: int
    size: int

    @property
    def end(self) -> int:
        return self.index + self.size - 1

    @property
    def diagsteps(self) -> bool:
        return False

    def get_separable_structure(self):
        """List of (start_index, count, stride) triples (absolute indices)
        describing the groups whose preconditioner entries are averaged
        when diagsteps is False.  Default: the whole range, stride 1."""
        return [(self.index, self.size, 1)]

    def average_precond(self, seg):
        """Preconditioner averaged over this prox's separable groups."""
        return seg.mean().expand_as(seg).clone()

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau: bool):
        raise NotImplementedError

    def eval(self, arg, tau_diag, tau_scal, invert_tau: bool = False):
        """Slice the flat vectors to this operator's range and evaluate."""
        lo, hi = self.index, self.index + self.size
        return self.eval_local(arg[lo:hi], tau_diag[lo:hi], tau_scal,
                               invert_tau)


class ProxSeparableSum(Prox):
    """Prox with count x dim separable-sum structure."""

    count: int
    dim: int
    interleaved: bool

    def get_separable_structure(self):
        # one entry per dim-dimensional vector
        if self.interleaved:
            return [(self.index + i * self.dim, self.dim, 1)
                    for i in range(self.count)]
        return [(self.index + i, self.dim, self.count)
                for i in range(self.count)]

    def average_precond(self, seg):
        vecs = self.to_vectors(seg)
        avg = vecs.mean(dim=0, keepdim=True).expand_as(vecs)
        return self.from_vectors(avg)

    # -- layout helpers -----------------------------------------------------

    def to_vectors(self, seg):
        """Segment (size,) -> (dim, count): row i = component i of all
        vectors."""
        if self.interleaved:
            return seg.reshape(self.count, self.dim).T
        return seg.reshape(self.dim, self.count)

    def from_vectors(self, vecs):
        """(dim, count) -> flat segment (size,) in this prox's layout."""
        if self.interleaved:
            return vecs.T.reshape(self.size)
        return vecs.reshape(self.size)

    def vector_tau(self, tau_diag):
        """Per-vector step (count,): first component of each vector's tau
        (exact when diagsteps is False, the preconditioner having been
        averaged over each vector)."""
        if self.interleaved:
            return tau_diag.reshape(self.count, self.dim)[:, 0]
        return tau_diag.reshape(self.dim, self.count)[0]


def effective_tau(tau_diag, tau_scal, invert_tau: bool):
    """Combined step size tau = tau_scal * tau_diag, optionally inverted
    (the flip the Moreau identity uses)."""
    tau = tau_scal * tau_diag
    return 1.0 / tau if invert_tau else tau


def check_domain(proxs: list[Prox], n: int, name: str) -> None:
    """Validate that prox operators tile [0, n) without gaps or overlap."""
    if not proxs:
        return
    s = sorted(proxs, key=lambda p: p.index)
    for a, b in zip(s[:-1], s[1:]):
        if a.end != b.index - 1:
            raise ProstError(
                f"{name}: prox operators overlap or leave a gap: "
                f"[{a.index}, {a.end}] and [{b.index}, {b.end}]."
            )
    if s[0].index != 0:
        raise ProstError(f"{name}: first prox starts at {s[0].index}, not 0.")
    if s[-1].end != n - 1:
        raise ProstError(
            f"{name}: last prox ends at {s[-1].end}, domain end is {n - 1}."
        )


def apply_proxs(proxs: list[Prox], arg, tau_diag, tau_scal,
                invert_tau: bool = False):
    """Apply a domain-covering list of proxs to the full flat vector;
    results are concatenated in index order."""
    if (len(proxs) == 1 and proxs[0].index == 0
            and proxs[0].size == arg.shape[0]):
        return proxs[0].eval_local(arg, tau_diag, tau_scal, invert_tau)
    pieces = [p.eval(arg, tau_diag, tau_scal, invert_tau)
              for p in sorted(proxs, key=lambda q: q.index)]
    return torch.cat(pieces)
