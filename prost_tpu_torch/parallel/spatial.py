"""Spatially sharded PDHG: one big problem, its pixel axis split over the
ranks of a mesh (counterpart of ``prost_tpu/parallel/spatial.py``).

The JAX package annotates the state vectors with a named sharding and lets
XLA's SPMD partitioner place the collectives.  The torch counterpart is
DTensor: every state vector is a ``DTensor`` sharded on its only axis
(``Shard(0)``) over the mesh's ``sp`` axis, every scalar a plain tensor
that each rank holds alike (replicated), and the generic step runs under
``implicit_replication``, so the problem's plain tensors (preconditioners,
prox data) count as replicated; the elementwise work stays local and the
residual norms become all-reduces.

Where XLA reshapes a sharded vector by inserting collectives, DTensor
refuses a view that does not split evenly (a prox's (dim, count) view, a
gradient's (L, nx, ny) view, over a rank count that does not divide dim or
L).  So the linear operator and the proxes are redistributed explicitly:
each evaluates on the whole of its argument (an all-gather) on every rank
and returns a replicated result, which the elementwise steps cut back to
the rank's shard locally.  Correct for any problem built from the block
library, and, as the JAX package says of its own generic sharded path, it
gathers: the halo-exchange routes of ``spatial_fused.py`` are the
hand-scheduled alternative.

Every rank builds the same problem and makes the same sequence of calls;
a rank's solver reads the replicated scalars and, through
``current_solution``, the gathered vectors.
"""

from __future__ import annotations

import dataclasses

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from ..backend.pdhg import BackendPDHG, PDHGState, hold_if, pdhg_step


def sp_mesh(mesh, axis_name: str):
    """The one-dimensional mesh of ``axis_name`` (the mesh itself when it
    has one axis)."""
    return mesh[axis_name] if mesh.ndim > 1 else mesh


def whole(v):
    """The whole of a sharded or replicated DTensor on every rank (a plain
    tensor as it is)."""
    return v.full_tensor() if isinstance(v, DTensor) else v


def shard_vector(v, mesh):
    """``v`` as a DTensor sharded on its only axis over the 1-D ``mesh``:
    a plain tensor that every rank holds alike is cut locally (no
    communication), a DTensor laid out otherwise is redistributed."""
    if not isinstance(v, DTensor):
        v = DTensor.from_local(v, mesh, [Replicate()], run_check=False)
    if tuple(v.placements) == (Shard(0),):
        return v
    return v.redistribute(mesh, [Shard(0)])


def shard_state(s: PDHGState, mesh) -> PDHGState:
    """``s`` with its vectors sharded over the 1-D ``mesh`` and its
    scalars plain."""
    changes = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        changes[f.name] = shard_vector(v, mesh) if v.dim() else whole(v)
    return dataclasses.replace(s, **changes)


class _GatheredLinop:
    """``linop`` applied to the whole of its argument on every rank, the
    result replicated over ``mesh``."""

    def __init__(self, linop, mesh):
        self.linop, self.mesh = linop, mesh
        self.nrows, self.ncols = linop.nrows, linop.ncols

    def _replicated(self, t):
        return DTensor.from_local(t, self.mesh, [Replicate()],
                                  run_check=False)

    def apply(self, x):
        return self._replicated(self.linop.apply(whole(x)))

    def apply_adjoint(self, y):
        return self._replicated(self.linop.apply_adjoint(whole(y)))


class _GatheredProx:
    """``prox`` evaluated on the whole of its argument on every rank, the
    result replicated over ``mesh``."""

    def __init__(self, prox, mesh):
        self.prox, self.mesh = prox, mesh
        self.index, self.size = prox.index, prox.size

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        out = self.prox.eval_local(whole(arg), whole(tau_diag),
                                   whole(tau_scal), invert_tau)
        return DTensor.from_local(out, self.mesh, [Replicate()],
                                  run_check=False)

    def eval(self, arg, tau_diag, tau_scal, invert_tau=False):
        lo, hi = self.index, self.index + self.size
        return self.eval_local(whole(arg)[lo:hi], whole(tau_diag)[lo:hi],
                               tau_scal, invert_tau)


class ShardedPDHG(BackendPDHG):
    """``BackendPDHG`` whose state vectors are sharded along the pixel
    axis over ``mesh``'s ``axis_name`` (``make_mesh``).  Same API as
    ``BackendPDHG``; ``run`` returns the state every rank holds its shard
    of, and ``current_solution`` the gathered vectors."""

    def __init__(self, problem, opts, solver_opts, mesh,
                 axis_name: str = "sp"):
        super().__init__(problem, opts, solver_opts)
        self.mesh = sp_mesh(mesh, axis_name)
        self.axis_name = axis_name
        self.linop = _GatheredLinop(problem.linop, self.mesh)
        self._step_problem = dataclasses.replace(problem, linop=self.linop)
        self._proxs = tuple(tuple(_GatheredProx(p, self.mesh) for p in ps)
                            for ps in (self.prox_g, self.prox_fstar))

    def initial_state(self) -> PDHGState:
        return shard_state(super().initial_state(), self.mesh)

    def generic_step(self, s: PDHGState, it: int) -> PDHGState:
        ri = max(int(self.opts.residual_iter), 1)
        with implicit_replication():
            new = pdhg_step(self._step_problem, *self._proxs, self.opts,
                            self.tols, s, it % ri == 0)
            new = hold_if(s.converged, s, new)
        return shard_state(new, self.mesh)

    def current_solution(self, state: PDHGState):
        with implicit_replication():
            sol = super().current_solution(state)
        return tuple(whole(v) for v in sol)
