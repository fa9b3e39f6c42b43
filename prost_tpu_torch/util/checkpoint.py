"""Solver-state checkpointing (counterpart of
``prost_tpu/util/checkpoint.py``).

The reference has no disk checkpointing; resume means re-solving with
Options.x0/y0.  Here the whole solver state is one small dataclass, so
checkpoint and resume are exact: every loop-carried quantity (iterates,
step sizes, adaptive-scheme state, iteration counter, converged flag)
survives.  Resume with ``backend.run(state, until, int(state.iteration))``
(``int(state.iteration[0])`` for a batched state).

The file is an ``.npz`` with one array per dataclass field, by name, and
the class name and field list beside them.  A sharded state (vectors as
DTensors over a mesh) is saved whole: every rank of the mesh calls
``save_state`` (the vectors are gathered), the mesh's first rank writes
the file, and every rank returns once it is written.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from ..common import to_numpy

_CLASS, _FIELDS = "__class__", "__fields__"


def _mesh_of(state):
    """The mesh of the state's first DTensor field, or None."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, DTensor):
            return v.device_mesh
    return None


def save_state(path: str, state) -> None:
    """Write a solver state (PDHGState, ADMMState, or BatchedPDHG's batched
    PDHGState; sharded or not) to an .npz file."""
    if not dataclasses.is_dataclass(state) or isinstance(state, type):
        raise ValueError(f"save_state: {type(state).__name__} is not a "
                         "solver state dataclass")
    names = [f.name for f in dataclasses.fields(state)]
    arrays = {}
    for name in names:
        v = getattr(state, name)
        if isinstance(v, DTensor):
            v = v.full_tensor()  # a collective: every rank calls it
        arrays[name] = to_numpy(v)
    arrays[_CLASS] = np.asarray(type(state).__name__)
    arrays[_FIELDS] = np.asarray(names)
    mesh = _mesh_of(state)
    if mesh is None:
        np.savez(path, **arrays)
        return
    group = mesh.get_group()
    if dist.get_rank(group) == 0:
        np.savez(path, **arrays)
    dist.barrier(group)


def load_state(path: str, like):
    """Load a state saved by :func:`save_state`.  ``like`` is a state of
    the same class, fields and shapes (e.g. ``backend.initial_state()``);
    each field is put on ``like``'s device in ``like``'s dtype, and a
    DTensor field on ``like``'s mesh with its placements.  Raises
    ValueError when the file's structure does not match ``like``'s."""
    data = np.load(path, allow_pickle=False)
    saved = (str(data[_CLASS]), [str(n) for n in data[_FIELDS]])
    if not dataclasses.is_dataclass(like) or isinstance(like, type):
        raise ValueError(
            "checkpoint structure mismatch:\n"
            f"  saved: {saved[0]}{saved[1]}\n  expected: {type(like)}")
    names = [f.name for f in dataclasses.fields(like)]
    shapes = [tuple(getattr(like, n).shape) for n in names]
    got = [tuple(data[n].shape) if n in data.files else None for n in names]
    if saved != (type(like).__name__, names) or got != shapes:
        raise ValueError(
            "checkpoint structure mismatch:\n"
            f"  saved: {saved[0]}{saved[1]} {got}\n"
            f"  expected: {type(like).__name__}{names} {shapes}")
    fields = {}
    for name in names:
        ref = getattr(like, name)
        if isinstance(ref, DTensor):
            local = ref.to_local()
            t = torch.as_tensor(data[name]).to(device=local.device,
                                               dtype=local.dtype)
            t = DTensor.from_local(t, ref.device_mesh, [Replicate()],
                                   run_check=False)
            fields[name] = t.redistribute(ref.device_mesh, ref.placements)
        else:
            fields[name] = torch.as_tensor(data[name]).to(device=ref.device,
                                                          dtype=ref.dtype)
    return type(like)(**fields)
