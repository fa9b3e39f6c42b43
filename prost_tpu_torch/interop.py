"""Hand-over between the JAX package and the port, through numpy only.

* ``pdhg_state_from_numpy`` / ``admm_state_from_numpy`` build the port's
  ``PDHGState`` / ``ADMMState`` from the fields of the JAX state given as
  numpy arrays, so both packages can go on from the same point; a batched
  PDHG state (``BatchedPDHG``'s) keeps its leading batch axis, vectors
  (B, n) and scalars (B,);
* ``pdhg_state_to_numpy`` / ``admm_state_to_numpy`` are their inverses;
* ``sharded_pdhg_state_from_numpy`` / ``sharded_pdhg_state_to_numpy`` do
  the same for the state of a spatially sharded backend (``ShardedPDHG``
  and the halo routes): every rank builds its shard of each vector from
  the whole (gathered) vectors, and every rank gets the whole vectors back;
  ``sharded_admm_state_from_numpy`` / ``sharded_admm_state_to_numpy`` for
  ``ShardedFusedADMM``'s state;
* ``problem_arrays`` lists a finalized problem's linear operator (its
  blocks with their data), preconditioners and prox coefficients as numpy,
  so a test can check that both packages build the same K and finalize the
  same problem.  It reads attributes only, so it takes a JAX ``Problem`` as
  well as the port's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .backend.admm import ADMMState
from .backend.pdhg import PDHGState
from .common import to_numpy
from .config import dtype as config_dtype

_PDHG_VECTORS = ("x", "y", "kx", "kty", "x_prev", "y_prev", "kx_prev",
                 "kty_prev")
_ADMM_VECTORS = ("x_half", "x_proj", "x_dual", "z_half", "z_proj", "z_dual",
                 "cg_warm")


def _state_from_numpy(cls, vectors, fields: dict, device):
    """A ``cls`` state on ``device`` from numpy fields: vectors and scalars
    in the configured dtype, ``iteration`` int32, ``converged`` bool.
    Every field of ``cls`` must be present.  Where the first vector has a
    leading batch axis (B, n), every vector keeps it and every scalar is
    (B,)."""
    dt = config_dtype()
    lead = np.shape(fields[vectors[0]])[:-1]
    out = {}
    for f in dataclasses.fields(cls):
        v = np.asarray(fields[f.name])
        if f.name == "iteration":
            t = torch.as_tensor(v.astype(np.int32))
        elif f.name == "converged":
            t = torch.as_tensor(v.astype(bool))
        else:
            t = torch.as_tensor(v.astype(np.float64)).to(dt)
        t = t.reshape(*lead, -1) if f.name in vectors else t.reshape(lead)
        out[f.name] = t.to(device)
    return cls(**out)


def _state_to_numpy(state) -> dict:
    return {f.name: to_numpy(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def pdhg_state_from_numpy(fields: dict, device) -> PDHGState:
    """The port's ``PDHGState`` on ``device`` from a JAX ``PDHGState``'s
    fields as numpy arrays, batched or not."""
    return _state_from_numpy(PDHGState, _PDHG_VECTORS, fields, device)


def pdhg_state_to_numpy(state) -> dict:
    """Every field of a ``PDHGState`` as a numpy array."""
    return _state_to_numpy(state)


def sharded_pdhg_state_from_numpy(fields: dict, mesh, device,
                                  axis_name: str = "sp") -> PDHGState:
    """This rank's sharded ``PDHGState`` on ``device`` (its shard of every
    vector over ``mesh``'s ``axis_name``, the scalars whole) from a JAX
    ``PDHGState``'s fields as numpy arrays, its vectors gathered whole.
    Every rank of the mesh passes the same fields; no data is sent."""
    from .parallel.spatial import shard_state, sp_mesh

    return shard_state(pdhg_state_from_numpy(fields, device),
                       sp_mesh(mesh, axis_name))


def sharded_pdhg_state_to_numpy(state) -> dict:
    """Every field of a sharded ``PDHGState`` (or ``ADMMState``) as a numpy
    array, each vector gathered whole: a collective, which every rank of
    the mesh calls."""
    from .parallel.spatial import whole

    return {f.name: to_numpy(whole(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


def sharded_admm_state_from_numpy(fields: dict, mesh, device,
                                  axis_name: str = "sp") -> ADMMState:
    """This rank's sharded ``ADMMState`` on ``device`` from a JAX
    ``ADMMState``'s fields as numpy arrays, its vectors gathered whole
    (``sharded_pdhg_state_from_numpy`` for ADMM)."""
    from .parallel.spatial import shard_state, sp_mesh

    return shard_state(admm_state_from_numpy(fields, device),
                       sp_mesh(mesh, axis_name))


sharded_admm_state_to_numpy = sharded_pdhg_state_to_numpy


def admm_state_from_numpy(fields: dict, device) -> ADMMState:
    """The port's ``ADMMState`` on ``device`` from a JAX ``ADMMState``'s
    fields as numpy arrays."""
    return _state_from_numpy(ADMMState, _ADMM_VECTORS, fields, device)


def admm_state_to_numpy(state) -> dict:
    """Every field of an ``ADMMState`` as a numpy array."""
    return _state_to_numpy(state)


def _coeff(v):
    if isinstance(v, (int, float)):
        return float(v)
    return to_numpy(v)


def _prox_arrays(p) -> dict:
    out = {"type": type(p).__name__, "index": int(p.index),
           "size": int(p.size)}
    for name in ("fun", "count", "dim", "interleaved"):
        if hasattr(p, name):
            out[name] = getattr(p, name)
    if getattr(p, "coeffs", None):
        out["coeffs"] = tuple(_coeff(c) for c in p.coeffs)
    if getattr(p, "child", None) is not None:
        out["child"] = _prox_arrays(p.child)
    return out


# the data of each block kind: sizes and flags as Python values, arrays
# (conv kernel, kron matrix, diagonal factors) as numpy
_BLOCK_FIELDS = ("nx", "ny", "L", "label_first", "kx", "ky", "diaglength",
                 "offsets")
_BLOCK_ARRAYS = ("kernel", "data", "factors")


def _block_arrays(b) -> dict:
    out = {"type": type(b).__name__, "row": int(b.row), "col": int(b.col),
           "nrows": int(b.nrows), "ncols": int(b.ncols)}
    for name in _BLOCK_FIELDS:
        if hasattr(b, name):
            out[name] = getattr(b, name)
    for name in _BLOCK_ARRAYS:
        if getattr(b, name, None) is not None:
            out[name] = to_numpy(getattr(b, name))
    return out


def problem_arrays(problem) -> dict:
    """The linear operator's blocks, preconditioners and prox
    structure/coefficients of a finalized problem, as numpy arrays and
    Python values."""
    out = {"nrows": int(problem.nrows), "ncols": int(problem.ncols),
           "blocks": [_block_arrays(b)
                      for b in sorted(problem.linop.blocks,
                                      key=lambda b: (b.row, b.col))],
           "scaling_left": to_numpy(problem.scaling_left),
           "scaling_right": to_numpy(problem.scaling_right)}
    for side in ("prox_g", "prox_f", "prox_gstar", "prox_fstar"):
        out[side] = [_prox_arrays(p)
                     for p in sorted(getattr(problem, side),
                                     key=lambda q: q.index)]
    return out
