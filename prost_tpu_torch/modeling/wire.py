"""Wire format: serialize/deserialize problem specifications (counterpart
of ``prost_tpu/modeling/wire.py``).

A problem crosses process and language boundaries as a JSON-able dict
that names each prox and block by the reference's registry names
(prox = {name, idx, size, diagsteps, data}, block = {name, row, col,
data}), decoded by a string -> constructor registry.  The format is the
JAX package's, key for key: a spec written by either package loads in the
other.

    spec = to_spec(problem)            # JSON-able dict
    problem = from_spec(spec)          # rebuild (validates via the registry)
    save_spec(path, spec) / load_spec(path)

Arrays are written as {"__array__": flat list, "dtype", "shape"} from host
copies of the tensors.  On load, prox data become tensors of
``config.dtype()`` (int32 for index arrays) on ``config.device()``;
``Problem.create`` computes the preconditioners on the CPU as always.
``BlockSparse`` writes its row-sorted triplets (``rows_f``, ``cols_f``,
``vals_f``), the order both packages keep; ``ProxIndRange`` writes a
sparse A (torch sparse CSR) as the JAX package's BCOO form, (nnz, 2)
index rows.

Custom operators register with ``register_prox`` / ``register_block``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..common import to_numpy
from ..config import ProstError, device as config_device, dtype as config_dtype
from ..linop import (
    BlockConv2D,
    BlockDense,
    BlockDiags,
    BlockGradient2D,
    BlockGradient3D,
    BlockIdKron,
    BlockKronId,
    BlockSparse,
    BlockZero,
    LinearOperator,
)
from ..problem import Problem
from ..prox import (
    ProxElem1D,
    ProxElemEigen2x2,
    ProxElemEigenNxN,
    ProxElemIndSimplex,
    ProxElemIndSum,
    ProxElemMassNorm,
    ProxElemNorm2,
    ProxElemSingularNx2,
    ProxIndEpiPolyhedral,
    ProxIndEpiQuad,
    ProxIndHalfspace,
    ProxIndRange,
    ProxIndSOC,
    ProxIndSum,
    ProxMoreau,
    ProxPermute,
    ProxTransform,
    ProxZero,
)

# ---------------------------------------------------------------------------
# array <-> JSON
# ---------------------------------------------------------------------------

def _enc(v):
    """Encode scalars inline and arrays as {"__array__": ..., dtype, shape}."""
    if v is None:
        return None
    a = to_numpy(v)
    if a.ndim == 0:
        return a.item()
    return {"__array__": a.ravel().tolist(), "dtype": str(a.dtype),
            "shape": list(a.shape)}


def _dec(v):
    if isinstance(v, dict) and "__array__" in v:
        return np.asarray(v["__array__"], dtype=v["dtype"]).reshape(v["shape"])
    return v


def _wire_arr(v, dtype=None):
    """A decoded array as a tensor of ``dtype`` (default the configured
    floating dtype) on the configured device."""
    return torch.as_tensor(np.asarray(_dec(v)), dtype=dtype or config_dtype(),
                           device=config_device())


def _dec_value(v):
    """A decoded coefficient: an array (or a plain JSON list) becomes a
    tensor (``_wire_arr``), a scalar stays a Python number."""
    v = _dec(v)
    return _wire_arr(v) if isinstance(v, (np.ndarray, list)) else v


def _enc_coeffs(coeffs):
    return [_enc(c) for c in coeffs]


def _dec_coeffs(coeffs):
    return tuple(_dec_value(c) for c in coeffs)


# ---------------------------------------------------------------------------
# prox registry: name -> (cls, to_data, from_data); the reference's names
# ---------------------------------------------------------------------------

_PROX_REGISTRY: dict = {}
_BLOCK_REGISTRY: dict = {}


def register_prox(name, cls, to_data, from_data):
    """Register a prox kind: ``to_data(prox) -> dict`` (JSON-able),
    ``from_data(idx, size, data, name) -> prox``."""
    _PROX_REGISTRY[name] = (cls, to_data, from_data)


def register_block(name, cls, to_data, from_data):
    """Register a block kind: ``to_data(block) -> dict``,
    ``from_data(row, col, data) -> block``."""
    _BLOCK_REGISTRY[name] = (cls, to_data, from_data)


def _prox_name(p) -> str:
    for name, (cls, _, _) in _PROX_REGISTRY.items():
        if type(p) is cls:
            if cls is ProxElem1D:
                return f"elem_operation:1d:{p.fun}"
            if cls is ProxElemNorm2:
                return f"elem_operation:norm2:{p.fun}"
            if cls is ProxElemEigen2x2:
                return f"elem_operation:eigen_2x2:{p.fun}"
            if cls is ProxElemEigenNxN:
                return f"elem_operation:eigen_nxn:{p.fun}"
            if cls is ProxElemSingularNx2:
                return f"elem_operation:singular_nx2:{p.fun}"
            if cls is ProxElemMassNorm:
                return (f"elem_operation:ind_comass{p.n}_ball" if p.conjugate
                        else f"elem_operation:mass{p.n}")
            return name
    raise ProstError(f"wire: unregistered prox type {type(p).__name__}")


def _lookup_prox_key(name: str):
    if name in _PROX_REGISTRY:
        return name
    # family names: elem_operation:1d:<fun> etc. are registered by family
    parts = name.split(":")
    for k in (":".join(parts[:2]), parts[0]):
        if k in _PROX_REGISTRY:
            return k
    raise ProstError(f"wire: unknown prox kind '{name}'")


def to_prox_spec(p) -> dict:
    name = _prox_name(p)
    _, to_data, _ = _PROX_REGISTRY[_lookup_prox_key(name)]
    return {
        "name": name,
        "idx": int(p.index),
        "size": int(p.size),
        "diagsteps": bool(p.diagsteps),
        "data": to_data(p),
    }


def from_prox_spec(spec: dict):
    name = spec["name"]
    _, _, from_data = _PROX_REGISTRY[_lookup_prox_key(name)]
    return from_data(spec["idx"], spec["size"], spec["data"], name)


def to_block_spec(b) -> dict:
    # the first registered name of the block's class (aliases come later)
    for name, (cls, to_data, _) in _BLOCK_REGISTRY.items():
        if type(b) is cls:
            return {"name": name, "row": int(b.row), "col": int(b.col),
                    "data": to_data(b)}
    raise ProstError(f"wire: unregistered block type {type(b).__name__}")


def from_block_spec(spec: dict):
    name = spec["name"]
    if name not in _BLOCK_REGISTRY:
        raise ProstError(f"wire: unknown block kind '{name}'")
    _, _, from_data = _BLOCK_REGISTRY[name]
    return from_data(spec["row"], spec["col"], spec["data"])


# ---------------------------------------------------------------------------
# problem <-> spec
# ---------------------------------------------------------------------------

def to_spec(problem: Problem) -> dict:
    """Serialize a Problem to a JSON-able dict (the preconditioners are
    stored, and a rebuilt problem takes them as custom scaling)."""
    return {
        "nrows": problem.nrows,
        "ncols": problem.ncols,
        "linop": [to_block_spec(b) for b in problem.linop.blocks],
        "prox_g": [to_prox_spec(p) for p in problem.prox_g],
        "prox_f": [to_prox_spec(p) for p in problem.prox_f],
        "prox_gstar": [to_prox_spec(p) for p in problem.prox_gstar],
        "prox_fstar": [to_prox_spec(p) for p in problem.prox_fstar],
        "scaling_left": _enc(problem.scaling_left),
        "scaling_right": _enc(problem.scaling_right),
    }


def from_spec(spec: dict) -> Problem:
    """Rebuild a Problem from a spec produced by :func:`to_spec` (of
    either package), on ``config.device()``.  The problem is validated as
    one with custom scaling (the stored diagonals' square roots), then
    takes the stored diagonals themselves, bit for bit: squaring the
    square roots again in the working dtype can move them by an ulp,
    where the JAX package's ``from_spec`` keeps that ulp."""
    linop = LinearOperator.create(
        [from_block_spec(b) for b in spec["linop"]]
    )
    kw = {}
    for side in ("prox_g", "prox_f", "prox_gstar", "prox_fstar"):
        kw[side] = [from_prox_spec(p) for p in spec.get(side, [])]
    left, right = (np.asarray(_dec(spec[k]), np.float64)
                   for k in ("scaling_left", "scaling_right"))
    problem = Problem.create(
        linop, nrows=spec["nrows"], ncols=spec["ncols"],
        scaling="custom", scaling_left=np.sqrt(left),
        scaling_right=np.sqrt(right), **kw,
    )
    return dataclasses.replace(problem, scaling_left=_wire_arr(left),
                               scaling_right=_wire_arr(right))


def save_spec(path: str, spec: dict) -> None:
    with open(path, "w") as fh:
        json.dump(spec, fh)


def load_spec(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# default registry entries
# ---------------------------------------------------------------------------

def _seps(p):
    return {"count": p.count, "dim": p.dim, "interleaved": p.interleaved}


def _fun(name, first=2):
    """The function part of a family name, from its ``first`` field on."""
    return ":".join(name.split(":")[first:])


def _eigen_nxn_to(p):
    return {"count": p.count, "n": p.n, "interleaved": p.interleaved,
            "coeffs": _enc_coeffs(p.coeffs)}


register_prox(
    "zero", ProxZero,
    lambda p: {},
    lambda idx, size, data, name: ProxZero(index=idx, size=size),
)
register_prox(
    "elem_operation:1d", ProxElem1D,
    lambda p: {"coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElem1D(
        index=idx, size=size, fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation:norm2", ProxElemNorm2,
    lambda p: {**_seps(p), "coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElemNorm2(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        interleaved=data["interleaved"], fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation:ind_simplex", ProxElemIndSimplex,
    _seps,
    lambda idx, size, data, name: ProxElemIndSimplex(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        interleaved=data["interleaved"]),
)
register_prox(
    "elem_operation:ind_sum", ProxElemIndSum,
    _seps,
    lambda idx, size, data, name: ProxElemIndSum(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        interleaved=data["interleaved"]),
)
register_prox(
    "elem_operation:eigen_2x2", ProxElemEigen2x2,
    lambda p: {"count": p.count, "interleaved": p.interleaved,
               "coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElemEigen2x2(
        index=idx, size=size, count=data["count"],
        interleaved=data["interleaved"], fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation:eigen_nxn", ProxElemEigenNxN,
    _eigen_nxn_to,
    lambda idx, size, data, name: ProxElemEigenNxN(
        index=idx, size=size, count=data["count"], n=data["n"],
        interleaved=data["interleaved"], fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation:singular_nx2", ProxElemSingularNx2,
    lambda p: {**_seps(p), "coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElemSingularNx2(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        interleaved=data["interleaved"], fun=_fun(name),
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    # the reference's eigen_3x3 is the NxN spectral prox at n = 3; it
    # writes back as eigen_nxn, its class's first name
    "elem_operation:eigen_3x3", ProxElemEigenNxN,
    _eigen_nxn_to,
    lambda idx, size, data, name: ProxElemEigenNxN(
        index=idx, size=size, count=data["count"], n=3,
        interleaved=data["interleaved"], fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation", ProxElemMassNorm,  # mass4/5, ind_comass{4,5}_ball
    lambda p: {"count": p.count, "n": p.n, "interleaved": p.interleaved,
               "conjugate": p.conjugate, "cost": p.cost},
    # n and conjugate follow from the reference's kind name when absent
    # (elem_operation:mass4, elem_operation:ind_comass5_ball, ...)
    lambda idx, size, data, name: ProxElemMassNorm(
        index=idx, size=size, count=data["count"],
        n=data.get("n", 5 if "5" in name else 4),
        interleaved=data.get("interleaved", False),
        conjugate=data.get("conjugate", "comass" in name),
        cost=data.get("cost", 1.0)),
)
register_prox(
    "ind_soc", ProxIndSOC,
    lambda p: {"count": p.count, "dim": p.dim, "alpha": p.alpha},
    lambda idx, size, data, name: ProxIndSOC(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        alpha=data["alpha"]),
)
register_prox(
    "ind_halfspace", ProxIndHalfspace,
    lambda p: {"count": p.count, "dim": p.dim,
               "a": _enc(p.a), "b": _enc(p.b)},
    lambda idx, size, data, name: ProxIndHalfspace(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        a=_wire_arr(data["a"]), b=_wire_arr(data["b"])),
)
register_prox(
    "ind_epi_quad", ProxIndEpiQuad,
    lambda p: {"count": p.count, "dim": p.dim,
               "a": _enc(p.a), "b": _enc(p.b), "c": _enc(p.c)},
    lambda idx, size, data, name: ProxIndEpiQuad(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        a=_wire_arr(data["a"]), b=_wire_arr(data["b"]),
        c=_wire_arr(data["c"])),
)
register_prox(
    "ind_epi_polyhedral", ProxIndEpiPolyhedral,
    lambda p: {"count": p.count, "dim": p.dim, "sweeps": p.sweeps,
               "tol": p.tol, "omega": p.omega,
               "a": _enc(p.a), "b": _enc(p.b), "mask": _enc(p.mask)},
    lambda idx, size, data, name: ProxIndEpiPolyhedral.create(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        a=np.asarray(_dec(data["a"])).reshape(-1, data["dim"] - 1,
                                              data["count"]),
        b=np.asarray(_dec(data["b"])).reshape(-1, data["count"]),
        mask=np.asarray(_dec(data["mask"])).reshape(-1, data["count"]),
        sweeps=data["sweeps"], tol=data.get("tol", 5e-7),
        omega=data.get("omega", 1.7)),
)
register_prox(
    "ind_sum", ProxIndSum,
    lambda p: {
        "count": p.count, "dim": p.dim, "sum_target": p.sum_target,
        "count2": p.count2, "dim2": p.dim2, "sum_target2": p.sum_target2,
        "inds": _enc(p.inds),
        "inds2": None if p.inds2 is None else _enc(p.inds2),
    },
    lambda idx, size, data, name: ProxIndSum(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        sum_target=data["sum_target"], count2=data["count2"],
        dim2=data["dim2"], sum_target2=data["sum_target2"],
        inds=_wire_arr(data["inds"], torch.int32),
        inds2=(None if data["inds2"] is None
               else _wire_arr(data["inds2"], torch.int32))),
)


def _ind_range_to(p):
    if p.At is not None:
        # sparse CSR -> the BCOO form: (nnz, 2) rows of (row, col)
        coo = p.A.to_sparse_coo().coalesce()
        return {"A_sparse": {"data": _enc(coo.values()),
                             "indices": _enc(coo.indices().T.to(torch.int32)),
                             "shape": list(p.A.shape)}}
    return {"A": _enc(p.A)}


def _ind_range_from(idx, size, data, name):
    if "A_sparse" in data:
        import scipy.sparse as ssp

        sp = data["A_sparse"]
        ind = np.asarray(_dec(sp["indices"])).reshape(-1, 2)
        A = ssp.coo_matrix(
            (np.asarray(_dec(sp["data"])), (ind[:, 0], ind[:, 1])),
            shape=tuple(sp["shape"]))
        return ProxIndRange.create(idx, size, A)
    return ProxIndRange.create(idx, size, np.asarray(_dec(data["A"])))


register_prox("ind_range", ProxIndRange, _ind_range_to, _ind_range_from)
register_prox(
    "moreau", ProxMoreau,
    lambda p: {"child": to_prox_spec(p.child)},
    lambda idx, size, data, name: ProxMoreau(
        index=idx, size=size, child=from_prox_spec(data["child"])),
)
register_prox(
    "transform", ProxTransform,
    lambda p: {"child": to_prox_spec(p.child),
               **{k: _enc(getattr(p, k)) for k in ("a", "b", "c", "d", "e")}},
    lambda idx, size, data, name: ProxTransform(
        index=idx, size=size, child=from_prox_spec(data["child"]),
        **{k: _dec_value(data[k]) for k in ("a", "b", "c", "d", "e")}),
)
register_prox(
    "permute", ProxPermute,
    lambda p: {"child": to_prox_spec(p.child), "perm": _enc(p.perm)},
    lambda idx, size, data, name: ProxPermute(
        index=idx, size=size, child=from_prox_spec(data["child"]),
        perm=_wire_arr(data["perm"], torch.int32)),
)


# blocks ---------------------------------------------------------------------

def _kron_id_to(b):
    return {"diaglength": b.diaglength, "data": _enc(b.data)}


def _kron_id_from(row, col, data):
    return BlockKronId.create(row, col, data["diaglength"],
                              np.asarray(_dec(data["data"])))


def _id_kron_to(b):
    return {"ncopies": b.ncopies, "data": _enc(b.data)}


def _id_kron_from(row, col, data):
    return BlockIdKron.create(row, col, data["ncopies"],
                              np.asarray(_dec(data["data"])))


def _diags_to(b):
    return {"nrows": b.nrows, "ncols": b.ncols,
            "factors": _enc(b.factors), "offsets": list(b.offsets)}


register_block(
    "sparse", BlockSparse,
    lambda b: {
        "nrows": b.nrows, "ncols": b.ncols,
        "rows": _enc(b.rows_f), "cols": _enc(b.cols_f),
        "vals": _enc(b.vals_f),
    },
    lambda row, col, data: BlockSparse.create(
        row, col, data["nrows"], data["ncols"],
        (np.asarray(_dec(data["rows"])), np.asarray(_dec(data["cols"])),
         np.asarray(_dec(data["vals"])))),
)
register_block(
    "dense", BlockDense,
    lambda b: {"data": _enc(b.data)},
    lambda row, col, data: BlockDense.create(
        row, col, np.asarray(_dec(data["data"]))),
)
register_block(
    "diags", BlockDiags,
    _diags_to,
    lambda row, col, data: BlockDiags.create(
        row, col, data["nrows"], data["ncols"],
        np.asarray(_dec(data["factors"])), data["offsets"]),
)
register_block(
    "gradient2d", BlockGradient2D,
    lambda b: {"nx": b.nx, "ny": b.ny, "L": b.L,
               "label_first": b.label_first},
    lambda row, col, data: BlockGradient2D(
        row=row, col=col, nx=data["nx"], ny=data["ny"], L=data["L"],
        label_first=data["label_first"]),
)
register_block(
    "gradient3d", BlockGradient3D,
    lambda b: {"nx": b.nx, "ny": b.ny, "L": b.L,
               "label_first": b.label_first},
    lambda row, col, data: BlockGradient3D(
        row=row, col=col, nx=data["nx"], ny=data["ny"], L=data["L"],
        label_first=data["label_first"]),
)
register_block("sparse_kron_id", BlockKronId, _kron_id_to, _kron_id_from)
register_block("id_kron_sparse", BlockIdKron, _id_kron_to, _id_kron_from)
register_block(
    "conv2d", BlockConv2D,
    # the kernel is stored (kx, ky); the wire carries it as the user gave
    # it, (ky, kx)
    lambda b: {"nx": b.nx, "ny": b.ny, "L": b.L,
               "kernel": _enc(to_numpy(b.kernel).T)},
    lambda row, col, data: BlockConv2D.create(
        row, col, data["nx"], data["ny"], data["L"],
        np.asarray(_dec(data["kernel"]))),
)
# The reference's aliases: one class serves each kron orientation, and
# identity is a single unit diagonal, so these names are read only.
# to_block_spec takes a class's first registered name, so the aliases
# register after the canonical names.
register_block("dense_kron_id", BlockKronId, _kron_id_to, _kron_id_from)
register_block("id_kron_dense", BlockIdKron, _id_kron_to, _id_kron_from)
register_block(
    "identity", BlockDiags,
    _diags_to,
    lambda row, col, data: BlockDiags.create(
        row, col, data.get("nrows", data.get("n")),
        data.get("ncols", data.get("n")),
        np.asarray(_dec(data.get("factors", [data.get("factor", 1.0)]))),
        data.get("offsets", [0])),
)
register_block(
    "zero", BlockZero,
    lambda b: {"nrows": b.nrows, "ncols": b.ncols},
    lambda row, col, data: BlockZero(
        row=row, col=col, nrows=data["nrows"], ncols=data["ncols"]),
)
