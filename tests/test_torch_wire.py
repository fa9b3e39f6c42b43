"""Port parity: the wire format of prost_tpu_torch (modeling/wire.py)
against prost_tpu's.

Every prox kind name the JAX wire layer accepts is one case: the names of
its registry (``prost_tpu.modeling.wire._PROX_REGISTRY``), each family
``elem_operation:<family>`` expanded over the functions it takes (the 14
of ``FUN_1D`` for 1d, norm2, eigen_2x2, eigen_nxn and eigen_3x3; the 16
of ``FUN_2D`` for singular_nx2), and the four mass-norm names: 102 names.
Each constructs in both packages from the same spec and evaluates on the
same seeded input in float64 (JAX in x64 mode) within 1e-12 (closed
forms and eigh-based forms alike; the polyhedral epigraph's SOR sweeps
within 1e-10), and its spec round-trips in both, the two packages'
``to_prox_spec`` equal key by key.

Every block kind round-trips and applies alike.  Whole problems (config
1's ROF, config 3's fast multilabel, the tight multilabel, volumetric TV
and the dual ROF on ``block.sparse``, at small sizes) give the same spec
in both packages (arrays within 1e-7 relative; sparse matrices compared
as matrices), a spec of either package loads in the other with
``interop.problem_arrays`` equal, and a rebuilt problem takes its route.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as ssp
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.modeling import wire as jw
from prost_tpu.prox.fun1d import FUN_1D
from prost_tpu.prox.fun2d import FUN_2D
from prost_tpu_torch import interop
from prost_tpu_torch.common import tree_to
from prost_tpu_torch.config import ProstError
from prost_tpu_torch.modeling import wire as tw

CLOSED = dict(rtol=1e-12, atol=1e-12)
SWEEPS = dict(rtol=1e-10, atol=1e-10)  # the polyhedral epigraph's SOR
SPEC_RTOL = 1e-7
COEFFS = [1.0, 0.0, 1.0, 0.0, 0.0, 0.5, 0.5]  # (a, b, c, d, e, alpha, beta)

_FUN_FAMILIES = {
    "elem_operation:1d": FUN_1D, "elem_operation:norm2": FUN_1D,
    "elem_operation:eigen_2x2": FUN_1D, "elem_operation:eigen_nxn": FUN_1D,
    "elem_operation:eigen_3x3": FUN_1D,
    "elem_operation:singular_nx2": FUN_2D,
}
_MASS = ("mass4", "mass5", "ind_comass4_ball", "ind_comass5_ball")


def prox_kind_names():
    """Every prox kind name the JAX wire layer accepts."""
    names = []
    for key in jw._PROX_REGISTRY:
        if key in _FUN_FAMILIES:
            names += [f"{key}:{fun}" for fun in sorted(_FUN_FAMILIES[key])]
        elif key == "elem_operation":
            names += [f"elem_operation:{m}" for m in _MASS]
        else:
            names.append(key)
    return names


PROX_NAMES = prox_kind_names()


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    pt.set_dtype(jnp.float64)
    ptt.set_dtype(torch.float64)
    yield
    ptt.set_dtype(torch.float32)
    pt.set_dtype(jnp.float32)
    jax.config.update("jax_enable_x64", False)


def _enc(a):
    return jw._enc(np.asarray(a))


def _spec(name):
    """A spec of the kind ``name`` (the JAX package's reference-parity
    templates, extended to every family)."""
    rng = np.random.RandomState(3)
    inner = {"name": "elem_operation:1d:square", "idx": 0, "size": 8,
             "data": {"coeffs": COEFFS}}
    fixed = {
        "zero": (8, {}),
        "moreau": (8, {"child": inner}),
        "transform": (8, {"child": inner, "a": [2.0, 1.0, 0.5, 1.0, 3.0,
                                                1.0, 1.0, 2.0],
                          "b": 0.25, "c": [1.0], "d": 0.0, "e": 0.5}),
        "permute": (8, {"child": inner, "perm": list(range(7, -1, -1))}),
        "ind_range": (8, {"A": _enc(np.linalg.qr(rng.randn(8, 3))[0])}),
        "ind_soc": (9, {"count": 3, "dim": 3, "alpha": 1.0}),
        "ind_halfspace": (8, {"count": 2, "dim": 4,
                              "a": [1.0, 0.0, 0.0, 1.0], "b": [1.0]}),
        "ind_epi_quad": (9, {"count": 3, "dim": 3, "a": [1.0],
                             "b": [0.0, 0.0], "c": [0.0]}),
        "ind_sum": (8, {"count": 2, "dim": 3, "sum_target": 1.0,
                        "count2": 0, "dim2": 0, "sum_target2": 1.0,
                        "inds": [0, 1, 2, 4, 5, 6], "inds2": None}),
        "ind_epi_polyhedral": (
            12, {"count": 4, "dim": 3, "sweeps": 400, "tol": 5e-7,
                 "omega": 1.7, "a": _enc(rng.randn(5, 2, 4)),
                 "b": _enc(rng.randn(5, 4)),
                 "mask": _enc((rng.rand(5, 4) < 0.8).astype(float))}),
    }
    if name in fixed:
        size, data = fixed[name]
    else:
        family = name.split(":")[1]
        size, data = {
            "1d": (8, {"coeffs": COEFFS}),
            "norm2": (8, {"count": 4, "dim": 2, "interleaved": False,
                          "coeffs": COEFFS}),
            "ind_simplex": (8, {"count": 2, "dim": 4, "interleaved": False}),
            "ind_sum": (8, {"count": 2, "dim": 4, "interleaved": False}),
            "eigen_2x2": (8, {"count": 2, "interleaved": False,
                              "coeffs": COEFFS}),
            "eigen_3x3": (18, {"count": 2, "interleaved": False,
                               "coeffs": COEFFS}),
            "eigen_nxn": (32, {"count": 2, "n": 4, "interleaved": False,
                               "coeffs": COEFFS}),
            "singular_nx2": (12, {"count": 2, "dim": 6, "interleaved": False,
                                  "coeffs": COEFFS}),
            "mass4": (12, {"count": 2}), "ind_comass4_ball": (12,
                                                              {"count": 2}),
            "mass5": (20, {"count": 2}), "ind_comass5_ball": (20,
                                                              {"count": 2}),
        }[family]
    return {"name": name, "idx": 0, "size": size, "data": data}


def _jax_eval(p, arg, tau_scal):
    return np.asarray(p.eval(jnp.asarray(arg), jnp.ones(arg.size), tau_scal,
                             False))


def _torch_eval(p, arg, tau_scal):
    p = tree_to(p, torch.device("cpu"), torch.float64)
    return p.eval(torch.from_numpy(arg), torch.ones(arg.size,
                                                    dtype=torch.float64),
                  tau_scal, False).numpy()


def _matrix(spec_data):
    """A sparse block's or an A_sparse's triplets as a dense matrix."""
    if "A_sparse" in spec_data:
        sp = spec_data["A_sparse"]
        ind = jw._dec(sp["indices"]).reshape(-1, 2)
        return ssp.coo_matrix((jw._dec(sp["data"]), (ind[:, 0], ind[:, 1])),
                              shape=tuple(sp["shape"])).toarray()
    return ssp.coo_matrix(
        (jw._dec(spec_data["vals"]),
         (jw._dec(spec_data["rows"]), jw._dec(spec_data["cols"]))),
        shape=(spec_data["nrows"], spec_data["ncols"])).toarray()


def assert_same_spec(a, b, path="spec"):
    """Two specs equal key by key: arrays of one kind and shape within
    SPEC_RTOL, sparse matrices (``rows/cols/vals`` or ``A_sparse``) as
    matrices, everything else exactly."""
    if isinstance(a, dict) and "__array__" in a:
        assert isinstance(b, dict) and "__array__" in b, path
        x, y = jw._dec(a), jw._dec(b)
        assert x.shape == y.shape and x.dtype.kind == y.dtype.kind, path
        np.testing.assert_allclose(y, x, rtol=SPEC_RTOL, atol=0,
                                   err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a.keys(),
                                                          b.keys())
        if "A_sparse" in a or {"rows", "cols", "vals"} <= set(a):
            np.testing.assert_allclose(_matrix(b), _matrix(a),
                                       rtol=SPEC_RTOL, err_msg=path)
            a = {k: v for k, v in a.items()
                 if k not in ("A_sparse", "rows", "cols", "vals")}
        for k in a:
            assert_same_spec(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same_spec(u, v, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(b, a, rtol=SPEC_RTOL, err_msg=path)
    else:
        assert a == b, (path, a, b)


def test_prox_kind_names_cover_the_registry():
    """102 names: 19 registry entries, six families over their functions,
    four mass-norm names; none that the JAX layer refuses."""
    assert len(PROX_NAMES) == len(set(PROX_NAMES)) == 102
    assert set(tw._PROX_REGISTRY) == set(jw._PROX_REGISTRY)
    assert list(tw._PROX_REGISTRY) == list(jw._PROX_REGISTRY)


@pytest.mark.parametrize("name", PROX_NAMES)
def test_prox_kind_matches_jax(x64, name):
    spec = json.loads(json.dumps(_spec(name)))
    jp, tp = jw.from_prox_spec(spec), tw.from_prox_spec(spec)
    assert type(tp).__name__ == type(jp).__name__
    size = spec["size"]
    arg = np.random.RandomState(0).randn(size)
    tol = SWEEPS if name == "ind_epi_polyhedral" else CLOSED
    ja, ta = _jax_eval(jp, arg, 0.7), _torch_eval(tp, arg, 0.7)
    assert ta.shape == (size,) and np.all(np.isfinite(ta))
    np.testing.assert_allclose(ta, ja, **tol)

    # both packages write the same spec, which round-trips in each
    jback, tback = jw.to_prox_spec(jp), tw.to_prox_spec(tp)
    assert_same_spec(jback, tback)
    tback = json.loads(json.dumps(tback))
    np.testing.assert_allclose(_torch_eval(tw.from_prox_spec(tback), arg,
                                           0.7), ta, **CLOSED)
    np.testing.assert_allclose(_jax_eval(jw.from_prox_spec(tback), arg, 0.7),
                               ja, **CLOSED)


def test_ind_range_sparse_crosses_both_ways(x64):
    """A sparse range basis: the port's CSR is written in the JAX BCOO
    form, and each package reads the other's."""
    rng = np.random.RandomState(5)
    A = ssp.random(30, 4, density=0.3, random_state=rng, format="csr")
    A = (A + ssp.eye(30, 4)).tocsr()
    jp = pt.prox.ProxIndRange.create(0, 30, A)
    tp = ptt.prox.ProxIndRange.create(0, 30, A)
    jspec, tspec = jw.to_prox_spec(jp), tw.to_prox_spec(tp)
    assert "A_sparse" in tspec["data"]
    assert_same_spec(jspec, tspec)
    arg = rng.randn(30)
    want = _jax_eval(jp, arg, 1.0)
    for spec in (jspec, tspec):
        spec = json.loads(json.dumps(spec))
        np.testing.assert_allclose(_torch_eval(tw.from_prox_spec(spec), arg,
                                               1.0), want, rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(_jax_eval(jw.from_prox_spec(spec), arg,
                                             1.0), want, rtol=1e-10,
                                   atol=1e-12)


# ------------------------------------------------------------------ blocks

def _blocks(mod):
    rng = np.random.RandomState(0)
    K = rng.randn(4, 6)
    K[K < -0.5] = 0.0
    L = mod.linop
    return {
        "sparse": L.BlockSparse.create(0, 0, 4, 6, ssp.csr_matrix(K)),
        "dense": L.BlockDense.create(0, 0, K),
        "diags": L.BlockDiags.create(0, 0, 5, 5, [1.0, -2.0], [0, 1]),
        "gradient2d": L.BlockGradient2D(row=0, col=0, nx=4, ny=5, L=2),
        "gradient3d": L.BlockGradient3D(row=0, col=0, nx=4, ny=5, L=2),
        "sparse_kron_id": L.BlockKronId.create(0, 0, 3, K),
        "id_kron_sparse": L.BlockIdKron.create(0, 0, 3, K),
        "conv2d": L.BlockConv2D.create(0, 0, 6, 5, 1, rng.randn(3, 2)),
        "zero": L.BlockZero(row=0, col=0, nrows=4, ncols=9),
    }


# the reference's aliases, read only: (alias, the spec's data)
_ALIASES = {
    "dense_kron_id": ("sparse_kron_id", None),
    "id_kron_dense": ("id_kron_sparse", None),
    "identity": ("diags", {"n": 7, "factor": 2.5}),
}
BLOCK_NAMES = list(jw._BLOCK_REGISTRY)


def test_block_kinds_cover_the_registry():
    assert len(BLOCK_NAMES) == 12
    assert list(tw._BLOCK_REGISTRY) == BLOCK_NAMES
    assert set(BLOCK_NAMES) == set(_blocks(pt)) | set(_ALIASES)


@pytest.mark.parametrize("name", BLOCK_NAMES)
def test_block_kind_matches_jax(x64, name):
    canon, data = _ALIASES.get(name, (name, None))
    jb = _blocks(pt)[canon]
    tb = _blocks(ptt)[canon]
    jspec, tspec = jw.to_block_spec(jb), tw.to_block_spec(tb)
    assert jspec["name"] == tspec["name"] == canon
    assert_same_spec(jspec, tspec)
    spec = json.loads(json.dumps(tspec))
    if name in _ALIASES:
        spec["name"] = name
        if data is not None:
            spec["data"] = data
    jb2, tb2 = jw.from_block_spec(spec), tw.from_block_spec(spec)
    assert type(tb2).__name__ == type(jb2).__name__
    rng = np.random.RandomState(1)
    x = rng.randn(jb2.ncols)
    y = rng.randn(jb2.nrows)
    tb2 = tree_to(tb2, torch.device("cpu"), torch.float64)
    np.testing.assert_allclose(
        tb2.apply(torch.from_numpy(x)).numpy(),
        np.asarray(jb2.apply(jnp.asarray(x))), **CLOSED)
    np.testing.assert_allclose(
        tb2.apply_adjoint(torch.from_numpy(y)).numpy(),
        np.asarray(jb2.apply_adjoint(jnp.asarray(y))), **CLOSED)
    if name not in _ALIASES:
        np.testing.assert_allclose(
            tb2.apply(torch.from_numpy(x)).numpy(),
            tree_to(tb, torch.device("cpu"), torch.float64).apply(
                torch.from_numpy(x)).numpy(), **CLOSED)


def test_unknown_kind_raises():
    with pytest.raises(ProstError, match="unknown prox kind"):
        tw.from_prox_spec({"name": "nope", "idx": 0, "size": 1, "data": {}})
    with pytest.raises(ProstError, match="unknown block kind"):
        tw.from_block_spec({"name": "nope", "row": 0, "col": 0, "data": {}})

    class Unregistered(ptt.prox.ProxZero):
        pass

    with pytest.raises(ProstError, match="unregistered prox"):
        tw.to_prox_spec(Unregistered(index=0, size=3))
    with pytest.raises(ProstError, match="unregistered block"):
        tw.to_block_spec(type("B", (ptt.linop.BlockZero,), {})(
            row=0, col=0, nrows=1, ncols=1))


def test_register_hooks():
    """A registered custom prox and block serialize and come back."""
    import dataclasses

    @dataclasses.dataclass(eq=False)
    class ProxScale(ptt.prox.Prox):
        index: int
        size: int
        s: float = 1.0

        def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
            return self.s * arg

    @dataclasses.dataclass(eq=False)
    class BlockTwice(ptt.linop.BlockZero):
        def apply(self, x_seg):
            return 2.0 * x_seg

    tw.register_prox("test_scale", ProxScale, lambda p: {"s": p.s},
                     lambda idx, size, data, name: ProxScale(
                         index=idx, size=size, s=data["s"]))
    tw.register_block("test_twice", BlockTwice,
                      lambda b: {"n": b.nrows},
                      lambda row, col, data: BlockTwice(
                          row=row, col=col, nrows=data["n"],
                          ncols=data["n"]))
    try:
        spec = json.loads(json.dumps(tw.to_prox_spec(ProxScale(
            index=2, size=3, s=1.5))))
        assert spec["name"] == "test_scale" and spec["idx"] == 2
        p = tw.from_prox_spec(spec)
        assert isinstance(p, ProxScale) and p.s == 1.5
        bspec = json.loads(json.dumps(tw.to_block_spec(BlockTwice(
            row=1, col=0, nrows=4, ncols=4))))
        b = tw.from_block_spec(bspec)
        assert isinstance(b, BlockTwice) and (b.row, b.nrows) == (1, 4)
        torch.testing.assert_close(b.apply(torch.ones(4)),
                                   torch.full((4,), 2.0))
    finally:
        del tw._PROX_REGISTRY["test_scale"]
        del tw._BLOCK_REGISTRY["test_twice"]


def test_save_load_spec(tmp_path):
    p = ptt.prox.ProxTransform(
        index=0, size=4,
        child=ptt.prox.ProxElem1D(index=0, size=4, fun="abs",
                                  coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0,
                                          0.0)),
        a=2.0, b=1.0)
    path = str(tmp_path / "p.json")
    tw.save_spec(path, tw.to_prox_spec(p))
    q = tw.from_prox_spec(tw.load_spec(path))
    arg = torch.tensor([3.0, -1.0, 0.5, 2.0])
    tau = torch.ones(4)
    torch.testing.assert_close(q.eval_local(arg, tau, 1.0, False),
                               p.eval_local(arg, tau, 1.0, False))


# ---------------------------------------------------------------- problems

def _rof(mod, nx=10, ny=12):
    n = nx * ny
    f = np.random.RandomState(0).rand(n)
    u, q = mod.Variable(n), mod.Variable(2 * n)
    prob = mod.MinMaxProblem([u], [q])
    prob.add_function(u, mod.function.sum_1d("square", 1, f, 16.0))
    prob.add_function(q, mod.function.conjugate(
        mod.function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, 1))
    return prob.finalize()


def _ml(mod, nx=8, ny=10, L=4):
    n = nx * ny
    f = np.random.RandomState(1).rand(n * L)
    u, q, s = mod.Variable(n * L), mod.Variable(2 * n * L), mod.Variable(n)
    prob = mod.MinMaxProblem([u], [q, s])
    prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(q, mod.function.sum_norm2(2 * L, False, "ind_leq0",
                                                2.0, 1, 1))
    prob.add_function(s, mod.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, mod.block.sparse_kron_id(np.ones((1, L)), n))
    return prob.finalize()


def _tight(mod, nx=8, ny=10, L=3):
    from prost_tpu_torch.examples.example_multilabel_tight import (
        pair_local_matrix)

    n, k = nx * ny, L * (L - 1) // 2
    f = np.random.RandomState(2).rand(n * L)
    u, v = mod.Variable(n * L), mod.Variable(2 * n * k)
    q, p, s = mod.Variable(2 * n * L), mod.Variable(2 * n * k), \
        mod.Variable(n)
    prob = mod.MinMaxProblem([u, v], [q, p, s])
    prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(p, mod.function.sum_norm2(2, False, "ind_leq0", 1, 1,
                                                1))
    prob.add_function(s, mod.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, mod.block.sparse_kron_id(np.ones((1, L)), n))
    prob.add_dual_pair(v, p, mod.block.identity())
    prob.add_dual_pair(v, q, mod.block.sparse_kron_id(pair_local_matrix(L).T,
                                                      n))
    return prob.finalize()


def _vol(mod, nx=8, ny=10, L=3):
    n = L * nx * ny
    f = np.random.RandomState(3).rand(n)
    u, q = mod.Variable(n), mod.Variable(3 * n)
    prob = mod.MinMaxProblem([u], [q])
    prob.add_function(u, mod.function.sum_1d("square", 1, f, 6.0))
    prob.add_function(q, mod.function.conjugate(
        mod.function.sum_norm2(3, False, "abs")))
    prob.add_dual_pair(u, q, mod.block.gradient3d(nx, ny, L))
    return prob.finalize()


def _dual_rof(mod, nx=10, ny=12):
    from prost_tpu_torch.examples.example_rof_dual import spmat_gradient2d

    n = nx * ny
    f = np.random.RandomState(4).rand(n)
    grad = spmat_gradient2d(nx, ny, 1)
    q, w = mod.Variable(2 * n), mod.Variable(n)
    prob = mod.MinProblem([q], [w])
    prob.add_function(q, mod.function.sum_norm2(2, False, "ind_leq0", 1, 1,
                                                1))
    prob.add_function(w, mod.function.sum_1d("square", 1, -0.3 * f,
                                             1 / 0.3))
    prob.add_constraint(q, w, mod.block.sparse(-grad.T.tocsc()))
    return prob.finalize()


def _route(problem):
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.examples._common import route_name
    from prost_tpu_torch.ops import FusedROFPDHG

    return route_name(FusedROFPDHG(problem, PDHGOptions(),
                                   ptt.SolverOptions(verbose=False)))


MODELS = {"rof": (_rof, "rof"), "ml": (_ml, "ml"), "tight": (_tight, "tight"),
          "vol": (_vol, "vol"), "dual_rof_sparse": (_dual_rof, "generic")}


def _assert_same_arrays(a, b, path="problem"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_arrays(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same_arrays(u, v, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=1e-6,
                                   atol=1e-7, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("kind", list(MODELS))
def test_problem_spec_matches_jax(kind):
    build, route = MODELS[kind]
    jprob, tprob = build(pt), build(ptt)
    jspec = json.loads(json.dumps(jw.to_spec(jprob)))
    tspec = json.loads(json.dumps(tw.to_spec(tprob)))
    assert_same_spec(jspec, tspec)

    want = interop.problem_arrays(jprob)
    from_jax, from_port = tw.from_spec(jspec), jw.from_spec(tspec)
    _assert_same_arrays(want, interop.problem_arrays(from_jax))
    _assert_same_arrays(want, interop.problem_arrays(from_port))
    _assert_same_arrays(interop.problem_arrays(tprob),
                        interop.problem_arrays(tw.from_spec(tspec)))

    # the rebuilt problem takes the original's route, and its
    # preconditioners come back bit for bit
    assert _route(tprob) == _route(from_jax) == f"FusedROFPDHG:{route}"
    rebuilt = tw.from_spec(tspec)
    assert torch.equal(rebuilt.scaling_left, tprob.scaling_left)
    assert torch.equal(rebuilt.scaling_right, tprob.scaling_right)


def test_rebuilt_rof_solves_bit_for_bit():
    """Config 1's model through JSON and back: the fused route's run
    equals the original's bit for bit."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.ops import FusedROFPDHG

    prob = _rof(ptt, 16, 16)
    rebuilt = tw.from_spec(json.loads(json.dumps(tw.to_spec(prob))))
    opts = PDHGOptions(stepsize="boyd", residual_iter=10)
    sopts = ptt.SolverOptions(verbose=False)
    states = []
    for p in (prob, rebuilt):
        b = FusedROFPDHG(p, opts, sopts)
        assert b.rof is not None
        states.append(b.run(b.initial_state(), 205, 0))
    for k in vars(states[0]):
        assert torch.equal(getattr(states[0], k), getattr(states[1], k)), k
