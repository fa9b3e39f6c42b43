"""Slice 8a: spatial sharding of the port (``prost_tpu_torch.parallel``:
``make_mesh``, ``ShardedPDHG``, ``ShardedFusedROF``,
``ShardedFusedMultilabel``, ``ShardedFusedVol``) and the halo chunks'
plain versions, against the JAX package.

The JAX side runs as tests/test_spatial_fused.py runs it: 8 virtual CPU
devices (conftest.py), the Pallas kernels in interpret mode.  The port's
ranks are gloo processes started by ``torch_spatial_worker.run_ranks``
(spawned: this process holds JAX's threads), two groups of 2 and 4 ranks
for the whole module, each running every job once.  Tolerances: the halo
chunks' owned rows 2e-5 absolute and their norms 1e-4 relative against
the JAX kernels (f32, the same operations; the JAX kernels' rows next to
a shard's edge differ by design, see ``halo_row_ops``); the routes the JAX
sharded tests' own bars (x and y 2e-5, tau 1e-6 relative, residuals 1e-3
relative); ShardedPDHG tests/test_parallel.py's 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
import torch_spatial_worker as worker
from prost_tpu.backend import PDHGOptions as JOptions
from prost_tpu.ops import fused_multilabel as jfm
from prost_tpu.ops import fused_rof as jfr
from prost_tpu.ops import fused_vol as jfv
from prost_tpu.parallel import ShardedFusedMultilabel as JShardedML
from prost_tpu.parallel import ShardedFusedROF as JShardedROF
from prost_tpu.parallel import ShardedFusedVol as JShardedVol
from prost_tpu.parallel import ShardedPDHG as JShardedPDHG
from prost_tpu.parallel import make_mesh as jmake_mesh
from prost_tpu_torch.ops import fused_multilabel as tfm
from prost_tpu_torch.ops import fused_rof as tfr
from prost_tpu_torch.ops import fused_vol as tfv
from prost_tpu_torch.parallel import make_mesh
from prost_tpu_torch.parallel.spatial_fused import window
from test_fused_multilabel import ml_problem as jml_problem
from test_fused_rof import rof_problem as jrof_problem
from test_fused_vol import vol_problem as jvol_problem

PLANE_ATOL, NORM_RTOL = 2e-5, 1e-4
BAND_NORM_RTOL = 1e-6
RUN_ATOL, TAU_RTOL, RES_RTOL = 2e-5, 1e-6, 1e-3
PDHG_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


# ---------------------------------------------------------------------------
# the halo chunks (rows 3, 12 and 24 of the kernel table)
# ---------------------------------------------------------------------------

NXG, NY, L, RI = 48, 40, 3, 5
H = 2 * RI + 2
# (shards, rank): top edge, interior, bottom edge, the whole plane
BLOCKS = {"top": (4, 0), "interior": (4, 1), "bottom": (4, 3), "S1": (1, 0)}


def _planes(kind, seed, clean=True):
    """Random global planes of ``kind``; ``clean`` zeroes the dead dual
    coordinates (q_x's last row, q_y's last column)."""
    rng = np.random.RandomState(seed)
    lead = () if kind == "rof" else (L,)
    u = rng.rand(*lead, NXG, NY).astype(np.float32)
    nq = {"rof": (2,), "ml": (2 * L,), "vol": (3, L)}[kind]
    q = (0.3 * rng.randn(*nq, NXG, NY)).astype(np.float32)
    if clean:
        qx, qy = ((q[0], q[1]) if kind != "ml" else (q[:L], q[L:]))
        qx[..., -1, :] = 0.0
        qy[..., -1] = 0.0
    f = rng.rand(*lead, NXG, NY).astype(np.float32)
    if kind == "ml":
        s = rng.randn(NXG, NY).astype(np.float32)
        return u, q, s, f
    w = (rng.rand(*lead, NXG, NY) > 0.3).astype(np.float32)
    return u, q, f, w


HEAD = {"rof": [0.9, 1.1, 1.0, 8.0, 1.0], "ml": [0.9, 1.1, 1.0, 0.7, 0.3],
        "vol": [0.9, 1.1, 1.0, 6.0, 1.0]}


def _block(planes, kind, shards, rank):
    """The halo-extended block of ``rank`` of ``shards`` (zeros beyond the
    plane) and its scal8."""
    rows = NXG // shards
    lo = rank * rows - H
    ext = [window(torch.from_numpy(a), lo, lo + rows + 2 * H)
           for a in planes]
    scal = torch.tensor(HEAD[kind] + [lo, H, H + rows], dtype=torch.float32)
    return ext, scal, rows


@functools.lru_cache(maxsize=None)
def _jax_halo(kind, dataterm="square"):
    if kind == "rof":
        fn = functools.partial(jfr.rof_fused_chunk_halo, dataterm=dataterm)
    elif kind == "ml":
        fn = jfm.ml_fused_chunk_halo
    else:
        fn = functools.partial(jfv.vol_fused_chunk_halo, dataterm=dataterm)
    return jax.jit(lambda *a: fn(*a, RI, NXG, interpret=True))


def _port_halo(kind, ext, scal):
    if kind == "rof":
        return tfr.rof_chunk_halo(*ext, scal, RI, NXG)
    if kind == "ml":
        return tfm.ml_chunk_halo(*ext, scal, RI, NXG)
    return tfv.vol_chunk_halo(*ext, scal, RI, NXG)


def _owned(a, rows):
    return np.asarray(a)[..., H:H + rows, :]


def _close_owned(out, ref, rows, n_planes):
    for i in range(n_planes):
        np.testing.assert_allclose(_owned(out[i], rows), _owned(ref[i], rows),
                                   atol=PLANE_ATOL, err_msg=f"plane {i}")
    np.testing.assert_allclose(out[-1].numpy(), np.asarray(ref[-1]),
                               rtol=NORM_RTOL, atol=1e-7)


N_PLANES = {"rof": 4, "ml": 6, "vol": 4}


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("kind", ["rof", "ml", "vol"])
def test_halo_chunk_matches_jax_kernel(kind, block):
    """Each plain halo version against the JAX halo kernel on the same
    extended block and scal8: owned rows and owned-row norms."""
    shards, rank = BLOCKS[block]
    ext, scal, rows = _block(_planes(kind, 3), kind, shards, rank)
    out = _port_halo(kind, ext, scal)
    ref = _jax_halo(kind)(*[jnp.asarray(a.numpy()) for a in ext],
                          jnp.asarray(scal.numpy()))
    _close_owned(out, ref, rows, N_PLANES[kind])


def test_halo_chunk_projects_the_dead_duals():
    """The documented deviation: like the whole-plane kernels, the port's
    halo chunk zeroes q_x on the global last row and q_y on the last
    column at entry, where the JAX halo kernel keeps a warm start's mass
    there.  On a block holding the global last row, the port on a dirty q
    equals the JAX kernel on the projected q."""
    dirty = _planes("rof", 4, clean=False)
    clean = _planes("rof", 4, clean=True)
    ext, scal, rows = _block(dirty, "rof", *BLOCKS["bottom"])
    ext_clean, _, _ = _block(clean, "rof", *BLOCKS["bottom"])
    out = _port_halo("rof", ext, scal)
    for a, b in zip(out, _port_halo("rof", ext_clean, scal)):
        assert torch.equal(a, b)
    ref = _jax_halo("rof")(*[jnp.asarray(a.numpy()) for a in ext_clean],
                           jnp.asarray(scal.numpy()))
    _close_owned(out, ref, rows, 4)


IN_PLACE = {"rof": tfr.rof_chunk_halo_, "ml": tfm.ml_chunk_halo_,
            "vol": tfv.vol_chunk_halo_}


@pytest.mark.parametrize("kind", ["rof", "ml", "vol"])
def test_in_place_halo_chunk_is_the_functional_one(kind):
    """The in-place form the sharded routes call leaves the functional
    wrapper's outputs in the caller's buffers; with the converged flag set
    it leaves every buffer, the previous iterate included, as it was."""
    ext, scal, _ = _block(_planes(kind, 6), kind, *BLOCKS["interior"])
    k = 3 if kind == "ml" else 2
    state, data = ext[:k], ext[k:]
    want = _port_halo(kind, ext, scal)
    cur = [t.clone() for t in state]
    prev = [torch.full_like(t, 7.0) for t in state]
    norms2 = IN_PLACE[kind](*cur, *prev, *data, scal, RI, NXG)
    for a, b in zip(cur + prev + [norms2], want):
        assert torch.equal(a, b)
    before = [t.clone() for t in cur + prev]
    held = torch.cat([scal, torch.ones(1)])
    norms2 = IN_PLACE[kind](*cur, *prev, *data, held, RI, NXG)
    assert not norms2.any()
    for a, b in zip(cur + prev, before):
        assert torch.equal(a, b)


def _whole_plane(kind, planes):
    t = [torch.from_numpy(a) for a in planes]
    scal = torch.tensor(HEAD[kind], dtype=torch.float32)
    if kind == "rof":
        return tfr.rof_chunk_plain(*t, scal, RI, "abs")
    if kind == "ml":
        return tfm.ml_chunk_plain(*t, scal, RI)
    return tfv.vol_chunk_plain(*t, scal, RI, "wsquare")


def _band(kind, ext, scal):
    if kind == "rof":
        return tfr.rof_chunk_halo_plain(*ext, scal, RI, NXG, "abs")
    if kind == "ml":
        return tfm.ml_chunk_halo_plain(*ext, scal, RI, NXG)
    return tfv.vol_chunk_halo_plain(*ext, scal, RI, NXG, "wsquare")


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kind", ["rof", "ml", "vol"])
def test_bands_compose_the_whole_plane(kind, shards):
    """The owned rows of every band equal the whole-plane chunk's rows, bit
    for bit, and the bands' owned-row norms sum to its norms."""
    planes = _planes(kind, 5)
    whole = _whole_plane(kind, planes)
    total = torch.zeros(4)
    n = N_PLANES[kind]
    for rank in range(shards):
        ext, scal, rows = _block(planes, kind, shards, rank)
        out = _band(kind, ext, scal)
        for i in range(n):
            assert torch.equal(out[i][..., H:H + rows, :],
                               whole[i][..., rank * rows:(rank + 1) * rows,
                                        :]), (rank, i)
        total += out[-1]
    np.testing.assert_allclose(total.numpy(), whole[-1].numpy(),
                               rtol=BAND_NORM_RTOL)


# ---------------------------------------------------------------------------
# the sharded routes on gloo ranks
# ---------------------------------------------------------------------------

# (kind, shards, residual_iter, iterations): tests/test_spatial_fused.py's
ROUTES = [("rof", 4, 5, 61), ("rof", 2, 10, 61), ("ml", 4, 3, 31),
          ("ml", 2, 5, 31), ("vol", 4, 5, 31), ("vol", 2, 10, 31)]
HANDOVER = ("rof", 2, 10, 31, 61)  # JAX to 31, the port on to 61
PDHG_ITERS = 150


def _jopts(**kw):
    kw.setdefault("verbose", False)
    for k in ("tol_rel_primal", "tol_rel_dual", "tol_abs_primal",
              "tol_abs_dual"):
        kw.setdefault(k, 0.0)
    return pt.SolverOptions(**kw)


def _jax_problem(kind):
    if kind == "rof":
        f = np.random.RandomState(5).rand(64 * 32).astype(np.float32)
        return jrof_problem(64, 32, f, 12.0)
    if kind == "ml":
        return jml_problem(32, 16, 3, lmb=0.4, seed=8)[0]
    f = np.random.RandomState(23).rand(3 * 64 * 16).astype(np.float32)
    return jvol_problem(3, 64, 16, f, 6.0)


@functools.lru_cache(maxsize=None)
def _jax_route(kind, shards, ri, iters):
    """The JAX sharded route's state after ``iters`` iterations, numpy."""
    cls = {"rof": JShardedROF, "ml": JShardedML, "vol": JShardedVol}[kind]
    popts = JOptions(stepsize="boyd", residual_iter=ri,
                     scale_steps_operator=False)
    b = cls(_jax_problem(kind), popts, _jopts(),
            jmake_mesh((shards,), axis_names=("sp",)), interpret=True)
    s = b.run(b.initial_state(), iters)
    return {k: np.asarray(v) for k, v in vars(s).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job of the module on 2 and on 4 gloo ranks: {shards: [the
    results of each rank]}."""
    kind, shards, ri, mid, end = HANDOVER
    start = _jax_route(kind, shards, ri, mid)
    out = {}
    for world in (2, 4):
        jobs = {f"{k}-{ri}": ("route", dict(kind=k, ri=ri, iters=it))
                for k, s, ri, it in ROUTES if s == world}
        jobs["pdhg"] = ("sharded_pdhg", dict(iters=PDHG_ITERS))
        if world == 4:
            jobs["solve"] = ("solve", {})
            jobs["geometry"] = ("geometry", {})
        else:
            jobs["handover"] = ("route", dict(kind=kind, ri=ri, iters=end,
                                              start=start))
        init = tmp_path_factory.mktemp(f"pg{world}") / "pg"
        out[world] = worker.run_ranks(world, jobs, str(init))
    return out


def _close_state(port, ref):
    np.testing.assert_allclose(port["x"], ref["x"], atol=RUN_ATOL)
    np.testing.assert_allclose(port["y"], ref["y"], atol=RUN_ATOL)
    np.testing.assert_allclose(port["tau"], ref["tau"], rtol=TAU_RTOL)
    for k in ("primal_residual", "dual_residual"):
        np.testing.assert_allclose(port[k], ref[k], rtol=RES_RTOL)


@pytest.mark.parametrize("kind,shards,ri,iters", ROUTES)
def test_sharded_route_matches_jax(ranks, kind, shards, ri, iters):
    """ShardedFusedROF / Multilabel / Vol on gloo ranks against the JAX
    sharded routes on the same problems; every rank gathers the same
    state."""
    res = [r[f"{kind}-{ri}"] for r in ranks[shards]]
    ref = _jax_route(kind, shards, ri, iters)
    assert int(res[0]["state"]["iteration"]) == int(ref["iteration"]) == iters
    _close_state(res[0]["state"], ref)
    for r in res[1:]:
        for k, v in res[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def test_jax_state_continues_on_sharded_route(ranks):
    """A JAX ShardedFusedROF state after 31 iterations, handed to the
    port's ranks (``interop.sharded_pdhg_state_from_numpy``), goes on to
    the JAX run's state at 61."""
    kind, shards, ri, _, end = HANDOVER
    port = ranks[shards][0]["handover"]["state"]
    assert int(port["iteration"]) == end
    _close_state(port, _jax_route(kind, shards, ri, end))


# per chunk and rank: two messages of H rows of each exchanged plane with
# each neighbour (one at an edge), one all-reduce of the 4 squared norms;
# the data planes f (and w) are cut from the whole problem every rank holds
EXCHANGED_PLANES = {"rof": 3,          # x, q_x, q_y
                    "ml": 3 * 3 + 1,   # u (L), q (2L), s; L = 3
                    "vol": 4 * 3}      # u (L), q (3L); L = 3
NY_OF = {"rof": 32, "ml": 16, "vol": 16}


@pytest.mark.parametrize("kind", ["rof", "ml", "vol"])
def test_comm_volume_per_chunk(ranks, kind):
    ri = next(r for k, s, r, _ in ROUTES if k == kind and s == 4)
    res = [r[f"{kind}-{ri}"] for r in ranks[4]]
    halo = res[0]["halo"]
    assert halo == 2 * ri + 2
    per_neighbour = EXCHANGED_PLANES[kind] * halo * NY_OF[kind] * 4
    for rank, r in enumerate(res):
        c = r["counts"]
        chunks = c["exchanges"]
        assert chunks > 0 and c["all_reduces"] == chunks
        assert c["reduced_bytes"] == chunks * 4 * 4
        neighbours = 1 if rank in (0, 3) else 2
        assert c["sent_bytes"] == chunks * neighbours * per_neighbour
        assert c["received_bytes"] == c["sent_bytes"]


@functools.lru_cache(maxsize=None)
def _jax_sharded_pdhg():
    f = np.random.RandomState(2).rand(256).astype(np.float32)
    b = JShardedPDHG(jrof_problem(16, 16, f, 5.0),
                     JOptions(scale_steps_operator=False),
                     _jopts(tol_rel_primal=1e-6, tol_rel_dual=1e-6,
                            tol_abs_primal=1e-6, tol_abs_dual=1e-6),
                     mesh=jmake_mesh((1, 8), axis_names=("dp", "sp")))
    s = b.run(b.initial_state(), PDHG_ITERS)
    return {k: np.asarray(v) for k, v in vars(s).items()}


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_pdhg_matches_jax(ranks, shards):
    """ShardedPDHG (DTensor vectors, Shard(0)) against the JAX package's
    ShardedPDHG (tests/test_parallel.py's problem and bar)."""
    res = ranks[shards][0]["pdhg"]
    assert res["placements"] == "(Shard(dim=0),)"
    assert res["local"] == 256 // shards
    ref = _jax_sharded_pdhg()
    assert int(res["state"]["iteration"]) == int(ref["iteration"])
    for k in ("x", "y"):
        np.testing.assert_allclose(res["state"][k], ref[k], atol=PDHG_ATOL)


def test_sharded_full_solve_converges(ranks):
    """The Solver with ShardedFusedROF on 4 ranks converges
    (tests/test_spatial_fused.py's solve), where the one-process fused
    route does, to its solution."""
    res = ranks[4][0]["solve"]
    assert res["result"] == res["one_result"] == "converged"
    assert abs(res["iterations"] - res["one_iterations"]) <= 30
    np.testing.assert_allclose(res["x"], res["one_x"], atol=1e-3)


def test_sharded_geometry_errors(ranks):
    """The halo routes refuse shards lower than the halo and row counts
    that do not divide; make_mesh refuses shapes beyond the group and a
    card mesh on a gloo group (tests/test_spatial_fused.py:181-195)."""
    g = ranks[4][0]["geometry"]
    assert "shard height 6 < halo 22" in g["halo"]
    assert g["ok"] is None
    assert "nx=30 not divisible by 4" in g["divisible"]
    assert g["too_many"].startswith("ValueError: mesh shape (5,) needs 5")
    assert "'nccl' backend" in g["backend"]


def test_make_mesh_needs_a_group_and_a_device(monkeypatch):
    """Without a process group make_mesh raises; without a card and
    without set_device("cpu") it raises where the package's device is
    read, as every entry point of the port does."""
    with pytest.raises(ptt.ProstError, match="process group"):
        make_mesh((1,), axis_names=("sp",))
    from prost_tpu_torch import config

    monkeypatch.setattr(config, "_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ptt.ProstError, match="No CUDA card"):
        make_mesh((1,), axis_names=("sp",))
