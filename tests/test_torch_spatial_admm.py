"""Slice 8b, Chebyshev ADMM and ensembles over ranks: the halo mode of one
ADMM iteration (row 10 of the kernel table, ``admm_iter_halo``),
``ShardedFusedADMM`` and ``BatchedPDHG`` over a ``dp`` mesh, against the
JAX package.

The JAX side runs as tests/test_spatial_fused.py and tests/test_parallel.py
run it: 8 virtual CPU devices (conftest.py), the Pallas kernels in
interpret mode.  The port's ranks are gloo processes started by
``torch_spatial_worker.run_ranks``, two groups of 2 and 4 ranks for the
whole module.  Tolerances: the halo iteration's owned rows 2e-6 absolute
and its norms 1e-5 relative against the JAX banded kernel (one iteration
in f32, the same operations; the maskless adjoints against the JAX
masked ones on clean duals); the bands' owned rows bit-equal to the
whole-plane plain chunk of one iteration and their norms within 1e-6; the
route 2e-5 on x_half and z_half after 40 iterations, rho 1e-6 relative and
the residuals 1e-3 relative (tests/test_spatial_fused.py's bar is 2e-6
against the one-device JAX run, which takes the same rows in the same
order; the port's sums come in another order); the dp ensembles
tests/test_parallel.py's 1e-6 on x and y, tau 1e-6 relative.
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
from prost_tpu.backend.admm import ADMMOptions as JADMMOptions
from prost_tpu.backend.admm import BackendADMM as JBackendADMM
from prost_tpu.ops import fused_admm as ja
from prost_tpu.parallel import BatchedPDHG as JBatched
from prost_tpu.parallel import ShardedFusedADMM as JShardedADMM
from prost_tpu.parallel import make_mesh as jmake_mesh
from prost_tpu_torch.ops import fused_admm as ta
from prost_tpu_torch.parallel.spatial_fused import window
from test_fused_tight import tight_problem as jtight_problem
from test_parallel import rof_problem as jrof_problem

PLANE_ATOL, NORM_RTOL = 2e-6, 1e-5
BAND_NORM_RTOL = 1e-6
RUN_ATOL, RHO_RTOL, RES_RTOL = 2e-5, 1e-6, 1e-3
ENS_ATOL, TAU_RTOL = 1e-6, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


# ---------------------------------------------------------------------------
# one ADMM iteration on a halo band (row 10 of the kernel table)
# ---------------------------------------------------------------------------

# degree 3: H = ceil8(2 * 3 + 4) = 16; 4 bands of 16 rows (the JAX banded
# kernel takes 8-row multiples only)
NX, NY, DEG, ALPHA = 64, 24, 3, 1.7
H = ta.admm_cheby_halo_rows(DEG)
SCAL = [1.3, 8.0, 1.0]  # rho, lmb, radius
BLOCKS = {"top": (4, 0), "interior": (4, 1), "bottom": (4, 3), "S1": (1, 0)}


def _planes(seed):
    """Random global ADMM planes (xh, xp, xd, zh, zp, zd, warm, f, w), the
    z arrays' dead coordinates zero (as every state the solver produces
    has them)."""
    rng = np.random.RandomState(seed)

    def z():
        a = 0.3 * rng.randn(2, NX, NY)
        a[0, -1, :] = 0.0
        a[1, :, -1] = 0.0
        return a

    out = [rng.rand(NX, NY) for _ in range(3)] + [z(), z(), z()]
    out += [rng.rand(NX, NY), rng.rand(NX, NY), 2.0 * (rng.rand(NX, NY) > .3)]
    return [torch.from_numpy(a.astype(np.float32)) for a in out]


def _block(planes, shards, rank):
    rows = NX // shards
    lo = rank * rows - H
    return [window(a, lo, lo + rows + 2 * H) for a in planes], lo, rows


@functools.lru_cache(maxsize=None)
def _jax_iter(rows, dataterm, with_norms):
    """``admm_banded_iter`` with one band on a block of ``rows`` owned rows,
    the row offset traced (one compile for the blocks of one shape)."""
    return jax.jit(lambda *a: ja.admm_banded_iter(
        *a[:9], *SCAL, 1, DEG, ALPHA, dataterm=dataterm, interpret=True,
        with_norms=with_norms, own_lo=H, out_rows=rows, nx_global=NX,
        row_offset0=a[9]))


# the data term with the weight plane takes the norms, the shrink none
@pytest.mark.parametrize("dataterm,with_norms", [("wsquare", True),
                                                 ("abs", False)])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_admm_iter_halo_matches_jax_banded_iter(block, dataterm,
                                                with_norms):
    """The plain halo iteration against ``admm_banded_iter`` with one band
    on the same extended block (own_lo = H, out_rows, nx_global,
    row_offset0): owned rows and owned-row norms, zeros without norms."""
    shards, rank = BLOCKS[block]
    ext, lo, rows = _block(_planes(3), shards, rank)
    out = ta.admm_iter_halo(*ext, torch.tensor(SCAL), DEG, ALPHA, NX, lo, H,
                            H + rows, dataterm, with_norms)
    ref = _jax_iter(rows, dataterm, with_norms)(
        *[jnp.asarray(a.numpy()) for a in ext], jnp.int32(lo))
    for i in range(7):
        np.testing.assert_allclose(out[i].numpy()[..., H:H + rows, :],
                                   np.asarray(ref[i]), atol=PLANE_ATOL,
                                   err_msg=f"plane {i}")
    np.testing.assert_allclose(out[7].numpy(), np.asarray(ref[7]),
                               rtol=NORM_RTOL, atol=0)
    assert with_norms or not out[7].any()


@pytest.mark.parametrize("shards", [2, 4])
def test_bands_compose_the_whole_plane(shards):
    """The owned rows of every band equal one whole-plane Chebyshev
    iteration (``admm_chunk_plain`` with count 1), bit for bit, and the
    bands' owned-row norms sum to its norms."""
    planes = _planes(5)
    scal = torch.tensor(SCAL)
    whole = ta.admm_chunk_plain(*planes, scal, None, 1, 0, ALPHA, "square",
                                DEG)
    total = torch.zeros(4)
    for rank in range(shards):
        ext, lo, rows = _block(planes, shards, rank)
        out = ta.admm_iter_halo_plain(*ext, scal, DEG, ALPHA, NX, lo, H,
                                      H + rows, "square")
        for i in range(7):
            assert torch.equal(out[i][..., H:H + rows, :],
                               whole[i][..., rank * rows:(rank + 1) * rows,
                                        :]), (rank, i)
        total += out[7]
    np.testing.assert_allclose(total.numpy(), whole[7].numpy(),
                               rtol=BAND_NORM_RTOL)


def test_in_place_halo_iteration_is_the_functional_one():
    """The in-place form the sharded route calls leaves the functional
    wrapper's outputs in the caller's buffers; with the converged flag set
    nothing changes and the norms are zero."""
    ext, lo, rows = _block(_planes(6), *BLOCKS["interior"])
    state, data = ext[:7], ext[7:]
    scal = torch.tensor(SCAL)
    want = ta.admm_iter_halo(*ext, scal, DEG, ALPHA, NX, lo, H, H + rows)
    cur = [t.clone() for t in state]
    norms2 = ta.admm_iter_halo_(*cur, *data, scal, DEG, ALPHA, NX, lo, H,
                                H + rows)
    for a, b in zip(cur + [norms2], want):
        assert torch.equal(a, b)
    before = [t.clone() for t in cur]
    held = torch.cat([scal, torch.ones(1)])
    norms2 = ta.admm_iter_halo_(*cur, *data, held, DEG, ALPHA, NX, lo, H,
                                H + rows)
    assert not norms2.any()
    for a, b in zip(cur, before):
        assert torch.equal(a, b)


def test_halo_iteration_refuses_owned_rows_outside_the_band():
    ext, lo, rows = _block(_planes(7), *BLOCKS["top"])
    with pytest.raises(ptt.ProstError, match="owned rows"):
        ta.admm_iter_halo(*ext, torch.tensor(SCAL), DEG, ALPHA, NX, lo, H,
                          H + rows + 2 * H)


# ---------------------------------------------------------------------------
# ShardedFusedADMM and the dp ensembles on gloo ranks
# ---------------------------------------------------------------------------

ADMM_ITERS, HANDOVER = 40, 20  # the JAX run to 20, the port on to 40
ADMM65_ITERS = 20
ENSEMBLES = {"rof": 31, "tight": 21}  # iterations (tests/test_parallel.py)
ERRORS = {
    "admm_cgls": "ShardedFusedADMM: requires projection='auto' or 'cheby'",
    "admm_halo": "ShardedFusedADMM: shard height 16 < halo 24 (= "
                 "2*cheby_degree + 4, rounded up to 8); lower cheby_degree",
    "admm_divisible": "ShardedFusedADMM: nx=66 not divisible by 4 shards",
    "ensemble_batch": "BatchedPDHG: batch size 3 must be divisible by the "
                      "mesh's 4 devices",
}


def _jopts():
    return pt.SolverOptions(verbose=False, tol_rel_primal=0, tol_rel_dual=0,
                            tol_abs_primal=0, tol_abs_dual=0)


@functools.lru_cache(maxsize=None)
def _jax_admm(shards, iters):
    """The JAX ShardedFusedADMM's state on tests/test_spatial_fused.py's
    problem after ``iters`` iterations, numpy."""
    f = np.random.RandomState(17).rand(128 * 32).astype(np.float32)
    b = JShardedADMM(jrof_problem(128, 32, f, 8.0),
                     JADMMOptions(residual_iter=10, projection="cheby"),
                     _jopts(), jmake_mesh((shards,), axis_names=("sp",)),
                     interpret=True)
    s = b.run(b.initial_state(), iters)
    return {k: np.asarray(v) for k, v in vars(s).items()}


@functools.lru_cache(maxsize=None)
def _jax_ensemble(kind):
    """The JAX BatchedPDHG over a dp mesh of 4 devices, numpy state."""
    if kind == "rof":
        rng = np.random.RandomState(8)
        problems = [jrof_problem(16, 16, rng.rand(256).astype(np.float32),
                                 lmb)
                    for lmb in (4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0)]
    else:
        problems = [jtight_problem(12, 12, L=3, lmb=1.0, seed=i)
                    for i in range(4)]
    b = JBatched(problems, JOptions(stepsize="boyd", residual_iter=5,
                                    scale_steps_operator=False),
                 _jopts(), mesh=jmake_mesh((4,), axis_names=("dp",)),
                 interpret=True)
    assert getattr(b, kind) is not None
    s = b.run(b.initial_state(), ENSEMBLES[kind])
    return ({k: np.asarray(v) for k, v in vars(s).items()},
            [np.asarray(v) for v in b.current_solution(s)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job of the module on 2 and on 4 gloo ranks: {shards: [the
    results of each rank]}."""
    start = _jax_admm(2, HANDOVER)
    out = {}
    for world in (2, 4):
        jobs = {"admm": ("admm_route", dict(iters=ADMM_ITERS))}
        jobs.update({f"ens-{k}": ("ensemble", dict(kind=k, iters=it))
                     for k, it in ENSEMBLES.items()})
        if world == 2:
            jobs["handover"] = ("admm_route", dict(iters=ADMM_ITERS,
                                                   start=start))
        else:
            jobs["errors"] = ("errors_8b", {})
        init = tmp_path_factory.mktemp(f"pg{world}") / "pg"
        out[world] = worker.run_ranks(world, jobs, str(init))
    return out


def _close_admm(port, ref):
    for k in ("x_half", "z_half"):
        np.testing.assert_allclose(port[k], ref[k], atol=RUN_ATOL, err_msg=k)
    np.testing.assert_allclose(port["rho"], ref["rho"], rtol=RHO_RTOL)
    for k in ("primal_residual", "dual_residual"):
        np.testing.assert_allclose(port[k], ref[k], rtol=RES_RTOL, err_msg=k)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_admm_matches_jax(ranks, shards):
    """ShardedFusedADMM on gloo ranks against the JAX ShardedFusedADMM
    (tests/test_spatial_fused.py's problem, 40 iterations of ri 10); every
    rank gathers the same state."""
    res = [r["admm"] for r in ranks[shards]]
    port, ref = res[0]["state"], _jax_admm(shards, ADMM_ITERS)
    assert int(port["iteration"]) == int(ref["iteration"]) == ADMM_ITERS
    _close_admm(port, ref)
    for r in res[1:]:
        for k, v in port.items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def test_jax_admm_state_continues_on_sharded_route(ranks):
    """A JAX ShardedFusedADMM state after 20 iterations, handed to the
    port's ranks (``interop.sharded_admm_state_from_numpy``), goes on to
    the JAX run's state at 40."""
    port = ranks[2][0]["handover"]["state"]
    assert int(port["iteration"]) == ADMM_ITERS
    _close_admm(port, _jax_admm(2, ADMM_ITERS))


def test_admm_comm_volume_per_iteration(ranks):
    """Per iteration and rank: 8 planes (x_half, x_proj, x_dual, z_half
    (2), z_dual (2), cg_warm) of H rows with each neighbour, 2 x 8 x H x
    ny x 4 bytes for an interior rank (tests/test_spatial_fused.py:326's
    pin), and one 4-float all-reduce per chunk of residual_iter
    iterations."""
    res = [r["admm"] for r in ranks[4]]
    halo, ny = res[0]["halo"], 32
    assert halo == 24
    for rank, r in enumerate(res):
        c = r["counts"]
        assert c["exchanges"] == ADMM_ITERS
        neighbours = 1 if rank in (0, 3) else 2
        per_iteration = neighbours * 8 * halo * ny * 4
        assert c["sent_bytes"] == ADMM_ITERS * per_iteration
        assert c["received_bytes"] == c["sent_bytes"]
        assert c["all_reduces"] == ADMM_ITERS // 10
        assert c["reduced_bytes"] == c["all_reduces"] * 4 * 4


@functools.lru_cache(maxsize=None)
def _jax_admm65(iters):
    """The JAX package's Chebyshev ADMM at degree 65 on the worker's
    ``problem("admm65")`` after ``iters`` iterations, numpy: its generic
    step, the iteration its sharded route runs band by band (that route
    takes about 500 s in interpret mode at this degree on a CPU)."""
    f = np.random.RandomState(19).rand(144 * 16).astype(np.float32)
    b = JBackendADMM(jrof_problem(144, 16, f, 8.0),
                     JADMMOptions(residual_iter=10, projection="cheby",
                                  cheby_degree=65), _jopts())
    s = b.run(b.initial_state(), iters)
    return {k: np.asarray(v) for k, v in vars(s).items()}


def test_sharded_admm_runs_chebyshev_degree_65(tmp_path):
    """ShardedFusedADMM takes any Chebyshev degree its constructor accepts,
    as the JAX route does: at degree 65 (above the 64 that the halo
    iteration's launch argument held before its coefficients moved to a
    device array) on one gloo rank of 144 rows, which hold the JAX halo of
    136, its state after 20 iterations matches the JAX ADMM's."""
    res = worker.run_ranks(1, {"admm": ("admm_route", dict(
        iters=ADMM65_ITERS, kind="admm65", degree=65))},
        str(tmp_path / "pg"))[0]["admm"]
    assert res["halo"] == ta.admm_cheby_halo_rows(65) == 136
    assert int(res["state"]["iteration"]) == ADMM65_ITERS
    _close_admm(res["state"], _jax_admm65(ADMM65_ITERS))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kind", list(ENSEMBLES))
def test_dp_ensemble_matches_jax(ranks, kind, shards):
    """BatchedPDHG over a dp mesh of gloo ranks, each rank running its
    B / S instances through the fused route, against the JAX BatchedPDHG
    over a dp mesh (tests/test_parallel.py:160-194, :484-511); the gathered
    state and ``current_solution`` agree on every rank."""
    res = [r[f"ens-{kind}"] for r in ranks[shards]]
    ref, ref_sol = _jax_ensemble(kind)
    B = ref["x"].shape[0]
    for r in res:
        assert r["route"] == kind and r["local"] == B // shards
        assert r["x_shape"][0] == B // shards
    port = res[0]["state"]
    np.testing.assert_array_equal(port["iteration"], ref["iteration"])
    np.testing.assert_array_equal(port["converged"], ref["converged"])
    for k in ("x", "y"):
        np.testing.assert_allclose(port[k], ref[k], atol=ENS_ATOL, err_msg=k)
    np.testing.assert_allclose(port["tau"], ref["tau"], rtol=TAU_RTOL)
    for a, b in zip(res[0]["solution"], ref_sol):
        np.testing.assert_allclose(a, b, atol=5e-5)
    for r in res[1:]:
        for k, v in port.items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def test_dp_ensemble_reduces_one_flag_per_residual_step(ranks):
    """The stop rule's collectives: one flag all-reduce at entry, one per
    chunk and one per residual generic step (iteration % ri == 0) of
    phases A and C; nothing inside a chunk."""
    ri, until = 5, ENSEMBLES["rof"]
    chunks = (until - 1) // ri            # phase A runs iteration 0 alone
    tail = range(1 + chunks * ri, until)  # phase C
    want = 1 + 1 + chunks + sum(it % ri == 0 for it in tail)
    for shards in (2, 4):
        for r in ranks[shards]:
            assert r["ens-rof"]["flag_reduces"] == want


@pytest.mark.parametrize("case", list(ERRORS))
def test_sharded_admm_and_dp_refuse(ranks, case):
    """CGLS, shards lower than the Chebyshev halo, rows that do not divide
    (tests/test_spatial_fused.py:315-323) and a batch that does not split
    evenly (tests/test_parallel.py:196-211)."""
    got = ranks[4][0]["errors"][case]
    assert got is not None and ERRORS[case] in got, got
