"""Slice 8b, the convolutional and tight routes of spatial sharding: the
halo modes of the deblur and tight chunks (rows 17 and 20 of the kernel
table) and ``ShardedFusedDeblur`` and ``ShardedFusedTight``, against the
JAX package.

The JAX side runs as tests/test_spatial_fused.py runs it: 8 virtual CPU
devices (conftest.py), the Pallas kernels in interpret mode.  The port's
ranks are gloo processes started by ``torch_spatial_worker.run_ranks``,
two groups of 2 and 4 ranks for the whole module.  Tolerances: the halo
chunks' owned rows 2e-5 times max(1, |plane|max) and their norms 1e-4
relative with a floor of 1e-4 of the largest norm against the JAX kernels
(tests/test_torch_deblur.py's and tests/test_torch_tight.py's bars: f32,
the same operations in another order; the deblur route's dual variable
norm is rounding noise); the bands' owned rows bit-equal to the
whole-plane plain chunk and their norms within 1e-6; the routes the JAX
sharded tests' bars (x and y 2e-5, tau 1e-6 relative, residuals 1e-3
relative).
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
from prost_tpu.ops import fused_deblur as jd
from prost_tpu.ops import fused_tight as jt
from prost_tpu.parallel import ShardedFusedDeblur as JShardedDeblur
from prost_tpu.parallel import ShardedFusedTight as JShardedTight
from prost_tpu.parallel import make_mesh as jmake_mesh
from prost_tpu_torch.ops import fused_deblur as td
from prost_tpu_torch.ops import fused_tight as tt
from prost_tpu_torch.parallel.spatial_fused import window
from test_fused_deblur import deblur_problem as jdeblur_problem
from test_fused_tight import tight_problem as jtight_problem

PLANE_ATOL, NORM_RTOL = 2e-5, 1e-4
BAND_NORM_RTOL = 1e-6
RUN_ATOL, TAU_RTOL, RES_RTOL = 2e-5, 1e-6, 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


# ---------------------------------------------------------------------------
# the halo chunks (rows 17 and 20 of the kernel table)
# ---------------------------------------------------------------------------

# deblur: a 4x3 blur of row reach 3 on the (96, 22) grid of a 93x20 image,
# H = (2 * 2 + 2) * 3 = 18; tight: L = 3 on 48x20, H = 2 * 3 + 2 = 8
DEBLUR_TAPS = ((0, 0, 0.1), (1, 2, 0.3), (2, 1, 0.25), (2, 2, 0.2),
               (3, 0, 0.15))
NX, NY, NX2, NY2, DEBLUR_RI = 93, 20, 96, 22, 2
SIG_Q, TAU_T = 0.5, 0.2
NXG, L, TIGHT_RI = 48, 3, 3
HALO = {"deblur": jd.deblur_halo_rows(DEBLUR_RI, DEBLUR_TAPS),
        "tight": 2 * TIGHT_RI + 2}
GRID_ROWS = {"deblur": NX2, "tight": NXG}
HEAD = {"deblur": [0.9, 1.1, 1.0, 20.0, 1.0],
        "tight": [0.9, 1.1, 1.0, 0.8, 1.0]}
N_STATE = {"deblur": 3, "tight": 5}
# (shards, rank): top edge, interior, bottom edge, the whole plane
BLOCKS = {"top": (4, 0), "interior": (4, 1), "bottom": (4, 3), "S1": (1, 0)}


@functools.lru_cache(maxsize=None)
def _tight_consts():
    m = jt.match_tight_structure(jtight_problem(8, 8, L=L, lmb=1.0))
    return m["taps"], m["consts"]


def _planes(kind, seed):
    """Random global planes of ``kind``, in the port's layout: deblur (x,
    yv, q, fb, sv), tight (u, v, q, p, s, f)."""
    rng = np.random.RandomState(seed)
    if kind == "deblur":
        out = (rng.rand(NX, NY), 0.3 * rng.randn(NX2, NY2),
               0.3 * rng.randn(2, NX, NY), rng.rand(NX2, NY2),
               0.5 + rng.rand(NX2, NY2))
    else:
        k = L * (L - 1) // 2
        out = (rng.rand(L, NXG, NY), 0.2 * rng.randn(2 * k, NXG, NY),
               0.3 * rng.randn(2 * L, NXG, NY), 0.3 * rng.randn(2 * k, NXG, NY),
               0.1 * rng.randn(NXG, NY), rng.rand(L, NXG, NY))
    return [torch.from_numpy(a.astype(np.float32)) for a in out]


def _block(planes, kind, shards, rank):
    """The halo-extended block of ``rank`` of ``shards`` (zeros beyond the
    planes) and its scal8."""
    H, rows = HALO[kind], GRID_ROWS[kind] // shards
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor(HEAD[kind] + [lo, H, H + rows], dtype=torch.float32)
    return ext, scal, rows


def _port_halo(kind, ext, scal):
    if kind == "deblur":
        return td.deblur_chunk_halo(*ext, scal, DEBLUR_RI, NX, DEBLUR_TAPS,
                                    SIG_Q, TAU_T)
    taps, consts = _tight_consts()
    return tt.tight_chunk_halo(*ext, scal, TIGHT_RI, NXG, taps, consts)


def _plain_band(kind, ext, scal):
    if kind == "deblur":
        return td.deblur_chunk_plain(*ext, scal, DEBLUR_RI, DEBLUR_TAPS,
                                     SIG_Q, TAU_T, NX)
    taps, consts = _tight_consts()
    return tt.tight_chunk_halo_plain(*ext, scal, TIGHT_RI, NXG, taps, consts)


def _whole_plane(kind, planes):
    scal = torch.tensor(HEAD[kind], dtype=torch.float32)
    if kind == "deblur":
        return td.deblur_chunk_plain(*planes, scal, DEBLUR_RI, DEBLUR_TAPS,
                                     SIG_Q, TAU_T)
    taps, consts = _tight_consts()
    return tt.tight_chunk_plain(*planes, scal, TIGHT_RI, taps, consts)


@functools.lru_cache(maxsize=None)
def _jax_halo(kind):
    if kind == "deblur":
        return jax.jit(lambda *a: jd.deblur_fused_chunk_halo(
            *a, DEBLUR_RI, NX, NY, DEBLUR_TAPS, SIG_Q, TAU_T,
            interpret=True))
    taps, consts = _tight_consts()
    return jax.jit(lambda *a: jt.tight_fused_chunk_halo(
        *a, TIGHT_RI, NXG, taps, consts, interpret=True))


def _jax_outputs(kind, ext, scal):
    """The JAX halo kernel on the same block, in the port's layout (the
    deblur kernel's x and q embedded in the yv grid, cropped back)."""
    if kind == "deblur":
        rows = ext[0].shape[0]
        args = [td.embed(a, rows, NY2) for a in ext]
        x2, yv2, q2, xp, yvp, qp, n2 = _jax_halo(kind)(
            *[jnp.asarray(a.numpy()) for a in args],
            jnp.asarray(scal.numpy()))
        crop = (..., slice(0, NY))
        return [np.asarray(a)[crop] if i in (0, 2, 3, 5) else np.asarray(a)
                for i, a in enumerate((x2, yv2, q2, xp, yvp, qp))] + [
                    np.asarray(n2)]
    new, prev, n2 = _jax_halo(kind)(*[jnp.asarray(a.numpy()) for a in ext],
                                    jnp.asarray(scal.numpy()))
    return [np.asarray(a) for a in (*new, *prev, n2)]


def _owned(a, rows, H):
    return np.asarray(a)[..., H:H + rows, :]


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("kind", ["deblur", "tight"])
def test_halo_chunk_matches_jax_kernel(kind, block):
    """Each plain halo version against the JAX halo kernel on the same
    extended block and scal8: owned rows and owned-row norms."""
    shards, rank = BLOCKS[block]
    ext, scal, rows = _block(_planes(kind, 3), kind, shards, rank)
    out = _port_halo(kind, ext, scal)
    ref = _jax_outputs(kind, ext, scal)
    H, n = HALO[kind], 2 * N_STATE[kind]
    for i in range(n):
        want = _owned(ref[i], rows, H)
        np.testing.assert_allclose(
            _owned(out[i], rows, H), want,
            atol=PLANE_ATOL * max(1.0, float(np.abs(want).max())),
            err_msg=f"plane {i}")
    norms, want = out[-1].numpy(), ref[-1]
    np.testing.assert_allclose(norms, want, rtol=NORM_RTOL,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kind", ["deblur", "tight"])
def test_bands_compose_the_whole_plane(kind, shards):
    """The owned rows of every band equal the whole-plane plain chunk's
    rows, bit for bit (the deblur x and q at the grid rows the image has),
    and the bands' owned-row norms sum to its norms."""
    planes = _planes(kind, 5)
    whole = _whole_plane(kind, planes)
    H, n = HALO[kind], 2 * N_STATE[kind]
    total = torch.zeros(4)
    for rank in range(shards):
        ext, scal, rows = _block(planes, kind, shards, rank)
        out = _plain_band(kind, ext, scal)
        lo = rank * rows
        for i in range(n):
            assert torch.equal(out[i][..., H:H + rows, :],
                               window(whole[i], lo, lo + rows)), (rank, i)
        total += out[-1]
    np.testing.assert_allclose(total.numpy(), whole[-1].numpy(),
                               rtol=BAND_NORM_RTOL,
                               atol=1e-9 * float(whole[-1].abs().max()))


IN_PLACE = {"deblur": td.deblur_chunk_halo_, "tight": tt.tight_chunk_halo_}


@pytest.mark.parametrize("kind", ["deblur", "tight"])
def test_in_place_halo_chunk_is_the_functional_one(kind):
    """The in-place form the sharded routes call leaves the functional
    wrapper's outputs in the caller's buffers; with the converged flag set
    it leaves every buffer, the previous iterate included, as it was."""
    ext, scal, _ = _block(_planes(kind, 6), kind, *BLOCKS["interior"])
    k = N_STATE[kind]
    state, data = ext[:k], ext[k:]
    want = _port_halo(kind, ext, scal)
    if kind == "deblur":
        tail = (DEBLUR_RI, NX, DEBLUR_TAPS, SIG_Q, TAU_T)
    else:
        tail = (TIGHT_RI, NXG, *_tight_consts())
    cur = [t.clone() for t in state]
    prev = [torch.full_like(t, 7.0) for t in state]
    norms2 = IN_PLACE[kind](*cur, *prev, *data, scal, *tail)
    for a, b in zip(cur + prev + [norms2], want):
        assert torch.equal(a, b)
    before = [t.clone() for t in cur + prev]
    held = torch.cat([scal, torch.ones(1)])
    norms2 = IN_PLACE[kind](*cur, *prev, *data, held, *tail)
    assert not norms2.any()
    for a, b in zip(cur + prev, before):
        assert torch.equal(a, b)


def test_deblur_halo_chunk_refuses_rows_that_differ():
    """A deblur band cuts x and yv at the same rows of the yv grid."""
    ext, scal, _ = _block(_planes("deblur", 7), "deblur", *BLOCKS["top"])
    with pytest.raises(ptt.ProstError, match="same rows"):
        td.deblur_chunk_halo(ext[0][:-1], *ext[1:], scal, DEBLUR_RI, NX,
                             DEBLUR_TAPS, SIG_Q, TAU_T)


# ---------------------------------------------------------------------------
# the sharded routes on gloo ranks
# ---------------------------------------------------------------------------

# (kind, shards, residual_iter, iterations); deblur on a blur of row reach
# 2 (tests/test_spatial_fused.py:263-282), H = 12 at ri 2
ROUTES = [("deblur", 2, 2, 21), ("deblur", 4, 2, 21), ("tight", 2, 5, 31),
          ("tight", 4, 3, 31)]
ERRORS = {
    "deblur_alg2": "ShardedFusedDeblur: alg2 changes the step sizes",
    "tight_reference": "ShardedFusedTight: the fused chunk kernels compute "
                       "consistent-mode residual norms",
    "deblur_divisible": "ShardedFusedDeblur: nx2=130 not divisible by 4 "
                        "shards",
    "deblur_halo": "ShardedFusedDeblur: shard height 32 < halo 44 (= "
                   "(2*residual_iter + 2) * conv row reach)",
    "tight_halo": "ShardedFusedTight: shard height 16 < halo 22",
    "tight_divisible": "ShardedFusedTight: nx=30 not divisible by 4 shards",
}


def _jopts(**kw):
    kw.setdefault("verbose", False)
    for k in ("tol_rel_primal", "tol_rel_dual", "tol_abs_primal",
              "tol_abs_dual"):
        kw.setdefault(k, 0.0)
    return pt.SolverOptions(**kw)


def _jax_problem(kind):
    if kind == "deblur":
        return jdeblur_problem(126, 12, lmb=25.0, seed=4, k=3)[0]
    return jtight_problem(64, 12, L=3, lmb=0.6, seed=9)


@functools.lru_cache(maxsize=None)
def _jax_route(kind, shards, ri, iters):
    """The JAX sharded route's state after ``iters`` iterations, numpy."""
    cls = {"deblur": JShardedDeblur, "tight": JShardedTight}[kind]
    b = cls(_jax_problem(kind), JOptions(stepsize="boyd", residual_iter=ri,
                                         scale_steps_operator=False),
            _jopts(), jmake_mesh((shards,), axis_names=("sp",)),
            interpret=True)
    s = b.run(b.initial_state(), iters)
    return {k: np.asarray(v) for k, v in vars(s).items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job of the module on 2 and on 4 gloo ranks: {shards: [the
    results of each rank]}."""
    out = {}
    for world in (2, 4):
        jobs = {f"{k}-{ri}": ("route", dict(kind=k, ri=ri, iters=it))
                for k, s, ri, it in ROUTES if s == world}
        if world == 4:
            jobs["errors"] = ("errors_8b", {})
        init = tmp_path_factory.mktemp(f"pg{world}") / "pg"
        out[world] = worker.run_ranks(world, jobs, str(init))
    return out


@pytest.mark.parametrize("kind,shards,ri,iters", ROUTES)
def test_sharded_route_matches_jax(ranks, kind, shards, ri, iters):
    """ShardedFusedDeblur / Tight on gloo ranks against the JAX sharded
    routes on the same problems; every rank gathers the same state."""
    res = [r[f"{kind}-{ri}"] for r in ranks[shards]]
    ref = _jax_route(kind, shards, ri, iters)
    port = res[0]["state"]
    assert int(port["iteration"]) == int(ref["iteration"]) == iters
    np.testing.assert_allclose(port["x"], ref["x"], atol=RUN_ATOL)
    np.testing.assert_allclose(port["y"], ref["y"], atol=RUN_ATOL)
    np.testing.assert_allclose(port["tau"], ref["tau"], rtol=TAU_RTOL)
    for k in ("primal_residual", "dual_residual"):
        np.testing.assert_allclose(port[k], ref[k], rtol=RES_RTOL)
    for r in res[1:]:
        for k, v in port.items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["deblur", "tight"])
def test_comm_volume_per_chunk(ranks, kind):
    """Per chunk and rank: two messages of H rows of each exchanged plane
    with each neighbour (one at an edge) and one all-reduce of the 4
    squared norms.  Deblur: x (ny), yv (ny2) and q (2 ny) columns, bx and
    g recomputed by the chunk, fb and sv cut once; tight: u, v, q, p and s,
    3L + 4k + 1 planes of ny columns, f cut once."""
    ri = next(r for k, s, r, _ in ROUTES if k == kind and s == 4)
    res = [r[f"{kind}-{ri}"] for r in ranks[4]]
    halo = res[0]["halo"]
    if kind == "deblur":
        assert halo == (2 * ri + 2) * 2  # the blur's row reach is 2
        columns = 12 + 14 + 2 * 12
    else:
        assert halo == 2 * ri + 2
        columns = (3 * 3 + 4 * 3 + 1) * 12
    per_neighbour = halo * columns * 4
    for rank, r in enumerate(res):
        c = r["counts"]
        chunks = c["exchanges"]
        assert chunks > 0 and c["all_reduces"] == chunks
        assert c["reduced_bytes"] == chunks * 4 * 4
        neighbours = 1 if rank in (0, 3) else 2
        assert c["sent_bytes"] == chunks * neighbours * per_neighbour
        assert c["received_bytes"] == c["sent_bytes"]


@pytest.mark.parametrize("case", list(ERRORS))
def test_sharded_route_refuses(ranks, case):
    """alg2, reference residuals, a grid that does not divide and shards
    lower than the halo (tests/test_spatial_fused.py:181-195)."""
    got = ranks[4][0]["errors"][case]
    assert got is not None and ERRORS[case] in got, got
