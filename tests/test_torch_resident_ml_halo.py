"""The grid-resident multilabel multichunk (row 13, ``ml_multichunk_``:
every chunk of the launch, with the adaptation between them, in one
launch) and the ROF halo chunk on the grid-resident ROF body (row 3,
``rof_chunk_halo_``), as far as the CPU can check them: the shape rules
and the bytes they count; the in-place forms and the routes' light calls
(``MLMultichunk``, ``ROFChunk`` with a band) against the functional
wrappers (bit for bit: on the CPU every form runs the same plain version)
and against the JAX kernels in interpret mode (f32, at the tolerances of
tests/test_torch_fused_multilabel.py and tests/test_torch_spatial.py);
the multilabel route, whose multichunks now update the run's own vectors
in place, against the JAX fused route across several ``run`` calls; and
``ShardedFusedROF`` on gloo ranks, whose chunks now go through
``ROFChunk``, against the JAX sharded route.

The kernels themselves are held against the launch sequences on the card
by tests/test_torch_cuda_redesign.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
import test_torch_fused_multilabel as tfml
import test_torch_resident_multi as trm
import test_torch_spatial as tsp
import torch_spatial_worker as worker
from prost_tpu.ops import fused_multilabel as jml
from prost_tpu_torch.ops import fused_multilabel as tml
from prost_tpu_torch.ops import fused_rof as tfr

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into (no resident kernel holds static shared memory)
H100_SMS, H100_SMEM = 132, 232448


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the shape rules
# ---------------------------------------------------------------------------

# (L, nx, ny, SMs, resident?): config 3's 256x256x8, the ragged 250x190x5
# of chip_smoke's kernel checks, 512x512x8 (the route at the JAX package's
# banded size), 9 labels (beyond the labels held in registers), and
# 256x256x8 on half the SMs
ML_MULTI_RULE = [(8, 256, 256, H100_SMS, True),
                 (5, 250, 190, H100_SMS, True),
                 (8, 512, 512, H100_SMS, False),
                 (9, 16, 16, H100_SMS, False),
                 (8, 256, 256, 66, False)]


@pytest.mark.parametrize("L,nx,ny,sms,want", ML_MULTI_RULE)
def test_ml_multichunk_shape_rule(L, nx, ny, sms, want):
    assert tml.resident_ok(L, nx, ny, sms, H100_SMEM, multi=True) is want


def test_ml_multichunk_bytes_count_the_layout():
    """csrc's layout by hand: at 256x256x8 over 132 blocks (bands of 2
    rows) the chunk's MLRes (u and q_x 3 rows, q_y, g_x, g_y and f 2 rows
    of 8 planes, s and su 2 rows, 118784 bytes) and w_hat's window of its
    own (2 rows of 8 planes, 16384 bytes; f is read again in the next
    chunk); a window smaller than the 2048 floats of the reductions'
    array, which borrows it, counts as that array."""
    assert tml.resident_bytes(8, 256, 256, 132) == 118784
    assert tml.resident_bytes(8, 256, 256, 132, multi=True) == \
        118784 + 16384 == 135168
    assert tml.resident_bytes(8, 512, 512, 132, multi=True) == \
        4 * ((2 * 8 * 5 + 4 * 8 * 4 + 2 * 4) * 512 + 8 * 4 * 512) \
        > H100_SMEM
    # L = 1, 40 wide, bands of 1 row: a 40-float w_hat window
    assert tml.resident_bytes(1, 9, 40, 132, multi=True) == \
        4 * ((2 * 2 + 4 + 2) * 40 + 2048)


# (rows of the band, ny, data term, resident?): config 1's 512x512 cut
# into 1, 2 and 4 bands (halo 22 rows above and below each), the one-shard
# band with wsquare's weights, and the one-shard band of a 2048-wide plane
ROF_HALO_RULE = [(556, 512, "square", True), (300, 512, "square", True),
                 (172, 512, "abs", True), (556, 512, "wsquare", True),
                 (2092, 2048, "square", False)]


@pytest.mark.parametrize("nxb,ny,dataterm,want", ROF_HALO_RULE)
def test_rof_halo_band_shape_rule(nxb, ny, dataterm, want):
    assert tfr.resident_ok(nxb, ny, dataterm, H100_SMS, H100_SMEM) is want


def test_rof_halo_band_bytes_count_the_layout():
    """The one-shard band of 556 rows over 132 blocks: bands of 5 rows, x,
    q_y and f 6 rows, q_x 7, g_x and g_y 5 (35 rows of 512, 71680 bytes);
    wsquare's weights 6 rows more."""
    assert tfr.resident_bytes(556, 512, 132) == 35 * 512 * 4 == 71680
    assert tfr.resident_bytes(556, 512, 132, "wsquare") == 41 * 512 * 4


# ---------------------------------------------------------------------------
# row 13: the in-place multichunk and its light call
# ---------------------------------------------------------------------------

RI = 5


def _ml_mc_close(t_out, j_out):
    """Planes within the multilabel tolerances, norms within NORM_RTOL,
    sout's converged flag and chunk count exactly."""
    tfml._close(t_out, j_out)
    assert t_out[7][5:].tolist() == np.asarray(j_out[7])[5:7].tolist()


@pytest.mark.parametrize("tol", [0.0, 2e-2])
@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
def test_ml_multichunk_inplace_is_the_functional_and_jax(stepsize, tol):
    """``ml_multichunk_`` from a solve's start (u = q = s = 0; ri 5, 8
    chunks) leaves the functional wrapper's planes and previous iterates in
    the caller's buffers and returns its norms and sout, bit for bit; both
    are the JAX kernel's (interpret mode) within the multilabel
    tolerances.  At tolerance 0 every chunk runs; at 2e-2 both rules adapt
    and the launch converges partway."""
    u, q, s, f = map(torch.from_numpy, tfml._inputs(7, start=True))
    scal = torch.from_numpy(tfml._scal13(tol))
    args = (f, scal, RI, 8, stepsize, tfml._consts())
    want = tml.ml_multichunk(u, q, s, *args)
    cur = [u.clone(), q.clone(), s.clone()]
    prev = [torch.full_like(t, np.nan) for t in cur]
    norms, sout = tml.ml_multichunk_(*cur, *prev, *args)
    _equal(cur + prev + [norms, sout], want)
    if tol:
        assert float(sout[5]) == 1.0 and 1 < float(sout[6]) < 8
    else:
        assert sout[5:].tolist() == [0.0, 8.0]
    ref = jml.ml_fused_multichunk(
        *[jnp.asarray(t.numpy()) for t in (u, q, s, f, scal)], RI, 8,
        stepsize, tfml._consts(), interpret=True)
    _ml_mc_close(tuple(cur + prev + [norms, sout]), ref)


def test_ml_multichunk_inplace_with_the_flag_changes_nothing():
    u, q, s, f = map(torch.from_numpy, tfml._inputs(81))
    cur = [u.clone(), q.clone(), s.clone()]
    prev = [t - 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    scal = torch.cat([torch.from_numpy(tfml._scal13(1e-3)), torch.ones(1)])
    norms, sout = tml.ml_multichunk_(*cur, *prev, f, scal, RI, 8, "boyd",
                                     tfml._consts())
    _equal(cur + prev, before)
    assert not norms.any() and sout[5:].tolist() == [1.0, 0.0]


def test_ml_multichunk_inplace_refuses_bad_paths_and_buffers():
    u, q, s, f = map(torch.from_numpy, tfml._inputs(82))
    args = (f, torch.from_numpy(tfml._scal13(0.0)), 2, 2, "boyd",
            tfml._consts())
    prev = (u.clone(), q.clone(), s.clone())
    with pytest.raises(ptt.ProstError, match="path must be"):
        tml.ml_multichunk_(u, q, s, *prev, *args, path="cluster")
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        tml.ml_multichunk_(u, q, s, u.clone(), q[:2].clone(), s.clone(),
                           *args)
    strided = s.t().contiguous().t()
    with pytest.raises(ptt.ProstError, match="contiguous"):
        tml.ml_multichunk_(u, q, strided, *prev, *args)
    with pytest.raises(ptt.ProstError, match="stepsize"):
        tml.ml_multichunk_(u, q, s, *prev, *args[:4], "alg2", args[5])


def _ml_route_match():
    """The parts of the ml route's match that ``MLMultichunk`` reads."""
    m = tml.match_multilabel_structure(
        tfml.ml_problem(ptt, tfml.NX, tfml.NY, tfml.L, seed=83)[0])
    assert m is not None
    m["radius_t"] = torch.tensor(m["radius"])
    m["d_s_t"] = torch.tensor(m["d_s"])
    m["tols_t"] = tuple(torch.tensor(1e-3) for _ in range(4))
    m["adapt_consts"] = tfml._consts()
    return m


@pytest.mark.parametrize("stepsize,converged", [("boyd", False),
                                                ("goldstein", False),
                                                ("boyd", True)])
def test_ml_multichunk_light_call_is_the_inplace_form(stepsize, converged):
    """``MLMultichunk``, made once per route, on the route's planes: the
    same buffers, norms and sout as ``ml_multichunk_`` with the same
    scalars (radius and d_s in slots 3 and 4, the one data plane f),
    twice in a row (its scalar buffer is reused)."""
    m = _ml_route_match()
    call = tml.MLMultichunk(m, RI, 4, stepsize, torch.device("cpu"))
    u, q, s = map(torch.from_numpy, tfml._inputs(84)[:3])
    cur, prev = [u.clone(), q.clone(), s.clone()], [u.clone(), q.clone(),
                                                    s.clone()]
    want_cur = [t.clone() for t in cur]
    want_prev = [t.clone() for t in prev]
    steps = (0.9, 1.1, 1.0, 0.5, 2.0, 3.0)
    for it in (1, 21):
        got = call(cur, prev, *(torch.tensor(v) for v in steps),
                   torch.tensor(it), torch.tensor(converged))
        scal = torch.tensor(list(steps[:3]) + [m["radius"], m["d_s"]]
                            + list(steps[3:]) + [float(it)] + [1e-3] * 4
                            + [float(converged)])
        want = tml.ml_multichunk_(*want_cur, *want_prev, m["f"], scal, RI, 4,
                                  stepsize, m["adapt_consts"])
        _equal(cur + prev + list(got), want_cur + want_prev + list(want))


def test_ml_route_multichunks_across_runs_match_jax():
    """The multilabel route over 190 iterations of boyd with ri 5 in three
    runs, each with a multichunk through ``MLMultichunk`` in place on the
    run's own vectors (and chunks through ``MLChunk``), against the JAX
    fused route's one run in interpret mode."""
    popts = dict(stepsize="boyd", residual_iter=RI,
                 scale_steps_operator=False)
    jb = tfml.JFused(tfml.ml_problem(pt, tfml.NX, tfml.NY, tfml.L,
                                     seed=3)[0], tfml.JOptions(**popts),
                     tfml._sopts(pt, 1e-5), interpret=True)
    tb = tfml.TFused(tfml.ml_problem(ptt, tfml.NX, tfml.NY, tfml.L,
                                     seed=3)[0], tfml.TOptions(**popts),
                     tfml._sopts(ptt, 1e-5))
    js = jb.run(jb.initial_state(), 190)
    ts = trm._split_run(tb, (45, 100, 190))
    assert isinstance(tb.ml["multi"], tml.MLMultichunk)
    assert isinstance(tb.ml["call"], tml.MLChunk)
    assert int(ts.iteration) == 190
    tfml._assert_runs_agree(ts, js)


# ---------------------------------------------------------------------------
# row 3: the halo chunk in place and ROFChunk on a band
# ---------------------------------------------------------------------------

def _rof_band_match(dataterm):
    """The parts of the ROF route's match that ``ROFChunk`` reads."""
    return {"nx": tsp.NXG, "ny": tsp.NY, "lmb": tsp.HEAD["rof"][3],
            "radius": tsp.HEAD["rof"][4], "dataterm": dataterm}


@pytest.mark.parametrize("block", ["top", "interior", "S1"])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_rof_chunk_on_a_band_is_the_halo_inplace_form_and_jax(dataterm,
                                                              block):
    """``ROFChunk`` made with a band's rows and row context, on the band's
    extended planes: the same buffers and squared norms as
    ``rof_chunk_halo_`` with the same scal8, twice in a row (its scalar
    buffer is reused), and the JAX halo kernel's (interpret mode) in the
    owned rows and norms."""
    shards, rank = tsp.BLOCKS[block]
    ext, scal, rows = tsp._block(tsp._planes("rof", 11), "rof", shards,
                                 rank)
    lo = rank * rows - tsp.H
    call = tfr.ROFChunk(_rof_band_match(dataterm), tsp.RI,
                        torch.device("cpu"),
                        (tsp.NXG, rows + 2 * tsp.H, lo, tsp.H,
                         tsp.H + rows))
    cur, prev = [t.clone() for t in ext[:2]], [t.clone() for t in ext[:2]]
    want_cur, want_prev = ([t.clone() for t in ext[:2]] for _ in range(2))
    first = None
    for tau in (0.9, 0.7):
        got = call(cur, prev, *ext[2:], torch.tensor(tau),
                   torch.tensor(1.1), torch.tensor(1.0), torch.tensor(False))
        sc = scal.clone()
        sc[0] = tau
        want = tfr.rof_chunk_halo_(*want_cur, *want_prev, *ext[2:], sc,
                                   tsp.RI, tsp.NXG, dataterm)
        _equal(cur + prev + [got], want_cur + want_prev + [want])
        if first is None:
            first = [t.clone() for t in cur + prev] + [got.clone()]
    ref = tsp._jax_halo("rof", dataterm)(
        *[jnp.asarray(a.numpy()) for a in ext], jnp.asarray(scal.numpy()))
    tsp._close_owned(first, ref, rows, 4)


def test_rof_chunk_on_a_band_with_the_flag_changes_nothing():
    ext, scal, rows = tsp._block(tsp._planes("rof", 12), "rof",
                                 *tsp.BLOCKS["bottom"])
    lo = tsp.BLOCKS["bottom"][1] * rows - tsp.H
    call = tfr.ROFChunk(_rof_band_match("square"), tsp.RI,
                        torch.device("cpu"),
                        (tsp.NXG, rows + 2 * tsp.H, lo, tsp.H,
                         tsp.H + rows))
    cur = [t.clone() for t in ext[:2]]
    prev = [torch.full_like(t, 7.0) for t in cur]
    before = [t.clone() for t in cur + prev]
    got = call(cur, prev, *ext[2:], torch.tensor(0.9), torch.tensor(1.1),
               torch.tensor(1.0), torch.tensor(True))
    _equal(cur + prev, before)
    assert not got.any()


def test_rof_chunk_halo_inplace_refuses_bad_paths():
    ext, scal, _ = tsp._block(tsp._planes("rof", 13), "rof",
                              *tsp.BLOCKS["interior"])
    cur, prev = [t.clone() for t in ext[:2]], [t.clone() for t in ext[:2]]
    with pytest.raises(ptt.ProstError, match="path must be"):
        tfr.rof_chunk_halo_(*cur, *prev, *ext[2:], scal, tsp.RI, tsp.NXG,
                            path="cluster")


# ---------------------------------------------------------------------------
# ShardedFusedROF through ROFChunk on gloo ranks
# ---------------------------------------------------------------------------

SHARDED_ROF = ("rof", 2, 10, 61)  # kind, shards, ri, iterations


@pytest.fixture(scope="module")
def sharded_rof(tmp_path_factory):
    """ShardedFusedROF on the worker's ROF problem (64x32) on 2 gloo ranks,
    ri 10 (halo 22), 61 iterations: per-rank results."""
    kind, world, ri, iters = SHARDED_ROF
    init = tmp_path_factory.mktemp("pg") / "pg"
    return worker.run_ranks(world, {"rof": ("route", dict(
        kind=kind, ri=ri, iters=iters))}, str(init))


def test_sharded_rof_route_goes_through_rofchunk_and_matches_jax(
        sharded_rof):
    """Each rank ran its chunks through ``ROFChunk`` on its band, the
    gathered state is the JAX sharded route's (interpret mode, the same
    problem and shards) within tests/test_torch_spatial.py's bars, and the
    ranks agree bit for bit."""
    res = [r["rof"] for r in sharded_rof]
    assert all(r["light"] == "ROFChunk" for r in res)
    assert int(res[0]["state"]["iteration"]) == SHARDED_ROF[3]
    tsp._close_state(res[0]["state"], tsp._jax_route(*SHARDED_ROF))
    for r in res[1:]:
        for k, v in res[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
