"""The grid-resident ADMM chunk (row 8, ``admm_chunk_``: one Chebyshev chunk
in one launch) and the grid-resident volumetric multichunk (row 26,
``vol_multichunk_``: every chunk of the launch, with the adaptation
between them, in one launch), as far as the CPU can check them: the
multichunk's shape rule and the bytes it counts; the in-place forms and
the routes' light calls (``ADMMChunk``, ``VolMultichunk``) against the
functional wrappers (bit for bit: on the CPU every form runs the same plain
version) and against the JAX kernels in interpret mode (f32, at the
tolerances of tests/test_torch_fused_admm.py and tests/test_torch_vol.py);
and ``FusedROFADMM``'s Chebyshev route and the volumetric route, which now
update the run's own state in place in their chunks and multichunks,
against the JAX routes across several ``run`` calls.

The kernels themselves are held against the launch sequences on the card
by tests/test_torch_cuda_redesign.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_admm as jfa
from prost_tpu.ops import fused_vol as jv
from prost_tpu_torch.ops import fused_admm as tfa
from prost_tpu_torch.ops import fused_vol as tv
import test_torch_fused_admm as tfad
import test_torch_resident_multi as trm
import test_torch_vol as ttv

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
# row 26's shape rule
# ---------------------------------------------------------------------------

# (L, nx, ny, data term, SMs, bytes, resident?): vol256x8 (square, abs and
# wsquare), the ragged 190x250x5 and 64x96x1 volumes of chip_smoke's kernel
# checks, 512x512x8 (the route at the JAX package's banded size), 9 labels
# (beyond the unrolled loops), and vol256x8 on half the SMs
VOL_MULTI_RULE = [(8, 256, 256, "square", H100_SMS, H100_SMEM, True),
                  (8, 256, 256, "abs", H100_SMS, H100_SMEM, True),
                  (8, 256, 256, "wsquare", H100_SMS, H100_SMEM, True),
                  (5, 190, 250, "wsquare", H100_SMS, H100_SMEM, True),
                  (1, 64, 96, "square", H100_SMS, H100_SMEM, True),
                  (8, 512, 512, "square", H100_SMS, H100_SMEM, False),
                  (9, 16, 16, "square", H100_SMS, H100_SMEM, False),
                  (8, 256, 256, "square", 66, H100_SMEM, False)]


@pytest.mark.parametrize("L,nx,ny,dataterm,sms,smem,want", VOL_MULTI_RULE)
def test_vol_multichunk_shape_rule(L, nx, ny, dataterm, sms, smem, want):
    assert tv.resident_ok(L, nx, ny, dataterm, sms, smem, multi=True) is want


def test_vol_multichunk_bytes_count_the_layout():
    """csrc's layout by hand: at vol256x8 over 132 blocks (bands of 2
    rows) the chunk's VolRes (u and q_x 3 rows, q_y, q_l, g_x, g_y, g_l and
    f 2 rows of 8 planes, 147456 bytes) and w_hat's window of its own (2
    rows of 8 planes, 16384 bytes; f is read again in the next chunk), and
    with wsquare's weights 16384 more; a window smaller than the 2048
    floats of the reductions' array, which borrows it, counts as that
    array."""
    assert tv.resident_bytes(8, 256, 256, 132) == 147456
    assert tv.resident_bytes(8, 256, 256, 132, multi=True) == \
        147456 + 16384 == 163840
    assert tv.resident_bytes(8, 256, 256, 132, "wsquare", True) == 180224
    assert tv.resident_bytes(8, 512, 512, 132, multi=True) == \
        4 * (2 * 8 * 5 + 6 * 8 * 4 + 8 * 4) * 512 > H100_SMEM
    # L = 1, 40 wide, bands of 1 row: a 40-float w_hat window
    assert tv.resident_bytes(1, 9, 40, 132, multi=True) == \
        4 * ((2 * 2 + 6) * 40 + 2048)


# ---------------------------------------------------------------------------
# row 8: the in-place chunk and its light call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 10])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_admm_chunk_inplace_is_the_functional_and_jax(degree, dataterm):
    """``admm_chunk_`` (ri 7) leaves the functional wrapper's state in the
    caller's arrays and returns its squared norms, bit for bit; both are
    the JAX kernel's (interpret mode) within the fused ADMM file's
    Chebyshev tolerances."""
    planes, f, w = tfad._planes(70 + degree)
    t = [torch.from_numpy(a) for a in planes]
    args = (torch.from_numpy(f), torch.from_numpy(w),
            torch.tensor([1.3, 8.0, 1.0]), None, 7, 10, 1.7, dataterm,
            degree)
    want = tfa.admm_chunk(*t, *args)
    cur = [a.clone() for a in t]
    norms2 = tfa.admm_chunk_(*cur, *args)
    _equal(cur + [norms2], want)
    ref = jfa.admm_fused_chunk(
        *map(jnp.asarray, planes), jnp.asarray(f), jnp.asarray(w),
        jnp.float32(1.3), 8.0, 1.0, jnp.ones(7, jnp.float32), 7, 10, 1.7,
        dataterm=dataterm, interpret=True, cheby_degree=degree)
    tfad._close(tuple(cur) + (norms2,), ref, tfad.PLANE_ATOL[10],
                tfad.NORM_RTOL[10])


def test_admm_chunk_inplace_cgls_is_the_functional():
    """The CGLS chunk in place (the launch sequence on a card) is the
    functional wrapper's, bit for bit."""
    planes, f, w = tfad._planes(73)
    t = [torch.from_numpy(a) for a in planes]
    tols = 1e-3 / torch.arange(1, 4, dtype=torch.float32) ** 1.3
    args = (torch.from_numpy(f), torch.from_numpy(w),
            torch.tensor([1.3, 8.0, 1.0]), tols, 3, 10, 1.7, "square", None)
    want = tfa.admm_chunk(*t, *args)
    cur = [a.clone() for a in t]
    _equal(cur + [tfa.admm_chunk_(*cur, *args)], want)


def test_admm_chunk_inplace_with_the_flag_changes_nothing():
    planes, f, w = tfad._planes(74)
    cur = [torch.from_numpy(a) for a in planes]
    cur[3][0, -1, :] = 1.0  # dirty dead coordinates stay: nothing runs
    before = [a.clone() for a in cur]
    norms2 = tfa.admm_chunk_(*cur, torch.from_numpy(f), torch.from_numpy(w),
                             torch.tensor([1.3, 8.0, 1.0, 1.0]), None, 5, 10,
                             1.7, "square", 10)
    _equal(cur, before)
    assert not norms2.any()


def test_admm_chunk_inplace_refuses_bad_paths_and_buffers():
    planes, f, w = tfad._planes(75)
    cur = [torch.from_numpy(a) for a in planes]
    data = (torch.from_numpy(f), torch.from_numpy(w),
            torch.tensor([1.3, 8.0, 1.0]))
    with pytest.raises(ptt.ProstError, match="path must be"):
        tfa.admm_chunk_(*cur, *data, None, 2, 10, 1.7, "square", 10,
                        path="cluster")
    with pytest.raises(ptt.ProstError, match="CGLS projection runs"):
        tfa.admm_chunk_(*cur, *data, torch.ones(2), 2, 10, 1.7, "square",
                        None, path="resident")
    strided = cur[0].t().contiguous().t()
    with pytest.raises(ptt.ProstError, match="contiguous"):
        tfa.admm_chunk_(strided, *cur[1:], *data, None, 2, 10, 1.7,
                        "square", 10)


@pytest.mark.parametrize("dataterm,converged", [("square", False),
                                                ("wsquare", False),
                                                ("abs", True)])
def test_admm_chunk_light_call_is_the_inplace_form(dataterm, converged):
    """``ADMMChunk``, made once per route, on the route's planes: the same
    arrays and squared norms as ``admm_chunk_`` with the same scalars,
    twice in a row (its scalar buffer is reused)."""
    planes, f, w = tfad._planes(76)
    f_t, w_t = torch.from_numpy(f), torch.from_numpy(w)
    r = trm._Route(f_t, w_t, dataterm, 1e-3).r
    call = tfa.ADMMChunk(r, 5, 1.7, 10, torch.device("cpu"))
    cur = [torch.from_numpy(a) for a in planes]
    want_cur = [a.clone() for a in cur]
    for rho in (1.3, 0.9):
        got = call(cur, torch.tensor(rho), torch.tensor(converged))
        scal = torch.tensor([rho, 16.0, 1.0, float(converged)])
        want = tfa.admm_chunk_(*want_cur, f_t, w_t, scal, None, 5, 10, 1.7,
                               dataterm, 10)
        _equal(cur + [got], want_cur + [want])


# ---------------------------------------------------------------------------
# row 26: the in-place multichunk and its light call
# ---------------------------------------------------------------------------

L, NX, NY, RI = 3, 16, 20, 5


def _scal(tol, conv=None):
    return torch.tensor(ttv._scal13(tol) + ([conv] if conv is not None
                                            else []))


def _vol_mc_close(t_out, j_out):
    """Volumes and previous iterates within PLANE_ATOL, the norms within
    NORM_RTOL, sout (its seven scalars) exactly."""
    ttv._close(t_out, j_out)
    np.testing.assert_array_equal(t_out[5].numpy(), np.asarray(j_out[5])[:7])


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_vol_multichunk_inplace_is_the_functional_and_jax(dataterm,
                                                          stepsize):
    """``vol_multichunk_`` on a 16x20x3 volume from a solve's start (u = f,
    q = 0; ri 5, 8 chunks, tolerance 1e-4: both rules adapt; abs converges
    before the last chunk, the others run every chunk) leaves the functional wrapper's
    volumes and previous iterates in the caller's buffers and returns its
    norms and sout, bit for bit; both are the JAX kernel's (interpret mode)
    within the volumetric tolerances, sout exactly."""
    f, w = (torch.from_numpy(a) for a in ttv._chunk_inputs(80, L, NX, NY)[2:])
    u, q = f.clone(), torch.zeros((3, L, NX, NY))
    consts = ttv._mc_consts(L, NX, NY)
    args = (f, w, _scal(1e-4), RI, 8, dataterm, stepsize, consts)
    want = tv.vol_multichunk(u, q, *args)
    cur = [u.clone(), q.clone()]
    prev = [torch.full_like(t, np.nan) for t in cur]
    norms, sout = tv.vol_multichunk_(*cur, *prev, *args)
    _equal(cur + prev + [norms, sout], want)
    if dataterm == "abs":
        assert float(sout[5]) == 1.0 and 1 < float(sout[6]) < 8
    else:
        assert sout[5:].tolist() == [0.0, 8.0]
    ref = jv.vol_fused_multichunk(
        *[jnp.asarray(t.numpy()) for t in (u, q, f, w)],
        jnp.asarray(ttv._scal13(1e-4), jnp.float32), RI, 8, dataterm,
        stepsize, consts, interpret=True)
    _vol_mc_close(tuple(cur + prev + [norms, sout]), ref)


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
def test_vol_multichunk_inplace_converging_mid_launch(stepsize):
    """From a solve's start at tolerance 1e-2 the launch adapts and
    converges in its fourth chunk of 8: the in-place form's buffers, norms
    and sout are the functional wrapper's, and the JAX kernel's."""
    f = torch.from_numpy(ttv._chunk_inputs(7, L, NX, NY)[2])
    u, q = f.clone(), torch.zeros((3, L, NX, NY))
    consts = ttv._mc_consts(L, NX, NY)
    args = (f, f, _scal(1e-2), RI, 8, "square", stepsize, consts)
    want = tv.vol_multichunk(u, q, *args)
    cur = [u.clone(), q.clone()]
    prev = [t.clone() for t in cur]
    norms, sout = tv.vol_multichunk_(*cur, *prev, *args)
    _equal(cur + prev + [norms, sout], want)
    assert float(sout[5]) == 1.0 and 1 < float(sout[6]) < 8
    ref = jv.vol_fused_multichunk(
        *[jnp.asarray(t.numpy()) for t in (u, q, f, f)],
        jnp.asarray(ttv._scal13(1e-2), jnp.float32), RI, 8, "square",
        stepsize, consts, interpret=True)
    _vol_mc_close(tuple(cur + prev + [norms, sout]), ref)


def test_vol_multichunk_inplace_with_the_flag_changes_nothing():
    u, q, f, w = (torch.from_numpy(a)
                  for a in ttv._chunk_inputs(81, 2, 8, 7))
    cur = [u.clone(), q.clone()]
    prev = [t - 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    norms, sout = tv.vol_multichunk_(*cur, *prev, f, w, _scal(1e-3, 1.0), 5,
                                     8, "square", "boyd",
                                     ttv._mc_consts(2, 8, 7))
    _equal(cur + prev, before)
    assert not norms.any() and sout[5:].tolist() == [1.0, 0.0]


def test_vol_multichunk_inplace_refuses_bad_paths_and_buffers():
    u, q, f, w = (torch.from_numpy(a)
                  for a in ttv._chunk_inputs(82, 2, 8, 7))
    args = (f, w, _scal(0.0), 2, 2, "square", "boyd", ttv._mc_consts(2, 8, 7))
    with pytest.raises(ptt.ProstError, match="path must be"):
        tv.vol_multichunk_(u, q, u.clone(), q.clone(), *args, path="cluster")
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        tv.vol_multichunk_(u, q, u.clone(), q[:2].clone(), *args)
    with pytest.raises(ptt.ProstError, match="stepsize"):
        tv.vol_multichunk_(u, q, u.clone(), q.clone(), *args[:6], "alg2",
                           args[7])


def _vol_route_match(dataterm="square"):
    """The parts of the vol route's match that ``VolMultichunk`` reads."""
    f = np.random.RandomState(83).rand(L * NX * NY)
    m = tv.match_vol_structure(
        ttv.vol_model(ptt, NX, NY, L, f, 6.0)[0].finalize())
    assert m is not None
    m["lmb_t"] = torch.tensor(m["lmb"])
    m["radius_t"] = torch.tensor(m["radius"])
    m["tols_t"] = tuple(torch.tensor(1e-3) for _ in range(4))
    m["adapt_consts"] = ttv._mc_consts(L, NX, NY)
    return m


@pytest.mark.parametrize("stepsize,converged", [("boyd", False),
                                                ("goldstein", False),
                                                ("boyd", True)])
def test_vol_multichunk_light_call_is_the_inplace_form(stepsize, converged):
    """``VolMultichunk``, made once per route, on the route's volumes: the
    same buffers, norms and sout as ``vol_multichunk_`` with the same
    scalars, twice in a row (its scalar buffer is reused)."""
    m = _vol_route_match()
    call = tv.VolMultichunk(m, RI, 4, stepsize, torch.device("cpu"))
    u, q = (torch.from_numpy(a) for a in ttv._chunk_inputs(84, L, NX, NY)[:2])
    cur, prev = [u.clone(), q.clone()], [u.clone(), q.clone()]
    want_cur, want_prev = [u.clone(), q.clone()], [u.clone(), q.clone()]
    steps = (0.9, 1.1, 1.0, 0.5, 2.0, 3.0)
    for it in (1, 21):
        got = call(cur, prev, *(torch.tensor(v) for v in steps),
                   torch.tensor(it), torch.tensor(converged))
        scal = torch.tensor(list(steps[:3]) + [m["lmb"], m["radius"]]
                            + list(steps[3:]) + [float(it)] + [1e-3] * 4
                            + [float(converged)])
        want = tv.vol_multichunk_(*want_cur, *want_prev, m["f"], m["w"],
                                  scal, RI, 4, m["dataterm"], stepsize,
                                  m["adapt_consts"])
        _equal(cur + prev + list(got), want_cur + want_prev + list(want))


# ---------------------------------------------------------------------------
# the routes, in place on the run's own state
# ---------------------------------------------------------------------------

def test_admm_route_chunks_across_runs_match_jax():
    """``FusedROFADMM``'s Chebyshev route (ri 5, tolerance 1e-3) in four
    runs: multichunks and chunks through the light calls in place on the
    run's own state arrays (the second run has three chunks after its
    multichunk, the third six chunks, the fourth a multichunk and a
    chunk), against the JAX route's one run in interpret mode."""
    rng = np.random.RandomState(4)
    f = rng.rand(tfad.NX * tfad.NY).astype(np.float32)
    jb = tfad.JFused(tfad._tv(pt, tfad.NX, tfad.NY, f),
                     tfad.JOptions(residual_iter=5), tfad._sopts(pt, 1e-3),
                     interpret=True)
    tb = tfad.TFused(tfad._tv(ptt, tfad.NX, tfad.NY, f),
                     tfad.TOptions(residual_iter=5), tfad._sopts(ptt, 1e-3))
    assert jb.mode == tb.mode == "cheby"
    js = jb.run(jb.initial_state(), 140)
    ts = trm._split_run(tb, (3, 62, 95, 140))
    assert isinstance(tb.rof["chunk"], tfa.ADMMChunk)
    assert isinstance(tb.rof["call"], tfa.ADMMMultichunk)
    tfad._assert_runs_agree(ts, js)


def test_vol_route_multichunks_across_runs_match_jax():
    """The volumetric route over 190 iterations of boyd with ri 10 in two
    runs, each with a multichunk through ``VolMultichunk`` in place on the
    run's own vectors (the first also a chunk), against the JAX fused
    route's one run."""
    jb, tb = (ttv._fused(mod, ttv._model(mod)[0].finalize())
              for mod in (pt, ptt))
    js = jb.run(jb.initial_state(), 190)
    ts = trm._split_run(tb, (95, 190))
    assert isinstance(tb.vol["multi"], tv.VolMultichunk)
    assert isinstance(tb.vol["call"], tv.VolChunk)
    assert int(ts.iteration) == 190
    ttv._assert_runs_agree(ts, js)
