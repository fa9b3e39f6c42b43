"""The grid-resident ROF chunk (row 2, ``rof_chunk_``: one chunk in one
launch) and multichunk (row 1, ``rof_multichunk_``: every chunk of the
launch, with the adaptation between them, in one launch), the main path's
kernels, as far as the CPU can check them: the shape rule and the bytes it
counts; the in-place forms and the route's light calls (``ROFChunk``,
``ROFMultichunk``) against the functional wrappers (bit for bit: on the CPU
every form runs the same plain version) and against the JAX kernels in
interpret mode (f32, at tests/test_torch_fused_rof.py's tolerances); and
``FusedROFPDHG``'s ROF route, which now updates the run's own state in
place in its chunks and multichunks, against the JAX route across several
``run`` calls, for the square, abs and wsquare data terms.

The kernels themselves are held against the launch sequences on the card
by tests/test_torch_cuda_redesign.py and chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_rof as jfr
from prost_tpu_torch.ops import fused_rof as tfr
import test_torch_fused_rof as tfrt
import test_torch_resident_multi as trm

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into (no resident kernel holds static shared memory)
H100_SMS, H100_SMEM = 132, 232448
NX, NY = tfrt.NX, tfrt.NY


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the shape rule
# ---------------------------------------------------------------------------

# (nx, ny, data term, SMs, multichunk?, resident?): config 1's 512x512 for
# the three data terms, chunk and multichunk; a ragged 250x190; the
# 2048x1536 and 2048x2048 planes that chip_smoke checks (streaming); half
# the SMs (bands of 8 rows still fit) and an eighth (bands of 32 do not)
ROF_RULE = [(512, 512, "square", H100_SMS, False, True),
            (512, 512, "abs", H100_SMS, False, True),
            (512, 512, "wsquare", H100_SMS, False, True),
            (512, 512, "square", H100_SMS, True, True),
            (512, 512, "abs", H100_SMS, True, True),
            (512, 512, "wsquare", H100_SMS, True, True),
            (250, 190, "wsquare", H100_SMS, True, True),
            (2048, 1536, "square", H100_SMS, False, False),
            (2048, 1536, "wsquare", H100_SMS, True, False),
            (2048, 2048, "square", H100_SMS, False, False),
            (2048, 2048, "square", H100_SMS, True, False),
            (512, 512, "wsquare", 66, True, True),
            (512, 512, "square", 16, False, False)]


@pytest.mark.parametrize("nx,ny,dataterm,sms,multi,want", ROF_RULE)
def test_rof_shape_rule(nx, ny, dataterm, sms, multi, want):
    assert tfr.resident_ok(nx, ny, dataterm, sms, H100_SMEM, multi) is want


def test_rof_resident_bytes_count_the_layout():
    """csrc's layout by hand: at 512x512 over 132 blocks (bands of 4
    rows) x, q_y and f 5 rows (the band's and the first of the band
    below, whose primal step each band also takes), q_x 6 (and the row
    above), g_x and g_y 4 rows of 512 floats (59392 bytes), wsquare's w 5
    rows more (69632); the multichunk adds w_hat's window of its own (4
    rows, 8192 bytes: f is read again in the next chunk).  2048x1536 needs
    bands of 16 rows (620544 bytes), beyond the card's 232448; a window
    smaller than the 2048 floats of the reductions' array, which borrows
    it, counts as that array."""
    assert tfr.resident_bytes(512, 512, 132) == \
        4 * (3 * 5 + 6 + 2 * 4) * 512 == 59392
    assert tfr.resident_bytes(512, 512, 132, "wsquare") == 69632
    assert tfr.resident_bytes(512, 512, 132, multi=True) == 67584
    assert tfr.resident_bytes(512, 512, 132, "wsquare", True) == 77824
    assert tfr.resident_bytes(2048, 1536, 132) == \
        4 * (3 * 17 + 18 + 2 * 16) * 1536 == 620544
    assert tfr.resident_bytes(2048, 2048, 132) == 827392
    # 9 rows, 40 wide, bands of 1 row: the chunk is under the reductions'
    # array, the multichunk's w_hat window counts as it
    assert tfr.resident_bytes(9, 40, 132) == 8192
    assert tfr.resident_bytes(9, 40, 132, multi=True) == \
        4 * ((3 * 2 + 3 + 2) * 40 + 2048)


# ---------------------------------------------------------------------------
# row 2: the in-place chunk and its light call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ri", [1, 10])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_rof_chunk_inplace_is_the_functional_and_jax(ri, dataterm):
    """``rof_chunk_`` leaves the functional wrapper's planes and previous
    iterates in the caller's buffers (written over NaN) and returns its
    squared norms, bit for bit; both are the JAX kernel's (interpret mode)
    within the fused ROF file's tolerances."""
    x, q, f, w = tfrt._inputs(40 + ri, clean=False)
    t = [torch.from_numpy(a) for a in (x, q, f, w)]
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0])
    want = tfr.rof_chunk(*t, scal, ri, dataterm)
    cur = [t[0].clone(), t[1].clone()]
    prev = [torch.full_like(a, np.nan) for a in cur]
    norms2 = tfr.rof_chunk_(*cur, *prev, t[2], t[3], scal, ri, dataterm)
    _equal(cur + prev + [norms2], want)
    ref = jfr.rof_fused_chunk(*map(jnp.asarray, (x, q, f, w)), 0.9, 1.1,
                              1.0, 8.0, 1.0, ri, dataterm=dataterm,
                              interpret=True)
    tfrt._close(tuple(cur + prev + [norms2]), ref)


def test_rof_chunk_inplace_with_the_flag_changes_nothing():
    cur = [torch.from_numpy(a) for a in tfrt._inputs(44, clean=False)[:2]]
    prev = [a - 1.0 for a in cur]
    before = [a.clone() for a in cur + prev]
    _, _, f, w = (torch.from_numpy(a) for a in tfrt._inputs(45))
    norms2 = tfr.rof_chunk_(*cur, *prev, f, w,
                            torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0, 1.0]), 5)
    _equal(cur + prev, before)
    assert not norms2.any()


def test_rof_inplace_forms_refuse_bad_paths_and_buffers():
    x, q, f, w = (torch.from_numpy(a) for a in tfrt._inputs(46))
    scal5 = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0])
    scal13 = torch.tensor([1.0, 1.0, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0]
                          + [1e-3] * 4)
    mc = (scal13, 5, 2, "square", "boyd", tfrt._consts())
    with pytest.raises(ptt.ProstError, match="path must be"):
        tfr.rof_chunk_(x, q, x.clone(), q.clone(), f, w, scal5, 2,
                       path="cluster")
    with pytest.raises(ptt.ProstError, match="path must be"):
        tfr.rof_multichunk_(x, q, x.clone(), q.clone(), f, w, *mc,
                            path="cluster")
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        tfr.rof_chunk_(x, q, x.clone(), q[:1].clone(), f, w, scal5, 2)
    with pytest.raises(ptt.ProstError, match="contiguous"):
        tfr.rof_multichunk_(x.t().contiguous().t(), q, x.clone(), q.clone(),
                            f, w, *mc)
    with pytest.raises(ptt.ProstError, match="stepsize"):
        tfr.rof_multichunk_(x, q, x.clone(), q.clone(), f, w, *mc[:4],
                            "alg2", mc[5])
    with pytest.raises(ptt.ProstError, match="scal"):
        tfr.rof_chunk_(x, q, x.clone(), q.clone(), f, w, scal13, 2)


def _match(dataterm="square", tol=1e-3):
    """The ROF route's match for a 24x40 problem with ``dataterm``, with
    the tensors that ``FusedROFPDHG`` adds and the light calls read."""
    fun, coeffs, ball = tfrt._cases(NX, NY, 5)[dataterm]
    m = tfr.match_rof_structure(tfrt._tv(ptt, NX, NY, fun, coeffs, ball))
    assert m is not None and m["dataterm"] == dataterm
    m["lmb_t"] = torch.tensor(m["lmb"])
    m["radius_t"] = torch.tensor(m["radius"])
    m["tols_t"] = tuple(torch.tensor(tol) for _ in range(4))
    m["adapt_consts"] = tfrt._consts()
    return m


@pytest.mark.parametrize("dataterm,converged", [("square", False),
                                                ("wsquare", False),
                                                ("abs", True)])
def test_rof_chunk_light_call_is_the_inplace_form(dataterm, converged):
    """``ROFChunk``, made once per route, on the route's planes: the same
    buffers and squared norms as ``rof_chunk_`` with the same scalars,
    twice in a row (its scalar buffer is reused)."""
    m = _match(dataterm)
    call = tfr.ROFChunk(m, 7, torch.device("cpu"))
    x, q = (torch.from_numpy(a) for a in tfrt._inputs(47)[:2])
    cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    want_cur, want_prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    for tau, sigma in ((0.9, 1.1), (1.3, 0.7)):
        got = call(cur, prev, m["f"], m["w"], torch.tensor(tau),
                   torch.tensor(sigma), torch.tensor(1.0),
                   torch.tensor(converged))
        scal = torch.tensor([tau, sigma, 1.0, m["lmb"], m["radius"],
                             float(converged)])
        want = tfr.rof_chunk_(*want_cur, *want_prev, m["f"], m["w"], scal,
                              7, dataterm)
        _equal(cur + prev + [got], want_cur + want_prev + [want])


# ---------------------------------------------------------------------------
# row 1: the in-place multichunk and its light call
# ---------------------------------------------------------------------------

def _scal13(tol, conv=None):
    return torch.tensor([1.0, 1.0, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0]
                        + [tol] * 4 + ([conv] if conv is not None else []))


def _mc_close(t_out, j_out):
    """Planes and previous iterates within PLANE_ATOL, the norms within
    NORM_RTOL, sout (its seven scalars) exactly."""
    tfrt._close(t_out[:5], j_out[:5])
    np.testing.assert_array_equal(t_out[5].numpy(), np.asarray(j_out[5])[:7])


def _multichunk_both(x, q, f, w, scal, ri, dataterm, stepsize):
    """The functional multichunk and the in-place form (previous iterates
    over NaN) from the same inputs: (in-place outputs, functional
    outputs)."""
    args = (f, w, scal, ri, 8, dataterm, stepsize, tfrt._consts())
    want = tfr.rof_multichunk(x, q, *args)
    cur = [x.clone(), q.clone()]
    prev = [torch.full_like(t, np.nan) for t in cur]
    norms, sout = tfr.rof_multichunk_(*cur, *prev, *args)
    got = cur + prev + [norms, sout]
    _equal(got, want)
    return got


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_rof_multichunk_inplace_is_the_functional_and_jax(dataterm,
                                                          stepsize):
    """``rof_multichunk_`` from a solve's start (x = f, q = 0; ri 5, 8
    chunks, tolerance 1e-4: both rules adapt and every chunk runs) leaves
    the functional wrapper's planes and previous iterates in the caller's
    buffers and returns its norms and sout, bit for bit; both are the JAX
    kernel's (interpret mode) within the fused ROF tolerances, sout
    exactly."""
    _, _, f, w = tfrt._inputs(48)
    x, q = f.copy(), np.zeros((2, NX, NY), np.float32)
    t = [torch.from_numpy(a) for a in (x, q, f, w)]
    got = _multichunk_both(*t, _scal13(1e-4), 5, dataterm, stepsize)
    assert got[5][5:].tolist() == [0.0, 8.0]
    ref = jfr.rof_fused_multichunk(
        *map(jnp.asarray, (x, q, f, w)), jnp.asarray(_scal13(1e-4).numpy()),
        5, 8, dataterm, stepsize, tfrt._consts(), interpret=True)
    _mc_close(tuple(got), ref)


def test_rof_multichunk_inplace_converging_mid_launch():
    """From a solve's start at tolerance 1e-2 boyd adapts and the launch
    converges before its last chunk: the in-place form's buffers, norms and
    sout are the functional wrapper's, and the JAX kernel's."""
    _, _, f, w = tfrt._inputs(27)
    x, q = f.copy(), np.zeros((2, NX, NY), np.float32)
    t = [torch.from_numpy(a) for a in (x, q, f, w)]
    got = _multichunk_both(*t, _scal13(1e-2), 10, "square", "boyd")
    assert float(got[5][5]) == 1.0 and 1 < float(got[5][6]) < 8
    ref = jfr.rof_fused_multichunk(
        *map(jnp.asarray, (x, q, f, w)), jnp.asarray(_scal13(1e-2).numpy()),
        10, 8, "square", "boyd", tfrt._consts(), interpret=True)
    _mc_close(tuple(got), ref)


def test_rof_multichunk_inplace_with_the_flag_changes_nothing():
    x, q, f, w = (torch.from_numpy(a) for a in tfrt._inputs(49))
    cur = [x.clone(), q.clone()]
    prev = [t - 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    norms, sout = tfr.rof_multichunk_(*cur, *prev, f, w, _scal13(1e-3, 1.0),
                                      5, 8, "square", "boyd", tfrt._consts())
    _equal(cur + prev, before)
    assert not norms.any() and sout[5:].tolist() == [1.0, 0.0]


@pytest.mark.parametrize("stepsize,converged", [("boyd", False),
                                                ("alg1", False),
                                                ("goldstein", True)])
def test_rof_multichunk_light_call_is_the_inplace_form(stepsize, converged):
    """``ROFMultichunk``, made once per route, on the route's planes: the
    same buffers, norms and sout as ``rof_multichunk_`` with the same
    scalars, twice in a row (its scalar buffer is reused)."""
    m = _match("wsquare")
    call = tfr.ROFMultichunk(m, 5, 4, stepsize, torch.device("cpu"))
    x, q = (torch.from_numpy(a) for a in tfrt._inputs(50)[:2])
    cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    want_cur, want_prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    steps = (0.9, 1.1, 1.0, 0.5, 2.0, 3.0)
    for it in (1, 21):
        got = call(cur, prev, *(torch.tensor(v) for v in steps),
                   torch.tensor(it), torch.tensor(converged))
        scal = torch.tensor(list(steps[:3]) + [m["lmb"], m["radius"]]
                            + list(steps[3:]) + [float(it)] + [1e-3] * 4
                            + [float(converged)])
        want = tfr.rof_multichunk_(*want_cur, *want_prev, m["f"], m["w"],
                                   scal, 5, 4, "wsquare", stepsize,
                                   m["adapt_consts"])
        _equal(cur + prev + list(got), want_cur + want_prev + list(want))


# ---------------------------------------------------------------------------
# the route, in place on the run's own state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,ri,stops", [("square", 5, (3, 62, 95, 140)),
                                           ("abs", 7, (60, 140)),
                                           ("wsquare", 5, (46, 140))])
def test_rof_route_across_runs_matches_jax(case, ri, stops):
    """``FusedROFPDHG``'s ROF route (boyd, tolerance 0) over 140 iterations
    in several runs, each with its multichunk and chunks through the light
    calls in place on the run's own copies of the state's vectors (no run
    changes the state it was given), against the JAX fused route's one run
    in interpret mode."""
    fun, coeffs, ball = tfrt._cases(NX, NY, 3)[case]
    jb = tfrt.JFused(tfrt._tv(pt, NX, NY, fun, coeffs, ball),
                     tfrt.JOptions(stepsize="boyd", residual_iter=ri,
                                   scale_steps_operator=False),
                     tfrt._sopts(pt, 0.0), interpret=True)
    tb = tfrt.TFused(tfrt._tv(ptt, NX, NY, fun, coeffs, ball),
                     tfrt.TOptions(stepsize="boyd", residual_iter=ri,
                                   scale_steps_operator=False),
                     tfrt._sopts(ptt, 0.0))
    js = jb.run(jb.initial_state(), 140)
    ts = trm._split_run(tb, stops)
    assert isinstance(tb.rof["multi"], tfr.ROFMultichunk)
    assert isinstance(tb.rof["call"], tfr.ROFChunk)
    assert int(ts.iteration) == int(js.iteration) == 140
    for name in ("x", "y", "x_prev", "y_prev", "kx", "kty"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=2e-5,
                                   err_msg=name)
    for name in ("tau", "sigma"):
        np.testing.assert_allclose(float(getattr(ts, name)),
                                   float(getattr(js, name)), rtol=1e-6)


def test_rof_route_leaves_the_callers_state():
    """A run from a warm state the caller keeps: its x, y, x_prev and
    y_prev (with mass on the dead dual coordinates) are unchanged after
    the run, which worked in place on its own copies, and the result is
    the one from a copy of that state."""
    fun, coeffs, ball = tfrt._cases(NX, NY, 3)["square"]
    tb = tfrt.TFused(tfrt._tv(ptt, NX, NY, fun, coeffs, ball),
                     tfrt.TOptions(stepsize="boyd", residual_iter=5,
                                   scale_steps_operator=False),
                     tfrt._sopts(ptt, 0.0))
    s = tb.run(tb.initial_state(), 41, 0)
    s.y.view(2, NX, NY)[0, -1, :] = 0.5
    kept = {k: v.clone() for k, v in vars(s).items()
            if isinstance(v, torch.Tensor)}
    out = tb.run(s, 101, 41)
    for k, v in kept.items():
        assert torch.equal(getattr(s, k), v), k
    again = tb.run(dataclasses.replace(s, **kept), 101, 41)
    _equal([out.x, out.y, out.x_prev, out.y_prev],
           [again.x, again.y, again.x_prev, again.y_prev])
    assert not out.y.view(2, NX, NY)[0, -1, :].any()
