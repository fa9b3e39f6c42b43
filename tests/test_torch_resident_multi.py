"""The grid-resident batched multilabel chunk (row 15, ``ml_chunk_batched_``,
its instances one after another in one launch) and the grid-resident ADMM
multichunk (row 9, ``admm_multichunk_``, every chunk of the launch with the
planes in shared memory), as far as the CPU can check them: the two shape
rules for given SM counts and shared-memory limits; the bands of the ADMM
launch; the in-place forms and the routes' light calls (``MLBatchedChunk``,
``ADMMMultichunk``) against the functional wrappers (bit for bit: on the
CPU every form runs the same plain version) and against the JAX kernels in
interpret mode (f32, at the tolerances of tests/test_torch_ensemble.py and
tests/test_torch_fused_admm.py); and ``BatchedPDHG``'s multilabel route and
``FusedROFADMM``'s Chebyshev route, which now update the run's own state in
place, against the JAX routes across several ``run`` calls.

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
from prost_tpu.ops import fused_multilabel as jml
from prost_tpu_torch.ops import fused_admm as tfa
from prost_tpu_torch.ops import fused_multilabel as tml
from prost_tpu_torch.ops.pdhg_chunk import resident_rows
import test_torch_ensemble as tens
import test_torch_fused_admm as tfad

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into (neither resident kernel has static shared memory)
H100_SMS, H100_SMEM = 132, 232448


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


# ---------------------------------------------------------------------------
# the shape rules and the bands
# ---------------------------------------------------------------------------

# (L, nx, ny, SMs, bytes, resident?): config 3's instances (the 8-instance
# ensemble), a ragged instance, ML_LARGE's, 9 labels, half the SMs
ML_BATCHED_RULE = [(8, 256, 256, H100_SMS, H100_SMEM, True),
                   (5, 250, 190, H100_SMS, H100_SMEM, True),
                   (8, 512, 512, H100_SMS, H100_SMEM, False),
                   (9, 16, 16, H100_SMS, H100_SMEM, False),
                   (8, 256, 256, 66, H100_SMEM, True)]


@pytest.mark.parametrize("L,nx,ny,sms,smem,want", ML_BATCHED_RULE)
def test_ml_batched_rule_is_one_instances(L, nx, ny, sms, smem, want):
    """A batched launch runs its instances one after another on the same
    blocks, so the batch size does not enter its rule: ``ml_chunk_batched_``
    and ``MLBatchedChunk`` take ``resident_ok`` on one instance's shape,
    and a block of the batched launch holds one instance's band
    (``resident_bytes``), as a single chunk's does."""
    assert tml.resident_ok(L, nx, ny, sms, smem) is want
    if L <= tml.MAX_RESIDENT_L:
        assert (tml.resident_bytes(L, nx, ny, sms) <= smem) is want


# (nx, ny, data term, SMs, bytes, resident?): config 4 at 512x512 (bands
# of 4 rows), its wsquare and abs forms, a ragged plane, the 2048x2048 run
# of chip_smoke's phase_large, 1024x1024, and 512x512 on half the SMs
ADMM_RULE = [(512, 512, "square", H100_SMS, H100_SMEM, True),
             (512, 512, "wsquare", H100_SMS, H100_SMEM, True),
             (512, 512, "abs", H100_SMS, H100_SMEM, True),
             (300, 190, "square", H100_SMS, H100_SMEM, True),
             (2048, 2048, "square", H100_SMS, H100_SMEM, False),
             (1024, 1024, "wsquare", H100_SMS, H100_SMEM, False),
             (512, 512, "wsquare", 66, H100_SMEM, False)]


@pytest.mark.parametrize("nx,ny,dataterm,sms,smem,want", ADMM_RULE)
def test_admm_multichunk_shape_rule(nx, ny, dataterm, sms, smem, want):
    assert tfa.admm_resident_ok(nx, ny, dataterm, sms, smem) is want


def test_admm_resident_bytes_count_the_layout():
    """csrc's layout by hand at 512x512 over 132 blocks (bands of at most
    4 rows): xh, xp, xd, warm, v0 and v1 6 rows each, t1, x and the two
    parts of zh, zp, zd and dd 5 rows, f and r (and w) 4 rows, 512 wide,
    and the 2048 floats of the reductions."""
    rows = 6 * 6 + 10 * 5 + 2 * 4
    assert tfa.admm_resident_bytes(512, 512, 132, "square") == \
        4 * (rows * 512 + 2048)
    assert tfa.admm_resident_bytes(512, 512, 132, "wsquare") == \
        4 * ((rows + 4) * 512 + 2048) == 208896


@pytest.mark.parametrize("nx,blocks", [(512, 132), (300, 132), (2048, 132),
                                       (13, 16), (40, 3)])
def test_admm_resident_bands_cover_every_row_once(nx, blocks):
    """The resident multichunk's bands (band_of, one block per SM): every
    row in exactly one band, sizes within one, the largest
    ``resident_rows``; at 512x512 bands of 3 and 4 rows, which the 8-row
    norm tiles straddle."""
    bands = tfa.admm_bands(nx, blocks)
    rows = [r for lo, hi in bands for r in range(lo, hi)]
    assert rows == list(range(nx))
    sizes = {hi - lo for lo, hi in bands}
    assert max(sizes) - min(sizes) <= 1
    assert max(sizes) == resident_rows(nx, blocks)
    if nx == 512:
        assert sizes == {3, 4}


# ---------------------------------------------------------------------------
# row 15: the in-place batched form and its light call
# ---------------------------------------------------------------------------

B, L, NX, NY = 3, 4, 12, 10


def _ml_batch(seed, flags=None):
    """u, f (B, L, nx, ny) and the flat dual rows (B, 2 L n + n) of a route,
    and the (5, B) (+ flags) scalar rows."""
    rng = np.random.RandomState(seed)
    n = NX * NY
    u = rng.rand(B, L, NX, NY).astype(np.float32)
    y = np.concatenate([0.3 * rng.randn(B, 2 * L * n),
                        0.1 * rng.randn(B, n)], 1).astype(np.float32)
    f = rng.rand(B, L, NX, NY).astype(np.float32)
    rows = [0.8 + 0.2 * rng.rand(B), 0.9 + 0.3 * rng.rand(B), np.ones(B),
            0.5 + rng.rand(B), rng.rand(B)]
    if flags is not None:
        rows.append(np.asarray(flags, np.float64))
    return u, y, f, np.array(rows, np.float32)


def _views(u, y):
    n2 = 2 * L * NX * NY
    return (u, y[:, :n2].view(B, 2 * L, NX, NY), y[:, n2:].view(B, NX, NY))


@pytest.mark.parametrize("flags", [None, [0.0, 1.0, 0.0]])
def test_ml_chunk_batched_inplace_is_the_functional_and_jax(flags):
    """``ml_chunk_batched_`` on views of a route's flat (B, 2 L n + n) y
    leaves the functional wrapper's outputs in the caller's buffers, bit
    for bit, a flagged instance's buffers untouched; both are the JAX
    kernel's (interpret mode) within the ensemble tolerances."""
    u, y, f, scal = _ml_batch(60, flags)
    t_u, t_y = torch.from_numpy(u), torch.from_numpy(y)
    t_f, t_scal = torch.from_numpy(f), torch.from_numpy(scal)
    want = tml.ml_chunk_batched(*[v.contiguous() for v in _views(t_u, t_y)],
                                t_f, t_scal, 4)
    cur_u, cur_y = t_u.clone(), t_y.clone()
    prev_u, prev_y = torch.full_like(t_u, 7.0), torch.full_like(t_y, 7.0)
    norms2 = tml.ml_chunk_batched_(*_views(cur_u, cur_y),
                                   *_views(prev_u, prev_y), t_f, t_scal, 4)
    got = list(_views(cur_u, cur_y)) + list(_views(prev_u, prev_y))
    for b in range(B):
        if flags and flags[b]:
            for a in got[3:]:
                assert torch.all(a[b] == 7.0)
            for a, w in zip(got[:3], want[:3]):
                assert torch.equal(a[b], w[b])
            assert not norms2[:, b].any()
            continue
        for a, w in zip(got, want[:6]):
            assert torch.equal(a[b], w[b])
        assert torch.equal(norms2[:, b], want[6][:, b])
    ref = jml.ml_fused_chunk_batched(
        *map(jnp.asarray, (u, *[v.numpy() for v in _views(t_u, t_y)[1:]], f,
                           scal[:5])), 4, interpret=True)
    if flags is None:
        tens._close(tuple(got) + (norms2,), ref, 6)


def test_ml_chunk_batched_inplace_refuses_mismatched_buffers():
    u, y, f, scal = _ml_batch(61)
    t = _views(torch.from_numpy(u), torch.from_numpy(y))
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        tml.ml_chunk_batched_(*t, t[0], t[1][:, 1:], t[2],
                              torch.from_numpy(f), torch.from_numpy(scal), 2)
    q_other = t[1].contiguous()
    with pytest.raises(ptt.ProstError, match="space their instances"):
        tml.ml_chunk_batched_(*t, t[0], q_other, t[2], torch.from_numpy(f),
                              torch.from_numpy(scal), 2)
    one = t[0][:1].expand(B, -1, -1, -1)
    with pytest.raises(ptt.ProstError, match="overlap"):
        tml.ml_chunk_batched_(one, *t[1:], one, *t[1:], torch.from_numpy(f),
                              torch.from_numpy(scal), 2)


@pytest.mark.parametrize("converged", [False, True])
def test_ml_batched_light_call_is_the_inplace_form(converged):
    """``MLBatchedChunk``, made once per route from the route's match
    (every instance's radius and d_s), on the route's views: the same
    buffers and norms as ``ml_chunk_batched_`` with the same scalars, the
    flag set for every instance."""
    u, y, f, scal = _ml_batch(62)
    m = {"L": L, "nx": NX, "ny": NY, "radius": torch.from_numpy(scal[3]),
         "d_s": torch.from_numpy(scal[4])}
    call = tml.MLBatchedChunk(m, B, 3, torch.device("cpu"))
    tau, sigma, theta = (torch.from_numpy(scal[k]) for k in range(3))
    flag = torch.tensor(converged)
    cur = [torch.from_numpy(u).clone(), torch.from_numpy(y).clone()]
    prev = [a.clone() for a in cur]
    norms2 = call(_views(*cur), _views(*prev), torch.from_numpy(f), tau,
                  sigma, theta, flag)
    want_cur = [torch.from_numpy(u).clone(), torch.from_numpy(y).clone()]
    want_prev = [a.clone() for a in want_cur]
    full = torch.from_numpy(np.concatenate(
        [scal, np.full((1, B), float(converged), np.float32)]))
    want = tml.ml_chunk_batched_(*_views(*want_cur), *_views(*want_prev),
                                 torch.from_numpy(f), full, 3)
    for a, b in zip(cur + prev + [norms2], want_cur + want_prev + [want]):
        assert torch.equal(a, b)
    assert torch.equal(call.scal(), full)


# ---------------------------------------------------------------------------
# row 9: the in-place multichunk and its light call
# ---------------------------------------------------------------------------

def _admm_scal(tol, conv=None):
    rows = [1.0, 16.0, 1.0, 1.05, 0.0, 0.0, 0.0, tol, tol, tol, tol]
    return np.array(rows + ([conv] if conv is not None else []), np.float32)


def test_admm_multichunk_inplace_is_the_functional_and_jax():
    """``admm_multichunk_`` from a solve's start with tolerance 1e-2 (rho
    adapts and the launch converges in chunk 3 of 8) leaves the functional
    wrapper's state in the caller's arrays and returns its norms and sout,
    bit for bit; both are the JAX kernel's within the fused ADMM file's
    tolerances."""
    planes, f = tfad._solve_start()
    scal = _admm_scal(1e-2)
    t = [torch.from_numpy(a) for a in planes]
    args = (torch.from_numpy(f), torch.from_numpy(f), torch.from_numpy(scal),
            10, 8, 1.7, 10, tfad._consts())
    want = tfa.admm_multichunk(*t, *args)
    cur = [a.clone() for a in t]
    norms, sout = tfa.admm_multichunk_(*cur, *args)
    for a, b in zip(cur + [norms, sout], want):
        assert torch.equal(a, b)
    assert sout[4:].tolist() == [1.0, 3.0]
    ref = jfa.admm_fused_multichunk(
        *map(jnp.asarray, planes), jnp.asarray(f), jnp.asarray(f),
        jnp.asarray(scal), 10, 8, 1.7, 10, tfad._consts(), interpret=True)
    tfad._close(tuple(cur) + (norms,), ref[:8], tfad.PLANE_ATOL[10], 1e-3)
    np.testing.assert_allclose(sout.numpy(), np.asarray(ref[8]), rtol=1e-6)


def test_admm_multichunk_inplace_with_the_flag_changes_nothing():
    planes, f, w = tfad._planes(63)
    cur = [torch.from_numpy(a) for a in planes]
    before = [a.clone() for a in cur]
    norms, sout = tfa.admm_multichunk_(
        *cur, torch.from_numpy(f), torch.from_numpy(w),
        torch.from_numpy(_admm_scal(1e-3, 1.0)), 5, 8, 1.7, 10,
        tfad._consts())
    for a, b in zip(cur, before):
        assert torch.equal(a, b)
    assert sout[4:].tolist() == [1.0, 0.0]
    with pytest.raises(ptt.ProstError, match="path must be"):
        tfa.admm_multichunk_(*cur, torch.from_numpy(f), torch.from_numpy(w),
                             torch.from_numpy(_admm_scal(0.0)), 5, 8, 1.7,
                             10, tfad._consts(), path="cluster")


class _Route:
    """The parts of a route's match that ``ADMMMultichunk`` reads."""

    def __init__(self, f, w, dataterm, tol):
        self.r = {"nx": tfad.NX, "ny": tfad.NY, "f": f, "w": w,
                  "dataterm": dataterm, "lmb_t": torch.tensor(16.0),
                  "radius_t": torch.tensor(1.0),
                  "tols_t": tuple(torch.tensor(tol) for _ in range(4)),
                  "consts": tfad._consts()}


@pytest.mark.parametrize("dataterm,converged", [("square", False),
                                                ("wsquare", False),
                                                ("abs", True)])
def test_admm_light_call_is_the_inplace_form(dataterm, converged):
    """``ADMMMultichunk``, made once per route, on the route's planes: the
    same arrays, norms and sout as ``admm_multichunk_`` with the same
    scalars, twice in a row (its scalar buffer is reused)."""
    planes, f, w = tfad._planes(64)
    f_t, w_t = torch.from_numpy(f), torch.from_numpy(w)
    r = _Route(f_t, w_t, dataterm, 1e-3).r
    call = tfa.ADMMMultichunk(r, 5, 4, 1.7, 10, torch.device("cpu"))
    cur = [torch.from_numpy(a) for a in planes]
    want_cur = [a.clone() for a in cur]
    rho, delta, arb_l, arb_u = (torch.tensor(v) for v in (1.3, 1.05, 2.0,
                                                          3.0))
    for it in (11, 31):
        got = call(cur, rho, delta, arb_l, arb_u, torch.tensor(it),
                   torch.tensor(converged))
        scal = torch.tensor([1.3, 16.0, 1.0, 1.05, 2.0, 3.0, float(it)]
                            + [1e-3] * 4 + [float(converged)])
        want = tfa.admm_multichunk_(*want_cur, f_t, w_t, scal, 5, 4, 1.7, 10,
                                    tfad._consts(), dataterm)
        for a, b in zip(cur + list(got), want_cur + list(want)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the routes, in place on the run's own state
# ---------------------------------------------------------------------------

def _split_run(b, stops, start=0, state=None):
    """``b.run`` through the iterations ``stops``, each run from the state
    the last one returned (a solver's callback epochs); also checks that
    no run changed a state it was given."""
    s = b.initial_state() if state is None else state
    for stop in stops:
        given = {k: v.clone() for k, v in vars(s).items()}
        new = b.run(s, stop, start)
        for k, v in given.items():
            assert torch.equal(getattr(s, k), v), k
        s, start = new, stop
    return s


def test_batched_ml_route_across_runs_matches_jax():
    """``BatchedPDHG``'s multilabel route (three 16x16x3 instances, boyd,
    ri 5) over 41 iterations in three runs, each with its own copies of
    the state's vectors, which the light call then updates in place,
    against the JAX BatchedPDHG's one run in interpret mode."""
    tb = tens._batched(ptt, tens._ml_probs(ptt), 5)
    jb = tens._batched(pt, tens._ml_probs(pt), 5)
    assert tb.ml is not None and jb.ml is not None
    ts = _split_run(tb, (9, 26, 41))
    js = tens._run(jb, 41)
    assert "call" in tb.ml
    np.testing.assert_array_equal(ts.iteration.numpy(), 41)
    tens._assert_states(ts, js, tens.RUN_ATOL)
    for a, b in zip(tb.current_solution(ts), jb.current_solution(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=tens.SOL_ATOL)


def test_admm_route_across_runs_matches_jax():
    """``FusedROFADMM``'s Chebyshev route (ri 5, tolerance 1e-3) in four
    runs, three of them with multichunks through the light call in place
    on the run's own state arrays, against the JAX route's one run in
    interpret mode."""
    rng = np.random.RandomState(4)
    f = rng.rand(tfad.NX * tfad.NY).astype(np.float32)
    jb = tfad.JFused(tfad._tv(pt, tfad.NX, tfad.NY, f),
                     tfad.JOptions(residual_iter=5), tfad._sopts(pt, 1e-3),
                     interpret=True)
    tb = tfad.TFused(tfad._tv(ptt, tfad.NX, tfad.NY, f),
                     tfad.TOptions(residual_iter=5), tfad._sopts(ptt, 1e-3))
    assert jb.mode == tb.mode == "cheby"
    js = jb.run(jb.initial_state(), 140)
    ts = _split_run(tb, (3, 47, 95, 140))
    assert "call" in tb.rof
    tfad._assert_runs_agree(ts, js)
