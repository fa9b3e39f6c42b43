"""The grid-resident chunks of rows 17 and 12 (deblur and multilabel), as
far as the CPU can check them: the shape rule that sends a chunk to the
grid-resident launch or to the streaming launch sequence, for given SM
counts and shared-memory limits; the in-place whole-plane forms
``deblur_chunk_`` and ``ml_chunk_`` and the routes' light calls
(``DeblurChunk``, ``MLChunk``) against the functional wrappers (bit for
bit: on the CPU every form runs the same plain version) and against the
JAX kernels in interpret mode (f32, the tolerances of
tests/test_torch_deblur.py and tests/test_torch_fused_multilabel.py); and
the two routes, which now update the run's own vectors in place, against
the JAX fused routes across several ``run`` calls.

The kernels themselves are held against the streaming sequence on the
card by tests/test_torch_cuda_redesign.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_deblur as jd
from prost_tpu.ops import fused_multilabel as jml
from prost_tpu_torch.ops import fused_admm as ta
from prost_tpu_torch.ops import fused_deblur as td
from prost_tpu_torch.ops import fused_multilabel as tml
from prost_tpu_torch.ops.pdhg_chunk import pick_path, resident_rows
from prost_tpu_torch.parallel.spatial_fused import window
import test_torch_deblur as tdb
import test_torch_fused_multilabel as tfm

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into, less the deblur kernel's 1156 bytes of staged taps
H100_SMS, H100_SMEM = 132, 232448
DB_SMEM = H100_SMEM - 1156
MOTION = tdb.motion_kernel()  # config 2's blur: row reach 7


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _taps(kernel):
    return td.kernel_taps(torch.as_tensor(kernel.T, dtype=torch.float32))


# ---------------------------------------------------------------------------
# the shape rule
# ---------------------------------------------------------------------------

# (yv-grid rows, ny, ny2, SMs, bytes, resident?): config 2 at 512x512 and
# its one-shard halo band (520 + 2 x 154 rows), DB_LARGE, and the same
# grids on half the SMs or a 48 KB budget
DEBLUR_RULE = [(520, 512, 520, H100_SMS, DB_SMEM, True),
               (828, 512, 520, H100_SMS, DB_SMEM, True),
               (2056, 2048, 2056, H100_SMS, DB_SMEM, False),
               (520, 512, 520, 66, DB_SMEM, True),
               (828, 512, 520, 66, DB_SMEM, False),
               (520, 512, 520, H100_SMS, 48 * 1024, False),
               (8, 6, 12, H100_SMS, 48 * 1024, True)]


@pytest.mark.parametrize("nx2,ny,ny2,sms,smem,want", DEBLUR_RULE)
def test_deblur_shape_rule(nx2, ny, ny2, sms, smem, want):
    taps = _taps(MOTION)
    assert td.taps_reach(taps) == 7
    assert td.resident_ok(nx2, ny, ny2, taps, sms, smem) is want
    assert (td.resident_bytes(nx2, ny, ny2, taps, sms) <= smem) is want


# (L, rows, ny, SMs, bytes, resident?): config 3 at 256x256x8 and its
# one-shard halo band (256 + 2 x 22 rows), ML_LARGE, 9 labels (beyond the
# registers), and half the SMs
ML_RULE = [(8, 256, 256, H100_SMS, H100_SMEM, True),
           (8, 300, 256, H100_SMS, H100_SMEM, True),
           (8, 512, 512, H100_SMS, H100_SMEM, False),
           (9, 16, 16, H100_SMS, H100_SMEM, False),
           (5, 250, 190, H100_SMS, H100_SMEM, True),
           (8, 256, 256, 66, H100_SMEM, True),
           (8, 300, 256, 66, H100_SMEM, False)]


@pytest.mark.parametrize("L,nx,ny,sms,smem,want", ML_RULE)
def test_ml_shape_rule(L, nx, ny, sms, smem, want):
    assert tml.resident_ok(L, nx, ny, sms, smem) is want


def test_resident_bytes_count_the_layout():
    """csrc's layouts by hand: deblur DBRes at 520 rows over 132 blocks
    (bands of at most 4 rows, reach 7): x 12 rows, q_x 5, q_y, g_x, g_y, wh
    4 each (512 wide), yv 11, bx, fb, sv 4 each (520 wide); multilabel
    MLRes at 256x256x8 (bands of 2): u and q_x 3 rows, q_y, g_x, g_y, f 2
    rows of 8 planes, s and su 2 rows."""
    assert td.resident_bytes(520, 512, 520, _taps(MOTION), 132) == \
        4 * ((12 + 5 + 4 * 4) * 512 + (11 + 3 * 4) * 520)
    assert tml.resident_bytes(8, 256, 256, 132) == \
        4 * (8 * (3 + 3 + 4 * 2) + 2 * 2) * 256
    assert td.resident_bytes(2, 2, 2, ((0, 0, 1.0),), 132) == 4 * 4 * 512


@pytest.mark.parametrize("sms", [1, 3, 66, 132, 264])
def test_resident_rows_is_the_largest_band(sms):
    """The bands of a grid-resident launch are band_of's (the ADMM
    cooperative launch's formula): the largest has resident_rows rows."""
    for n in range(1, 1100, 13):
        sizes = [hi - lo for lo, hi in ta.admm_bands(n, sms)]
        assert max(sizes) == resident_rows(n, sms)


def test_pick_path_follows_the_rule_or_the_caller():
    assert pick_path(None, True, "x") and not pick_path(None, False, "x")
    assert pick_path("resident", True, "x")
    assert not pick_path("streaming", True, "x")
    with pytest.raises(ptt.ProstError, match="do not fit"):
        pick_path("resident", False, "deblur_chunk")
    with pytest.raises(ptt.ProstError, match="path must be"):
        pick_path("cluster", True, "deblur_chunk")


# ---------------------------------------------------------------------------
# the in-place forms and the light calls
# ---------------------------------------------------------------------------

def _deblur_inputs(seed, nx=20, ny=17, kernel=MOTION):
    (x, yv, q, fb, sv), taps = tdb._chunk_inputs(seed, nx, ny, kernel)
    return [torch.from_numpy(a) for a in (x, yv, q, fb, sv)], taps


@pytest.mark.parametrize("ri", [1, 3])
def test_deblur_chunk_inplace_is_the_functional_and_jax(ri):
    """``deblur_chunk_`` leaves the functional wrapper's state and previous
    iterate in the caller's buffers and returns its norms, bit for bit; both
    are the JAX kernel's (interpret mode) within the deblur tolerances."""
    (x, yv, q, fb, sv), taps = _deblur_inputs(30 + ri)
    scal = torch.tensor(tdb.ARGS)
    want = td.deblur_chunk(x, yv, q, fb, sv, scal, ri, taps, 0.5, 0.2)
    cur = [t.clone() for t in (x, yv, q)]
    prev = [torch.full_like(t, np.nan) for t in cur]
    norms2 = td.deblur_chunk_(*cur, *prev, fb, sv, scal, ri, taps, 0.5, 0.2)
    for a, b in zip(cur + prev + [norms2], want):
        assert torch.equal(a, b)
    nx, ny = x.shape
    nx2, ny2 = yv.shape
    ref = jd.deblur_fused_chunk(
        jnp.asarray(tdb._embed(x.numpy(), nx2, ny2)), jnp.asarray(yv.numpy()),
        jnp.asarray(tdb._embed(q.numpy(), nx2, ny2)),
        jnp.asarray(fb.numpy()), jnp.asarray(sv.numpy()), *tdb.ARGS, ri, nx,
        ny, taps, 0.5, 0.2, interpret=True)
    tdb._close(tuple(cur + prev + [norms2]), ref, nx, ny)


def test_deblur_chunk_inplace_with_the_flag_changes_nothing():
    (x, yv, q, fb, sv), taps = _deblur_inputs(35)
    cur = [t.clone() for t in (x, yv, q)]
    prev = [t + 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    norms2 = td.deblur_chunk_(*cur, *prev, fb, sv,
                              torch.tensor(tdb.ARGS + (1.0,)), 4, _taps(MOTION),
                              0.5, 0.2)
    assert not norms2.any()
    for a, b in zip(cur + prev, before):
        assert torch.equal(a, b)


def test_deblur_inplace_refuses_mismatched_buffers():
    (x, yv, q, fb, sv), taps = _deblur_inputs(36)
    scal = torch.tensor(tdb.ARGS)
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        td.deblur_chunk_(x, yv, q, x, yv[1:], q, fb, sv, scal, 2, taps, 0.5,
                         0.2)


def _deblur_match(nx=20, ny=17):
    prob = tdb.deblur_model(ptt, nx, ny, MOTION)[0].finalize()
    b = tdb._fused(ptt, prob)
    return b.deblur


@pytest.mark.parametrize("converged", [False, True])
def test_deblur_light_call_is_the_inplace_form(converged):
    """``DeblurChunk``, made once per route, on the route's planes: the
    same buffers and norms as ``deblur_chunk_`` with the same scalars."""
    m = _deblur_match()
    (x, yv, q, fb, sv), _ = _deblur_inputs(37, m["nx"], m["ny"])
    call = td.DeblurChunk(m, 4, torch.device("cpu"))
    tau, sigma, theta = (torch.tensor(v) for v in (0.9, 1.1, 1.0))
    flag = torch.tensor(converged)
    cur = [t.clone() for t in (x, yv, q)]
    prev = [t.clone() for t in cur]
    norms2 = call(cur, prev, m["fb"], m["sv"], tau, sigma, theta, flag)
    want_cur = [t.clone() for t in (x, yv, q)]
    want_prev = [t.clone() for t in want_cur]
    scal = torch.tensor([0.9, 1.1, 1.0, m["lmb"], m["radius"],
                         float(converged)])
    want = td.deblur_chunk_(*want_cur, *want_prev, m["fb"], m["sv"], scal, 4,
                            m["taps"], m["sig_q"], m["tau_t"])
    for a, b in zip(cur + prev + [norms2], want_cur + want_prev + [want]):
        assert torch.equal(a, b)
    assert torch.equal(call.scal(), scal)


def test_deblur_light_call_on_a_band_is_the_halo_form():
    """With a band's row context (the lower of 2 shards of the 28-row grid
    of config 2's blur, ri 2: halo 42 rows), ``DeblurChunk`` is
    ``deblur_chunk_halo_``."""
    m = _deblur_match()
    (x, yv, q, fb, sv), _ = _deblur_inputs(38, m["nx"], m["ny"])
    ri, rows = 2, m["nx2"] // 2
    H = td.deblur_halo_rows(ri, m["taps"])
    lo = rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in (x, yv, q, fb, sv)]
    call = td.DeblurChunk(m, ri, torch.device("cpu"),
                          (m["nx"], rows + 2 * H, lo, H, H + rows))
    tau, sigma, theta = (torch.tensor(v) for v in (0.9, 1.1, 1.0))
    cur = [t.clone() for t in ext[:3]]
    prev = [t.clone() for t in cur]
    norms2 = call(cur, prev, *ext[3:], tau, sigma, theta,
                  torch.tensor(False))
    scal = torch.tensor([0.9, 1.1, 1.0, m["lmb"], m["radius"], lo, H,
                         H + rows, 0.0])
    want = td.deblur_chunk_halo(*ext, scal, ri, m["nx"], m["taps"],
                                m["sig_q"], m["tau_t"])
    for a, b in zip(cur + prev + [norms2], want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ri", [1, 4])
def test_ml_chunk_inplace_is_the_functional_and_jax(ri):
    """``ml_chunk_`` leaves the functional wrapper's outputs in the
    caller's buffers, bit for bit; both are the JAX kernel's (interpret
    mode) within the multilabel tolerances."""
    u, q, s, f = tfm._inputs(40 + ri)
    scal = torch.tensor(tfm.ARGS)
    t = [torch.from_numpy(a) for a in (u, q, s, f)]
    want = tml.ml_chunk(*t, scal, ri)
    cur = [a.clone() for a in t[:3]]
    prev = [torch.full_like(a, np.nan) for a in cur]
    norms2 = tml.ml_chunk_(*cur, *prev, t[3], scal, ri)
    for a, b in zip(cur + prev + [norms2], want):
        assert torch.equal(a, b)
    ref = jml.ml_fused_chunk(*map(jnp.asarray, (u, q, s, f)), *tfm.ARGS, ri,
                             interpret=True)
    tfm._close(tuple(cur + prev + [norms2]), ref)


def test_ml_chunk_inplace_with_the_flag_changes_nothing():
    t = [torch.from_numpy(a) for a in tfm._inputs(45)]
    cur = [a.clone() for a in t[:3]]
    prev = [a - 1.0 for a in cur]
    before = [a.clone() for a in cur + prev]
    norms2 = tml.ml_chunk_(*cur, *prev, t[3], torch.tensor(tfm.ARGS + (1.0,)),
                           3)
    assert not norms2.any()
    for a, b in zip(cur + prev, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("band", [False, True])
def test_ml_light_call_is_the_inplace_form(band):
    """``MLChunk`` on the whole plane is ``ml_chunk_``; with a band's row
    context (the top band of 2 shards, ri 3: halo 8 rows) it is
    ``ml_chunk_halo_``."""
    prob, _ = tfm.ml_problem(ptt, tfm.NX, tfm.NY, tfm.L, seed=46)
    m = tfm.TFused(prob, tfm.TOptions(), tfm._sopts(ptt, 0)).ml
    t = [torch.from_numpy(a) for a in tfm._inputs(47)]
    ri = 3
    tau, sigma, theta = (torch.tensor(v) for v in (0.9, 1.1, 1.0))
    head = [0.9, 1.1, 1.0, m["radius"], m["d_s"]]
    if band:
        rows, H = m["nx"] // 2, 2 * ri + 2
        t = [window(a, -H, rows + H) for a in t]
        ctx = (m["nx"], rows + 2 * H, -H, H, H + rows)
        call = tml.MLChunk(m, ri, torch.device("cpu"), ctx)
        want = tml.ml_chunk_halo(*t, torch.tensor(head + [-H, H, H + rows,
                                                          0.0]), ri, m["nx"])
    else:
        call = tml.MLChunk(m, ri, torch.device("cpu"))
        want = tml.ml_chunk(*t, torch.tensor(head + [0.0]), ri)
    cur = [a.clone() for a in t[:3]]
    prev = [a.clone() for a in cur]
    norms2 = call(cur, prev, t[3], tau, sigma, theta, torch.tensor(False))
    for a, b in zip(cur + prev + [norms2], want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the routes, in place on the run's own vectors
# ---------------------------------------------------------------------------

def _split_run(b, stops):
    """``b.run`` from the initial state through the iterations ``stops``,
    each run from the state the last one returned (a solver's callback
    epochs); also checks that no run changed a state it was given."""
    s, start = b.initial_state(), 0
    for stop in stops:
        given = {k: v.clone() for k, v in vars(s).items()}
        new = b.run(s, stop, start)
        for k, v in given.items():
            assert torch.equal(getattr(s, k), v), k
        s, start = new, stop
    return s


def test_deblur_route_across_runs_matches_jax():
    """The deblur route over 60 iterations of boyd with ri 10 in three runs
    (each with its own copies of the state's vectors, which the chunks then
    update in place) against the JAX fused route's one run."""
    jb, tb = (tdb._fused(mod, tdb._model(mod)[0].finalize())
              for mod in (pt, ptt))
    js = jb.run(jb.initial_state(), 60)
    ts = _split_run(tb, (13, 35, 60))
    assert int(ts.iteration) == 60
    tdb._assert_runs_agree(ts, js)


def test_ml_route_across_runs_matches_jax():
    """The multilabel route over 100 iterations of boyd with ri 5 in three
    runs (multichunks and chunks in each) against the JAX fused route's one
    run."""
    popts = dict(stepsize="boyd", residual_iter=5, scale_steps_operator=False)
    jb = tfm.JFused(tfm.ml_problem(pt, tfm.NX, tfm.NY, tfm.L, seed=3)[0],
                    tfm.JOptions(**popts), tfm._sopts(pt, 1e-5),
                    interpret=True)
    tb = tfm.TFused(tfm.ml_problem(ptt, tfm.NX, tfm.NY, tfm.L, seed=3)[0],
                    tfm.TOptions(**popts), tfm._sopts(ptt, 1e-5))
    js = jb.run(jb.initial_state(), 100)
    ts = _split_run(tb, (7, 58, 100))
    tfm._assert_runs_agree(ts, js)
