"""The grid-resident batched volumetric chunk (row 25, ``vol_chunk_batched_``)
and the grid-resident batched deblur chunk (row 18,
``deblur_chunk_batched_``), each running its instances one after another in
one launch, as far as the CPU can check them: the two shape rules for given
SM counts and shared-memory limits and the shared memory they count; the
in-place forms and the routes' light calls (``VolBatchedChunk``,
``DeblurBatchedChunk``) against the functional wrappers (bit for bit: on
the CPU every form runs the same plain version) and against the JAX
batched kernels in interpret mode (f32, at the tolerances of
tests/test_torch_vol.py and tests/test_torch_ensemble_conv.py); and
``BatchedPDHG``'s volumetric and deblur routes, which now update the run's
own state in place, against the JAX routes across several ``run`` calls.

The kernels themselves are held against the launch sequences on the card
by tests/test_torch_cuda_redesign.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_deblur as jd
from prost_tpu.ops import fused_vol as jv
from prost_tpu_torch.ops import fused_deblur as td
from prost_tpu_torch.ops import fused_vol as tv
import test_torch_ensemble as tens
import test_torch_ensemble_conv as tconv
from test_torch_deblur import _close as deblur_close
from test_torch_deblur import asym_kernel, motion_kernel
from test_torch_resident_multi import _split_run

# an H100 SXM: 132 SMs, 227 KB of shared memory a block may opt into (the
# batched deblur kernel's static Taps take 1156 bytes of it)
H100_SMS, H100_SMEM = 132, 232448


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _taps(name):
    kernel = motion_kernel() if name == "motion" else asym_kernel()
    taps = td.kernel_taps(torch.as_tensor(kernel.T, dtype=torch.float32))
    return taps, kernel.shape[0]


# ---------------------------------------------------------------------------
# the shape rules
# ---------------------------------------------------------------------------

# (L, nx, ny, data term, SMs, bytes, resident?): vol256x8's volumes (the
# 8-instance ensemble) with the three data terms, a ragged volume, one
# slice, VOL_LARGE's 512x512x8, 9 labels, half the SMs (bands of 4 rows)
VOL_RULE = [(8, 256, 256, "square", H100_SMS, H100_SMEM, True),
            (8, 256, 256, "wsquare", H100_SMS, H100_SMEM, True),
            (8, 256, 256, "abs", H100_SMS, H100_SMEM, True),
            (5, 190, 250, "wsquare", H100_SMS, H100_SMEM, True),
            (1, 64, 96, "square", H100_SMS, H100_SMEM, True),
            (8, 512, 512, "square", H100_SMS, H100_SMEM, False),
            (9, 16, 16, "square", H100_SMS, H100_SMEM, False),
            (8, 256, 256, "square", 66, H100_SMEM, False),
            (8, 256, 256, "wsquare", H100_SMS, 160000, False)]


@pytest.mark.parametrize("L,nx,ny,dataterm,sms,smem,want", VOL_RULE)
def test_vol_batched_shape_rule(L, nx, ny, dataterm, sms, smem, want):
    """The batched launch runs its volumes one after another on the same
    blocks, so B does not enter the rule: ``resident_ok`` on one volume's
    shape, a block holding one volume's band (``resident_bytes``)."""
    assert tv.resident_ok(L, nx, ny, dataterm, sms, smem) is want
    if L <= tv.MAX_RESIDENT_L:
        fits = tv.resident_bytes(L, nx, ny, sms, dataterm) <= smem
        assert fits is want


def test_vol_resident_bytes_count_the_layout():
    """csrc's VolRes by hand at 256x256x8 over 132 blocks (bands of at most
    2 rows): u and q_x 3 rows of each of 8 labels, q_y, q_l, the three
    carried gradient volumes and f 2 rows (wsquare's w 2 more), 256 wide;
    the reductions' 2048 floats at the least."""
    assert tv.resident_bytes(8, 256, 256, 132) == \
        4 * (2 * 8 * 3 + 6 * 8 * 2) * 256 == 147456
    assert tv.resident_bytes(8, 256, 256, 132, "wsquare") == \
        4 * (2 * 8 * 3 + 7 * 8 * 2) * 256 == 163840
    assert tv.resident_bytes(8, 256, 256, 132, "abs") == 147456
    assert tv.resident_bytes(1, 2, 3, 132) == 4 * 2048


# (blur, nx, ny, SMs, bytes, resident?): deblur8x512's frames (config 2),
# a ragged frame with the asymmetric blur, DB_LARGE's 2048x2048, config 2
# on half the SMs (bands of 8 rows) and on a tenth of them
DEBLUR_RULE = [("motion", 512, 512, H100_SMS, H100_SMEM - 1156, True),
               ("asym", 250, 190, H100_SMS, H100_SMEM - 1156, True),
               ("motion", 2048, 2048, H100_SMS, H100_SMEM - 1156, False),
               ("motion", 512, 512, 66, H100_SMEM - 1156, True),
               ("motion", 512, 512, 13, H100_SMEM - 1156, False)]


@pytest.mark.parametrize("blur,nx,ny,sms,smem,want", DEBLUR_RULE)
def test_deblur_batched_shape_rule(blur, nx, ny, sms, smem, want):
    """``deblur_chunk_batched_`` and ``DeblurBatchedChunk`` take
    ``resident_ok`` on one frame's shape, whatever B."""
    taps, k = _taps(blur)
    nx2, ny2 = nx + k - 1, ny + k - 1
    assert td.resident_ok(nx2, ny, ny2, taps, sms, smem) is want


# (blur, nx, ny, SMs, bytes, two frames a block?): config 2's frames on an
# H100 (230848 bytes beside the staged taps), a ragged frame, config 2 on
# half the SMs, and with 500 bytes less than the card allows
PAIRS_RULE = [("motion", 512, 512, H100_SMS, H100_SMEM - 1156, True),
              ("asym", 250, 190, H100_SMS, H100_SMEM - 1156, True),
              ("motion", 512, 512, 66, H100_SMEM - 1156, False),
              ("motion", 512, 512, H100_SMS, 230348, False)]


@pytest.mark.parametrize("blur,nx,ny,sms,smem,want", PAIRS_RULE)
def test_deblur_pairs_rule(blur, nx, ny, sms, smem, want):
    """Two frames side by side in a block where twice one frame's band
    fits in the block's shared memory (``pairs_ok``)."""
    taps, k = _taps(blur)
    nx2, ny2 = nx + k - 1, ny + k - 1
    assert td.pairs_ok(nx2, ny, ny2, taps, sms, smem) is want


def test_deblur_resident_bytes_count_the_layout():
    """csrc's DBRes at config 2 (520-row yv grid over 132 blocks: bands of
    at most 4 rows, the motion blur's row reach 7): x 4 + 7 + 1 rows, q_x
    5, q_y, g_x, g_y and w_hat 4, 512 wide; yv 4 + 7 rows, bx, fb and sv 4,
    520 wide.  Two frames side by side would need twice that, 230848
    bytes, beside the 1156 of the staged taps."""
    taps, _ = _taps("motion")
    want = 4 * ((12 + 5 + 16) * 512 + (11 + 12) * 520)
    assert td.resident_bytes(520, 512, 520, taps, 132) == want == 115424
    assert 2 * want + 1156 <= H100_SMEM


# ---------------------------------------------------------------------------
# row 25: the in-place batched form and its light call
# ---------------------------------------------------------------------------

B, L, NX, NY = 3, 3, 10, 12


def _vol_batch(seed, flags=None):
    """A route's flat rows x (B, L n) and y (B, 3 L n), f and w (B, L, nx,
    ny), and the (5, B) (+ flags) scalar rows."""
    rng = np.random.RandomState(seed)
    n = L * NX * NY
    x = rng.rand(B, n).astype(np.float32)
    y = (0.3 * rng.randn(B, 3 * n)).astype(np.float32)
    f = rng.rand(B, L, NX, NY).astype(np.float32)
    w = (2.0 * (rng.rand(B, L, NX, NY) > 0.3)).astype(np.float32)
    rows = [0.8 + 0.2 * rng.rand(B), 0.9 + 0.3 * rng.rand(B), np.ones(B),
            4 + 4 * rng.rand(B), 0.5 + rng.rand(B)]
    if flags is not None:
        rows.append(np.asarray(flags, np.float64))
    return x, y, f, w, np.array(rows, np.float32)


def _volumes(x, y):
    return x.view(B, L, NX, NY), y.view(B, 3, L, NX, NY)


@pytest.mark.parametrize("flags", [None, [0.0, 1.0, 0.0]])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_vol_chunk_batched_inplace_is_the_functional_and_jax(dataterm,
                                                             flags):
    """``vol_chunk_batched_`` on views of a route's flat x and y leaves the
    functional wrapper's outputs in the caller's buffers, bit for bit, a
    flagged volume's previous buffers untouched; both are the JAX kernel's
    (interpret mode) within the ensemble tolerances."""
    x, y, f, w, scal = _vol_batch(70, flags)
    t_x, t_y = torch.from_numpy(x), torch.from_numpy(y)
    t_f, t_w, t_scal = (torch.from_numpy(a) for a in (f, w, scal))
    want = tv.vol_chunk_batched(*_volumes(t_x, t_y), t_f, t_w, t_scal, 5,
                                dataterm)
    cur_x, cur_y = t_x.clone(), t_y.clone()
    prev_x, prev_y = torch.full_like(t_x, 7.0), torch.full_like(t_y, 7.0)
    norms2 = tv.vol_chunk_batched_(*_volumes(cur_x, cur_y),
                                   *_volumes(prev_x, prev_y), t_f, t_w,
                                   t_scal, 5, dataterm)
    got = list(_volumes(cur_x, cur_y)) + list(_volumes(prev_x, prev_y))
    for b in range(B):
        if flags and flags[b]:
            for a in got[2:]:
                assert torch.all(a[b] == 7.0)
            for a, v in zip(got[:2], want[:2]):
                assert torch.equal(a[b], v[b])
            assert not norms2[:, b].any()
            continue
        for a, v in zip(got, want[:4]):
            assert torch.equal(a[b], v[b])
        assert torch.equal(norms2[:, b], want[4][:, b])
    if flags is None:
        ref = jv.vol_fused_chunk_batched(
            *map(jnp.asarray, (x.reshape(B, L, NX, NY),
                               y.reshape(B, 3, L, NX, NY), f, w, scal)), 5,
            dataterm=dataterm, interpret=True)
        tens._close(tuple(got) + (norms2,), ref, 4)


def test_vol_chunk_batched_inplace_refuses_mismatched_buffers():
    x, y, f, w, scal = _vol_batch(71)
    u, q = _volumes(torch.from_numpy(x), torch.from_numpy(y))
    args = (torch.from_numpy(f), torch.from_numpy(w), torch.from_numpy(scal),
            2)
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        tv.vol_chunk_batched_(u, q, u, q[:, 1:], *args)
    wide = torch.zeros(B, 2 * L * NX * NY)[:, :L * NX * NY].view(B, L, NX,
                                                                  NY)
    with pytest.raises(ptt.ProstError, match="space their instances"):
        tv.vol_chunk_batched_(u, q, wide, q.clone(), *args)
    one = u[:1].expand(B, -1, -1, -1)
    with pytest.raises(ptt.ProstError, match="overlap"):
        tv.vol_chunk_batched_(one, q, one, q.clone(), *args)
    with pytest.raises(ptt.ProstError, match="Unknown volumetric data term"):
        tv.vol_chunk_batched_(u, q, u.clone(), q.clone(), *args, "huber")


@pytest.mark.parametrize("dataterm,converged", [("square", False),
                                                ("wsquare", False),
                                                ("abs", True)])
def test_vol_batched_light_call_is_the_inplace_form(dataterm, converged):
    """``VolBatchedChunk``, made once per route from the route's match
    (every volume's lmb and radius), on the route's views: the same buffers
    and norms as ``vol_chunk_batched_`` with the same scalars, twice in a
    row (its scalar buffer reused), the flag set for every volume."""
    x, y, f, w, scal = _vol_batch(72)
    m = {"L": L, "nx": NX, "ny": NY, "dataterm": dataterm,
         "lmb": torch.from_numpy(scal[3]), "radius": torch.from_numpy(scal[4])}
    call = tv.VolBatchedChunk(m, B, 3, torch.device("cpu"))
    assert call.resident is None
    tau, sigma, theta = (torch.from_numpy(scal[k]) for k in range(3))
    t_f, t_w = torch.from_numpy(f), torch.from_numpy(w)
    cur = [torch.from_numpy(x).clone(), torch.from_numpy(y).clone()]
    prev = [a.clone() for a in cur]
    want_cur = [a.clone() for a in cur]
    want_prev = [a.clone() for a in cur]
    full = torch.from_numpy(np.concatenate(
        [scal, np.full((1, B), float(converged), np.float32)]))
    for _ in range(2):
        norms2 = call(_volumes(*cur), _volumes(*prev), t_f, t_w, tau, sigma,
                      theta, torch.tensor(converged))
        want = tv.vol_chunk_batched_(*_volumes(*want_cur),
                                     *_volumes(*want_prev), t_f, t_w, full, 3,
                                     dataterm)
        for a, b in zip(cur + prev + [norms2], want_cur + want_prev + [want]):
            assert torch.equal(a, b)
    assert torch.equal(call.scal(), full)


# ---------------------------------------------------------------------------
# row 18: the in-place batched form and its light call
# ---------------------------------------------------------------------------

DNX, DNY = 10, 9


def _deblur_batch(seed, blur, flags=None):
    """A route's flat rows x (B, n) and y (B, m2 + 2 n), fb and sv (B, nx2,
    ny2), the (5, B) (+ flags) scalar rows and the taps."""
    taps, k = _taps(blur)
    nx2, ny2 = DNX + k - 1, DNY + k - 1
    n, m2 = DNX * DNY, nx2 * ny2
    rng = np.random.RandomState(seed)
    x = rng.rand(B, n).astype(np.float32)
    y = np.concatenate([rng.randn(B, m2), 0.3 * rng.randn(B, 2 * n)],
                       1).astype(np.float32)
    fb = rng.rand(B, nx2, ny2).astype(np.float32)
    sv = (0.5 + rng.rand(B, nx2, ny2)).astype(np.float32)
    scal = tconv._scal(rng, B, 40.0, 1.0)
    if flags is not None:
        scal = np.concatenate([scal, np.asarray([flags], np.float32)])
    return x, y, fb, sv, scal, taps, (nx2, ny2)


def _frames(x, y, nx2, ny2):
    m2 = nx2 * ny2
    return (x.view(B, DNX, DNY), y[:, :m2].view(B, nx2, ny2),
            y[:, m2:].view(B, 2, DNX, DNY))


@pytest.mark.parametrize("flags", [None, [1.0, 0.0, 0.0]])
@pytest.mark.parametrize("blur", ["motion", "asym"])
def test_deblur_chunk_batched_inplace_is_the_functional_and_jax(blur, flags):
    """``deblur_chunk_batched_`` on views of a route's flat x and y (yv
    and q share a row) leaves the functional wrapper's outputs in the
    caller's buffers, bit for bit, a flagged frame's previous buffers
    untouched; each frame is the JAX kernel's (interpret mode, embedded
    planes) within the deblur tolerances.  Config 2's motion blur (row
    reach 7 on a 10-row image) and the asymmetric 5x5 one."""
    x, y, fb, sv, scal, taps, (nx2, ny2) = _deblur_batch(73, blur, flags)
    t_x, t_y = torch.from_numpy(x), torch.from_numpy(y)
    data = [torch.from_numpy(a) for a in (fb, sv, scal)]
    extra = (4, taps, 0.5, 0.2)
    want = td.deblur_chunk_batched(
        *[v.contiguous() for v in _frames(t_x, t_y, nx2, ny2)], *data,
        *extra)
    cur_x, cur_y = t_x.clone(), t_y.clone()
    prev_x, prev_y = torch.full_like(t_x, 7.0), torch.full_like(t_y, 7.0)
    norms2 = td.deblur_chunk_batched_(*_frames(cur_x, cur_y, nx2, ny2),
                                      *_frames(prev_x, prev_y, nx2, ny2),
                                      *data, *extra)
    got = (list(_frames(cur_x, cur_y, nx2, ny2))
           + list(_frames(prev_x, prev_y, nx2, ny2)))
    for b in range(B):
        if flags and flags[b]:
            for a in got[3:]:
                assert torch.all(a[b] == 7.0)
            for a, v in zip(got[:3], want[:3]):
                assert torch.equal(a[b], v[b])
            assert not norms2[:, b].any()
            continue
        for a, v in zip(got, want[:6]):
            assert torch.equal(a[b], v[b])
        assert torch.equal(norms2[:, b], want[6][:, b])
    if flags is None:
        xs, yvs, qs = (v.numpy() for v in _frames(t_x, t_y, nx2, ny2))
        pad = ((0, 0), (0, nx2 - DNX), (0, ny2 - DNY))
        ref = jd.deblur_fused_chunk_batched(
            jnp.asarray(np.pad(xs, pad)), jnp.asarray(yvs),
            jnp.asarray(np.pad(qs, ((0, 0),) + pad)), jnp.asarray(fb),
            jnp.asarray(sv), jnp.asarray(scal), 4, DNX, DNY, taps, 0.5, 0.2,
            interpret=True)
        out = tuple(got) + (norms2,)
        for b in range(B):
            deblur_close(tconv._instance(out, b, 6),
                         tconv._instance(ref, b, 6), DNX, DNY)


def test_deblur_chunk_batched_inplace_refuses_mismatched_buffers():
    x, y, fb, sv, scal, taps, (nx2, ny2) = _deblur_batch(74, "asym")
    st = _frames(torch.from_numpy(x), torch.from_numpy(y), nx2, ny2)
    data = [torch.from_numpy(a) for a in (fb, sv, scal)]
    extra = (2, taps, 0.5, 0.2)
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        td.deblur_chunk_batched_(*st, st[0], st[1][:, 1:], st[2], *data,
                                 *extra)
    yv_own = st[1].contiguous()
    with pytest.raises(ptt.ProstError, match="space their instances"):
        td.deblur_chunk_batched_(*st, st[0].clone(), yv_own, st[2].clone(),
                                 *data, *extra)
    with pytest.raises(ptt.ProstError, match="taps"):
        td.deblur_chunk_batched_(*st, *[t.clone() for t in st], *data, 2,
                                 (), 0.5, 0.2)


@pytest.mark.parametrize("converged", [False, True])
def test_deblur_batched_light_call_is_the_inplace_form(converged):
    """``DeblurBatchedChunk``, made once per route from the route's match
    (the taps, sig_q, tau_t and every frame's lmb and radius), on the
    route's views: the same buffers and norms as ``deblur_chunk_batched_``
    with the same scalars, twice in a row, the flag set for every
    frame."""
    x, y, fb, sv, scal, taps, (nx2, ny2) = _deblur_batch(75, "motion")
    m = {"nx": DNX, "ny": DNY, "nx2": nx2, "ny2": ny2, "taps": taps,
         "sig_q": 0.5, "tau_t": 0.2, "lmb": torch.from_numpy(scal[3]),
         "radius": torch.from_numpy(scal[4])}
    call = td.DeblurBatchedChunk(m, B, 3, torch.device("cpu"))
    assert call.resident is None
    tau, sigma, theta = (torch.from_numpy(scal[k]) for k in range(3))
    t_fb, t_sv = torch.from_numpy(fb), torch.from_numpy(sv)
    cur = [torch.from_numpy(x).clone(), torch.from_numpy(y).clone()]
    prev = [a.clone() for a in cur]
    want_cur = [a.clone() for a in cur]
    want_prev = [a.clone() for a in cur]
    full = torch.from_numpy(np.concatenate(
        [scal, np.full((1, B), float(converged), np.float32)]))
    for _ in range(2):
        norms2 = call(_frames(*cur, nx2, ny2), _frames(*prev, nx2, ny2),
                      t_fb, t_sv, tau, sigma, theta, torch.tensor(converged))
        want = td.deblur_chunk_batched_(
            *_frames(*want_cur, nx2, ny2), *_frames(*want_prev, nx2, ny2),
            t_fb, t_sv, full, 3, taps, 0.5, 0.2)
        for a, b in zip(cur + prev + [norms2], want_cur + want_prev + [want]):
            assert torch.equal(a, b)
    assert torch.equal(call.scal(), full)


# ---------------------------------------------------------------------------
# the routes, in place on the run's own state
# ---------------------------------------------------------------------------

def test_batched_vol_route_across_runs_matches_jax():
    """``BatchedPDHG``'s volumetric route (three 12x12x3 volumes, boyd, ri
    5) over 31 iterations in three runs, each with its own copies of the
    state's vectors, which the light call then updates in place, against
    the JAX BatchedPDHG's one run in interpret mode."""
    tb = tens._batched(ptt, tens._vol_probs(ptt), 5)
    jb = tens._batched(pt, tens._vol_probs(pt), 5)
    assert tb.vol is not None and jb.vol is not None
    ts = _split_run(tb, (8, 19, 31))
    js = tens._run(jb, 31)
    assert isinstance(tb.vol["call"], tv.VolBatchedChunk)
    np.testing.assert_array_equal(ts.iteration.numpy(), 31)
    tens._assert_states(ts, js, tens.RUN_ATOL)
    for a, b in zip(tb.current_solution(ts), jb.current_solution(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=tens.SOL_ATOL)


def test_batched_deblur_route_across_runs_matches_jax():
    """``BatchedPDHG``'s deblur route (tests/test_parallel.py's three 12x12
    frames of one 5x5 blur, ri 5) over 31 iterations in three runs, in
    place through the light call on each run's own vectors, against the
    JAX BatchedPDHG's one run in interpret mode, at the deblur route's
    tolerances (scaled by the blur dual's size)."""
    build, ri, until = tconv.CONV["deblur"]
    tb, jb = tens._batched(ptt, build(ptt), ri), tens._batched(pt, build(pt),
                                                               ri)
    assert tb.deblur is not None and jb.deblur is not None
    ts = _split_run(tb, (6, 17, until))
    js = tens._run(jb, until)
    assert isinstance(tb.deblur["call"], td.DeblurBatchedChunk)
    np.testing.assert_array_equal(ts.iteration.numpy(), until)
    tens._assert_states(ts, js, tens.RUN_ATOL, fields=())
    pairs = [(getattr(ts, k), getattr(js, k), tens.RUN_ATOL)
             for k in ("x", "y")]
    pairs += [(a, b, tens.SOL_ATOL) for a, b in zip(tb.current_solution(ts),
                                                    jb.current_solution(js))]
    for i, (a, b, atol) in enumerate(pairs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, err_msg=str(i),
                                   atol=atol * max(1.0, np.abs(b).max()))
