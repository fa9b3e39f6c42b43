"""The grid-resident chunks of rows 20 (tight) and 23-24 (volumetric), as
far as the CPU can check them: the shape rules that send a chunk to the
grid-resident launch or to the streaming launch sequence, for given SM
counts and shared-memory limits, and the bytes they count; the in-place
forms ``tight_chunk_``, ``tight_chunk_halo_``, ``vol_chunk_`` and
``vol_chunk_halo_`` and the routes' light calls (``TightChunk``,
``VolChunk``) against the functional wrappers (bit for bit: on the CPU
every form runs the same plain version) and against the JAX kernels in
interpret mode (f32, the tolerances of tests/test_torch_tight.py and
tests/test_torch_vol.py); the two fused routes, which now update the run's
own vectors in place, against the JAX fused routes across several ``run``
calls; and ``ShardedFusedTight`` and ``ShardedFusedVol``, which now call
the light calls on their bands, on one and two gloo ranks against the
one-card route.

The kernels themselves are held against the streaming sequence on the
card by tests/test_torch_cuda_redesign.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_tight as jt
from prost_tpu.ops import fused_vol as jv
from prost_tpu_torch.backend import PDHGOptions as TOptions
from prost_tpu_torch.ops import FusedROFPDHG as TFused
from prost_tpu_torch.ops import fused_tight as tt
from prost_tpu_torch.ops import fused_vol as tv
from prost_tpu_torch.parallel.spatial_fused import window
import test_torch_tight as ttt
import test_torch_vol as ttv
import torch_spatial_worker as worker

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into (neither resident kernel holds static shared memory)
H100_SMS, H100_SMEM = 132, 232448


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _tight_taps(L):
    k = L * (L - 1) // 2
    pt_ = ttt.pair_matrix(L).T
    return tuple((r, m, float(pt_[r, m])) for r in range(2 * L)
                 for m in range(2 * k) if pt_[r, m] != 0.0)


# ---------------------------------------------------------------------------
# the shape rules
# ---------------------------------------------------------------------------

# (L, rows, ny, SMs, bytes, resident?): tight128x4 and its one-shard halo
# band (128 + 2 x 22 rows), 250x190x3, the route at 512x512x4, and the
# same on half the SMs or a 48 KB budget
TIGHT_RULE = [(4, 128, 128, H100_SMS, H100_SMEM, True),
              (4, 172, 128, H100_SMS, H100_SMEM, True),
              (3, 250, 190, H100_SMS, H100_SMEM, True),
              (4, 512, 512, H100_SMS, H100_SMEM, False),
              (4, 172, 128, 66, H100_SMEM, True),
              (4, 172, 128, H100_SMS, 48 * 1024, False)]


@pytest.mark.parametrize("L,nx,ny,sms,smem,want", TIGHT_RULE)
def test_tight_shape_rule(L, nx, ny, sms, smem, want):
    k, taps = L * (L - 1) // 2, _tight_taps(L)
    assert len(taps) == 4 * k
    assert tt.resident_ok(L, k, len(taps), nx, ny, sms, smem) is want


# (L, rows, ny, data term, SMs, bytes, resident?): vol256x8 and its
# one-shard halo band (256 + 2 x 22 rows), which fits with square and abs
# and streams with wsquare's weights; 512x512x8; 9 labels (beyond the
# unrolled loops); the ragged 190x250x5 volume
VOL_RULE = [(8, 256, 256, "square", H100_SMS, H100_SMEM, True),
            (8, 300, 256, "square", H100_SMS, H100_SMEM, True),
            (8, 300, 256, "abs", H100_SMS, H100_SMEM, True),
            (8, 300, 256, "wsquare", H100_SMS, H100_SMEM, False),
            (8, 512, 512, "square", H100_SMS, H100_SMEM, False),
            (9, 16, 16, "square", H100_SMS, H100_SMEM, False),
            (5, 190, 250, "wsquare", H100_SMS, H100_SMEM, True)]


@pytest.mark.parametrize("L,nx,ny,dataterm,sms,smem,want", VOL_RULE)
def test_vol_shape_rule(L, nx, ny, dataterm, sms, smem, want):
    assert tv.resident_ok(L, nx, ny, dataterm, sms, smem) is want


def test_resident_bytes_count_the_layout():
    """csrc's layouts by hand: TightRes at tight128x4 over 132 blocks
    (bands of 1 row): u and q (3L planes) 2 rows, v, p (2k each), kxq (2L),
    f (L), s and su 1 row, and the taps array (2L + 2k + 2 + 4T floats);
    its halo band of 172 rows (bands of 2); VolRes on the 300-row band of
    vol256x8 (bands of 3): u and q_x 4 rows, q_y, q_l, g_x, g_y, g_l, f (and
    wsquare's w) 3 rows of 8 planes."""
    taps = 2 * 4 + 2 * 6 + 2 + 4 * 24
    assert tt.resident_bytes(4, 6, 24, 128, 128, 132) == \
        4 * ((12 * 2 + (24 + 12 + 2) * 1) * 128 + taps)
    assert tt.resident_bytes(4, 6, 24, 172, 128, 132) == \
        4 * ((12 * 3 + (24 + 12 + 2) * 2) * 128 + taps)
    assert tv.resident_bytes(8, 300, 256, 132) == \
        (2 * 8 * 4 + 6 * 8 * 3) * 256 * 4 == 212992
    assert tv.resident_bytes(8, 300, 256, 132, "wsquare") == 237568
    assert tv.resident_bytes(8, 256, 256, 132) == 147456
    assert tt.resident_bytes(2, 1, 4, 2, 2, 132) == 4 * 4 * 512


# ---------------------------------------------------------------------------
# the in-place forms and the light calls
# ---------------------------------------------------------------------------

def _tight(seed, L, nx, ny):
    """The matched model's taps and constants, and a chunk's state and f
    (torch, from numpy seeds)."""
    m = ttt._matched(L, nx, ny)
    state = [torch.from_numpy(a) for a in ttt._chunk_inputs(seed, L, nx, ny)]
    return m, state, torch.from_numpy(m["f"])


def _head(m, keys):
    return [0.9, 1.1, 1.0] + [m[k] for k in keys]


def _equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,nx,ny,ri", [(3, 13, 9, 1), (4, 10, 12, 3)])
def test_tight_chunk_inplace_is_the_functional_and_jax(L, nx, ny, ri):
    """``tight_chunk_`` leaves the functional wrapper's state and previous
    iterate in the caller's buffers and returns its norms, bit for bit; both
    are the JAX kernel's (interpret mode) within the tight tolerances."""
    m, state, f = _tight(50 + ri, L, nx, ny)
    head = _head(m, ("radius", "d_s"))
    scal = torch.tensor(head)
    want = tt.tight_chunk(*state, f, scal, ri, m["taps"], m["consts"])
    cur = [t.clone() for t in state]
    prev = [torch.full_like(t, np.nan) for t in cur]
    norms2 = tt.tight_chunk_(*cur, *prev, f, scal, ri, m["taps"], m["consts"])
    _equal(cur + prev + [norms2], want)
    new, old, norms = jt.tight_fused_chunk(
        *[jnp.asarray(t.numpy()) for t in state], jnp.asarray(m["f"]), *head,
        ri, m["taps"], m["consts"], interpret=True)
    ttt._close(tuple(cur + prev + [norms2]), new, old, norms)


def test_tight_chunk_inplace_with_the_flag_changes_nothing():
    m, state, f = _tight(55, 3, 8, 7)
    cur = [t.clone() for t in state]
    prev = [t + 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    scal = torch.tensor(_head(m, ("radius", "d_s")) + [1.0])
    norms2 = tt.tight_chunk_(*cur, *prev, f, scal, 4, m["taps"], m["consts"])
    assert not norms2.any()
    _equal(cur + prev, before)


def _owned(planes, ctx):
    """The owned rows (axis -2) of each of ``planes`` (the JAX halo
    kernels are held to the port's on the owned rows, as in
    tests/test_torch_spatial_conv.py)."""
    _, lo, hi = ctx
    return [np.asarray(a)[..., lo:hi, :] for a in planes]


def _bands(state, f, ri, rank, shards=2):
    """Rank ``rank``'s halo-extended band of 2 shards: (ext state, ext f,
    row context (row_offset, own_lo, own_hi), nx_global)."""
    nxg = state[0].shape[-2]
    rows, H = nxg // shards, 2 * ri + 2
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in state]
    fe = [window(a, lo, lo + rows + 2 * H) for a in f]
    return ext, fe, (lo, H, H + rows), nxg


@pytest.mark.parametrize("rank", [0, 1])
def test_tight_halo_inplace_is_the_functional_and_jax(rank):
    """``tight_chunk_halo_`` on each band of two shards of a 20-row plane
    (ri 2, halo 6) is ``tight_chunk_halo`` bit for bit, and the JAX halo
    kernel's (interpret mode) on the owned rows within the tight
    tolerances."""
    ri = 2
    m, state, f = _tight(57, 3, 20, 9)
    ext, (fe,), ctx, nxg = _bands(state, [f], ri, rank)
    head = _head(m, ("radius", "d_s")) + list(ctx)
    scal = torch.tensor(head)
    want = tt.tight_chunk_halo(*ext, fe, scal, ri, nxg, m["taps"],
                               m["consts"])
    cur = [t.clone() for t in ext]
    prev = [torch.full_like(t, np.nan) for t in cur]
    norms2 = tt.tight_chunk_halo_(*cur, *prev, fe, scal, ri, nxg, m["taps"],
                                  m["consts"])
    _equal(cur + prev + [norms2], want)
    new, old, norms = jt.tight_fused_chunk_halo(
        *[jnp.asarray(t.numpy()) for t in ext], jnp.asarray(fe.numpy()),
        jnp.asarray(head, dtype=jnp.float32), ri, nxg, m["taps"],
        m["consts"], interpret=True)
    got = [torch.from_numpy(a) for a in _owned(cur + prev, ctx)]
    ttt._close(tuple(got + [norms2]), _owned(new, ctx), _owned(old, ctx),
               norms)


@pytest.mark.parametrize("band", [False, True])
def test_tight_light_call_is_the_inplace_form(band):
    """``TightChunk`` on the whole plane is ``tight_chunk_``; with a band's
    row context (the lower of 2 shards, ri 3: halo 8 rows) it is
    ``tight_chunk_halo_``; its scalars are the call's."""
    ri = 3
    m, state, f = _tight(58, 3, 20, 9)
    tau, sigma, theta = (torch.tensor(v) for v in (0.9, 1.1, 1.0))
    head = _head(m, ("radius", "d_s"))
    if band:
        state, (f,), ctx, nxg = _bands(state, [f], ri, 1)
        call = tt.TightChunk(m, ri, torch.device("cpu"),
                             (nxg, state[0].shape[1], *ctx))
        scal = torch.tensor(head + list(ctx) + [0.0])
        want_cur = [t.clone() for t in state]
        want_prev = [t.clone() for t in state]
        want = tt.tight_chunk_halo_(*want_cur, *want_prev, f, scal, ri, nxg,
                                    m["taps"], m["consts"])
    else:
        call = tt.TightChunk(m, ri, torch.device("cpu"))
        scal = torch.tensor(head + [0.0])
        want_cur = [t.clone() for t in state]
        want_prev = [t.clone() for t in state]
        want = tt.tight_chunk_(*want_cur, *want_prev, f, scal, ri, m["taps"],
                               m["consts"])
    cur = [t.clone() for t in state]
    prev = [t.clone() for t in state]
    norms2 = call(cur, prev, f, tau, sigma, theta, torch.tensor(False))
    _equal(cur + prev + [norms2], want_cur + want_prev + [want])
    assert torch.equal(call.scal(), scal)


def _vol(seed, L, nx, ny, clean=False):
    return [torch.from_numpy(a)
            for a in ttv._chunk_inputs(seed, L, nx, ny, clean)]


@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_vol_chunk_inplace_is_the_functional_and_jax(dataterm):
    """``vol_chunk_`` on a ragged 10x9x3 volume with mass on the dead dual
    coordinates (ri 4) is ``vol_chunk`` bit for bit, and the JAX kernel's
    (interpret mode) within the volumetric tolerances."""
    u, q, f, w = _vol(61, 3, 10, 9)
    scal = torch.tensor(ttv.ARGS)
    want = tv.vol_chunk(u, q, f, w, scal, 4, dataterm)
    cur = [u.clone(), q.clone()]
    prev = [torch.full_like(t, np.nan) for t in cur]
    norms2 = tv.vol_chunk_(*cur, *prev, f, w, scal, 4, dataterm)
    _equal(cur + prev + [norms2], want)
    ref = jv.vol_fused_chunk(*[jnp.asarray(t.numpy()) for t in (u, q, f, w)],
                             *ttv.ARGS, 4, dataterm=dataterm, interpret=True)
    ttv._close(tuple(cur + prev + [norms2]), ref)


def test_vol_chunk_inplace_with_the_flag_changes_nothing():
    u, q, f, w = _vol(62, 2, 8, 7)
    cur = [u.clone(), q.clone()]
    prev = [t - 1.0 for t in cur]
    before = [t.clone() for t in cur + prev]
    norms2 = tv.vol_chunk_(*cur, *prev, f, w,
                           torch.tensor(ttv.ARGS + (1.0,)), 3)
    assert not norms2.any()
    _equal(cur + prev, before)


@pytest.mark.parametrize("rank", [0, 1])
def test_vol_halo_inplace_is_the_functional_and_jax(rank):
    """``vol_chunk_halo_`` on each band of two shards of a 20-row volume
    (ri 2, halo 6; an edge shard's rows beyond the volume are zeros) is
    ``vol_chunk_halo`` bit for bit, and the JAX halo kernel's (interpret
    mode) on the owned rows within the volumetric tolerances, from a
    canonical q as the sharded routes hand it over (the JAX halo kernel
    does not zero the dead coordinates)."""
    ri = 2
    u, q, f, w = _vol(63, 3, 20, 9, clean=True)
    (eu, eq), (ef, ew), ctx, nxg = _bands([u, q], [f, w], ri, rank)
    head = list(ttv.ARGS) + list(ctx)
    scal = torch.tensor(head)
    want = tv.vol_chunk_halo(eu, eq, ef, ew, scal, ri, nxg, "abs")
    cur = [eu.clone(), eq.clone()]
    prev = [torch.full_like(t, np.nan) for t in cur]
    norms2 = tv.vol_chunk_halo_(*cur, *prev, ef, ew, scal, ri, nxg, "abs")
    _equal(cur + prev + [norms2], want)
    ref = jv.vol_fused_chunk_halo(
        *[jnp.asarray(t.numpy()) for t in (eu, eq, ef, ew)],
        jnp.asarray(head, dtype=jnp.float32), ri, nxg, "abs",
        interpret=True)
    got = [torch.from_numpy(a) for a in _owned(cur + prev, ctx)]
    ttv._close(tuple(got + [norms2]), _owned(ref[:4], ctx) + [ref[4]])


def _vol_match(L=3, nx=20, ny=9):
    f = np.random.RandomState(64).rand(L * nx * ny)
    prob = ttv.vol_model(ptt, nx, ny, L, f, 6.0)[0].finalize()
    m = tv.match_vol_structure(prob)
    assert m is not None
    return m


@pytest.mark.parametrize("band", [False, True])
def test_vol_light_call_is_the_inplace_form(band):
    """``VolChunk`` on the whole volume is ``vol_chunk_``; with a band's
    row context (the upper of 2 shards, ri 3: halo 8 rows) it is
    ``vol_chunk_halo_``."""
    ri = 3
    m = _vol_match()
    u, q, _, _ = _vol(65, 3, 20, 9)
    state, data = [u, q], [m["f"], m["w"]]
    tau, sigma, theta = (torch.tensor(v) for v in (0.9, 1.1, 1.0))
    head = _head(m, ("lmb", "radius"))
    want_cur = [t.clone() for t in state]
    want_prev = [t.clone() for t in state]
    if band:
        state, data, ctx, nxg = _bands(state, data, ri, 0)
        want_cur = [t.clone() for t in state]
        want_prev = [t.clone() for t in state]
        call = tv.VolChunk(m, ri, torch.device("cpu"),
                           (nxg, state[0].shape[1], *ctx))
        scal = torch.tensor(head + list(ctx) + [0.0])
        want = tv.vol_chunk_halo_(*want_cur, *want_prev, *data, scal, ri,
                                  nxg, m["dataterm"])
    else:
        call = tv.VolChunk(m, ri, torch.device("cpu"))
        scal = torch.tensor(head + [0.0])
        want = tv.vol_chunk_(*want_cur, *want_prev, *data, scal, ri,
                             m["dataterm"])
    cur = [t.clone() for t in state]
    prev = [t.clone() for t in state]
    norms2 = call(cur, prev, *data, tau, sigma, theta, torch.tensor(False))
    _equal(cur + prev + [norms2], want_cur + want_prev + [want])
    assert torch.equal(call.scal(), scal)


def test_inplace_forms_refuse_bad_buffers():
    m, state, f = _tight(66, 3, 8, 7)
    scal = torch.tensor(_head(m, ("radius", "d_s")))
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        tt.tight_chunk_(*state, *state[:4], state[4][1:], f, scal, 2,
                        m["taps"], m["consts"])
    u, q, fv, w = _vol(67, 2, 8, 7)
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        tv.vol_chunk_(u, q, u, q[:2], fv, w, torch.tensor(ttv.ARGS), 2)
    strided = u.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ptt.ProstError, match="contiguous"):
        tv.vol_chunk_(strided, q, strided.clone(), q.clone(), fv, w,
                      torch.tensor(ttv.ARGS), 2)


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


def test_tight_route_across_runs_matches_jax():
    """The tight route over 60 iterations of boyd with ri 10 in three runs
    (each with its own copies of the state's vectors, which the chunks then
    update in place through ``TightChunk``) against the JAX fused route's
    one run."""
    jb, tb = (ttt._fused(mod, ttt._model(mod)[0].finalize())
              for mod in (pt, ptt))
    js = jb.run(jb.initial_state(), 60)
    ts = _split_run(tb, (13, 35, 60))
    assert isinstance(tb.tight["call"], tt.TightChunk)
    assert int(ts.iteration) == 60
    ttt._assert_runs_agree(ts, js)


def test_vol_route_across_runs_matches_jax():
    """The volumetric route over 130 iterations of boyd with ri 10 in three
    runs (a multichunk and a chunk in the first, a chunk in the second,
    generic steps in the third; the chunks through ``VolChunk``) against
    the JAX fused route's one run."""
    jb, tb = (ttv._fused(mod, ttv._model(mod)[0].finalize())
              for mod in (pt, ptt))
    js = jb.run(jb.initial_state(), 130)
    ts = _split_run(tb, (95, 120, 130))
    assert isinstance(tb.vol["call"], tv.VolChunk)
    assert int(ts.iteration) == 130
    ttv._assert_runs_agree(ts, js)


# ---------------------------------------------------------------------------
# the sharded routes through the light calls
# ---------------------------------------------------------------------------

SHARD_RI, SHARD_ITERS = 5, 60


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The sharded tight and volumetric routes (the worker's problems, 64
    rows, ri 5: halo 12) on 1 and 2 gloo ranks: {world: per-rank results}."""
    jobs = {k: ("route", dict(kind=k, ri=SHARD_RI, iters=SHARD_ITERS))
            for k in ("tight", "vol")}
    out = {}
    for world in (1, 2):
        init = tmp_path_factory.mktemp(f"pg{world}") / "pg"
        out[world] = worker.run_ranks(world, jobs, str(init))
    return out


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("kind", ["tight", "vol"])
def test_sharded_route_through_the_light_call_is_the_one_card_route(
        sharded, world, kind):
    """Every rank's gathered state after 60 iterations equals the one-card
    fused route's within the whole-run tolerance (the owned rows' norms
    sum in another order), each rank ran its chunks through the light
    call, and the ranks agree."""
    opts = TOptions(stepsize="boyd", residual_iter=SHARD_RI,
                    scale_steps_operator=False)
    b = TFused(worker.problem(kind), opts, worker.solver_opts())
    one = b.run(b.initial_state(), SHARD_ITERS, 0)
    ranks = sharded[world]
    want = {"tight": "TightChunk", "vol": "VolChunk"}[kind]
    for res in ranks:
        st = res[kind]["state"]
        assert res[kind]["light"] == want
        assert int(st["iteration"]) == SHARD_ITERS
        for name in ("x", "y", "x_prev", "y_prev"):
            np.testing.assert_allclose(st[name], getattr(one, name).numpy(),
                                       atol=ttt.RUN_ATOL, err_msg=name)
            assert np.array_equal(st[name], ranks[0][kind]["state"][name])
