"""The grid-resident batched tight chunk (row 21, ``tight_chunk_batched_``),
which runs its instances side by side in one launch, each on its own group
of blocks, as far as the CPU can check it: the batched shape rule for given
SM counts and shared-memory limits and the shared memory it counts; the
in-place form and ``BatchedPDHG``'s light call (``TightBatchedChunk``)
against the functional wrapper (bit for bit: on the CPU every form runs the
same plain version) and against the JAX batched kernel in interpret mode
(f32, at the tolerances of tests/test_torch_ensemble_conv.py); a row of
flags; and ``BatchedPDHG``'s tight route, which now updates the run's own
state in place, against the JAX route across several ``run`` calls.

The kernel itself is held against the launch sequence on the card by
tests/test_torch_cuda_redesign.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_tight as jt
from prost_tpu_torch.ops import fused_tight as tt
import test_torch_ensemble as tens
import test_torch_ensemble_conv as tconv
from test_torch_resident_multi import _split_run
from test_torch_tight import _close as tight_close
from test_torch_tight import tight_model

# an H100 SXM: 132 SMs, 227 KB of shared memory a block may opt into
H100_SMS, H100_SMEM = 132, 232448


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


# ---------------------------------------------------------------------------
# the batched shape rule
# ---------------------------------------------------------------------------

# (B, L, nx, ny, SMs, bytes, resident?): tight8x128x4's ensemble (16 blocks
# an instance, 8-row bands), one instance, 9 instances (14 blocks, 10-row
# bands: 262616 bytes), 16 (8 blocks, 16-row bands), one instance a block,
# more instances than SMs, a limit a byte under what B = 8 needs, a ragged
# ensemble of 250x190x3 (44 blocks, 6-row bands), and 2 instances on half
# the SMs
TIGHT_RULE = [(8, 4, 128, 128, H100_SMS, H100_SMEM, True),
              (1, 4, 128, 128, H100_SMS, H100_SMEM, True),
              (9, 4, 128, 128, H100_SMS, H100_SMEM, False),
              (16, 4, 128, 128, H100_SMS, H100_SMEM, False),
              (132, 4, 128, 128, H100_SMS, H100_SMEM, False),
              (200, 4, 128, 128, H100_SMS, H100_SMEM, False),
              (200, 3, 4, 4, H100_SMS, H100_SMEM, False),
              (8, 4, 128, 128, H100_SMS, 211415, False),
              (3, 3, 250, 190, H100_SMS, H100_SMEM, True),
              (2, 4, 128, 128, 66, H100_SMEM, True)]


def _taps(L):
    """The example's taps of P^T for L labels and k."""
    m = tt.match_tight_structure(tight_model(ptt, 4, 4, L)[0].finalize())
    return m["taps"], m["k"]


@pytest.mark.parametrize("B,L,nx,ny,sms,smem,want", TIGHT_RULE)
def test_tight_batched_shape_rule(B, L, nx, ny, sms, smem, want):
    """``resident_ok`` with ``batch``: B instances side by side, each on
    sms // B blocks, where B <= sms and a band of nx rows over those
    blocks fits (``resident_bytes`` on sms // B)."""
    taps, k = _taps(L)
    assert tt.resident_ok(L, k, len(taps), nx, ny, sms, smem,
                          batch=B) is want
    if 1 <= B <= sms:
        fits = tt.resident_bytes(L, k, len(taps), nx, ny, sms // B) <= smem
        assert fits is want


def test_tight_batched_resident_bytes_count_the_layout():
    """csrc's TightRes by hand for tight8x128x4's instances on 16 blocks
    each (8-row bands): u 9 rows of 4 labels, q 9 rows of 8 planes, v and
    p 8 rows of 12 pair planes, kxq 8 rows of 8, f 8 of 4, s and su 8 of
    one, 128 wide, and the 24 taps' array (2L + 2k + 2 + 4T floats):
    52854 floats, 211416 bytes, under the card's 232448.  One instance
    alone keeps row 20's shape rule."""
    taps, k = _taps(4)
    assert (k, len(taps)) == (6, 24)
    floats = (3 * 4 * 9 + (4 * 6 + 3 * 4 + 2) * 8) * 128 + 8 + 12 + 2 + 96
    assert floats == 52854
    assert tt.resident_bytes(4, 6, 24, 128, 128, H100_SMS // 8) == \
        4 * floats == 211416
    for nx in (128, 172, 512):
        assert tt.resident_ok(4, 6, 24, nx, 128, H100_SMS, H100_SMEM,
                              batch=1) is tt.resident_ok(
            4, 6, 24, nx, 128, H100_SMS, H100_SMEM)


# ---------------------------------------------------------------------------
# the in-place batched form and its light call
# ---------------------------------------------------------------------------

B, L, NX, NY = 3, 3, 7, 6


def _model():
    """The example's match at (L, NX, NY): taps, k, consts, radius."""
    m = tt.match_tight_structure(tight_model(ptt, NX, NY, L)[0].finalize())
    assert m is not None
    return m


def _batch(seed, flags=None):
    """A route's flat rows x (B, (L + 2k) n) and y (B, (2L + 2k + 1) n), f
    (B, L, nx, ny) and the (5, B) (+ flags) scalar rows, as numpy."""
    m = _model()
    k, n = m["k"], NX * NY
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.rand(B, L * n), 0.1 * rng.randn(B, 2 * k * n)],
                       1).astype(np.float32)
    y = np.concatenate([0.2 * rng.randn(B, 2 * L * n),
                        0.1 * rng.randn(B, 2 * k * n),
                        0.1 * rng.randn(B, n)], 1).astype(np.float32)
    f = rng.rand(B, L, NX, NY).astype(np.float32)
    scal = tconv._scal(rng, B, m["radius"], 1.0)
    if flags is not None:
        scal = np.concatenate([scal, np.asarray([flags], np.float32)])
    return x, y, f, scal, m


def _planes(x, y, k):
    """(u, v, q, p, s) views of the flat rows."""
    n = NX * NY
    nL, nk2 = L * n, 2 * k * n
    return (x[:, :nL].view(B, L, NX, NY), x[:, nL:].view(B, 2 * k, NX, NY),
            y[:, :2 * nL].view(B, 2 * L, NX, NY),
            y[:, 2 * nL:2 * nL + nk2].view(B, 2 * k, NX, NY),
            y[:, 2 * nL + nk2:].view(B, NX, NY))


@pytest.mark.parametrize("count", [1, 4])
@pytest.mark.parametrize("flags", [None, [0.0, 1.0, 0.0], [1.0, 0.0, 1.0]])
def test_tight_chunk_batched_inplace_is_the_functional(flags, count):
    """``tight_chunk_batched_`` on views of a route's flat x and y (u and v
    share a row, q, p and s another) leaves the functional wrapper's
    outputs in the caller's buffers, bit for bit; a flagged instance keeps
    its state and its previous buffers untouched, and its norms are
    zero."""
    x, y, f, scal, m = _batch(80 + count, flags)
    k = m["k"]
    t_x, t_y = torch.from_numpy(x), torch.from_numpy(y)
    t_f, t_scal = torch.from_numpy(f), torch.from_numpy(scal)
    args = (t_f, t_scal, count, m["taps"], m["consts"])
    want = tt.tight_chunk_batched(
        *[v.contiguous() for v in _planes(t_x, t_y, k)], *args)
    cur_x, cur_y = t_x.clone(), t_y.clone()
    prev_x, prev_y = torch.full_like(t_x, 7.0), torch.full_like(t_y, 7.0)
    norms2 = tt.tight_chunk_batched_(*_planes(cur_x, cur_y, k),
                                     *_planes(prev_x, prev_y, k), *args)
    got = list(_planes(cur_x, cur_y, k)) + list(_planes(prev_x, prev_y, k))
    assert norms2.shape == (4, B)
    ins = _planes(t_x, t_y, k)
    for b in range(B):
        if flags and flags[b]:
            for a, i in zip(got[:5], ins):
                assert torch.equal(a[b], i[b])
            for a in got[5:]:
                assert torch.all(a[b] == 7.0)
            assert not norms2[:, b].any()
            continue
        for a, v in zip(got, want[:10]):
            assert torch.equal(a[b], v[b])
        assert torch.equal(norms2[:, b], want[10][:, b])
        assert norms2[:, b].all()


def test_tight_chunk_batched_inplace_matches_jax_kernel():
    """The in-place form on a route's views against the JAX
    ``tight_fused_chunk_batched`` (interpret mode) on the same instances,
    each with its own steps and radius, at the ensemble tolerances."""
    x, y, f, scal, m = _batch(83)
    k, ri = m["k"], 4
    cur_x, cur_y = torch.from_numpy(x).clone(), torch.from_numpy(y).clone()
    prev_x, prev_y = cur_x.clone(), cur_y.clone()
    norms2 = tt.tight_chunk_batched_(
        *_planes(cur_x, cur_y, k), *_planes(prev_x, prev_y, k),
        torch.from_numpy(f), torch.from_numpy(scal), ri, m["taps"],
        m["consts"])
    ins = [v.contiguous().numpy() for v in _planes(torch.from_numpy(x),
                                                   torch.from_numpy(y), k)]
    new, prev, norms = jt.tight_fused_chunk_batched(
        *map(jnp.asarray, ins), jnp.asarray(f), jnp.asarray(scal), ri,
        m["taps"], m["consts"], interpret=True)
    out = (list(_planes(cur_x, cur_y, k)) + list(_planes(prev_x, prev_y, k))
           + [norms2])
    for b in range(B):
        tight_close(tconv._instance(out, b, 10), [a[b] for a in new],
                    [a[b] for a in prev], np.asarray(norms)[:, b])


def test_tight_chunk_batched_inplace_refuses_mismatched_buffers():
    x, y, f, scal, m = _batch(84)
    k = m["k"]
    st = _planes(torch.from_numpy(x), torch.from_numpy(y), k)
    args = (torch.from_numpy(f), torch.from_numpy(scal), 2, m["taps"],
            m["consts"])
    with pytest.raises(ptt.ProstError, match="previous-iterate buffer"):
        tt.tight_chunk_batched_(*st, *st[:4], st[4][:, 1:], *args)
    own = [t.contiguous() for t in st]
    with pytest.raises(ptt.ProstError, match="space their instances"):
        tt.tight_chunk_batched_(*st, *own, *args)
    one = st[0][:1].expand(B, -1, -1, -1)
    with pytest.raises(ptt.ProstError, match="overlap"):
        tt.tight_chunk_batched_(one, *st[1:], one, *own[1:], *args)
    with pytest.raises(ptt.ProstError, match="taps"):
        tt.tight_chunk_batched_(*st, *[t.clone() for t in st], *args[:3],
                                (), m["consts"])


@pytest.mark.parametrize("converged", [False, True])
def test_tight_batched_light_call_is_the_inplace_form(converged):
    """``TightBatchedChunk``, made once per route from the route's match
    (the taps, the constants and every instance's radius and d_s), on the
    route's views: the same buffers and norms as ``tight_chunk_batched_``
    with the same scalars, twice in a row (its scalar buffer reused), the
    flag set for every instance."""
    x, y, f, scal, m = _batch(85)
    k = m["k"]
    route = {**m, "radius": torch.from_numpy(scal[3]),
             "d_s": torch.from_numpy(scal[4])}
    call = tt.TightBatchedChunk(route, B, 3, torch.device("cpu"))
    assert call.resident is None
    tau, sigma, theta = (torch.from_numpy(scal[i]) for i in range(3))
    t_f = torch.from_numpy(f)
    cur = [torch.from_numpy(x).clone(), torch.from_numpy(y).clone()]
    prev = [a.clone() for a in cur]
    want_cur = [a.clone() for a in cur]
    want_prev = [a.clone() for a in cur]
    full = torch.from_numpy(np.concatenate(
        [scal, np.full((1, B), float(converged), np.float32)]))
    for _ in range(2):
        norms2 = call(_planes(*cur, k), _planes(*prev, k), t_f, tau, sigma,
                      theta, torch.tensor(converged))
        want = tt.tight_chunk_batched_(*_planes(*want_cur, k),
                                       *_planes(*want_prev, k), t_f, full, 3,
                                       m["taps"], m["consts"])
        for a, b in zip(cur + prev + [norms2], want_cur + want_prev + [want]):
            assert torch.equal(a, b)
    assert torch.equal(call.scal(), full)
    if converged:
        assert torch.equal(cur[0], torch.from_numpy(x))
        assert not norms2.any()


# ---------------------------------------------------------------------------
# the route, in place on the run's own state
# ---------------------------------------------------------------------------

def test_batched_tight_route_across_runs_matches_jax():
    """``BatchedPDHG``'s tight route (tests/test_parallel.py's three 12x12
    instances with 3 labels, ri 5) over 31 iterations in three runs, each
    with its own copies of the state's vectors, which the light call then
    updates in place, against the JAX BatchedPDHG's one run in interpret
    mode, at the route's tolerances."""
    build, ri, until = tconv.CONV["tight"]
    tb, jb = tens._batched(ptt, build(ptt), ri), tens._batched(pt, build(pt),
                                                               ri)
    assert tb.tight is not None and jb.tight is not None
    ts = _split_run(tb, (6, 17, until))
    js = tens._run(jb, until)
    assert isinstance(tb.tight["call"], tt.TightBatchedChunk)
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


def test_batched_tight_route_holds_a_converged_ensemble():
    """Once every instance has converged (tolerances that the first
    residual step meets), the in-place route's chunks change nothing: the
    state a run returns is the one it held, and a further run leaves it
    there."""
    build, ri, _ = tconv.CONV["tight"]
    tb = tens._batched(ptt, build(ptt), ri, t=1e3)
    s = tens._run(tb, 16)
    assert bool(s.converged.all())
    again = tb.run(s, 31, 16)
    for name in ("x", "y", "x_prev", "y_prev", "tau", "iteration"):
        assert torch.equal(getattr(again, name), getattr(s, name)), name
