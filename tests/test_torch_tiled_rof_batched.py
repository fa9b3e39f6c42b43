"""The batched tiled ROF chunk (row 7 of the kernel table,
``rof_chunk_batched_`` with ``path="tiled"``: the tiled launch with the
instances on the grid's z axis, for the instances that no cluster of 8
CTAs holds) and the ensembles' light call ``ROFBatchedChunk``, as far as
the CPU can check them.

* The plain twin ``rof_chunk_batched_tiled_plain`` (``rof_chunk_tiled_plain``
  instance by instance) against the JAX ``rof_fused_chunk_banded_batched``
  (row 7) and ``rof_fused_chunk_batched`` (row 4, with mass on the dead
  dual coordinates) in interpret mode, three ragged instances with their
  own steps, lmb and radius, the three data terms: against row 7 3e-7 of
  each plane's scale (max(1, its largest magnitude)) and 1e-5 relative on
  the norms (tests/test_torch_tiled_rof.py's banded tolerances), against
  row 4 2e-5 and 1e-4 (tests/test_torch_ensemble.py's, which hold the
  plain batched chunk against that kernel); against
  ``rof_chunk_batched_plain`` bit for bit in f64, a flagged instance
  returning its inputs.
* The batched tile rule (``tiled_tile`` with its batch) and the route rule
  ``batched_route_of`` on an H100's SM count and shared-memory limit.
* ``ROFBatchedChunk`` on the CPU against the copying ``rof_chunk_batched``,
  and ``BatchedPDHG``'s ROF route through it against the JAX
  ``BatchedPDHG`` and against the copying route, the caller's state left
  as it was.

The kernel itself is held bit for bit against ``rof_chunk_`` on each
instance and against the streaming sequence on the card by
tests/test_torch_cuda_redesign.py (``-k rof_batched_tiled``) and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_rof as jfr
from prost_tpu_torch.ops import fused_rof as tfr
from prost_tpu_torch.ops.pdhg_chunk import S_LEN
from test_torch_ensemble import (NORM_RTOL as ENS_NORM_RTOL,
                                 PLANE_ATOL as ENS_PLANE_ATOL, RUN_ATOL,
                                 SOL_ATOL, _assert_states, _batched,
                                 _rof_probs, _run)

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt into
H100_SMS, H100_SMEM = 132, 232448
PLANE_ATOL, NORM_RTOL = 3e-7, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _inputs(seed, B, nx, ny, clean=False, dtype=torch.float32, flags=None):
    """B instances (x, q, f, w) and (5, B) scalars with each instance's own
    tau, sigma, lmb and radius (+ a row of flags); mass on the dead dual
    coordinates unless ``clean``."""
    rng = np.random.RandomState(seed)
    q = 0.3 * rng.randn(B, 2, nx, ny)
    if clean:  # the banded JAX kernels take a canonical q
        q[:, 0, -1, :] = 0.0
        q[:, 1, :, -1] = 0.0
    arrs = [rng.rand(B, nx, ny), q, rng.rand(B, nx, ny),
            2.0 * (rng.rand(B, nx, ny) > 0.3)]
    rows = [0.8 + 0.2 * rng.rand(B), 0.9 + 0.3 * rng.rand(B), np.ones(B),
            4 + 12 * rng.rand(B), 0.5 + rng.rand(B)]
    if flags is not None:
        rows.append(np.asarray(flags, dtype=np.float64))
    return ([torch.from_numpy(a).to(dtype) for a in arrs],
            torch.tensor(np.array(rows), dtype=dtype))


def _close(got, want, plane_atol, norm_rtol):
    """Planes within ``plane_atol`` of their scale, max(1, the plane's
    largest magnitude: the duals here reach the largest radius, 1.5),
    norms within ``norm_rtol``."""
    for i, (a, b) in enumerate(zip(got[:4], want[:4])):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), b, atol=plane_atol * max(1.0, float(np.abs(b).max())),
            rtol=0.0, err_msg=f"plane {i}")
    ref = np.asarray(want[4])
    assert got[4].shape == ref.shape
    np.testing.assert_allclose(got[4].numpy(), ref, rtol=norm_rtol,
                               atol=1e-10)


def _equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"output {i}"


# ---------------------------------------------------------------------------
# the twin against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("kernel", ["banded", "batched"])
def test_batched_twin_matches_jax(kernel, dataterm):
    """Three 32x20 instances (tiles of 24x32 that do not divide them):
    against row 7, ``rof_fused_chunk_banded_batched`` (2 bands of 16 rows,
    a canonical q, count 5), and against row 4,
    ``rof_fused_chunk_batched`` (mass on the dead dual coordinates, count
    10), whose function the tiled launch runs for the instances beyond a
    cluster; each at the tolerances the repo holds the plain versions to
    against that kernel."""
    banded = kernel == "banded"
    planes, scal = _inputs(81, 3, 32, 20, clean=banded)
    args = [jnp.asarray(a.numpy()) for a in (*planes, scal)]
    if banded:
        count = 5
        want = jfr.rof_fused_chunk_banded_batched(*args, count, 2, dataterm,
                                                  interpret=True)
        tols = (PLANE_ATOL, NORM_RTOL)
    else:
        count = 10
        want = jfr.rof_fused_chunk_batched(*args, count, dataterm=dataterm,
                                           interpret=True)
        tols = (ENS_PLANE_ATOL, ENS_NORM_RTOL)
    got = tfr.rof_chunk_batched_tiled_plain(*planes, scal, count, dataterm,
                                            tile=(24, 32))
    _close(got, want, *tols)


# ---------------------------------------------------------------------------
# the twin against the plain batched chunk, bit for bit
# ---------------------------------------------------------------------------

# (B, nx, ny, count, tile, data term, flags): tiles that do not divide the
# planes, one wider than them, count 1 (only the aligned iteration) and ri
# 10, one instance flagged in each
TWIN_CASES = [(3, 70, 53, 10, (16, 32), "square", [0, 1, 0]),
              (3, 41, 97, 3, (24, 64), "wsquare", [0, 0, 1]),
              (2, 33, 40, 1, (64, 64), "abs", [1, 0])]


@pytest.mark.parametrize("B,nx,ny,count,tile,dataterm,flags", TWIN_CASES)
def test_batched_twin_is_batched_plain_f64(B, nx, ny, count, tile, dataterm,
                                           flags):
    planes, scal = _inputs(82 + count, B, nx, ny, dtype=torch.float64,
                           flags=flags)
    got = tfr.rof_chunk_batched_tiled_plain(*planes, scal, count, dataterm,
                                            tile=tile, partials=True)
    _equal(got[:5], tfr.rof_chunk_batched_plain(*planes, scal, count,
                                                dataterm))
    x, q = planes[:2]
    assert got[5].shape == (B, -(-nx // 8) * -(-ny // 32), 4)
    for b, flag in enumerate(flags):
        if flag:  # its inputs back, zero norms
            _equal([t[b] for t in got[:4]] + [got[4][:, b]],
                   [x[b], q[b], x[b], q[b], torch.zeros(4, dtype=x.dtype)])
        else:  # the kernel's reduction: tile partials, pdhg_finish's order
            torch.testing.assert_close(tfr.finish_sums(got[5][b]),
                                       got[4][:, b], rtol=1e-13, atol=0.0)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _cost(nx, ny, count, B, tile):
    """tiled_tile's measure of a tile: rounds of one block per SM over the
    B instances' tiles times a whole tile's window rows times its thread
    map's width (32 lanes a block of 32 columns)."""
    tx, ty = tile
    h = 2 * count + 1
    rounds = -(-(B * -(-nx // tx) * -(-ny // ty)) // H100_SMS)
    return rounds * min(tx + h, nx) * 32 * -(-min(ty + h, ny) // 32)


@pytest.mark.parametrize("nx,ny,B,dataterm", [
    (2048, 2048, 4, "square"), (1280, 1280, 2, "square"),
    (512, 512, 8, "wsquare"), (300, 272, 3, "abs"), (272, 272, 64, "square")])
def test_batched_tile_fits_covers_norm_tiles_and_counts_the_batch(
        nx, ny, B, dataterm):
    """The rule's tile fits a block, holds whole 32x8 norm tiles, and walks
    the fewest lane rows through the SMs over the B instances' tiles of
    every tile that fits."""
    count = 10
    tile = tfr.tiled_tile(nx, ny, count, dataterm, H100_SMS, H100_SMEM, B)
    tx, ty = tile
    assert tx % 8 == 0 and ty % 32 == 0
    assert tfr.tiled_bytes(tx, ty, count, dataterm) <= H100_SMEM
    fits = [(a, b) for a in tfr.TILE_ROWS for b in tfr.TILE_COLS
            if tfr.tiled_fits(a, b, count, dataterm, H100_SMEM)
            and a - 8 < nx and b - 32 < ny]
    assert _cost(nx, ny, count, B, tile) == min(
        _cost(nx, ny, count, B, t) for t in fits)


def test_batched_tile_rule_counts_the_instances():
    """One instance of 2048x2048 takes 72x96 tiles (638 tiles, 5 rounds of
    132 SMs); four take 56x128 (2368 tiles, 18 rounds), which walk fewer
    lane rows than four times the single instance's tiles."""
    one = tfr.tiled_tile(2048, 2048, 10, "square", H100_SMS, H100_SMEM)
    four = tfr.tiled_tile(2048, 2048, 10, "square", H100_SMS, H100_SMEM, 4)
    assert one == (72, 96) and four == (56, 128)
    assert _cost(2048, 2048, 10, 4, four) < _cost(2048, 2048, 10, 4, one)
    assert tfr.tiled_ok(2048, 2048, 10, "square", H100_SMS, H100_SMEM, 4)


# (instance side, data term, count, route): a cluster of 8 holds 256x256
# and not 272x272; 1280x1280 (the JAX package's banded ensemble) and
# 2048x2048 tile; a chunk of 40 with wsquare still tiles, one of 41 has a
# halo no window holds
ROUTES = [(128, "square", 10, "cluster"), (256, "wsquare", 10, "cluster"),
          (272, "square", 10, "tiled"), (1280, "square", 10, "tiled"),
          (2048, "wsquare", 10, "tiled"), (2048, "wsquare", 40, "tiled"),
          (2048, "wsquare", 41, "streaming")]


@pytest.mark.parametrize("n,dataterm,count,want", ROUTES)
def test_batched_route_rule(n, dataterm, count, want):
    for B in (1, 4):
        assert tfr.batched_route_of(B, n, n, dataterm, count, H100_SMS,
                                    H100_SMEM) == want
    assert (tfr.cluster_size(n, n, dataterm) is None) == (want != "cluster")


# ---------------------------------------------------------------------------
# the in-place form and the light call on the CPU
# ---------------------------------------------------------------------------

def test_inplace_form_is_the_functional_chunk():
    """``rof_chunk_batched_`` (any path on the CPU runs the plain version)
    leaves in (x, q) and (x_prev, q_prev) what ``rof_chunk_batched``
    returns; a flagged instance keeps all four; a cluster path or an
    unknown one raises."""
    planes, scal = _inputs(83, 3, 24, 40, flags=[0, 1, 0])
    x, q, f, w = planes
    want = tfr.rof_chunk_batched(*planes, scal, 4, "wsquare")
    for path in (None, "tiled", "streaming"):
        cur, prev = [x.clone(), q.clone()], [x + 1.0, q + 1.0]
        norms2 = tfr.rof_chunk_batched_(*cur, *prev, f, w, scal, 4,
                                        "wsquare", path)
        _equal(cur + [p[::2] for p in prev] + [norms2],
               list(want[:2]) + [want[2][::2], want[3][::2], want[4]])
        _equal([prev[0][1], prev[1][1]], [x[1] + 1.0, q[1] + 1.0])
    with pytest.raises(ptt.ProstError, match="path must be"):
        tfr.rof_chunk_batched_(x, q, x.clone(), q.clone(), f, w, scal, 4,
                               path="cluster")
    with pytest.raises(ptt.ProstError, match="path must be"):
        tfr.rof_chunk_batched(*planes, scal, 4, path="banded")


def _route(planes, scal, dataterm):
    x, q, f, w = planes
    B, nx, ny = x.shape
    return {"nx": nx, "ny": ny, "f": f, "w": w, "dataterm": dataterm,
            "lmb": scal[3], "radius": scal[4]}


@pytest.mark.parametrize("path", ["tiled", "streaming"])
def test_light_call_is_the_copying_chunk(path):
    """``ROFBatchedChunk`` on the CPU leaves in the run's own planes what
    the copying ``rof_chunk_batched`` returns, twice in a row from the
    state it left, and with the flags set nothing."""
    planes, scal = _inputs(84, 3, 16, 20)
    x, q, f, w = planes
    call = tfr.ROFBatchedChunk(_route(planes, scal, "abs"), 3, 5, "cpu",
                               path=path)
    assert call.inplace and call.route is None
    cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
    want = [x, q]
    for tau, done in ((0.9, False), (1.1, False), (1.1, True)):
        taus = torch.full((3,), tau)
        got = call(cur, prev, f, w, taus, scal[1], scal[2],
                   torch.tensor(done))
        s6 = torch.cat([torch.stack([taus, scal[1], scal[2], scal[3],
                                     scal[4]]),
                        torch.full((1, 3), float(done))])
        ref = tfr.rof_chunk_batched(*want, f, w, s6, 5, "abs")
        if done:
            _equal(cur + [got], want + [torch.zeros(4, 3)])
        else:
            _equal(cur + prev + [got], list(ref))
            want = [ref[0], ref[1]]


def test_light_call_takes_the_cluster_rule_on_the_cpu():
    """Where a cluster of 8 holds an instance (16x20) the light call is not
    the route's (``inplace`` false, and a call raises); where none holds
    one (16x4000) it is."""
    planes, scal = _inputs(85, 2, 16, 20)
    small = tfr.ROFBatchedChunk(_route(planes, scal, "square"), 2, 3, "cpu")
    assert not small.inplace
    with pytest.raises(ptt.ProstError, match="does not run in place"):
        small([planes[0], planes[1]], [planes[0], planes[1]], planes[2],
              planes[3], scal[0], scal[1], scal[2], torch.tensor(False))
    m = {"nx": 16, "ny": 4000, "dataterm": "square", "lmb": 8.0,
         "radius": 1.0}
    assert tfr.cluster_size(16, 4000, "square") is None
    assert tfr.ROFBatchedChunk(m, 2, 3, "cpu").inplace
    assert tfr.ROFBatchedChunk(m, 2, 3, "cpu").sc.shape == (2, S_LEN)
    with pytest.raises(ptt.ProstError, match="path must be"):
        tfr.ROFBatchedChunk(m, 2, 3, "cpu", path="resident")


# ---------------------------------------------------------------------------
# BatchedPDHG's ROF route through the light call
# ---------------------------------------------------------------------------

def _light(b, path="tiled"):
    """``b``'s ROF route on the light call (its path forced: the 16x16
    instances would take the cluster launch)."""
    b.rof["call"] = tfr.ROFBatchedChunk(b.rof, b.batch, b.ri, "cpu",
                                        path=path)
    return b


def test_light_route_matches_jax_fused():
    """tests/test_torch_ensemble.py's ROF ensemble (three 16x16 instances,
    lmb 4, 8, 16, ri 10, 60 iterations) through the light call in place
    against the JAX BatchedPDHG in interpret mode: iterates, steps and
    current_solution within the ensemble tolerances."""
    tb = _light(_batched(ptt, _rof_probs(ptt), 10))
    jb = _batched(pt, _rof_probs(pt), 10)
    ts, js = _run(tb, 60), _run(jb, 60)
    np.testing.assert_array_equal(ts.iteration.numpy(), 60)
    _assert_states(ts, js, RUN_ATOL)
    for a, b in zip(tb.current_solution(ts), jb.current_solution(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SOL_ATOL)


@pytest.mark.parametrize("path", ["tiled", "streaming"])
def test_light_route_is_the_copying_route_and_leaves_the_callers_state(path):
    """From a warm start with mass on the dead dual coordinates, two run
    calls through the light call give the copying route's state bit for
    bit, and the state the caller passed in is left as it was."""
    probs = _rof_probs(ptt, 12, 18, 9, (3.0, 9.0, 20.0))
    copying, light = (_batched(ptt, probs, 10),
                      _light(_batched(ptt, probs, 10), path))
    s0 = copying.initial_state()
    rng = np.random.RandomState(86)
    s0.y = torch.from_numpy(0.2 * rng.randn(*s0.y.shape).astype(np.float32))
    s0.x = torch.from_numpy(rng.rand(*s0.x.shape).astype(np.float32))
    before = {k: v.clone() for k, v in vars(s0).items()}
    got = []
    for b in (copying, light):
        s = b.run(s0, 27, 0)
        got.append(b.run(s, 55, 27))
    assert light.rof["call"].inplace
    assert not copying.rof["call"].inplace
    for name, v in vars(got[0]).items():
        assert torch.equal(v, getattr(got[1], name)), name
    for name, v in before.items():
        assert torch.equal(v, getattr(s0, name)), name
