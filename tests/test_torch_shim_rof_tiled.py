"""The tiled ROF kernel's own source on the CPU: ``csrc/fused_rof.cu``
built by ``tools/cuda_shim/build.py`` (g++, one thread per CUDA thread)
and its tiled entry points held bit for bit against the streaming ones,
which the same build runs with the same host arithmetic:

* ``prost_rof_chunk_tiled`` against ``prost_rof_chunk``;
* the tiled halo band (a row offset, owned rows inside the band) against
  ``prost_rof_chunk_halo``;
* ``prost_rof_chunk_batched_tiled`` at B = 3 with one flagged instance
  against each instance alone (``prost_rof_chunk``), the flagged one left
  as it was;
* ``prost_rof_multichunk_tiled`` after an odd and an even number of chunks
  against ``prost_rof_multichunk``;

for the square, wsquare and abs data terms, on planes and tiles at which
windows inside the plane (whose stencils test nothing) and windows at its
edges (every neighbour tested) both occur, and on a 9-row plane whose
windows all meet an edge.  The shim runs a launch's blocks one after
another, first to last or (``shim_set_reverse``) last to first, so a
block that wrote what a window read later reads would show in one of the
two orders.  The card runs the same comparisons at full size
(tests/test_torch_cuda_redesign.py ``-k rof_tiled``, chip_smoke.py).
"""

import os
import sys

import numpy as np
import pytest

from prost_tpu_torch.ops.pdhg_chunk import CF, CI, S_CONV, S_LEN, S_NORM, VP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATATERMS = {"square": 0, "wsquare": 1, "abs": 2}
NAN = float("nan")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    import ctypes

    sys.path.insert(0, os.path.join(ROOT, "tools", "cuda_shim"))
    try:
        import build
    finally:
        sys.path.pop(0)
    so = build.build("fused_rof", str(tmp_path_factory.mktemp("shim")))
    lib = ctypes.CDLL(so)
    sig = {"prost_rof_chunk": [VP] * 10 + [CI] * 4 + [VP],
           "prost_rof_chunk_halo": [VP] * 10 + [CI] * 5 + [VP],
           "prost_rof_multichunk": [VP] * 10 + [CI] * 6 + [CF] * 6 + [VP],
           "prost_rof_chunk_tiled": [VP] * 9 + [CI] * 7 + [VP],
           "prost_rof_chunk_batched_tiled": [VP] * 9 + [CI] * 7 + [VP],
           "prost_rof_multichunk_tiled": [VP] * 9 + [CI] * 6 + [CF] * 6
                                         + [CI] * 2 + [VP],
           "prost_rof_num_blocks": [CI, CI], "shim_set_reverse": [CI]}
    for fn, argtypes in sig.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = CI
    return lib


def _planes(seed, nx, ny, batch=None):
    """x, q (mass on the dead duals), f, w as f32 numpy planes."""
    rng = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    arrs = (rng.rand(*lead, nx, ny), 0.3 * rng.randn(*lead, 2, nx, ny),
            rng.rand(*lead, nx, ny), 2.0 * (rng.rand(*lead, nx, ny) > 0.3))
    return [np.ascontiguousarray(a, dtype=np.float32) for a in arrs]


def _scalars(batch=1, band=None, multi=False):
    sc = np.zeros((batch, S_LEN), np.float32)
    sc[:, :5] = (0.9, 1.1, 1.0, 8.0, 1.0)
    if band is not None:
        sc[:, 5:8] = band  # row offset, owned rows [lo, hi)
    if multi:
        sc[:, 5:9] = (0.5, 0.0, 0.0, 1.0)
    return sc


def _p(*arrs):
    return [a.ctypes.data for a in arrs]


def _run(fn, *args):
    rc = fn(*args)
    assert rc == 0, f"{fn.__name__}: error {rc}"


def _chunk(lib, path, x, q, f, w, sc, count, dt, tile=None, nxg=0):
    """One chunk in place on copies of (x, q); (x, q, x_prev, q_prev,
    scalars)."""
    x, q, sc = x.copy(), q.copy(), sc.copy()
    xp, qp = np.full_like(x, NAN), np.full_like(q, NAN)
    nx, ny = x.shape[-2:]
    partial = np.zeros(4 * lib.prost_rof_num_blocks(nx, ny), np.float32)
    if path == "tiled":
        scratch = np.zeros((3, nx, ny), np.float32)
        _run(lib.prost_rof_chunk_tiled, *_p(x, q, xp, qp, f, w, sc, partial,
                                            scratch), nx, ny, nxg, count, dt,
             *tile, None)
    else:
        g, gp = (np.zeros((2, nx, ny), np.float32) for _ in range(2))
        bufs = _p(x, q, xp, qp, g, gp, f, w, sc, partial)
        if nxg:
            _run(lib.prost_rof_chunk_halo, *bufs, nx, ny, nxg, count, dt,
                 None)
        else:
            _run(lib.prost_rof_chunk, *bufs, nx, ny, count, dt, None)
    return [x, q, xp, qp, sc]


@pytest.fixture
def order(lib, request):
    """The order the shim runs a launch's blocks in, for one test."""
    lib.shim_set_reverse(int(request.param == "reverse"))
    yield request.param
    lib.shim_set_reverse(0)


def _equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataterm", list(DATATERMS))
@pytest.mark.parametrize("nx,ny,count,tile,order", [
    (40, 100, 3, (16, 32), "forward"),  # 2 of 12 windows inside the plane
    (40, 100, 3, (16, 32), "reverse"),
    (9, 70, 2, (8, 32), "forward")],    # every window meets an edge
    indirect=["order"])
def test_tiled_chunk_is_the_streaming_chunk(lib, nx, ny, count, tile,
                                            order, dataterm):
    x, q, f, w = _planes(nx + ny + count, nx, ny)
    sc = _scalars()[0]
    dt = DATATERMS[dataterm]
    want = _chunk(lib, "streaming", x, q, f, w, sc, count, dt)
    got = _chunk(lib, "tiled", x, q, f, w, sc, count, dt, tile)
    _equal(got, want)
    assert (got[4][S_NORM:S_NORM + 4] > 0).all()


@pytest.mark.parametrize("dataterm", list(DATATERMS))
@pytest.mark.parametrize("lo,rows,order", [
    (24, 24, "forward"), (24, 24, "reverse"), (0, 24, "forward")],
    indirect=["order"])
def test_tiled_halo_band_is_the_streaming_band(lib, lo, rows, order,
                                               dataterm):
    """A band of ``rows`` owned rows from global row ``lo`` of a 72x100
    plane, with the halo of a 3-iteration chunk's route (2 count + 2 rows
    each side, zeros beyond the plane): a middle band (windows inside the
    global plane) and the first (the global first row in the band)."""
    nxg, ny, count, H = 72, 100, 3, 8
    x, q, f, w = _planes(500 + lo, nxg, ny)

    def band(a):
        out = np.zeros(a.shape[:-2] + (rows + 2 * H, ny), np.float32)
        a0, a1 = max(lo - H, 0), min(lo + rows + H, nxg)
        out[..., a0 - (lo - H):a1 - (lo - H), :] = a[..., a0:a1, :]
        return out

    bx, bq, bf, bw = (band(a) for a in (x, q, f, w))
    sc = _scalars(band=(lo - H, H, H + rows))[0]
    dt = DATATERMS[dataterm]
    want = _chunk(lib, "streaming", bx, bq, bf, bw, sc, count, dt, nxg=nxg)
    got = _chunk(lib, "tiled", bx, bq, bf, bw, sc, count, dt, (16, 32), nxg)
    _equal(got, want)


@pytest.mark.parametrize("dataterm", list(DATATERMS))
@pytest.mark.parametrize("order", ["reverse"], indirect=True)
def test_tiled_batch_is_each_instance_alone(lib, order, dataterm):
    """Three instances of 40x70 in one launch (16x32 tiles, count 3; the
    blocks last to first), instance 1 flagged: instances 0 and 2 are the
    streaming chunk on each alone; instance 1 keeps its planes, previous
    iterates and norms."""
    B, nx, ny, count = 3, 40, 70, 3
    x, q, f, w = _planes(600, nx, ny, B)
    sc = _scalars(B)
    sc[1, S_CONV] = 1.0
    dt = DATATERMS[dataterm]
    bx, bq, bsc = x.copy(), q.copy(), sc.copy()
    bxp, bqp = np.full_like(x, NAN), np.full_like(q, NAN)
    partial = np.zeros(4 * B * lib.prost_rof_num_blocks(nx, ny), np.float32)
    scratch = np.zeros((3 * B, nx, ny), np.float32)
    _run(lib.prost_rof_chunk_batched_tiled,
         *_p(bx, bq, bxp, bqp, f, w, bsc, partial, scratch), nx, ny, count,
         dt, B, 16, 32, None)
    for b in range(B):
        got = [bx[b], bq[b], bxp[b], bqp[b], bsc[b]]
        if b == 1:
            _equal(got[:2], [x[b], q[b]])
            assert np.isnan(got[2]).all() and np.isnan(got[3]).all()
            _equal([got[4]], [sc[b]])
            continue
        want = _chunk(lib, "streaming", x[b], q[b], f[b], w[b], sc[b], count,
                      dt)
        _equal(got, want)


@pytest.mark.parametrize("dataterm,k_chunks", [
    ("square", 3), ("wsquare", 2), ("abs", 3)])
def test_tiled_multichunk_is_the_streaming_multichunk(lib, dataterm,
                                                      k_chunks):
    """Every chunk runs (tolerance 0, boyd's adaptation between chunks):
    after an odd count the result is copied back from the scratch, after
    an even one it is in place; planes, previous iterates and every
    scalar bit-equal."""
    nx, ny, count = 40, 96, 2
    x, q, f, w = _planes(700 + k_chunks, nx, ny)
    sc0 = _scalars(multi=True)[0]
    consts = (float(np.sqrt(2 * nx * ny)), float(np.sqrt(nx * ny)), 1.5,
              0.95, 1.05, 0.8)
    dt = DATATERMS[dataterm]
    out = {}
    for path in ("streaming", "tiled"):
        cx, cq, sc = x.copy(), q.copy(), sc0.copy()
        xp, qp = np.full_like(x, NAN), np.full_like(q, NAN)
        partial = np.zeros(4 * lib.prost_rof_num_blocks(nx, ny), np.float32)
        if path == "tiled":
            scratch = np.zeros((3, nx, ny), np.float32)
            _run(lib.prost_rof_multichunk_tiled,
                 *_p(cx, cq, xp, qp, f, w, sc, partial, scratch), nx, ny,
                 count, k_chunks, dt, 2, *consts, 16, 32, None)
        else:
            g, gp = (np.zeros((2, nx, ny), np.float32) for _ in range(2))
            _run(lib.prost_rof_multichunk,
                 *_p(cx, cq, xp, qp, g, gp, f, w, sc, partial), nx, ny,
                 count, k_chunks, dt, 2, *consts, None)
        out[path] = [cx, cq, xp, qp, sc]
    _equal(out["tiled"], out["streaming"])
    assert out["tiled"][4][14] == k_chunks  # every chunk ran
