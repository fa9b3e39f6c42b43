"""The tiled ROF chunk and multichunk (rows 6 and 5 of the kernel table,
``rof_chunk_`` / ``rof_chunk_halo_`` / ``rof_multichunk_`` with
``path="tiled"``: one launch a chunk over overlapping 2-D windows, for the
planes no grid-resident band holds), as far as the CPU can check them.

* Their plain twins, ``rof_chunk_tiled_plain`` and
  ``rof_multichunk_tiled_plain``, run ``rof_chunk_plain``'s arithmetic
  window by window with every mask decided by the pixel's place in the
  plane (``window_ops``) and stitch the owned pixels: bit-equal, in f64
  and f32, to ``rof_chunk_plain`` / ``rof_chunk_halo_plain`` /
  ``rof_multichunk_plain`` on shapes that the tiles do not divide, for the
  square, wsquare and abs data terms; their 32x8 tile partials, reduced in
  pdhg_finish's order, within rounding of the norms.
* The least halo (``tiled_halo``: count + 1 rows and columns before the
  tile, count after it) keeps the owned pixels exact, and one less on
  either side does not.
* The twins against the JAX banded kernels in interpret mode
  (``rof_fused_chunk_banded``, whole plane and halo band;
  ``rof_fused_multichunk_banded`` under boyd and alg1 with an odd chunk
  count): 3e-7 on the planes, 1e-5 relative on the norms.
* The shape rule (``route_of``, ``tiled_tile``, ``tiled_bytes``,
  ``tiled_map``) on an H100's SM count and shared-memory limit.

The kernel itself is held bit for bit against the streaming launch
sequence on the card by tests/test_torch_cuda_redesign.py (``-k tiled``)
and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu_torch as ptt
from prost_tpu.ops import fused_rof as jfr
from prost_tpu_torch.ops import fused_rof as tfr

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into (neither the resident nor the tiled kernel holds static shared
# memory)
H100_SMS, H100_SMEM = 132, 232448
PLANE_ATOL, NORM_RTOL = 3e-7, 1e-5
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _inputs(seed, nx, ny, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(nx, ny), 0.3 * rng.randn(2, nx, ny), rng.rand(nx, ny),
            2.0 * (rng.rand(nx, ny) > 0.3))
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _clean(q):
    """q without mass on the dead dual coordinates (the JAX kernels keep
    it; the port's zero it at entry)."""
    q = q.clone()
    q[0, -1, :] = 0.0
    q[1, :, -1] = 0.0
    return q


def _equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"output {i}"


SCAL = [0.9, 1.1, 1.0, 8.0, 1.0]  # tau, sigma, theta, lmb, radius


# ---------------------------------------------------------------------------
# the twins against the plain versions, bit for bit
# ---------------------------------------------------------------------------

# (nx, ny, count, tile): tiles that do not divide the plane, one wider
# than it, count 1 (only the aligned iteration) and ri 10
CHUNK_CASES = [(70, 53, 3, (16, 32)), (70, 53, 1, (8, 32)),
               (41, 97, 10, (24, 64)), (33, 40, 4, (64, 64))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("nx,ny,count,tile", CHUNK_CASES)
def test_tiled_chunk_twin_is_rof_chunk_plain(nx, ny, count, tile, dataterm,
                                             dtype):
    dt = DTYPES[dtype]
    x, q, f, w = _inputs(nx + count, nx, ny, dt)  # mass on the dead duals
    scal = torch.tensor(SCAL, dtype=dt)
    out = tfr.rof_chunk_tiled_plain(x, q, f, w, scal, count, dataterm,
                                    tile=tile, partials=True)
    _equal(out[:5], tfr.rof_chunk_plain(x, q, f, w, scal, count, dataterm))
    # the kernel's reduction: 32x8 tile partials, then pdhg_finish's order
    assert out[5].shape == (-(-nx // 8) * -(-ny // 32), 4)
    tol = 1e-13 if dt == torch.float64 else 1e-6
    torch.testing.assert_close(tfr.finish_sums(out[5]), out[4], rtol=tol,
                               atol=0.0)


def _band(planes, lo, hi, halo):
    """The halo-extended block of global rows [lo - halo, hi + halo),
    zeros beyond the plane (what the halo exchange delivers)."""
    out = []
    for a in planes:
        pad = torch.nn.functional.pad(a, (0, 0, halo, halo))
        out.append(pad[..., lo:hi + 2 * halo, :].contiguous())
    return out


# (global rows, shard rows [lo, hi), halo, count, tile): the top, a middle
# and the bottom shard of a 64-row plane, a ragged 50-row plane
HALO_CASES = [(64, 0, 16, 8, 3, (8, 32)), (64, 24, 40, 8, 5, (16, 32)),
              (64, 48, 64, 8, 3, (24, 64)), (50, 20, 37, 6, 4, (8, 32))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nxg,lo,hi,halo,count,tile", HALO_CASES)
def test_tiled_halo_twin_is_rof_chunk_halo_plain(nxg, lo, hi, halo, count,
                                                 tile, dtype):
    dt = DTYPES[dtype]
    x, q, f, w = _band(_inputs(nxg, nxg, 45, dt), lo, hi, halo)
    scal = torch.tensor(SCAL + [lo - halo, halo, halo + hi - lo], dtype=dt)
    out = tfr.rof_chunk_tiled_plain(x, q, f, w, scal, count, "wsquare",
                                    nx_global=nxg, tile=tile, partials=True)
    _equal(out[:5], tfr.rof_chunk_halo_plain(x, q, f, w, scal, count, nxg,
                                             "wsquare"))
    tol = 1e-13 if dt == torch.float64 else 1e-6
    torch.testing.assert_close(tfr.finish_sums(out[5]), out[4], rtol=tol,
                               atol=0.0)


def _mc_scal(tol, dt, tau=0.9, sigma=1.1, conv=None):
    return torch.tensor([tau, sigma, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0]
                        + [tol] * 4 + ([conv] if conv is not None else []),
                        dtype=dt)


def _consts(nx, ny):
    return (float(np.sqrt(2 * nx * ny)), float(np.sqrt(nx * ny)), 1.5, 0.95,
            1.05, 0.8)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("stepsize,k_chunks", [("boyd", 3), ("alg1", 3),
                                               ("goldstein", 4)])
def test_tiled_multichunk_twin_is_rof_multichunk_plain(stepsize, k_chunks,
                                                       dtype):
    dt = DTYPES[dtype]
    nx, ny = 45, 70
    x, q, f, w = _inputs(7, nx, ny, dt)
    scal = _mc_scal(0.0, dt)
    args = (x, q, f, w, scal, 3, k_chunks, "abs", stepsize,
            _consts(nx, ny))
    got = tfr.rof_multichunk_tiled_plain(*args, tile=(16, 32))
    _equal(got, tfr.rof_multichunk_plain(*args))
    assert got[5][6].item() == k_chunks


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_multichunk_twin_converging_mid_launch(dtype):
    """From a solve's start (x = f, q = 0) boyd adapts and the launch
    converges partway: an odd and an even number of executed chunks, each
    bit-equal to the plain multichunk, x_prev and q_prev those of the last
    executed chunk's aligned iteration."""
    dt = DTYPES[dtype]
    nx, ny = 40, 70
    f = _inputs(11, nx, ny, dt)[2]
    zero = torch.zeros((2, nx, ny), dtype=dt)
    seen = set()
    for tol in (2e-2, 1e-2):
        args = (f, zero, f, f, _mc_scal(tol, dt, 1.0, 1.0), 5, 8, "square",
                "boyd", _consts(nx, ny))
        got = tfr.rof_multichunk_tiled_plain(*args, tile=(16, 32))
        _equal(got, tfr.rof_multichunk_plain(*args))
        assert got[5][5].item() == 1.0
        seen.add(int(got[5][6].item()) % 2)
    assert seen == {0, 1}


def test_tiled_twins_with_the_flag_return_the_inputs():
    x, q, f, w = _inputs(3, 40, 40)
    out = tfr.rof_chunk_tiled_plain(x, q, f, w, torch.tensor(SCAL + [1.0]),
                                    3, tile=(8, 32))
    _equal(out, (x, q, x, q, torch.zeros(4)))
    m = tfr.rof_multichunk_tiled_plain(x, q, f, w,
                                       _mc_scal(1e-3, torch.float32,
                                                conv=1.0), 3, 8, "square",
                                       "boyd", _consts(40, 40),
                                       tile=(8, 32))
    _equal(m[:4], (x, q, x, q))
    assert m[5][5:].tolist() == [1.0, 0.0]


# ---------------------------------------------------------------------------
# the halo depth: count + 1 before the tile and count after it, no less
# ---------------------------------------------------------------------------

# in f32 the error a halo one short lets in at count 10 has faded below
# rounding by the time it reaches the tile (it crosses 10 pixels, each
# step scaling it by about tau / 4); f64 shows it
@pytest.mark.parametrize("count,dtype", [(1, "f64"), (3, "f64"), (10, "f64"),
                                         (1, "f32"), (3, "f32")])
def test_least_halo_is_exact_and_one_less_is_not(count, dtype):
    dt = DTYPES[dtype]
    nx, ny = 96, 100
    x, q, f, w = _inputs(40 + count, nx, ny, dt)
    scal = torch.tensor(SCAL, dtype=dt)
    want = tfr.rof_chunk_plain(x, q, f, w, scal, count, "square")
    lead, trail = tfr.tiled_halo(count)
    assert (lead, trail) == (count + 1, count)

    def run(halo):
        return tfr.rof_chunk_tiled_plain(x, q, f, w, scal, count, "square",
                                         tile=(32, 32), halo=halo)

    _equal(run((lead, trail)), want)
    # one row and column less before the tile spoils the norms' K^T q of
    # the new dual (and, from count 2, the planes); one less after it the
    # owned pixels' last dual step
    for short in ((lead - 1, trail), (lead, trail - 1)):
        got = run(short)
        assert not all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the twins against the JAX banded kernels in interpret mode
# ---------------------------------------------------------------------------

def _close(got, want, n_planes=4):
    for i, (a, b) in enumerate(zip(got[:n_planes], want[:n_planes])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PLANE_ATOL,
                                   rtol=0.0, err_msg=f"plane {i}")
    for a, b in zip(got[n_planes:], want[n_planes:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=NORM_RTOL,
                                   atol=1e-10)


@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_tiled_chunk_twin_matches_jax_banded(dataterm):
    nx, ny, count = 64, 53, 4
    x, q, f, w = _inputs(50, nx, ny)
    q = _clean(q)
    want = jfr.rof_fused_chunk_banded(
        *(jnp.asarray(a.numpy()) for a in (x, q, f, w)), *SCAL, count, 2,
        dataterm, interpret=True)
    got = tfr.rof_chunk_tiled_plain(x, q, f, w, torch.tensor(SCAL), count,
                                    dataterm, tile=(16, 32))
    _close(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 16), (24, 40)])
def test_tiled_halo_twin_matches_jax_banded_halo_mode(lo, hi):
    """A shard's halo-extended block (8 halo rows, zeros beyond the
    plane): the JAX kernel's outputs carry the owned rows (own_lo,
    out_rows, nx_global, row_offset0), the twin's the whole block."""
    nxg, ny, halo, count = 64, 45, 8, 3
    planes = _inputs(51, nxg, ny)
    planes[1] = _clean(planes[1])
    x, q, f, w = _band(planes, lo, hi, halo)
    want = jfr.rof_fused_chunk_banded(
        *(jnp.asarray(a.numpy()) for a in (x, q, f, w)), *SCAL, count, 2,
        "square", interpret=True, own_lo=halo, out_rows=hi - lo,
        nx_global=nxg, row_offset0=lo - halo)
    scal = torch.tensor(SCAL + [lo - halo, halo, halo + hi - lo])
    got = tfr.rof_chunk_tiled_plain(x, q, f, w, scal, count, "square",
                                    nx_global=nxg, tile=(8, 32))
    own = slice(halo, halo + hi - lo)
    _close([got[0][own], got[1][:, own], got[2][own], got[3][:, own],
            got[4]], want)


@pytest.mark.parametrize("stepsize", ["boyd", "alg1"])
def test_tiled_multichunk_twin_matches_jax_banded(stepsize):
    """3 chunks (an odd count: the JAX kernel's result in its second
    ping-pong slot), every one run."""
    nx, ny, count = 64, 40, 3
    x, _, f, w = _inputs(52, nx, ny)
    q = np.zeros((2, nx, ny), np.float32)
    scal = _mc_scal(0.0, torch.float32, 1.0, 1.0)
    want = jfr.rof_fused_multichunk_banded(
        jnp.asarray(x.numpy()), jnp.asarray(q), jnp.asarray(f.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(scal.numpy()), count, 3, 2,
        "square", stepsize, _consts(nx, ny), interpret=True)
    got = tfr.rof_multichunk_tiled_plain(
        x, torch.from_numpy(q), f, w, scal, count, 3, "square", stepsize,
        _consts(nx, ny), tile=(16, 32))
    _close(got[:5], want[:5])
    assert got[5][6].item() == float(want[5][6]) == 3.0
    np.testing.assert_allclose(got[5][:5].numpy(), np.asarray(want[5][:5]),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the shape rule
# ---------------------------------------------------------------------------

# (nx, ny, data term, multichunk?): config 1's 512x512 resident; the
# 2048x2048 and 2048x1536 planes and the 2092-row halo band of a 2048-wide
# plane (config 1's sharding at 2048, one shard, halo 22) tiled
RULE = [(512, 512, "square", False, "resident"),
        (512, 512, "wsquare", True, "resident"),
        (2048, 2048, "square", False, "tiled"),
        (2048, 2048, "square", True, "tiled"),
        (2048, 2048, "wsquare", True, "tiled"),
        (2048, 1536, "square", False, "tiled"),
        (2048, 1536, "wsquare", True, "tiled"),
        (2092, 2048, "square", False, "tiled"),
        (2092, 2048, "abs", False, "tiled")]


@pytest.mark.parametrize("nx,ny,dataterm,multi,want", RULE)
def test_rof_route_rule(nx, ny, dataterm, multi, want):
    assert tfr.route_of(nx, ny, dataterm, 10, H100_SMS, H100_SMEM,
                        H100_SMEM, multi) == want
    assert tfr.tiled_ok(nx, ny, 10, dataterm, H100_SMS, H100_SMEM)


@pytest.mark.parametrize("dataterm", ["square", "wsquare"])
@pytest.mark.parametrize("nx,ny,count", [(2048, 2048, 10), (2048, 1536, 10),
                                         (2092, 2048, 10), (2048, 2048, 1),
                                         (70, 53, 3), (2048, 2048, 39)])
def test_tiled_tile_fits_and_covers_the_norm_tiles(nx, ny, count, dataterm):
    tx, ty = tfr.tiled_tile(nx, ny, count, dataterm, H100_SMS, H100_SMEM)
    assert tx % 8 == 0 and ty % 32 == 0
    assert tfr.tiled_bytes(tx, ty, count, dataterm) <= H100_SMEM
    cb, rb = tfr.tiled_map(tx, ty, count)
    assert cb * rb <= tfr.TILE_WARPS


def test_tiled_bytes_count_the_window():
    """csrc's tiled_smem and tiled_map_ok by hand: a 104x64 tile of a chunk
    of 10 has a 125x85 window, its rows as wide as its map's 3 blocks of 32
    columns (96 floats); x, q_x, q_y and f after the block's 40-float head
    (192160 bytes; grad x is carried in registers), wsquare's w one plane
    more (240160: beyond a block, so wsquare takes another tile); the map
    is 3 blocks of columns by 10 of 13 rows, 30 of the block's 32 warps.
    A 112x64 tile's window needs 11 row blocks, 33 warps: refused."""
    assert tfr.tiled_bytes(104, 64, 10) == 4 * (4 * 125 * 96 + 40) == 192160
    assert tfr.tiled_bytes(104, 64, 10, "wsquare") == 240160
    assert tfr.tiled_bytes(104, 64, 10, "abs") == 192160
    assert tfr.tiled_map(104, 64, 10) == (3, 10)
    assert tfr.tiled_fits(104, 64, 10, "square", H100_SMEM)
    assert not tfr.tiled_fits(104, 64, 10, "wsquare", H100_SMEM)
    assert tfr.tiled_map(112, 64, 10) == (3, 11)
    assert not tfr.tiled_fits(112, 64, 10, "square", H100_SMEM)


def test_deep_chunks_stream():
    """A chunk of 41 iterations with wsquare (48 without) has a halo no
    window of an 8x32 tile holds in 227 KB (wsquare's 5 planes) or in the
    block's 32 warps (the map of 13-row strips): the rule streams, and
    ``tiled_tile`` says None; one iteration less still tiles."""
    for dataterm, deep in (("wsquare", 41), ("square", 48)):
        assert tfr.tiled_tile(2048, 2048, deep, dataterm, H100_SMS,
                              H100_SMEM) is None
        assert tfr.route_of(2048, 2048, dataterm, deep, H100_SMS, H100_SMEM,
                            H100_SMEM) == "streaming"
        assert tfr.tiled_tile(2048, 2048, deep - 1, dataterm, H100_SMS,
                              H100_SMEM) == (8, 32)


def test_cpu_wrappers_take_the_tiled_path_name():
    """On the CPU every path runs the plain version; "tiled" is a path
    the ROF wrappers know, and an unknown one raises."""
    x, q, f, w = _inputs(60, 24, 40)
    scal = torch.tensor(SCAL)
    got = {}
    for path in (None, "tiled"):
        cur, prev = [x.clone(), q.clone()], [x.clone(), q.clone()]
        norms2 = tfr.rof_chunk_(*cur, *prev, f, w, scal, 3, path=path)
        got[path] = cur + prev + [norms2]
    _equal(got["tiled"], got[None])
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tfr.rof_chunk_(x, q, x.clone(), q.clone(), f, w, scal, 3,
                       path="banded")
