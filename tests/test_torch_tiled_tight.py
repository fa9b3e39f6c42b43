"""The tiled tight chunk (row 22 of the kernel table, ``tight_chunk_`` and
``tight_chunk_halo_`` with ``path="tiled"``: a cooperative launch a chunk
over overlapping 2-D windows of the planes, a grid barrier between
iterations, for the planes no grid-resident band holds), as far as the
CPU can check it.

* Its plain twin, ``tight_chunk_tiled_plain``, runs ``chunk_core``'s
  arithmetic window by window with every mask decided by the pixel's
  place in the plane, K x of the iterate (kxq, su) recomputed in each
  window, and stitches the owned pixels: bit-equal, in f64 and f32, to
  ``tight_chunk_plain`` on shapes that the tiles do not divide, for the
  whole plane and halo bands, counts 1 to 3 and 10, a tile wider than the
  plane; its 32x8 tile partials, reduced in pdhg_finish's order, within
  rounding of the norms; with the flag set it returns its inputs.
* A one-pixel halo (``tight_tiled_halo``) keeps the owned pixels exact in
  f64, and halo 0 does not.
* The twin against the JAX banded kernel in interpret mode
  (``tight_fused_chunk_banded``, 2 and 3 bands, both double-buffer
  settings, and its sharded form on a halo-extended block): 1e-6 on the
  planes, 1e-5 relative on the norms; the port's fused route forced onto
  the twin against the JAX fused route forced onto its banded path.
* The shape rule (``tight_route_of``, ``tight_tiled_tile``,
  ``tight_tiled_bytes``) on an H100's SM count and shared-memory limit,
  and the CPU wrappers' ``path`` argument.

The kernel itself is held bit for bit against the streaming launch
sequence on the card by tests/test_torch_cuda_redesign.py (``-k
tight_tiled``) and chip_smoke.py (``phase_tiled_tight``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_tight as jt
from prost_tpu_torch.ops import fused_tight as tt
from prost_tpu_torch.ops.fused_rof import finish_sums
from prost_tpu_torch.parallel.spatial_fused import window
from test_torch_tight import (JFused, JOptions, TFused, TOptions,
                              _assert_runs_agree, _matched, _sopts,
                              pair_matrix, tight_model)

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into (the tiled kernels hold no static shared memory)
H100_SMS, H100_SMEM = 132, 232448
ARGS = [0.9, 1.1, 1.0, 0.7, 1.0]  # tau, sigma, theta, radius, d_s
DTYPES = {"f64": torch.float64, "f32": torch.float32}
CONSTS = (0.25, 1.0, 1 / 3, 0.2, 1 / 3)  # sig_q, sig_p, sig_s, tau_u, tau_v


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _taps(L):
    """P^T's nonzeros of the example's pair matrix for L labels."""
    k = L * (L - 1) // 2
    pt_ = pair_matrix(L).T
    return tuple((r, m, float(pt_[r, m])) for r in range(2 * L)
                 for m in range(2 * k) if pt_[r, m] != 0.0)


def _inputs(seed, L, nx, ny, dtype=torch.float32):
    """u, v, q (with mass on its boundary coordinates), p, s, f."""
    k = L * (L - 1) // 2
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.2 * rng.randn(2 * L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.1 * rng.randn(nx, ny), rng.rand(L, nx, ny))
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"output {i}"


# ---------------------------------------------------------------------------
# the twin against the plain version, bit for bit
# ---------------------------------------------------------------------------

# (L, nx, ny, count, tile): tiles that do not divide the plane, odd
# counts, a chunk of 10, a tile wider than the plane
CHUNK_CASES = [(3, 70, 53, 3, (16, 32)), (4, 9, 300, 10, (8, 64)),
               (3, 70, 53, 1, (24, 32)), (5, 33, 41, 2, (8, 32)),
               (2, 20, 30, 2, (64, 64))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,nx,ny,count,tile", CHUNK_CASES)
def test_tiled_twin_is_tight_chunk_plain(L, nx, ny, count, tile, dtype):
    """Window by window with one pixel of halo, the owned pixels are the
    whole plane's bit for bit, and so are the norms of the stitched
    planes."""
    dt = DTYPES[dtype]
    planes = _inputs(L + 7 * nx, L, nx, ny, dt)
    scal = torch.tensor(ARGS, dtype=dt)
    want = tt.tight_chunk_plain(*planes, scal, count, _taps(L), CONSTS)
    got = tt.tight_chunk_tiled_plain(*planes, scal, count, _taps(L), CONSTS,
                                     tile=tile)
    _equal(got, want)


# halo bands of a 48x40x3 plane: ri 2 (halo 6) on 4 shards of 12 rows and
# on one shard, ri 3 (halo 8) on an interior band
BL, BNX, BNY = 3, 48, 40


def _band(seed, shards, rank, ri, dtype=torch.float32):
    """The halo-extended block of ``rank`` of ``shards`` (zeros beyond the
    plane) and its scal8."""
    planes = _inputs(seed, BL, BNX, BNY, dtype)
    H, rows = 2 * ri + 2, BNX // shards
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor(ARGS + [lo, H, H + rows], dtype=dtype)
    return ext, scal


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shards,rank,ri", [(4, 0, 2), (4, 1, 2), (4, 3, 2),
                                            (1, 0, 2), (4, 2, 3)])
def test_tiled_twin_halo_is_tight_chunk_plain(shards, rank, ri, dtype):
    """The halo form on the top, an interior, the bottom band and the
    one-shard band: ``tight_chunk_halo_plain`` bit for bit, norms over the
    owned rows."""
    ext, scal = _band(3 + rank, shards, rank, ri, DTYPES[dtype])
    want = tt.tight_chunk_halo_plain(*ext, scal, ri, BNX, _taps(BL), CONSTS)
    got = tt.tight_chunk_tiled_plain(*ext, scal, ri, _taps(BL), CONSTS, BNX,
                                     tile=(8, 32))
    _equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("band", [False, True])
def test_tiled_partials_reduce_to_the_norms(band, dtype):
    """The 32x8 tiles' partials of the stitched planes (over the owned rows
    of a band), summed in pdhg_finish's order (thread t of 512 takes tiles
    t, t + 512, ..., then a tree), are the norms within the rounding of a
    different order."""
    dt = DTYPES[dtype]
    if band:
        ext, scal = _band(8, 4, 1, 2, dt)
        *out, partial = tt.tight_chunk_tiled_plain(
            *ext, scal, 2, _taps(BL), CONSTS, BNX, tile=(16, 32),
            partials=True)
        nx, ny = ext[4].shape
    else:
        planes = _inputs(11, 4, 70, 77, dt)
        *out, partial = tt.tight_chunk_tiled_plain(
            *planes, torch.tensor(ARGS, dtype=dt), 3, _taps(4), CONSTS,
            tile=(16, 32), partials=True)
        nx, ny = planes[4].shape
    assert partial.shape == (-(-nx // 8) * -(-ny // 32), 4)
    rtol = 1e-12 if dt == torch.float64 else 1e-5
    torch.testing.assert_close(finish_sums(partial), out[10], rtol=rtol,
                               atol=0.0)


def test_tiled_twin_with_the_flag_returns_the_inputs():
    """With the converged flag set at entry the twin gives back its inputs
    and zero norms, on the whole plane and on a band."""
    planes = _inputs(5, 3, 33, 41)
    got = tt.tight_chunk_tiled_plain(*planes, torch.tensor(ARGS + [1.0]), 2,
                                     _taps(3), CONSTS, tile=(8, 32))
    _equal(got[:10], planes[:5] * 2)
    assert torch.equal(got[10], torch.zeros(4))
    ext, scal8 = _band(6, 4, 2, 2)
    got = tt.tight_chunk_tiled_plain(*ext, torch.cat([scal8, torch.ones(1)]),
                                     2, _taps(BL), CONSTS, BNX, tile=(8, 32))
    _equal(got[:10], ext[:5] * 2)
    assert torch.equal(got[10], torch.zeros(4))


@pytest.mark.parametrize("L", [3, 5])
def test_one_pixel_halo_is_exact_and_halo_zero_is_not(L):
    """One pixel of halo keeps the owned pixels exact; without it the dual
    step at a window's edge reads the new u of a pixel the window does not
    hold, and the owned pixels next to it take it in.  In f64."""
    planes = _inputs(31 + L, L, 60, 70, torch.float64)
    scal = torch.tensor(ARGS, dtype=torch.float64)
    want = tt.tight_chunk_plain(*planes, scal, 2, _taps(L), CONSTS)
    assert tt.tight_tiled_halo() == 1
    got = tt.tight_chunk_tiled_plain(*planes, scal, 2, _taps(L), CONSTS,
                                     tile=(24, 32), halo=1)
    _equal(got, want)
    short = tt.tight_chunk_tiled_plain(*planes, scal, 2, _taps(L), CONSTS,
                                       tile=(24, 32), halo=0)
    assert not all(torch.equal(a, b) for a, b in zip(short[:10], want[:10]))


# ---------------------------------------------------------------------------
# against the JAX banded kernel and the JAX fused route (interpret mode)
# ---------------------------------------------------------------------------

def _close(got, new, prev, norms):
    ref = tuple(new) + tuple(prev)
    for i, (a, b) in enumerate(zip(got[:10], ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6, err_msg=f"plane {i}")
    np.testing.assert_allclose(got[10].numpy(), np.asarray(norms),
                               rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("n_bands", [2, 3])
def test_tiled_twin_matches_jax_banded(n_bands, double_buffer):
    """``tight_fused_chunk_banded`` (48x40x3 in bands of 24 or 16 rows
    with the 8-rounded halo of 16, ri 4) against the twin with 16x32
    tiles."""
    L, nx, ny, ri = 3, 48, 40, 4
    m = _matched(L, nx, ny)
    planes = [a.numpy() for a in _inputs(21, L, nx, ny)[:5]]
    args = (0.9, 1.1, 1.0, m["radius"], m["d_s"])
    new, prev, norms = jt.tight_fused_chunk_banded(
        *map(jnp.asarray, planes), jnp.asarray(m["f"]), *args, ri,
        m["taps"], m["consts"], n_bands, interpret=True,
        double_buffer=double_buffer)
    got = tt.tight_chunk_tiled_plain(
        *map(torch.from_numpy, planes), torch.from_numpy(m["f"]),
        torch.tensor(args), ri, m["taps"], m["consts"], tile=(16, 32))
    _close(got, new, prev, norms)


@pytest.mark.parametrize("rank", [0, 1])
def test_tiled_twin_matches_jax_banded_sharded(rank):
    """The sharded form of ``tight_fused_chunk_banded`` (the JAX halo route
    on a band: own_lo, out_rows, nx_global, row_offset0) on rank ``rank``
    of two shards of a 48x40x3 plane (24 rows, ri 3, halo 8, 3 bands of 8
    owned rows) against the twin's halo form on the same extended block,
    its owned rows."""
    L, nx, ny, ri = 3, 48, 40, 3
    H, rows = 2 * ri + 2, nx // 2
    m = _matched(L, nx, ny)
    planes = _inputs(23, L, nx, ny)[:5] + [torch.from_numpy(m["f"])]
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    args = [0.9, 1.1, 1.0, m["radius"], m["d_s"]]
    new, prev, norms = jt.tight_fused_chunk_banded(
        *(jnp.asarray(a.numpy()) for a in ext), *args, ri, m["taps"],
        m["consts"], 3, interpret=True, own_lo=H, out_rows=rows,
        nx_global=nx, row_offset0=lo)
    got = tt.tight_chunk_tiled_plain(
        *ext, torch.tensor(args + [lo, H, H + rows]), ri, m["taps"],
        m["consts"], nx, tile=(16, 32))
    own = (..., slice(H, H + rows), slice(None))
    _close([a[own] for a in got[:10]] + [got[10]], new, prev, norms)


def test_fused_route_on_the_tiled_twin_matches_jax_banded(monkeypatch):
    """The port's ``FusedROFPDHG`` (tight route) with its chunks forced
    onto the twin (16x32 tiles) against the JAX fused route forced onto
    its banded path (2 bands of 16 rows, ``tight_fused_chunk_banded``),
    40 iterations of boyd at ri 3."""
    calls = {"chunk": 0}

    def chunk(u, v, q, p, s, f, scal, count, taps, consts, rows=None,
              n_scal=5):
        calls["chunk"] += 1
        return tt.tight_chunk_tiled_plain(u, v, q, p, s, f, scal, count,
                                          taps, consts, tile=(16, 32))

    monkeypatch.setattr(tt, "tight_chunk_plain", chunk)
    popts = dict(stepsize="boyd", residual_iter=3, scale_steps_operator=False)
    jb = JFused(tight_model(pt, 32, 16, L=3, lmb=0.8, seed=22)[0].finalize(),
                JOptions(**popts), _sopts(pt), interpret=True)
    jb.tight["n_bands"] = 2
    tb = TFused(tight_model(ptt, 32, 16, L=3, lmb=0.8, seed=22)[0].finalize(),
                TOptions(**popts), _sopts(ptt))
    assert tb.tight is not None
    js = jb.run(jb.initial_state(), 40)
    ts = tb.run(tb.initial_state(), 40, 0)
    assert calls["chunk"] > 0
    assert int(ts.iteration) == 40
    _assert_runs_agree(ts, js)


# ---------------------------------------------------------------------------
# the shape rule and the CPU wrappers
# ---------------------------------------------------------------------------

# (L, k, ntaps, nx, ny, route) on an H100: tight128x4 and its one-shard
# band of 172 rows resident, the JAX package's banded 512x512x4 tiled (its
# one-shard halo band of 556 rows too), 6 labels streaming, and pairs
# other than L(L - 1)/2 streaming
ROUTE_CASES = [(4, 6, 24, 128, 128, "resident"), (4, 6, 24, 172, 128,
                                                  "resident"),
               (4, 6, 24, 512, 512, "tiled"), (4, 6, 24, 556, 512, "tiled"),
               (5, 10, 40, 512, 512, "tiled"), (6, 15, 60, 512, 512,
                                                "streaming"),
               (4, 5, 20, 512, 512, "streaming")]


@pytest.mark.parametrize("L,k,ntaps,nx,ny,want", ROUTE_CASES)
def test_tight_route_rule(L, k, ntaps, nx, ny, want):
    assert tt.tight_route_of(L, k, ntaps, nx, ny, H100_SMS, H100_SMEM,
                             H100_SMEM) == want


@pytest.mark.parametrize("L,n", [(4, 512), (4, 556), (5, 300), (2, 1000)])
def test_tight_tiled_tile_fits_and_covers_the_norm_tiles(L, n):
    """The rule's tile is a multiple of the 32x8 norm tiles, its window
    fits, and no tile of the search with fewer window pixels moved fits;
    at 512x512x4 it is the 64x32 tile (one round of 132 blocks)."""
    k = L * (L - 1) // 2
    T = len(_taps(L))
    tx, ty = tt.tight_tiled_tile(n, 512, L, k, T, H100_SMS, H100_SMEM)
    assert tx % 8 == 0 and ty % 32 == 0
    assert tt.tight_tiled_bytes(tx, ty, L, k, T) <= H100_SMEM

    def cost(a, b):
        rounds = -(-(-(-n // a) * -(-512 // b)) // H100_SMS)
        return rounds * (min(a, n) + 2) * (min(b, 512) + 2)

    best = cost(tx, ty)
    for a in range(8, 257, 8):
        for b in range(32, 257, 32):
            if (a - 8 < n and tt.tight_tiled_bytes(a, b, L, k, T)
                    <= H100_SMEM):
                assert cost(a, b) >= best
    if (L, n) == (4, 512):
        assert (tx, ty) == (64, 32)


def test_tight_tiled_bytes_count_the_window():
    """The taps (to 16 bytes), 4L + 1 planes of the tile and one pixel each
    way and 4k floats for each of 512 threads (202224 bytes for a 64x32
    tile at L = 4, 24 taps; the threads' floats hold the norm pass's two
    32x8 trees)."""
    assert tt.tight_tiled_bytes(64, 32, 4, 6, 24) == 4 * (
        120 + 17 * 66 * 34 + 24 * 512) == 202224
    assert tt.tight_tiled_bytes(8, 32, 2, 1, 4) == 4 * (
        24 + 9 * 10 * 34 + 4 * 512)
    assert not tt.tight_tiled_ok(6, 15, 60, 512, 512, H100_SMS, H100_SMEM)
    assert not tt.tight_tiled_ok(4, 6, 24, 512, 512, H100_SMS, 60000)


def test_cpu_wrappers_take_the_tiled_path_name():
    """On the CPU ``path="tiled"`` runs the plain version (the tensors'
    device decides), an unknown path raises, and the light call keeps no
    route."""
    planes = _inputs(9, 3, 24, 40)
    scal = torch.tensor(ARGS)
    want = tt.tight_chunk_plain(*planes, scal, 2, _taps(3), CONSTS)
    cur = [t.clone() for t in planes[:5]]
    prev = [t.clone() for t in cur]
    norms2 = tt.tight_chunk_(*cur, *prev, planes[5], scal, 2, _taps(3),
                             CONSTS, path="tiled")
    _equal(cur + prev + [norms2], list(want))
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tt.tight_chunk_(*cur, *prev, planes[5], scal, 2, _taps(3), CONSTS,
                        path="banded")
    ext, scal8 = _band(4, 4, 1, 2)
    bcur = [t.clone() for t in ext[:5]]
    bprev = [t.clone() for t in bcur]
    want = tt.tight_chunk_halo_plain(*ext, scal8, 2, BNX, _taps(BL), CONSTS)
    norms2 = tt.tight_chunk_halo_(*bcur, *bprev, ext[5], scal8, 2, BNX,
                                  _taps(BL), CONSTS, path="tiled")
    _equal(bcur + bprev + [norms2], list(want))
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tt.tight_chunk_halo_(*bcur, *bprev, ext[5], scal8, 2, BNX,
                             _taps(BL), CONSTS, path="banded")
    m = {"L": 3, "k": 3, "nx": 24, "ny": 40, "taps": _taps(3),
         "consts": CONSTS, "radius": 0.7, "d_s": 1.0}
    call = tt.TightChunk(m, 2, torch.device("cpu"), path="tiled")
    assert call.route is None and call.resident is None
