"""The tiled volumetric chunk and multichunk (rows 28 and 27 of the kernel
table, ``vol_chunk_``, ``vol_chunk_halo_`` and ``vol_multichunk_`` with
``path="tiled"``: a cooperative launch a chunk over overlapping 2-D
windows of the volume, a grid barrier between iterations, for the volumes
no grid-resident band holds), as far as the CPU can check it.

* Its plain twin, ``vol_chunk_tiled_plain``, runs ``_vol_update``'s
  arithmetic window by window with every mask decided by the pixel's
  place in the volume and the carried gradient recomputed in each window,
  and stitches the owned pixels: bit-equal, in f64 and f32, to
  ``vol_chunk_plain`` with the three data terms, on shapes that the tiles
  do not divide, for the whole volume and halo bands of 1, 2 and 4
  shards, counts 1, 3 and 10, a tile wider than the volume; its 32x8 tile
  partials, reduced in pdhg_finish's order, within rounding of the norms;
  with the flag set it returns its inputs.
* A one-pixel halo (``vol_tiled_halo``) keeps the owned pixels exact in
  f64, and halo 0 does not.
* The twin against the JAX banded kernels in interpret mode
  (``vol_fused_chunk_banded``, 2 and 3 bands, both double-buffer settings,
  and its sharded form; ``vol_fused_multichunk_banded`` through
  ``vol_multichunk_tiled_plain``, boyd converging partway): 1e-6 on the
  planes, 1e-5 relative on the norms; the port's fused route forced onto
  the twins against the JAX fused route forced onto its banded
  volumetric path.
* The shape rule (``vol_route_of``, ``vol_tiled_tile``,
  ``vol_tiled_bytes``) on an H100's SM count and shared-memory limit.

The kernel itself is held bit for bit against the streaming launch
sequence on the card by tests/test_torch_cuda_redesign.py (``-k
vol_tiled``) and chip_smoke.py (``phase_tiled_vol``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_vol as jv
from prost_tpu_torch.ops import fused_vol as tv
from prost_tpu_torch.ops.fused_rof import finish_sums
from prost_tpu_torch.parallel.spatial_fused import window
from test_torch_vol import (JFused, JOptions, TFused, TOptions,
                            _assert_runs_agree, _mc_consts, _scal13, _sopts,
                            vol_model)

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into (the tiled kernels hold no static shared memory)
H100_SMS, H100_SMEM = 132, 232448
ARGS = [0.9, 1.1, 1.0, 6.0, 0.5]  # tau, sigma, theta, lmb, radius
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _inputs(seed, L, nx, ny, dtype=torch.float32):
    """u, q (mass on the dead coordinates), f, w."""
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.3 * rng.randn(3, L, nx, ny),
            rng.rand(L, nx, ny), 2.0 * (rng.rand(L, nx, ny) > 0.3))
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"output {i}"


# ---------------------------------------------------------------------------
# the twin against the plain version, bit for bit
# ---------------------------------------------------------------------------

# (L, nx, ny, count, tile, data term): tiles that do not divide the
# volume, odd counts, a chunk of 10, a tile wider than the volume
CHUNK_CASES = [(3, 30, 45, 3, (16, 32), "square"),
               (2, 9, 70, 10, (8, 64), "wsquare"),
               (3, 30, 45, 1, (24, 32), "abs"),
               (1, 17, 33, 3, (8, 32), "wsquare"),
               (2, 20, 30, 10, (64, 64), "square"),
               (4, 26, 40, 1, (8, 32), "square")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,nx,ny,count,tile,dataterm", CHUNK_CASES)
def test_tiled_twin_is_vol_chunk_plain(L, nx, ny, count, tile, dataterm,
                                       dtype):
    """Window by window with one pixel of halo, the owned pixels are the
    whole volume's bit for bit, and so are the norms of the stitched
    volumes."""
    dt = DTYPES[dtype]
    u, q, f, w = _inputs(L + 7 * nx, L, nx, ny, dt)
    scal = torch.tensor(ARGS, dtype=dt)
    want = tv.vol_chunk_plain(u, q, f, w, scal, count, dataterm)
    got = tv.vol_chunk_tiled_plain(u, q, f, w, scal, count, dataterm,
                                   tile=tile)
    _equal(got, want)


# halo bands of a 48x20x2 volume: ri 2 (halo 6) on 4 shards of 12 rows, on
# 2 shards and on one shard, ri 3 (halo 8) on an interior band
BL, BNX, BNY = 2, 48, 20


def _band(seed, shards, rank, ri, dtype=torch.float32):
    """The halo-extended block of ``rank`` of ``shards`` (zeros beyond the
    volume) and its scal8."""
    planes = _inputs(seed, BL, BNX, BNY, dtype)
    H, rows = 2 * ri + 2, BNX // shards
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor(ARGS + [lo, H, H + rows], dtype=dtype)
    return ext, scal


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shards,rank,ri,dataterm",
                         [(4, 0, 2, "square"), (4, 1, 2, "wsquare"),
                          (4, 3, 2, "abs"), (2, 1, 2, "square"),
                          (1, 0, 2, "wsquare"), (4, 2, 3, "square")])
def test_tiled_twin_halo_is_vol_chunk_plain(shards, rank, ri, dataterm,
                                            dtype):
    """The halo form on the top, an interior and the bottom band of 4
    shards, a band of 2 and the one-shard band: ``vol_chunk_halo_plain``
    bit for bit, norms over the owned rows."""
    ext, scal = _band(3 + rank, shards, rank, ri, DTYPES[dtype])
    want = tv.vol_chunk_halo_plain(*ext, scal, ri, BNX, dataterm)
    got = tv.vol_chunk_tiled_plain(*ext, scal, ri, dataterm, BNX,
                                   tile=(8, 32))
    _equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("band", [False, True])
def test_tiled_partials_reduce_to_the_norms(band, dtype):
    """The 32x8 tiles' partials of the stitched volumes (over the owned
    rows of a band), summed in pdhg_finish's order (thread t of 512 takes
    tiles t, t + 512, ..., then a tree), are the norms within the rounding
    of a different order."""
    dt = DTYPES[dtype]
    if band:
        ext, scal = _band(8, 4, 1, 2, dt)
        *out, partial = tv.vol_chunk_tiled_plain(
            *ext, scal, 2, "square", BNX, tile=(16, 32), partials=True)
        nx, ny = ext[0].shape[1:]
    else:
        u, q, f, w = _inputs(11, 3, 40, 77, dt)
        *out, partial = tv.vol_chunk_tiled_plain(
            u, q, f, w, torch.tensor(ARGS, dtype=dt), 3, "wsquare",
            tile=(16, 32), partials=True)
        nx, ny = u.shape[1:]
    assert partial.shape == (-(-nx // 8) * -(-ny // 32), 4)
    rtol = 1e-12 if dt == torch.float64 else 1e-5
    torch.testing.assert_close(finish_sums(partial), out[4], rtol=rtol,
                               atol=0.0)


def test_tiled_twin_with_the_flag_returns_the_inputs():
    """With the converged flag set at entry the twin gives back its inputs
    and zero norms, on the whole volume and on a band."""
    u, q, f, w = _inputs(5, 3, 21, 41)
    got = tv.vol_chunk_tiled_plain(u, q, f, w, torch.tensor(ARGS + [1.0]), 2,
                                   tile=(8, 32))
    _equal(got[:4], [u, q, u, q])
    assert torch.equal(got[4], torch.zeros(4))
    ext, scal8 = _band(6, 4, 2, 2)
    got = tv.vol_chunk_tiled_plain(*ext, torch.cat([scal8, torch.ones(1)]),
                                   2, "square", BNX, tile=(8, 32))
    _equal(got[:4], ext[:2] * 2)
    assert torch.equal(got[4], torch.zeros(4))


@pytest.mark.parametrize("L", [1, 3])
def test_one_pixel_halo_is_exact_and_halo_zero_is_not(L):
    """One pixel of halo keeps the owned pixels exact; without it the dual
    step at a window's edge reads the new u of a pixel the window does not
    hold, and the owned pixels next to it take it in.  In f64."""
    u, q, f, w = _inputs(31 + L, L, 40, 70, torch.float64)
    scal = torch.tensor(ARGS, dtype=torch.float64)
    want = tv.vol_chunk_plain(u, q, f, w, scal, 2)
    assert tv.vol_tiled_halo() == 1
    got = tv.vol_chunk_tiled_plain(u, q, f, w, scal, 2, tile=(16, 32),
                                   halo=1)
    _equal(got, want)
    short = tv.vol_chunk_tiled_plain(u, q, f, w, scal, 2, tile=(16, 32),
                                     halo=0)
    assert not all(torch.equal(a, b) for a, b in zip(short[:4], want[:4]))


@pytest.mark.parametrize("dataterm", ["square", "abs"])
def test_tiled_multichunk_twin_is_vol_multichunk_plain(dataterm):
    """``vol_multichunk_tiled_plain`` is ``vol_multichunk_plain`` bit for
    bit (an odd count, converging partway under boyd)."""
    L, nx, ny = 3, 16, 20
    f = _inputs(41, L, nx, ny)[2]
    q = torch.zeros((3, L, nx, ny))
    scal = torch.tensor(_scal13(1e-2))
    consts = _mc_consts(L, nx, ny)
    want = tv.vol_multichunk_plain(f, q, f, f, scal, 3, 8, dataterm, "boyd",
                                   consts)
    got = tv.vol_multichunk_tiled_plain(f, q, f, f, scal, 3, 8, dataterm,
                                        "boyd", consts, tile=(8, 32))
    _equal(got, want)
    assert got[5][5].item() == 1.0 and 1 <= got[5][6].item() < 8


# ---------------------------------------------------------------------------
# against the JAX banded kernels and the JAX fused route (interpret mode)
# ---------------------------------------------------------------------------

def _clean(u, q, f, w):
    """Inputs with the dead dual coordinates zero: the JAX banded kernels
    take them clean (their route zeroes them once)."""
    q = q.clone()
    q[0, :, -1, :] = 0.0
    q[1, :, :, -1] = 0.0
    return [u, q, f, w]


def _close(got, ref, n_planes=4):
    for i, (a, b) in enumerate(zip(got[:n_planes], ref[:n_planes])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6, err_msg=f"plane {i}")
    np.testing.assert_allclose(got[n_planes].numpy(),
                               np.asarray(ref[n_planes]), rtol=1e-5,
                               atol=1e-10)


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("n_bands", [2, 3])
def test_tiled_twin_matches_jax_banded(n_bands, double_buffer):
    """``vol_fused_chunk_banded`` (48x16x3 in bands of 24 or 16 rows with
    the 8-rounded halo of 8, ri 3) against the twin with 16x32 tiles."""
    L, nx, ny, ri = 3, 48, 16, 3
    planes = _clean(*_inputs(21, L, nx, ny))
    ref = jv.vol_fused_chunk_banded(
        *(jnp.asarray(a.numpy()) for a in planes), *ARGS, ri, n_bands,
        interpret=True, double_buffer=double_buffer)
    got = tv.vol_chunk_tiled_plain(*planes, torch.tensor(ARGS), ri,
                                   tile=(16, 32))
    _close(got, ref)


@pytest.mark.parametrize("rank", [0, 1])
def test_tiled_twin_matches_jax_banded_sharded(rank):
    """The sharded form of ``vol_fused_chunk_banded`` (the JAX halo route
    on a band: own_lo, out_rows, nx_global, row_offset0) on rank ``rank``
    of two shards of a 48x16x2 volume (24 rows, ri 3, halo 8, 3 bands of 8
    owned rows, wsquare) against the twin's halo form on the same extended
    block, its owned rows."""
    L, nx, ny, ri = 2, 48, 16, 3
    H, rows = 2 * ri + 2, nx // 2
    planes = _clean(*_inputs(23, L, nx, ny))
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    ref = jv.vol_fused_chunk_banded(
        *(jnp.asarray(a.numpy()) for a in ext), *ARGS, ri, 3,
        dataterm="wsquare", interpret=True, own_lo=H, out_rows=rows,
        nx_global=nx, row_offset0=lo)
    got = tv.vol_chunk_tiled_plain(
        *ext, torch.tensor(ARGS + [lo, H, H + rows]), ri, "wsquare", nx,
        tile=(16, 32))
    own = (..., slice(H, H + rows), slice(None))
    _close([a[own] for a in got[:4]] + [got[4]], ref)


def test_tiled_multichunk_twin_matches_jax_banded():
    """``vol_fused_multichunk_banded`` (64x16x3 in 2 bands of 32 rows, ri
    3, boyd at tolerance 1e-2: a solve's start that converges partway)
    against ``vol_multichunk_tiled_plain``: the planes, the previous
    iterates, the sqrt'd norms and the 7 adaptation scalars, sout's flag
    and chunk count exactly."""
    L, nx, ny, ri = 3, 64, 16, 3
    f = _inputs(22, L, nx, ny)[2]
    q = torch.zeros((3, L, nx, ny))
    scal = np.asarray(_scal13(1e-2), np.float32)
    consts = _mc_consts(L, nx, ny)
    ref = jv.vol_fused_multichunk_banded(
        *(jnp.asarray(a.numpy()) for a in (f, q, f, f)), jnp.asarray(scal),
        ri, 8, 2, "square", "boyd", consts, interpret=True)
    got = tv.vol_multichunk_tiled_plain(f, q, f, f, torch.from_numpy(scal),
                                        ri, 8, "square", "boyd", consts,
                                        tile=(16, 32))
    _close(got, ref)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5])[:7],
                               rtol=1e-6)
    assert got[5][5:].tolist() == np.asarray(ref[5])[5:7].tolist()
    assert got[5][5].item() == 1.0 and got[5][6].item() < 8


def test_fused_route_on_the_tiled_twins_matches_jax_banded(monkeypatch):
    """The port's ``FusedROFPDHG`` (volumetric route) with its chunks and
    multichunks forced onto the twins (16x32 tiles) against the JAX fused
    route forced onto its banded volumetric path (2 bands, double-buffered:
    ``vol_fused_multichunk_banded`` in phase B0, ``vol_fused_chunk_banded``
    in phase B), 80 iterations of boyd at ri 3 (3 multichunks from
    iteration 1, 2 chunks from 73)."""
    calls = {"chunk": 0, "multi": 0}

    def chunk(u, q, f, w, scal, count, dataterm="square", rows=None,
              n_scal=5):
        calls["chunk"] += 1
        return tv.vol_chunk_tiled_plain(u, q, f, w, scal, count, dataterm,
                                        tile=(16, 32))

    def multi(u, q, f, w, scal, count, k_chunks, dataterm, stepsize,
              consts):
        calls["multi"] += 1
        return tv.vol_multichunk_tiled_plain(u, q, f, w, scal, count,
                                             k_chunks, dataterm, stepsize,
                                             consts, tile=(16, 32))

    monkeypatch.setattr(tv, "vol_chunk_plain", chunk)
    monkeypatch.setattr(tv, "vol_multichunk_plain", multi)
    L, nx, ny = 3, 32, 16
    rng = np.random.RandomState(24)
    data = (np.repeat(np.linspace(0.2, 0.8, nx)[None, :, None], L, 0)
            * np.ones((1, 1, ny)) + 0.1 * rng.randn(L, nx, ny)).reshape(-1)
    popts = dict(stepsize="boyd", residual_iter=3, scale_steps_operator=False)
    jb = JFused(vol_model(pt, nx, ny, L, data, 6.0)[0].finalize(),
                JOptions(**popts), _sopts(pt, 1e-5), interpret=True)
    jb.vol["n_bands"], jb.vol["double_buffer"] = 2, True
    tb = TFused(vol_model(ptt, nx, ny, L, data, 6.0)[0].finalize(),
                TOptions(**popts), _sopts(ptt, 1e-5))
    assert tb.vol is not None
    js = jb.run(jb.initial_state(), 80)
    ts = tb.run(tb.initial_state(), 80, 0)
    assert calls == {"chunk": 2, "multi": 3}
    assert int(ts.iteration) == 80
    _assert_runs_agree(ts, js)


# ---------------------------------------------------------------------------
# the shape rule and the CPU wrappers
# ---------------------------------------------------------------------------

# (L, nx, ny, data term, multi, route) on an H100: vol256x8 resident (chunk
# and multichunk), the JAX package's banded 512x512x8 tiled (chunk and
# multichunk, every data term; its one-shard halo band of 556 rows too),
# 9 labels streaming
ROUTE_CASES = [(8, 256, 256, "square", False, "resident"),
               (8, 256, 256, "square", True, "resident"),
               (8, 512, 512, "square", False, "tiled"),
               (8, 512, 512, "square", True, "tiled"),
               (8, 512, 512, "wsquare", True, "tiled"),
               (8, 556, 512, "square", False, "tiled"),
               (8, 556, 512, "abs", False, "tiled"),
               (9, 512, 512, "square", False, "streaming")]


@pytest.mark.parametrize("L,nx,ny,dataterm,multi,want", ROUTE_CASES)
def test_vol_route_rule(L, nx, ny, dataterm, multi, want):
    smem = H100_SMEM if L <= tv.MAX_RESIDENT_L else 0
    assert tv.vol_route_of(L, nx, ny, dataterm, H100_SMS, smem, H100_SMEM,
                           multi) == want


@pytest.mark.parametrize("L,nx,ny", [(8, 512, 512), (8, 556, 512),
                                     (5, 300, 300), (2, 1000, 1000)])
def test_vol_tiled_tile_fits_and_covers_the_norm_tiles(L, nx, ny):
    """The rule's tile is a multiple of the 32x8 norm tiles, its window
    fits, and no tile of the search with fewer window pixels moved fits;
    at 512x512x8 it is the 32x32 tile (two rounds of 132 blocks), on the
    556-row band 24x32."""
    tx, ty = tv.vol_tiled_tile(nx, ny, L, H100_SMS, H100_SMEM)
    assert tx % 8 == 0 and ty % 32 == 0
    assert tv.vol_tiled_bytes(tx, ty, L) <= H100_SMEM

    def cost(a, b):
        rounds = -(-(-(-nx // a) * -(-ny // b)) // H100_SMS)
        return rounds * (min(a, nx) + 3) * (min(b, ny) + 3)

    best = cost(tx, ty)
    for a in range(8, 257, 8):
        for b in range(32, 257, 32):
            if (a - 8 < nx and b - 32 < ny
                    and tv.vol_tiled_bytes(a, b, L) <= H100_SMEM):
                assert cost(a, b) >= best
    if (L, nx) == (8, 512):
        assert (tx, ty) == (32, 32)
    if (L, nx) == (8, 556):
        assert (tx, ty) == (24, 32)


def test_vol_tiled_bytes_count_the_window():
    """5L planes of the tile, one pixel after it and two before it on each
    axis, and L planes of the tile (228768 bytes for a 32x32 tile at L =
    8; 8724 for an 8x32 tile at L = 1, above the norm pass's two 32x8
    trees)."""
    assert tv.vol_tiled_bytes(32, 32, 8) == 4 * (40 * 35 * 35 + 8 * 1024) \
        == 228768
    assert tv.vol_tiled_bytes(8, 32, 1) == 4 * (5 * 11 * 35 + 8 * 32) \
        == 8724 > 4 * 2 * 4 * 256
    assert not tv.vol_tiled_ok(9, 512, 512, H100_SMS, H100_SMEM)
    assert not tv.vol_tiled_ok(8, 512, 512, H100_SMS, 40000)


def test_cpu_wrappers_take_the_tiled_path_name():
    """On the CPU ``path="tiled"`` runs the plain version (the tensors'
    device decides), an unknown path raises, and the light calls keep no
    route."""
    u, q, f, w = _inputs(9, 3, 24, 40)
    scal = torch.tensor(ARGS)
    want = tv.vol_chunk_plain(u, q, f, w, scal, 2)
    cur = [t.clone() for t in (u, q)]
    prev = [t.clone() for t in cur]
    norms2 = tv.vol_chunk_(*cur, *prev, f, w, scal, 2, path="tiled")
    _equal(cur + prev + [norms2], list(want))
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tv.vol_chunk_(*cur, *prev, f, w, scal, 2, path="banded")
    ext, scal8 = _band(4, 4, 1, 2)
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tv.vol_chunk_halo_(*ext[:2], *[t.clone() for t in ext[:2]], *ext[2:],
                           scal8, 2, BNX, path="banded")
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tv.vol_multichunk_(*cur, *prev, f, w, torch.tensor(_scal13(0.0)), 2,
                           2, "square", "boyd", _mc_consts(3, 24, 40),
                           path="banded")
    m = {"L": 3, "nx": 24, "ny": 40, "f": f, "w": w, "lmb": 6.0,
         "radius": 0.5, "dataterm": "square"}
    call = tv.VolChunk(m, 2, torch.device("cpu"), path="tiled")
    assert call.route is None and call.resident is None
