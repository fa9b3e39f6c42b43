"""The tiled multilabel chunk and multichunk (rows 16 and 14 of the kernel
table, ``ml_chunk_``, ``ml_chunk_halo_`` and ``ml_multichunk_`` with
``path="tiled"``: a cooperative launch a chunk over overlapping 2-D
windows of the planes, a grid barrier between iterations, for the planes
no grid-resident band holds), as far as the CPU can check it.

* Its plain twin, ``ml_chunk_tiled_plain``, runs ``_ml_update``'s
  arithmetic window by window with every mask decided by the pixel's
  place in the plane, the carried gradient and label sum recomputed in
  each window, and stitches the owned pixels: bit-equal, in f64 and f32,
  to ``ml_chunk_plain`` on shapes that the tiles do not divide, for the
  whole plane and halo bands, counts 1 to 3 and 10, a tile wider than the
  plane; its 32x8 tile partials, reduced in pdhg_finish's order, within
  rounding of the norms; with the flag set it returns its inputs.
* A one-pixel halo (``ml_tiled_halo``) keeps the owned pixels exact in
  f64, and halo 0 does not.
* The twin against the JAX banded kernels in interpret mode
  (``ml_fused_chunk_banded``, 2 and 3 bands, both double-buffer settings;
  ``ml_fused_multichunk_banded`` through ``ml_multichunk_tiled_plain``):
  1e-6 on the planes, 1e-5 relative on the norms; the port's fused route
  forced onto the twins against the JAX fused route forced onto its
  banded multilabel path.
* The shape rule (``ml_route_of``, ``ml_tiled_tile``, ``ml_tiled_bytes``)
  on an H100's SM count and shared-memory limit.

The kernel itself is held bit for bit against the streaming launch
sequence on the card by tests/test_torch_cuda_redesign.py (``-k
ml_tiled``) and chip_smoke.py (``phase_tiled_ml``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.ops import fused_multilabel as jml
from prost_tpu_torch.ops import fused_multilabel as tml
from prost_tpu_torch.ops.fused_rof import finish_sums
from prost_tpu_torch.parallel.spatial_fused import window
from test_torch_fused_multilabel import (JFused, JOptions, TFused, TOptions,
                                         _assert_runs_agree, _consts,
                                         _scal13, _sopts, ml_problem)

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into (the tiled kernels hold no static shared memory)
H100_SMS, H100_SMEM = 132, 232448
ARGS = [0.9, 1.1, 1.0, 0.5, 1.0]  # tau, sigma, theta, radius, d_s
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _inputs(seed, L, nx, ny, dtype=torch.float32):
    """u, q (mass on the dead coordinates), s, f."""
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.3 * rng.randn(2 * L, nx, ny),
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
CHUNK_CASES = [(3, 70, 53, 3, (16, 32)), (8, 9, 300, 10, (8, 64)),
               (3, 70, 53, 1, (24, 32)), (5, 33, 41, 2, (8, 32)),
               (2, 20, 30, 2, (64, 64))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,nx,ny,count,tile", CHUNK_CASES)
def test_tiled_twin_is_ml_chunk_plain(L, nx, ny, count, tile, dtype):
    """Window by window with one pixel of halo, the owned pixels are the
    whole plane's bit for bit, and so are the norms of the stitched
    planes."""
    dt = DTYPES[dtype]
    u, q, s, f = _inputs(L + 7 * nx, L, nx, ny, dt)
    scal = torch.tensor(ARGS, dtype=dt)
    want = tml.ml_chunk_plain(u, q, s, f, scal, count)
    got = tml.ml_chunk_tiled_plain(u, q, s, f, scal, count, tile=tile)
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
def test_tiled_twin_halo_is_ml_chunk_plain(shards, rank, ri, dtype):
    """The halo form on the top, an interior, the bottom band and the
    one-shard band: ``ml_chunk_halo_plain`` bit for bit, norms over the
    owned rows."""
    ext, scal = _band(3 + rank, shards, rank, ri, DTYPES[dtype])
    want = tml.ml_chunk_halo_plain(*ext, scal, ri, BNX)
    got = tml.ml_chunk_tiled_plain(*ext, scal, ri, BNX, tile=(8, 32))
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
        *out, partial = tml.ml_chunk_tiled_plain(
            *ext, scal, 2, BNX, tile=(16, 32), partials=True)
        nx, ny = ext[2].shape
    else:
        u, q, s, f = _inputs(11, 5, 70, 77, dt)
        *out, partial = tml.ml_chunk_tiled_plain(
            u, q, s, f, torch.tensor(ARGS, dtype=dt), 3, tile=(16, 32),
            partials=True)
        nx, ny = s.shape
    assert partial.shape == (-(-nx // 8) * -(-ny // 32), 4)
    rtol = 1e-12 if dt == torch.float64 else 1e-5
    torch.testing.assert_close(finish_sums(partial), out[6], rtol=rtol,
                               atol=0.0)


def test_tiled_twin_with_the_flag_returns_the_inputs():
    """With the converged flag set at entry the twin gives back its inputs
    and zero norms, on the whole plane and on a band."""
    u, q, s, f = _inputs(5, 3, 33, 41)
    got = tml.ml_chunk_tiled_plain(u, q, s, f, torch.tensor(ARGS + [1.0]), 2,
                                   tile=(8, 32))
    _equal(got[:6], [u, q, s, u, q, s])
    assert torch.equal(got[6], torch.zeros(4))
    ext, scal8 = _band(6, 4, 2, 2)
    got = tml.ml_chunk_tiled_plain(*ext[:3], ext[3],
                                   torch.cat([scal8, torch.ones(1)]), 2, BNX,
                                   tile=(8, 32))
    _equal(got[:6], ext[:3] * 2)
    assert torch.equal(got[6], torch.zeros(4))


@pytest.mark.parametrize("L", [3, 8])
def test_one_pixel_halo_is_exact_and_halo_zero_is_not(L):
    """One pixel of halo keeps the owned pixels exact; without it the dual
    step at a window's edge reads the new u of a pixel the window does not
    hold, and the owned pixels next to it take it in.  In f64."""
    u, q, s, f = _inputs(31 + L, L, 60, 70, torch.float64)
    scal = torch.tensor(ARGS, dtype=torch.float64)
    want = tml.ml_chunk_plain(u, q, s, f, scal, 2)
    assert tml.ml_tiled_halo() == 1
    got = tml.ml_chunk_tiled_plain(u, q, s, f, scal, 2, tile=(24, 32),
                                   halo=1)
    _equal(got, want)
    short = tml.ml_chunk_tiled_plain(u, q, s, f, scal, 2, tile=(24, 32),
                                     halo=0)
    assert not all(torch.equal(a, b) for a, b in zip(short[:6], want[:6]))


def test_tiled_multichunk_twin_is_ml_multichunk_plain():
    """``ml_multichunk_tiled_plain`` is ``ml_multichunk_plain`` bit for bit
    (an odd count, converging partway under boyd)."""
    u, q, s, f = _inputs(41, 3, 16, 12)
    for t in (u, q, s):
        t.zero_()
    scal = torch.from_numpy(_scal13(2e-2))
    want = tml.ml_multichunk_plain(u, q, s, f, scal, 3, 8, "boyd",
                                   _consts())
    got = tml.ml_multichunk_tiled_plain(u, q, s, f, scal, 3, 8, "boyd",
                                        _consts(), tile=(8, 32))
    _equal(got, want)
    assert got[7][5].item() == 1.0 and 1 <= got[7][6].item() < 8


# ---------------------------------------------------------------------------
# against the JAX banded kernels and the JAX fused route (interpret mode)
# ---------------------------------------------------------------------------

def _clean(u, q, s, f):
    """Numpy inputs with the dead dual coordinates zero: the JAX banded
    kernels take them clean (their route zeroes them once)."""
    L = u.shape[0]
    q = q.clone()
    q[:L, -1, :] = 0.0
    q[L:, :, -1] = 0.0
    return [a.numpy() for a in (u, q, s, f)]


def _close(got, ref, n_planes=6):
    for i, (a, b) in enumerate(zip(got[:n_planes], ref[:n_planes])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6, err_msg=f"plane {i}")
    np.testing.assert_allclose(got[n_planes].numpy(),
                               np.asarray(ref[n_planes]), rtol=1e-5,
                               atol=1e-10)


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("n_bands", [2, 3])
def test_tiled_twin_matches_jax_banded(n_bands, double_buffer):
    """``ml_fused_chunk_banded`` (96x40x3 in bands of 48 or 32 rows with
    the 8-rounded halo of 16, ri 4) against the twin with 16x32 tiles."""
    nx, ny, ri = 96, 40, 4
    u, q, s, f = _clean(*_inputs(21, 3, nx, ny))
    ref = jml.ml_fused_chunk_banded(*map(jnp.asarray, (u, q, s, f)), *ARGS,
                                    ri, n_bands, interpret=True,
                                    double_buffer=double_buffer)
    got = tml.ml_chunk_tiled_plain(*map(torch.from_numpy, (u, q, s, f)),
                                   torch.tensor(ARGS), ri, tile=(16, 32))
    _close(got, ref)


@pytest.mark.parametrize("k_chunks", [2, 3])
def test_tiled_multichunk_twin_matches_jax_banded(k_chunks):
    """``ml_fused_multichunk_banded`` (96x40x3 in 2 bands of 48 rows, ri
    3, boyd at tolerance 0: every chunk runs) against
    ``ml_multichunk_tiled_plain``: the planes, the previous iterates and
    the sqrt'd norms, sout's flag and chunk count exactly."""
    nx, ny, L, ri = 96, 40, 3, 3
    u, q, s, f = _clean(*_inputs(23, L, nx, ny))
    scal = _scal13(0.0)
    consts = _consts(L, nx, ny)
    ref = jml.ml_fused_multichunk_banded(
        *map(jnp.asarray, (u, q, s, f, scal)), ri, k_chunks, 2, "boyd",
        consts, interpret=True)
    got = tml.ml_multichunk_tiled_plain(
        *map(torch.from_numpy, (u, q, s, f, scal)), ri, k_chunks, "boyd",
        consts, tile=(16, 32))
    _close(got, ref)
    assert got[7][5:].tolist() == np.asarray(ref[7])[5:7].tolist() == \
        [0.0, float(k_chunks)]


def test_fused_route_on_the_tiled_twins_matches_jax_banded(monkeypatch):
    """The port's ``FusedROFPDHG`` (multilabel route) with its chunks and
    multichunks forced onto the twins (16x32 tiles) against the JAX fused
    route forced onto its banded multilabel path (2 bands:
    ``ml_fused_multichunk_banded`` in phase B0, ``ml_fused_chunk_banded``
    in phase B), 80 iterations of boyd at ri 3 (3 multichunks from
    iteration 1, 2 chunks from 73)."""
    calls = {"chunk": 0, "multi": 0}

    def chunk(u, q, s, f, scal, count, rows=None, n_scal=5):
        calls["chunk"] += 1
        return tml.ml_chunk_tiled_plain(u, q, s, f, scal, count,
                                        tile=(16, 32))

    def multi(u, q, s, f, scal, count, k_chunks, stepsize, consts):
        calls["multi"] += 1
        return tml.ml_multichunk_tiled_plain(u, q, s, f, scal, count,
                                             k_chunks, stepsize, consts,
                                             tile=(16, 32))

    monkeypatch.setattr(tml, "ml_chunk_plain", chunk)
    monkeypatch.setattr(tml, "ml_multichunk_plain", multi)
    popts = dict(stepsize="boyd", residual_iter=3, scale_steps_operator=False)
    jb = JFused(ml_problem(pt, 64, 16, 3, seed=22)[0], JOptions(**popts),
                _sopts(pt, 1e-5), interpret=True)
    jb.ml["n_bands"] = 2
    tb = TFused(ml_problem(ptt, 64, 16, 3, seed=22)[0], TOptions(**popts),
                _sopts(ptt, 1e-5))
    js = jb.run(jb.initial_state(), 80)
    ts = tb.run(tb.initial_state(), 80, 0)
    assert calls == {"chunk": 2, "multi": 3}
    assert int(ts.iteration) == 80
    _assert_runs_agree(ts, js)


# ---------------------------------------------------------------------------
# the shape rule and the CPU wrappers
# ---------------------------------------------------------------------------

# (L, nx, ny, multi, route) on an H100: config 3's 256x256x8 resident,
# the JAX package's banded 512x512x8 tiled (chunk and multichunk; its
# one-shard halo band of 556 rows too), 9 labels streaming
ROUTE_CASES = [(8, 256, 256, False, "resident"), (8, 256, 256, True,
                                                  "resident"),
               (8, 512, 512, False, "tiled"), (8, 512, 512, True, "tiled"),
               (8, 556, 512, False, "tiled"), (9, 512, 512, False,
                                               "streaming")]


@pytest.mark.parametrize("L,nx,ny,multi,want", ROUTE_CASES)
def test_ml_route_rule(L, nx, ny, multi, want):
    smem = H100_SMEM if L <= tml.MAX_RESIDENT_L else 0
    assert tml.ml_route_of(L, nx, ny, H100_SMS, smem, H100_SMEM,
                           multi) == want


@pytest.mark.parametrize("L,n", [(8, 512), (5, 300), (3, 1000)])
def test_ml_tiled_tile_fits_and_covers_the_norm_tiles(L, n):
    """The rule's tile is a multiple of the 32x8 norm tiles, its window
    fits, and no tile of the search with fewer window pixels moved fits;
    at 512x512x8 it is the 32x32 tile (two rounds of 132 blocks)."""
    tx, ty = tml.ml_tiled_tile(n, n, L, H100_SMS, H100_SMEM)
    assert tx % 8 == 0 and ty % 32 == 0
    assert tml.ml_tiled_bytes(tx, ty, L) <= H100_SMEM

    def cost(a, b):
        rounds = -(-(-(-n // a) * -(-n // b)) // H100_SMS)
        return rounds * (min(a, n) + 2) * (min(b, n) + 2)

    best = cost(tx, ty)
    for a in range(8, 257, 8):
        for b in range(32, 257, 32):
            if (a - 8 < n and b - 32 < n
                    and tml.ml_tiled_bytes(a, b, L) <= H100_SMEM):
                assert cost(a, b) >= best
    if (L, n) == (8, 512):
        assert (tx, ty) == (32, 32)


def test_ml_tiled_bytes_count_the_window():
    """4L + 1 planes of the tile and one pixel each way (152592 bytes for a
    32x32 tile at L = 8); at least the norm pass's two 32x8 trees."""
    assert tml.ml_tiled_bytes(32, 32, 8) == 4 * 33 * 34 * 34 == 152592
    assert tml.ml_tiled_bytes(8, 32, 1) == 4 * 2 * 4 * 256
    assert not tml.ml_tiled_ok(9, 512, 512, H100_SMS, H100_SMEM)
    assert not tml.ml_tiled_ok(8, 512, 512, H100_SMS, 40000)


def test_cpu_wrappers_take_the_tiled_path_name():
    """On the CPU ``path="tiled"`` runs the plain version (the tensors'
    device decides), an unknown path raises, and the light calls keep no
    route."""
    u, q, s, f = _inputs(9, 3, 24, 40)
    scal = torch.tensor(ARGS)
    want = tml.ml_chunk_plain(u, q, s, f, scal, 2)
    cur = [t.clone() for t in (u, q, s)]
    prev = [t.clone() for t in cur]
    norms2 = tml.ml_chunk_(*cur, *prev, f, scal, 2, path="tiled")
    _equal(cur + prev + [norms2], list(want))
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tml.ml_chunk_(*cur, *prev, f, scal, 2, path="banded")
    ext, scal8 = _band(4, 4, 1, 2)
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tml.ml_chunk_halo_(*ext[:3], *[t.clone() for t in ext[:3]], ext[3],
                           scal8, 2, BNX, path="banded")
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tml.ml_multichunk_(*cur, *prev, f, torch.from_numpy(_scal13(0.0)),
                           2, 2, "boyd", _consts(3, 24, 40), path="banded")
    m = {"L": 3, "nx": 24, "ny": 40, "f": f, "radius": 0.5, "d_s": 1.0}
    call = tml.MLChunk(m, 2, torch.device("cpu"), path="tiled")
    assert call.route is None and call.resident is None
