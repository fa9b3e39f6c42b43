"""The tiled Chebyshev-ADMM chunk and multichunk (row 11 of the kernel
table, ``admm_chunk_`` / ``admm_multichunk_`` with ``path="tiled"``: a
cooperative launch a chunk over overlapping 2-D windows of the planes, a
grid barrier between iterations, for the planes no grid-resident band
holds), as far as the CPU can check them.

* Their plain twins, ``admm_chunk_tiled_plain`` and
  ``admm_multichunk_tiled_plain``, run ``_admm_iter``'s arithmetic window
  by window with every mask decided by the pixel's place in the plane
  (``window_ops``) and stitch the owned pixels into the other slot:
  bit-equal, in f64 and f32, to ``admm_chunk_plain`` /
  ``admm_multichunk_plain`` on shapes that the tiles do not divide, for
  the square, wsquare and abs data terms, at degrees 10 and 3 and odd
  counts, every chunk run and converging partway; their 32x8 tile
  partials, reduced in admm_finish's order, within rounding of the norms.
* The least halo (``admm_tiled_halo``: degree + 1 pixels on every side)
  keeps the owned pixels exact in f64, and one less does not; wider ones
  (the kernel's map holds more) keep them exact too.
* The twin against the JAX banded chunk in interpret mode
  (``admm_banded_chunk``, 128x32 in 2 and 4 bands, a pending dual rescale
  of 1 and of 0.8): 1e-6 on the planes, 1e-4 relative on the norms; the
  port's fused route forced onto the twins against the JAX banded run
  with adaptation.
* The shape rule (``admm_route_of``, ``admm_tiled_tile``,
  ``admm_tiled_map``, ``admm_tiled_fits``, ``admm_tiled_bytes``) on an
  H100's SM count and shared-memory limit.

The kernel itself is held bit for bit against the streaming launch
sequence on the card by chip_smoke.py (``phase_tiled_admm``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend.admm import ADMMOptions as JOptions
from prost_tpu.ops import FusedROFADMM as JFused
from prost_tpu.ops.fused_admm import admm_banded_chunk
from prost_tpu_torch.backend import ADMMOptions as TOptions
from prost_tpu_torch.ops import FusedROFADMM as TFused
from prost_tpu_torch.ops import fused_admm as tfa
from prost_tpu_torch.ops.fused_rof import finish_sums
from test_torch_fused_admm import _assert_runs_agree, _sopts, _tv

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into (neither the grid-resident nor the tiled kernel holds static
# shared memory)
H100_SMS, H100_SMEM = 132, 232448
ALPHA = 1.7
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _inputs(seed, nx, ny, dtype=torch.float32):
    """The seven state arrays (mass on the dead z coordinates, which both
    versions zero at entry), f and w."""
    rng = np.random.RandomState(seed)
    arrs = [rng.rand(nx, ny) for _ in range(3)]
    arrs += [0.3 * rng.randn(2, nx, ny) for _ in range(3)]
    arrs += [0.1 * rng.randn(nx, ny), rng.rand(nx, ny),
             2.0 * (rng.rand(nx, ny) > 0.3)]
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"output {i}"


def _consts(nx, ny):
    return (float(np.sqrt(2 * nx * ny)), float(np.sqrt(nx * ny)), 0.8, 1.01)


def _solve_start(nx, ny, dtype, seed=3):
    """A solve's start: x_half = f, the rest zero."""
    f = torch.from_numpy(np.random.RandomState(seed).rand(nx, ny)).to(dtype)
    zero = torch.zeros_like(f)
    z = torch.zeros((2, nx, ny), dtype=dtype)
    return [f.clone(), zero, zero, z, z, z, zero], f


def _mscal(tol, dtype, rho=1.0):
    return torch.tensor([rho, 16.0, 1.0, 1.05, 0.0, 0.0, 0.0, tol, tol, tol,
                         tol], dtype=dtype)


# ---------------------------------------------------------------------------
# the twins against the plain versions, bit for bit
# ---------------------------------------------------------------------------

# (nx, ny, degree, count, tile): tiles that do not divide the plane, an odd
# count, a tile wider than the plane
CHUNK_CASES = [(70, 53, 10, 2, (16, 32)), (70, 53, 3, 3, (24, 32)),
               (40, 29, 10, 1, (8, 64))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("nx,ny,degree,count,tile", CHUNK_CASES)
def test_tiled_chunk_twin_is_admm_chunk_plain(nx, ny, degree, count, tile,
                                              dataterm, dtype):
    """Window by window with degree + 1 pixels of halo, the owned pixels
    are the whole plane's bit for bit, and so are the norms of the
    stitched planes."""
    dt = DTYPES[dtype]
    *planes, f, w = _inputs(nx + 7 * ny, nx, ny, dt)
    scal = torch.tensor([1.3, 8.0, 1.0], dtype=dt)
    want = tfa.admm_chunk_plain(*planes, f, w, scal, None, count, 0, ALPHA,
                                dataterm, degree)
    got = tfa.admm_chunk_tiled_plain(*planes, f, w, scal, count, ALPHA,
                                     dataterm, degree, tile=tile)
    _equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_chunk_partials_reduce_to_the_norms(dtype):
    """The 32x8 tiles' partials of the stitched planes, summed in
    admm_finish's order (thread t of 512 takes tiles t, t + 512, ..., then
    a tree), are the norms within the rounding of a different order."""
    dt = DTYPES[dtype]
    *planes, f, w = _inputs(11, 70, 77, dt)
    scal = torch.tensor([1.3, 8.0, 1.0], dtype=dt)
    *out, partial = tfa.admm_chunk_tiled_plain(
        *planes, f, w, scal, 3, ALPHA, "square", 10, tile=(16, 32),
        partials=True)
    assert partial.shape == (-(-70 // 8) * -(-77 // 32), 4)
    rtol = 1e-12 if dt == torch.float64 else 1e-5
    torch.testing.assert_close(finish_sums(partial), out[7], rtol=rtol,
                               atol=0.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
def test_tiled_multichunk_twin_is_admm_multichunk_plain(dataterm, dtype):
    """Every chunk run (3 chunks of an odd count), each chunk's rescale
    carried into the next chunk's loads: the plain multichunk bit for bit,
    the scalars too."""
    dt = DTYPES[dtype]
    *planes, f, w = _inputs(21, 45, 70, dt)
    scal = _mscal(0.0, dt, rho=1.3)
    want = tfa.admm_multichunk_plain(*planes, f, w, scal, 3, 3, ALPHA, 3,
                                     _consts(45, 70), dataterm)
    got = tfa.admm_multichunk_tiled_plain(*planes, f, w, scal, 3, 3, ALPHA,
                                          3, _consts(45, 70), dataterm,
                                          tile=(16, 32))
    assert float(got[8][5]) == 3.0
    _equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("count", [2, 3])
def test_tiled_multichunk_twin_converging_mid_launch(count, dtype):
    """From a solve's start, at a tolerance under which rho adapts and the
    multichunk converges after some but not all of its 8 chunks: the last
    executed chunk's rescale comes after the loop, and the twin is the
    plain multichunk bit for bit."""
    dt = DTYPES[dtype]
    planes, f = _solve_start(48, 40, dt)
    scal = _mscal(3e-2, dt)
    want = tfa.admm_multichunk_plain(*planes, f, f, scal, count, 8, ALPHA, 4,
                                     _consts(48, 40))
    got = tfa.admm_multichunk_tiled_plain(*planes, f, f, scal, count, 8,
                                          ALPHA, 4, _consts(48, 40),
                                          tile=(16, 32))
    assert float(got[8][4]) == 1.0 and 1.0 <= float(got[8][5]) < 8.0
    assert float(got[8][0]) != 1.0  # rho adapted: a rescale other than 1
    _equal(got, want)


def test_tiled_twins_with_the_flag_return_the_inputs():
    """With the converged flag set at entry, both twins give back their
    inputs (and zero norms for the chunk)."""
    *planes, f, w = _inputs(5, 33, 41)
    scal = torch.tensor([1.3, 8.0, 1.0, 1.0])
    got = tfa.admm_chunk_tiled_plain(*planes, f, w, scal, 2, ALPHA,
                                     "square", 3, tile=(8, 32))
    _equal(got[:7], planes)
    assert torch.equal(got[7], torch.zeros(4))
    mscal = torch.cat([_mscal(0.0, torch.float32), torch.ones(1)])
    got = tfa.admm_multichunk_tiled_plain(*planes, f, w, mscal, 2, 3, ALPHA,
                                          3, _consts(33, 41), tile=(8, 32))
    _equal(got[:7], planes)
    assert float(got[8][5]) == 0.0


@pytest.mark.parametrize("degree", [1, 3, 10])
def test_least_halo_is_exact_and_one_less_is_not(degree):
    """degree + 1 pixels of halo keep the owned pixels exact; with one
    less, z_proj's x_proj one row down (and the iterates through it) reads
    a pixel the window does not hold.  In f64: at degree 10 the far edge's
    error lies below f32's rounding."""
    *planes, f, w = _inputs(31, 70, 96, torch.float64)
    scal = torch.tensor([1.3, 8.0, 1.0], dtype=torch.float64)
    want = tfa.admm_chunk_plain(*planes, f, w, scal, None, 2, 0, ALPHA,
                                "square", degree)
    h = tfa.admm_tiled_halo(degree)
    assert h == degree + 1
    got = tfa.admm_chunk_tiled_plain(*planes, f, w, scal, 2, ALPHA,
                                     "square", degree, tile=(24, 32),
                                     halo=h)
    _equal(got, want)
    short = tfa.admm_chunk_tiled_plain(*planes, f, w, scal, 2, ALPHA,
                                       "square", degree, tile=(24, 32),
                                       halo=h - 1)
    assert not all(torch.equal(a, b) for a, b in zip(short[:7], want[:7]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("degree,extra", [(1, 7), (3, 1), (10, 5)])
def test_wider_halo_is_exact(degree, extra, dtype):
    """Windows wider than the least halo (the kernel's map holds more rows
    below and columns to the right than the tile and degree + 1 pixels
    need) keep the owned pixels exact: the plain version bit for bit."""
    dt = DTYPES[dtype]
    *planes, f, w = _inputs(37, 70, 96, dt)
    scal = torch.tensor([1.3, 8.0, 1.0], dtype=dt)
    want = tfa.admm_chunk_plain(*planes, f, w, scal, None, 2, 0, ALPHA,
                                "square", degree)
    got = tfa.admm_chunk_tiled_plain(
        *planes, f, w, scal, 2, ALPHA, "square", degree, tile=(24, 32),
        halo=tfa.admm_tiled_halo(degree) + extra)
    _equal(got, want)


# ---------------------------------------------------------------------------
# against the JAX banded chunk and run (interpret mode)
# ---------------------------------------------------------------------------

def _jax_banded_inputs(nx, ny, seed=16):
    """tests/test_fused_admm.py's banded-chunk inputs: clean dead duals."""
    rng = np.random.RandomState(seed)
    xh = (0.3 * rng.randn(nx, ny)).astype(np.float32)
    xp, xd, warm = xh + 0.1, xh * 0.5, xh * 0.2
    zh = (0.3 * rng.randn(2, nx, ny)).astype(np.float32)
    zh[0, -1, :] = 0.0
    zh[1, :, -1] = 0.0
    zd = zh * 0.1
    f = rng.rand(nx, ny).astype(np.float32)
    return xh, xp, xd, zh, zd, warm, f


@pytest.mark.parametrize("fac", [1.0, 0.8])
@pytest.mark.parametrize("n_bands", [2, 4])
def test_tiled_chunk_twin_matches_jax_banded(n_bands, fac):
    """``admm_banded_chunk`` (grid (count, n_bands), 24-row halo, the
    pending factor applied to x_dual and z_dual at t = 0) at 128x32, an
    odd count of 3, degree 10, against the twin with 32x32 tiles (the
    port's halo 11) and the same pending factor."""
    nx, ny, count = 128, 32, 3
    xh, xp, xd, zh, zd, warm, f = _jax_banded_inputs(nx, ny)
    w = np.ones_like(f)

    def dbl(a):
        return jnp.zeros((2,) + a.shape, a.dtype).at[0].set(jnp.asarray(a))

    outs = admm_banded_chunk(
        dbl(xh), dbl(xp), dbl(xd), dbl(zh), dbl(zd), dbl(warm),
        jnp.asarray(f), jnp.asarray(w), 0, jnp.asarray(1.0, jnp.float32),
        jnp.asarray(fac, jnp.float32), 16.0, 0.5, count, n_bands, 10, ALPHA,
        interpret=True)
    slot = count % 2
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (xh, xp, xd, zh, zh, zd, warm, f, w)]
    scal = torch.tensor([1.0, 16.0, 0.5])
    got = tfa.admm_chunk_tiled_plain(
        *t[:7], t[7], t[8], scal, count, ALPHA, "square", 10, tile=(32, 32),
        fac=None if fac == 1.0 else torch.tensor(fac))
    for name, g, e in zip(("xh", "xp", "xd", "zh", "zd", "warm"),
                          (got[0], got[1], got[2], got[3], got[5], got[6]),
                          outs[:6]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e[slot]), atol=1e-6,
                                   err_msg=f"{name}, {n_bands} bands")
    np.testing.assert_allclose(got[7].numpy(), np.asarray(outs[6]),
                               rtol=1e-4)


def test_fused_route_on_the_tiled_twins_matches_jax_banded(monkeypatch):
    """The port's ``FusedROFADMM`` with its chunk and multichunk calls
    forced onto the tiled twins (32x32 tiles of a 128x32 plane) against the
    JAX route forced onto its banded run (``jb.mode = "banded"``, 4
    bands), 100 iterations at ri 10 with adaptation (a multichunk of 8
    chunks, then chunks): the multichunk's pending rescale as a whole run
    sees it."""
    calls = {"chunk": 0, "multi": 0}

    def chunk(xh, xp, xd, zh, zp, zd, warm, f, w, scal, cg_tols, count,
              maxit, alpha, dataterm="square", cheby_degree=None):
        assert cheby_degree is not None
        calls["chunk"] += 1
        return tfa.admm_chunk_tiled_plain(xh, xp, xd, zh, zp, zd, warm, f,
                                          w, scal, count, alpha, dataterm,
                                          cheby_degree, tile=(32, 32))

    def multi(xh, xp, xd, zh, zp, zd, warm, f, w, scal, count, k_chunks,
              alpha, cheby_degree, consts, dataterm="square"):
        calls["multi"] += 1
        return tfa.admm_multichunk_tiled_plain(
            xh, xp, xd, zh, zp, zd, warm, f, w, scal, count, k_chunks, alpha,
            cheby_degree, consts, dataterm, tile=(32, 32))

    monkeypatch.setattr(tfa, "admm_chunk_plain", chunk)
    monkeypatch.setattr(tfa, "admm_multichunk_plain", multi)
    nx, ny = 128, 32
    f = np.random.RandomState(13).rand(nx * ny).astype(np.float32)
    aopts = dict(residual_iter=10, projection="cheby")
    jb = JFused(_tv(pt, nx, ny, f, lmb=8.0), JOptions(**aopts),
                _sopts(pt, 1e-3), interpret=True)
    jb.mode = "banded"
    jb.rof["n_bands"] = 4
    jb.rof["double_buffer"] = True
    tb = TFused(_tv(ptt, nx, ny, f, lmb=8.0), TOptions(**aopts),
                _sopts(ptt, 1e-3))
    js = jb.run(jb.initial_state(), 100)
    ts = tb.run(tb.initial_state(), 100, 0)
    assert calls["multi"] >= 1
    assert float(ts.rho) != 1.0  # adaptation fired
    _assert_runs_agree(ts, js)


def test_fused_route_on_the_tiled_chunk_twin_matches_plain_route(
        monkeypatch):
    """100 iterations at ri 7 and degree 3 (a multichunk of 8 chunks, then
    chunks of an odd count): the route on the twins is the route on the
    plain versions bit for bit, every call's outputs too."""
    nx, ny = 40, 70
    f = np.random.RandomState(4).rand(nx * ny).astype(np.float32)
    aopts = dict(residual_iter=7, projection="cheby", cheby_degree=3)

    def run():
        tb = TFused(_tv(ptt, nx, ny, f, lmb=8.0), TOptions(**aopts),
                    _sopts(ptt, 1e-3))
        return tb.run(tb.initial_state(), 100, 0)

    want = run()
    plain_chunk = tfa.admm_chunk_plain
    plain_multi = tfa.admm_multichunk_plain
    calls = {"chunk": 0, "multi": 0}

    def chunk(*args, **kw):
        calls["chunk"] += 1
        (xh, xp, xd, zh, zp, zd, warm, f_, w, scal, _, count, _, alpha,
         dataterm, degree) = args
        out = tfa.admm_chunk_tiled_plain(xh, xp, xd, zh, zp, zd, warm, f_, w,
                                         scal, count, alpha, dataterm, degree,
                                         tile=(16, 32))
        _equal(out, plain_chunk(*args, **kw))
        return out

    def multi(*args):
        calls["multi"] += 1
        out = tfa.admm_multichunk_tiled_plain(*args, tile=(16, 32))
        _equal(out, plain_multi(*args))
        return out

    monkeypatch.setattr(tfa, "admm_chunk_plain", chunk)
    monkeypatch.setattr(tfa, "admm_multichunk_plain", multi)
    got = run()
    assert calls["chunk"] >= 1 and calls["multi"] >= 1
    assert float(got.rho) != 1.0
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), field.name
        else:
            assert a == b, field.name


# ---------------------------------------------------------------------------
# the shape rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,ny,dataterm,want", [
    (512, 512, "square", "resident"),
    (512, 512, "wsquare", "resident"),
    (2048, 2048, "square", "tiled"),
    (2048, 2048, "wsquare", "tiled"),
    (2048, 2048, "abs", "tiled"),
    (2048, 1536, "square", "tiled"),
])
def test_admm_route_rule(nx, ny, dataterm, want):
    """Resident where the bands fit (config 4's 512x512), tiled where they
    do not (the JAX package's banded 2048x2048), on an H100."""
    assert tfa.admm_route_of(nx, ny, dataterm, 10, H100_SMS, H100_SMEM,
                             H100_SMEM) == want


@pytest.mark.parametrize("nx,ny,degree", [(2048, 2048, 10), (2048, 2048, 3),
                                          (1000, 777, 10), (70, 53, 10)])
def test_admm_tiled_tile_fits_and_covers_the_norm_tiles(nx, ny, degree):
    """The rule's tile is a multiple of the 32x8 norm tiles, the launch
    takes it (its map within a block's warps, its planes in shared
    memory), and no tile of the search the launch takes moves fewer window
    pixels through the SMs."""
    tx, ty = tfa.admm_tiled_tile(nx, ny, degree, H100_SMS, H100_SMEM)
    assert tx % 8 == 0 and ty % 32 == 0
    assert tfa.admm_tiled_fits(tx, ty, degree, H100_SMEM)
    assert tfa.admm_tiled_bytes(tx, ty, degree) <= H100_SMEM
    h = 2 * tfa.admm_tiled_halo(degree)

    def cost(a, b):
        rounds = -(-(-(-nx // a) * -(-ny // b)) // H100_SMS)
        return rounds * (min(a, nx) + h) * (min(b, ny) + h)

    best = cost(tx, ty)
    for a in range(8, 257, 8):
        for b in range(32, 257, 32):
            if (a - 8 < nx and b - 32 < ny
                    and tfa.admm_tiled_fits(a, b, degree, H100_SMEM)):
                assert cost(a, b) >= best


def test_admm_tiled_bytes_count_the_window():
    """Four planes of the map (blocks of 16 rows by 32 columns holding the
    tile and degree + 1 pixels each way) with a ring of one pixel (no data
    term adds one: f and wsquare's w are read from device memory, x and r
    live in registers; the norm pass reduces by warp shuffles), and the
    launch's 17 plane pointers, the tile's corner and the tile counts
    (four ints)."""
    assert tfa.admm_tiled_bytes(64, 96, 10) == 4 * 4 * (6 * 16 + 2) * (
        4 * 32 + 2) + 17 * 8 + 16
    assert tfa.admm_tiled_bytes(8, 32, 1) == 4 * 4 * 18 * 66 + 17 * 8 + 16


@pytest.mark.parametrize("tx,ty,degree,want", [
    (88, 96, 10, (4, 7)), (104, 64, 10, (3, 8)), (8, 32, 1, (2, 1)),
    (40, 32, 43, (4, 8)), (32, 32, 47, (4, 8)), (256, 256, 10, (9, 18))])
def test_admm_tiled_map_holds_the_window(tx, ty, degree, want):
    """The map (cb blocks of 32 columns, rb of 16 rows) is the least that
    holds the tile and degree + 1 pixels on every side."""
    cb, rb = tfa.admm_tiled_map(tx, ty, degree)
    assert (cb, rb) == want
    h = tfa.admm_tiled_halo(degree)
    assert 32 * (cb - 1) < ty + 2 * h <= 32 * cb
    assert 16 * (rb - 1) < tx + 2 * h <= 16 * rb


def test_admm_tiled_fits_counts_a_blocks_warps():
    """A map of more than a block's 24 warps or of more than 6 column
    blocks (the kernel's instantiations) is refused whatever the shared
    memory; one within them is taken where its planes fit."""
    assert tfa.admm_tiled_fits(72, 96, 10, H100_SMEM)  # 4 x 6 warps
    assert tfa.admm_tiled_fits(104, 64, 10, H100_SMEM)  # 3 x 8
    assert tfa.admm_tiled_fits(40, 160, 10, H100_SMEM)  # 6 x 4
    assert not tfa.admm_tiled_fits(88, 96, 10, 10 ** 9)  # 4 x 7
    assert not tfa.admm_tiled_fits(24, 224, 10, 10 ** 9)  # 8 x 3
    assert not tfa.admm_tiled_fits(256, 256, 10, 10 ** 9)
    assert not tfa.admm_tiled_fits(72, 96, 10,
                                   tfa.admm_tiled_bytes(72, 96, 10) - 4)


def test_admm_tiled_rule_at_2048():
    """At 2048x2048 the rule takes 104x64 tiles at degrees 1 and 10 (a
    map of 128x96: 640 tiles, 5 rounds of 132 SMs), 88x96 at 3, 40x64 at
    25 and 8x32 at 43."""
    want = {1: (104, 64), 3: (88, 96), 10: (104, 64), 25: (40, 64),
            43: (8, 32)}
    for degree, tile in want.items():
        assert tfa.admm_tiled_tile(2048, 2048, degree, H100_SMS,
                                   H100_SMEM) == tile
    assert tfa.admm_tiled_map(104, 64, 10) == (3, 8)
    assert tfa.admm_tiled_bytes(104, 64, 10) == 4 * 4 * 130 * 98 + 152


@pytest.mark.parametrize("degree,want", [(43, "tiled"), (44, "streaming"),
                                         (200, "streaming")])
def test_deep_degrees_stream(degree, want):
    """Where no tile's window fits in a block's shared memory (an 8x32 tile
    and degree + 1 pixels each way: degree 44 and above), the 2048x2048
    plane takes the streaming sequence."""
    tile = tfa.admm_tiled_tile(2048, 2048, degree, H100_SMS, H100_SMEM)
    assert (tile is None) == (want == "streaming")
    assert tfa.admm_route_of(2048, 2048, "square", degree, H100_SMS,
                             H100_SMEM, H100_SMEM) == want


def test_cpu_wrappers_take_the_tiled_path_name():
    """On the CPU ``path="tiled"`` runs the plain version (the tensors'
    device decides), an unknown path raises, the CGLS chunk refuses the
    tiled path, and the light calls keep no route."""
    *planes, f, w = _inputs(9, 24, 40)
    scal = torch.tensor([1.3, 8.0, 1.0])
    want = tfa.admm_chunk_plain(*planes, f, w, scal, None, 2, 0, ALPHA,
                                "square", 3)
    cur = [t.clone() for t in planes]
    norms2 = tfa.admm_chunk_(*cur, f, w, scal, None, 2, 0, ALPHA, "square",
                             3, path="tiled")
    _equal(cur + [norms2], list(want))
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tfa.admm_chunk_(*cur, f, w, scal, None, 2, 0, ALPHA, "square", 3,
                        path="banded")
    with pytest.raises(ptt.ProstError, match="CGLS projection runs"):
        tfa.admm_chunk_(*cur, f, w, scal, torch.ones(2), 2, 3, ALPHA,
                        "square", None, path="tiled")
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        tfa.admm_multichunk_(*cur, f, w, _mscal(0.0, torch.float32), 2, 2,
                             ALPHA, 3, _consts(24, 40), path="banded")
    r = {"nx": 24, "ny": 40, "f": f, "w": w, "dataterm": "square",
         "lmb_t": torch.tensor(8.0), "radius_t": torch.tensor(1.0),
         "tols_t": tuple(torch.tensor(0.0) for _ in range(4)),
         "consts": _consts(24, 40)}
    for call in (tfa.ADMMChunk(r, 2, ALPHA, 3, torch.device("cpu"),
                               path="tiled"),
                 tfa.ADMMMultichunk(r, 2, 2, ALPHA, 3, torch.device("cpu"),
                                    path="tiled")):
        assert call.route is None and call.resident is None
