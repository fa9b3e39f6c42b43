"""The tiled deblur chunk (row 19 of the kernel table, ``deblur_chunk_`` /
``deblur_chunk_halo_`` with ``path="tiled"``: a cooperative launch a chunk
over overlapping 2-D windows of the planes, a grid barrier between
iterations, for the planes no grid-resident band holds), as far as the CPU
can check it.

* Its plain twin, ``deblur_chunk_tiled_plain``, runs ``chunk_core``'s
  arithmetic window by window with every mask decided by the pixel's
  place in the planes, K x recomputed in each window, and stitches the
  owned pixels: bit-equal, in f64 and f32, to ``deblur_chunk_plain`` on
  shapes that the tiles do not divide, for the whole plane and halo
  bands, counts 1 to 3, a tile wider than the plane; its 32x8 tile
  partials, reduced in pdhg_finish's order, within rounding of the norms;
  with the flag set it returns its inputs.
* The least halo (``deblur_tiled_halo``: reach + 1 pixels on every side)
  keeps the owned pixels exact in f64, and one less does not.
* The twin against the JAX banded chunk in interpret mode
  (``deblur_fused_chunk_banded``, 46x12, 2 and 3 bands, both double-buffer
  settings): 1e-6 on the planes, 1e-5 relative on the norms; the port's
  fused route forced onto the twin against the JAX fused route with boyd
  adaptation.
* The shape rule (``deblur_route_of``, ``deblur_tiled_tile``,
  ``deblur_tiled_bytes``) on an H100's SM count and shared-memory limit,
  for any tap count; the windows the kernel runs untested
  (``deblur_tiled_windows``) read only pixels that exist.

The kernel itself is held bit for bit against the streaming launch
sequence on the card by chip_smoke.py (``phase_tiled_deblur``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend import BackendPDHG as JBackend
from prost_tpu.backend import PDHGOptions as JOptions
from prost_tpu.ops import FusedROFPDHG as JFused
from prost_tpu.ops import fused_deblur as jd
from prost_tpu_torch.backend import PDHGOptions as TOptions
from prost_tpu_torch.ops import FusedROFPDHG as TFused
from prost_tpu_torch.ops import fused_deblur as td
from prost_tpu_torch.ops.fused_rof import finish_sums
from prost_tpu_torch.parallel.spatial_fused import window
from test_torch_deblur import (_assert_runs_agree, _sopts, asym_kernel,
                               deblur_model, motion_kernel)

# an H100 SXM: 132 SMs, 227 KB of dynamic shared memory a block may opt
# into, less the 1168 bytes of the deblur kernels' staged taps
H100_SMS, H100_SMEM = 132, 231280
SIG_Q, TAU_T = 0.5, 0.2
ARGS = [0.9, 1.1, 1.0, 40.0, 1.0]  # tau, sigma, theta, lmb, radius
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def dense_kernel(k=3):
    """A k x k blur with every tap nonzero."""
    ker = np.arange(1.0, k * k + 1.0).reshape(k, k)
    return ker / ker.sum()


KERNELS = {"asym3": lambda: asym_kernel(3), "asym5": asym_kernel,
           "dense3": dense_kernel, "motion": motion_kernel}


def _taps(kernel):
    return td.kernel_taps(torch.as_tensor(kernel.T, dtype=torch.float32))


def _inputs(seed, nx, ny, kernel, dtype=torch.float32):
    """x, yv, q, fb, sv (random, mass on q's boundary coordinates) and the
    taps of ``kernel`` (ky, kx)."""
    nx2, ny2 = nx + kernel.shape[1] - 1, ny + kernel.shape[0] - 1
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(nx, ny), rng.randn(nx2, ny2), 0.3 * rng.randn(2, nx, ny),
            rng.rand(nx2, ny2), 0.5 + rng.rand(nx2, ny2))
    return [torch.from_numpy(a).to(dtype) for a in arrs], _taps(kernel)


def _equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"output {i}"


# ---------------------------------------------------------------------------
# the twin against the plain version, bit for bit
# ---------------------------------------------------------------------------

# (kernel, nx, ny, count, tile): tiles that do not divide the yv grid, an
# odd count, a tile wider than the plane
CHUNK_CASES = [("asym3", 46, 12, 2, (16, 32)), ("asym5", 70, 53, 3, (24, 32)),
               ("dense3", 33, 41, 1, (8, 64)), ("motion", 40, 29, 2, (16, 32))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel,nx,ny,count,tile", CHUNK_CASES)
def test_tiled_twin_is_deblur_chunk_plain(kernel, nx, ny, count, tile,
                                          dtype):
    """Window by window with reach + 1 pixels of halo, the owned pixels are
    the whole plane's bit for bit, and so are the norms of the stitched
    planes."""
    dt = DTYPES[dtype]
    (x, yv, q, fb, sv), taps = _inputs(nx + 7 * ny, nx, ny, KERNELS[kernel](),
                                       dt)
    scal = torch.tensor(ARGS, dtype=dt)
    want = td.deblur_chunk_plain(x, yv, q, fb, sv, scal, count, taps, SIG_Q,
                                 TAU_T)
    got = td.deblur_chunk_tiled_plain(x, yv, q, fb, sv, scal, count, taps,
                                      SIG_Q, TAU_T, tile=tile)
    _equal(got, want)


# the halo bands of tests/test_torch_spatial_conv.py: a 4x3 blur of row
# reach 3 on the (96, 22) grid of a 93x20 image, halo (2 ri + 2) 3
BAND_TAPS = ((0, 0, 0.1), (1, 2, 0.3), (2, 1, 0.25), (2, 2, 0.2),
             (3, 0, 0.15))
BNX, BNY, BNX2, BNY2, BRI = 93, 20, 96, 22, 2


def _band(seed, shards, rank, dtype=torch.float32):
    """The halo-extended block of ``rank`` of ``shards`` (zeros beyond the
    planes) and its scal8."""
    rng = np.random.RandomState(seed)
    planes = [torch.from_numpy(a).to(dtype) for a in (
        rng.rand(BNX, BNY), 0.3 * rng.randn(BNX2, BNY2),
        0.3 * rng.randn(2, BNX, BNY), rng.rand(BNX2, BNY2),
        0.5 + rng.rand(BNX2, BNY2))]
    H, rows = jd.deblur_halo_rows(BRI, BAND_TAPS), BNX2 // shards
    lo = rank * rows - H
    ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
    scal = torch.tensor(ARGS[:3] + [20.0, 1.0, lo, H, H + rows], dtype=dtype)
    return ext, scal


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shards,rank", [(4, 0), (4, 1), (4, 3), (1, 0)])
def test_tiled_twin_halo_is_deblur_chunk_plain(shards, rank, dtype):
    """The halo form on the top, an interior, the bottom band and the
    one-shard band: ``deblur_chunk_plain``'s halo form bit for bit, norms
    over the owned rows."""
    ext, scal = _band(3 + rank, shards, rank, DTYPES[dtype])
    want = td.deblur_chunk_plain(*ext, scal, BRI, BAND_TAPS, SIG_Q, TAU_T,
                                 BNX)
    got = td.deblur_chunk_tiled_plain(*ext, scal, BRI, BAND_TAPS, SIG_Q,
                                      TAU_T, BNX, tile=(16, 32))
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
        ext, scal = _band(8, 4, 1, dt)
        *out, partial = td.deblur_chunk_tiled_plain(
            *ext, scal, BRI, BAND_TAPS, SIG_Q, TAU_T, BNX, tile=(16, 32),
            partials=True)
        nx2, ny2 = ext[1].shape
    else:
        (x, yv, q, fb, sv), taps = _inputs(11, 70, 77, asym_kernel(), dt)
        scal = torch.tensor(ARGS, dtype=dt)
        *out, partial = td.deblur_chunk_tiled_plain(
            x, yv, q, fb, sv, scal, 3, taps, SIG_Q, TAU_T, tile=(16, 32),
            partials=True)
        nx2, ny2 = yv.shape
    assert partial.shape == (-(-nx2 // 8) * -(-ny2 // 32), 4)
    rtol = 1e-12 if dt == torch.float64 else 1e-5
    torch.testing.assert_close(finish_sums(partial), out[6], rtol=rtol,
                               atol=0.0)


def test_tiled_twin_with_the_flag_returns_the_inputs():
    """With the converged flag set at entry the twin gives back its inputs
    and zero norms, on the whole plane and on a band."""
    (x, yv, q, fb, sv), taps = _inputs(5, 33, 41, asym_kernel())
    scal = torch.tensor(ARGS + [1.0])
    got = td.deblur_chunk_tiled_plain(x, yv, q, fb, sv, scal, 2, taps, SIG_Q,
                                      TAU_T, tile=(8, 32))
    _equal(got[:6], [x, yv, q, x, yv, q])
    assert torch.equal(got[6], torch.zeros(4))
    ext, scal8 = _band(6, 4, 2)
    got = td.deblur_chunk_tiled_plain(*ext, torch.cat([scal8, torch.ones(1)]),
                                      BRI, BAND_TAPS, SIG_Q, TAU_T, BNX,
                                      tile=(8, 32))
    _equal(got[:6], ext[:3] * 2)
    assert torch.equal(got[6], torch.zeros(4))


@pytest.mark.parametrize("kernel", ["asym5", "motion"])
def test_least_halo_is_exact_and_one_less_is_not(kernel):
    """reach + 1 pixels of halo keep the owned pixels exact; with one less
    the primal step at a window's edge reads a neighbour the window does
    not hold, and the owned pixels next to it take it in.  In f64."""
    (x, yv, q, fb, sv), taps = _inputs(31, 60, 70, KERNELS[kernel](),
                                       torch.float64)
    scal = torch.tensor(ARGS, dtype=torch.float64)
    want = td.deblur_chunk_plain(x, yv, q, fb, sv, scal, 2, taps, SIG_Q,
                                 TAU_T)
    h = td.deblur_tiled_halo(taps)
    assert h == max(max(dx, dy) for dx, dy, _ in taps) + 1
    got = td.deblur_chunk_tiled_plain(x, yv, q, fb, sv, scal, 2, taps, SIG_Q,
                                      TAU_T, tile=(24, 32), halo=h)
    _equal(got, want)
    short = td.deblur_chunk_tiled_plain(x, yv, q, fb, sv, scal, 2, taps,
                                        SIG_Q, TAU_T, tile=(24, 32),
                                        halo=h - 1)
    assert not all(torch.equal(a, b) for a, b in zip(short[:6], want[:6]))


# ---------------------------------------------------------------------------
# against the JAX banded chunk and the JAX fused route (interpret mode)
# ---------------------------------------------------------------------------

def _embed(a, nx2, ny2):
    out = np.zeros(a.shape[:-2] + (nx2, ny2), np.float32)
    out[..., :a.shape[-2], :a.shape[-1]] = a
    return out


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("n_bands", [2, 3])
def test_tiled_twin_matches_jax_banded(n_bands, double_buffer):
    """``deblur_fused_chunk_banded`` (46x12 with a 3x3 blur: a yv grid of
    48 rows in bands of 24 or 16 with the 8-rounded halo of 16, ri 2)
    against the twin with 16x32 tiles and the port's halo of 3: the
    tolerances of tests/test_fused_deblur.py's banded test."""
    nx, ny, ri = 46, 12, 2
    (x, yv, q, fb, sv), taps = _inputs(21, nx, ny, asym_kernel(3))
    nx2, ny2 = yv.shape
    assert jd.deblur_banded_ok(nx2, n_bands)
    ref = jd.deblur_fused_chunk_banded(
        jnp.asarray(_embed(x.numpy(), nx2, ny2)), jnp.asarray(yv.numpy()),
        jnp.asarray(_embed(q.numpy(), nx2, ny2)), jnp.asarray(fb.numpy()),
        jnp.asarray(sv.numpy()), *ARGS, ri, nx, ny, taps, SIG_Q, TAU_T,
        n_bands, interpret=True, double_buffer=double_buffer)
    got = td.deblur_chunk_tiled_plain(x, yv, q, fb, sv, torch.tensor(ARGS),
                                      ri, taps, SIG_Q, TAU_T, tile=(16, 32))
    for i, (a, b) in enumerate(zip(got[:6], ref[:6])):
        b = np.asarray(b)
        if i in (0, 2, 3, 5):  # x and q: the JAX planes are embedded
            b = b[..., :nx, :ny]
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-6,
                                   err_msg=f"plane {i}, {n_bands} bands")
    np.testing.assert_allclose(got[6].numpy(), np.asarray(ref[6]),
                               rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("nx", [20, 46])
def test_fused_route_on_the_tiled_twin_matches_jax_fused(monkeypatch, nx):
    """The port's ``FusedROFPDHG`` (deblur route) with its chunk forced onto
    the twin (16x32 tiles) against the JAX fused route forced onto two
    bands (its tiled chunk at 20x12, its banded kernel at 46x12), boyd at
    ri 2 with a 3x3 blur (tests/test_fused_deblur.py's tiled end-to-end
    run) at tolerances 1e-2, under which tau adapts and the run converges
    within 80 iterations: chunks, adaptation, the stopping test and the
    phases around them; and the generic JAX run to the same iteration."""
    calls = {"n": 0}

    def chunk(x, yv, q, fb, sv, scal, count, taps, sig_q, tau_t,
              nx_global=None):
        calls["n"] += 1
        return td.deblur_chunk_tiled_plain(x, yv, q, fb, sv, scal, count,
                                           taps, sig_q, tau_t, nx_global,
                                           tile=(16, 32))

    monkeypatch.setattr(td, "deblur_chunk_plain", chunk)
    popts = dict(stepsize="boyd", residual_iter=2,
                 scale_steps_operator=False)
    kern = asym_kernel(3)
    jprob = deblur_model(pt, nx, 12, kern, lmb=25.0, seed=3)[0].finalize()
    tprob = deblur_model(ptt, nx, 12, kern, lmb=25.0, seed=3)[0].finalize()
    jb = JFused(jprob, JOptions(**popts), _sopts(pt, 1e-2), interpret=True)
    jb.deblur["n_bands"] = 2
    assert (nx == 46) == jd.deblur_banded_ok(jb.deblur["nx2"], 2)
    tb = TFused(tprob, TOptions(**popts), _sopts(ptt, 1e-2))
    js = jb.run(jb.initial_state(), 80)
    ts = tb.run(tb.initial_state(), 80, 0)
    assert calls["n"] >= 1
    assert bool(ts.converged) and float(ts.tau) != 1.0  # boyd adapted
    _assert_runs_agree(ts, js, atol=2e-5)
    gen = JBackend(jprob, JOptions(**popts), _sopts(pt, 1e-2))
    gs = gen.run(gen.initial_state(), int(ts.iteration))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(gs.x), atol=2e-5)


# ---------------------------------------------------------------------------
# the shape rule and the CPU wrappers
# ---------------------------------------------------------------------------

def _config2(n):
    taps = _taps(motion_kernel())
    return n + 8, n, n + 8, taps


@pytest.mark.parametrize("n,want", [(512, "resident"), (2048, "tiled"),
                                    (1000, "tiled")])
def test_deblur_route_rule(n, want):
    """Config 2's motion blur: resident where the bands fit (512x512),
    tiled where they do not (the JAX package's banded 2048x2048), on an
    H100."""
    nx2, ny, ny2, taps = _config2(n)
    assert td.deblur_route_of(nx2, ny, ny2, taps, H100_SMS, H100_SMEM,
                              H100_SMEM) == want


def test_wide_blurs_stream():
    """A blur whose window cannot fit (two taps 50 rows and columns apart:
    a halo of 51, an 8x32 tile's window of 110x134 pixels in five planes)
    streams at 2048x2048; one of shift 40 (a halo of 41) is tiled."""
    for shift, want in ((50, "streaming"), (40, "tiled")):
        taps = ((0, 0, 0.5), (shift, shift, 0.5))
        nx2 = 2048 + shift
        assert td.deblur_route_of(nx2, 2048, nx2, taps, H100_SMS, H100_SMEM,
                                  H100_SMEM) == want


@pytest.mark.parametrize("n", [2048, 1000, 300])
def test_deblur_tiled_tile_fits_and_covers_the_norm_tiles(n):
    """The rule's tile is a multiple of the 32x8 norm tiles, its window's
    two sets of planes fit, and no tile of the search whose two sets fit
    costs less: its rounds and one more (a block's first window, whose
    loads nothing hides) times its window's pixels and 500 (a window's
    barriers and set-up)."""
    nx2, _, ny2, taps = _config2(n)
    tx, ty = td.deblur_tiled_tile(nx2, ny2, taps, H100_SMS, H100_SMEM)
    assert tx % 8 == 0 and ty % 32 == 0
    assert td.deblur_tiled_bytes(tx, ty, taps) <= H100_SMEM
    h = 2 * td.deblur_tiled_halo(taps)

    def cost(a, b):
        rounds = -(-(-(-nx2 // a) * -(-ny2 // b)) // H100_SMS) + 1
        return rounds * ((min(a, nx2) + h) * (min(b, ny2) + h) + 500)

    best = cost(tx, ty)
    for a in range(8, 257, 8):
        for b in range(32, 257, 32):
            if (a - 8 < nx2 and b - 32 < ny2
                    and td.deblur_tiled_bytes(a, b, taps) <= H100_SMEM):
                assert cost(a, b) >= best


def test_deblur_tiled_bytes_count_the_window():
    """Nine planes of the tile and reach + 1 pixels each way (config 2's
    motion blur: reach 7; a single tap: the gradient's 1) where they fit:
    x after the primal step and two sets of the loaded x, yv, q_x and
    q_y; else five (one set); nothing else: the norm pass reduces in
    registers."""
    taps = _taps(motion_kernel())
    assert td.deblur_tiled_halo(taps) == 8
    assert td.deblur_tiled_bytes(48, 64, taps, H100_SMEM) == 4 * 9 * 64 * 80
    assert td.deblur_tiled_bytes(104, 64, taps) == 4 * 9 * 120 * 80
    assert td.deblur_tiled_bytes(104, 64, taps, H100_SMEM) == \
        4 * 5 * 120 * 80
    assert td.deblur_tiled_bytes(8, 32, ((0, 0, 1.0),)) == 4 * 9 * 12 * 36


@pytest.mark.parametrize("n", [1024, 2048])
def test_deblur_rule_takes_the_tiled_launch_for_any_tap_count(n):
    """The rule is a function of the window's size, not of the tap count:
    full k x k blurs of 1 to 81 taps and 96 taps (the most the kernels
    take) go to the tiled launch at 1024x1024 and 2048x2048 (on the card
    the tiled chunk beat the streaming sequence at 7, 9, 25, 49 and 81
    taps, tools/deblur_tiled_probe.py); each window's two sets of planes
    fit to a reach of 29, one set beyond."""
    for k in range(1, 10):
        taps = _taps(dense_kernel(k))
        assert len(taps) == k * k
        nx2 = n + k - 1
        assert td.deblur_route_of(nx2, n, nx2, taps, H100_SMS, H100_SMEM,
                                  H100_SMEM) == "tiled"
    many = tuple((i // 10, i % 10, 0.01) for i in range(96))
    assert td.deblur_route_of(n + 9, n, n + 9, many, H100_SMS, H100_SMEM,
                              H100_SMEM) == "tiled"
    for shift, two in ((29, True), (30, False)):
        taps = ((0, 0, 0.5), (shift, shift, 0.5))
        tile = td.deblur_tiled_tile(n + shift, n + shift, taps, H100_SMS,
                                    H100_SMEM)
        nbytes = td.deblur_tiled_bytes(*tile, taps, H100_SMEM)
        assert nbytes <= H100_SMEM
        assert (nbytes == td.deblur_tiled_bytes(*tile, taps)) == two


def _inner_sound(nx, ny, nx2, ny2, tile, taps, off, nxg):
    """Every stencil read of an interior window of the tiled launch exists,
    so that its untested stencils read what the masked ones read: the
    window's loads inside the planes and the image; at its primal pixels
    (rows and columns [R0 - reach, R1], [C0 - reach, C1]) an image pixel
    with all four neighbours and yv's reach below; at its owned pixels an
    image pixel with a neighbour below and right whose conv reads (reach
    up and left) are image pixels.  Returns the interior windows."""
    h = td.deblur_tiled_halo(taps)
    reach = h - 1
    inner, edge = td.deblur_tiled_windows(nx, ny, nx2, ny2, tile, h, off,
                                          nxg)
    assert len(inner) + len(edge) == -(-nx2 // tile[0]) * -(-ny2 // tile[1])

    def image(i):
        return i < nx and 0 <= i + off < nxg

    for R0, C0 in inner:
        R1, C1 = min(R0 + tile[0], nx2), min(C0 + tile[1], ny2)
        assert all(0 <= i < nx and image(i) for i in range(R0 - h, R1 + h))
        assert all(0 <= j < ny for j in range(C0 - h, C1 + h))
        for i in range(R0 - reach, R1 + 1):  # primal rows
            assert image(i) and i > 0 and i + off > 0
            assert i < nx - 1 and i + off < nxg - 1 and i + reach < nx2
        assert all(0 < j < ny - 1 for j in range(C0 - reach, C1 + 1))
        for i in range(R0, R1):  # owned rows and their conv reads
            assert image(i) and i < nx - 1 and i + off < nxg - 1
            assert all(a >= 0 and image(a) for a in range(i - reach, i + 1))
        assert all(0 <= j - reach and j < ny - 1 for j in range(C0, C1))
    return inner


@pytest.mark.parametrize("kernel,nx,ny,tile,off,nxg,n_inner", [
    ("motion", 2048, 2048, (104, 64), 0, None, 540),  # config 2
    ("asym5", 70, 53, (16, 32), 0, None, 0),
    ("asym3", 150, 200, (16, 32), 0, None, 40),
    ("motion", 9, 300, (8, 32), 0, None, 0),          # a strip: edges only
    ("asym5", 60, 200, (16, 32), -10, 100, 10),       # a band above row 0
    ("asym5", 60, 200, (8, 32), 70, 100, 10),         # a band past the last
    ("asym5", 60, 200, (8, 32), 20, 100, 25)])        # a band inside
def test_deblur_tiled_interior_windows_are_sound(kernel, nx, ny, tile, off,
                                                 nxg, n_inner):
    """The windows the tiled launch runs untested
    (``deblur_tiled_windows``): every read of their stencils exists, on
    the whole plane and on halo bands (local rows beyond the image's first
    or last row); config 2 at 2048x2048 runs 540 of its 660 untested."""
    kern = KERNELS[kernel]()
    taps = _taps(kern)
    nx2 = nx + (kern.shape[1] - 1 if nxg is None else 0)
    ny2 = ny + kern.shape[0] - 1
    nxg = nx if nxg is None else nxg
    assert len(_inner_sound(nx, ny, nx2, ny2, tile, taps, off, nxg)) == \
        n_inner


def test_cpu_wrappers_take_the_tiled_path_name():
    """On the CPU ``path="tiled"`` runs the plain version (the tensors'
    device decides), an unknown path raises, and the light call keeps no
    route."""
    (x, yv, q, fb, sv), taps = _inputs(9, 24, 40, asym_kernel())
    scal = torch.tensor(ARGS)
    want = td.deblur_chunk_plain(x, yv, q, fb, sv, scal, 2, taps, SIG_Q,
                                 TAU_T)
    cur = [t.clone() for t in (x, yv, q)]
    prev = [t.clone() for t in cur]
    norms2 = td.deblur_chunk_(*cur, *prev, fb, sv, scal, 2, taps, SIG_Q,
                              TAU_T, path="tiled")
    _equal(cur + prev + [norms2], list(want))
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        td.deblur_chunk_(*cur, *prev, fb, sv, scal, 2, taps, SIG_Q, TAU_T,
                         path="banded")
    ext, scal8 = _band(4, 4, 1)
    with pytest.raises(ptt.ProstError, match="path must be one of"):
        td.deblur_chunk_halo_(*ext[:3], *[t.clone() for t in ext[:3]],
                              *ext[3:], scal8, BRI, BNX, BAND_TAPS, SIG_Q,
                              TAU_T, path="banded")
    m = {"nx": 24, "ny": 40, "nx2": yv.shape[0], "ny2": yv.shape[1],
         "taps": taps, "lmb": 40.0, "radius": 1.0, "sig_q": SIG_Q,
         "tau_t": TAU_T}
    call = td.DeblurChunk(m, 2, torch.device("cpu"), path="tiled")
    assert call.route is None and call.resident is None
