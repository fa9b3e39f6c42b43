"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card (the
kernels have no CPU mode).  The file imports torch and the port only, so
it also runs where JAX is not installed; on such a machine run it without
the suite's conftest (which configures JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances (f32 on the card, kernels built with -fmad=false): planes 2e-5
absolute, the kernels' rsqrtf may round the ball projection differently
from torch.rsqrt; norms 1e-4 relative, block-tree sums against torch.sum.
The ADMM kernels with the CGLS projection: planes 5e-5 absolute, since
every CG step's alpha and beta come from whole-plane sums taken in another
order; residual norms after a multichunk launch of 80 iterations 1e-3
relative, being norms of differences of nearby iterates.  The multilabel
kernels: planes 2e-5 absolute as for ROF (their label sums run left to
right, torch.sum over the label axis may pair them otherwise); norms 1e-4
relative after a chunk, 1e-3 after a multichunk launch, as for ADMM.  The
deblur and tight kernels: planes 2e-5 times max(1, |plane|max) (the blur
dual scales with lmb); norms 1e-4 relative, with a floor of 1e-4 of the
largest norm, since the deblur route's dual variable norm is zero in exact
arithmetic (its prox_g is zero) and what is left is rounding noise.  The
volumetric kernels: planes 2e-5 absolute, norms 1e-4 relative after a
chunk and 1e-3 after a multichunk launch, as for the multilabel kernels
(their norm sums run per voxel, then over labels and blocks, where the
plain version takes whole-volume sums).
"""

import dataclasses

import numpy as np
import pytest
import torch

import prost_tpu_torch as ptt
from prost_tpu_torch.backend import ADMMOptions, PDHGOptions
from prost_tpu_torch.ops import FusedROFADMM, FusedROFPDHG
from prost_tpu_torch.linop import BlockConv2D
from prost_tpu_torch.ops import fused_admm as fa
from prost_tpu_torch.ops import fused_deblur as fd
from prost_tpu_torch.ops import fused_multilabel as fm
from prost_tpu_torch.ops import fused_rof as fr
from prost_tpu_torch.ops import fused_tight as ft
from prost_tpu_torch.ops import fused_vol as fv

pytestmark = pytest.mark.cuda

PLANE_ATOL, NORM_RTOL = 2e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(seed, nx, ny, dev):
    rng = np.random.RandomState(seed)
    x = rng.rand(nx, ny).astype(np.float32)
    q = (0.3 * rng.randn(2, nx, ny)).astype(np.float32)
    f = rng.rand(nx, ny).astype(np.float32)
    w = (rng.rand(nx, ny) > 0.3).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, q, f, w)]


def _consts(nx, ny):
    return (float(np.sqrt(2 * nx * ny)), float(np.sqrt(nx * ny)), 1.5, 0.95,
            1.05, 0.8)


def _close(out, ref, n_planes=4):
    for a, b in zip(out[:n_planes], ref[:n_planes]):
        torch.testing.assert_close(a, b, atol=PLANE_ATOL, rtol=0)
    for a, b in zip(out[n_planes:], ref[n_planes:]):
        torch.testing.assert_close(a, b, rtol=NORM_RTOL, atol=1e-7)


@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("ri", [1, 10])
def test_rof_chunk_matches_plain(dev, dataterm, ri):
    x, q, f, w = _inputs(5, 300, 200, dev)  # nx != ny, ragged blocks
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
    before = fr.launch_counts["rof_chunk"]
    out = fr.rof_chunk(x, q, f, w, scal, ri, dataterm)
    ref = fr.rof_chunk_plain(x, q, f, w, scal, ri, dataterm)
    torch.cuda.synchronize()
    assert fr.launch_counts["rof_chunk"] == before + 1
    assert all(t.is_cuda for t in out)
    _close(out, ref)


@pytest.mark.parametrize("stepsize,tol", [
    ("alg1", 0.0), ("goldstein", 2e-3), ("boyd", 2e-3), ("boyd", 0.0)])
def test_rof_multichunk_matches_plain(dev, stepsize, tol):
    x, _, f, w = _inputs(6, 300, 200, dev)
    q = torch.zeros(2, 300, 200, device=dev)
    scal = torch.tensor([1.0, 1.0, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0,
                         tol, tol, tol, tol], device=dev)
    before = fr.launch_counts["rof_multichunk"]
    out = fr.rof_multichunk(x, q, f, w, scal, 10, 8, "square", stepsize,
                            _consts(300, 200))
    ref = fr.rof_multichunk_plain(x, q, f, w, scal, 10, 8, "square",
                                  stepsize, _consts(300, 200))
    torch.cuda.synchronize()
    assert fr.launch_counts["rof_multichunk"] == before + 1
    _close(out, ref)
    # converged flag and executed-chunk count exactly
    assert out[5][5:].tolist() == ref[5][5:].tolist()


def test_converged_at_entry_returns_the_inputs(dev):
    x, q, f, w = _inputs(3, 64, 48, dev)
    c = fr.rof_chunk(x, q, f, w, torch.tensor(
        [0.9, 1.1, 1.0, 8.0, 1.0, 1.0], device=dev), 5)
    for a, b in zip(c[:4], (x, q, x, q)):
        assert torch.equal(a, b)
    assert c[4].abs().sum().item() == 0.0
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0, 0.5, 2.0, 3.0, 11.0,
                         1e-3, 1e-3, 1e-3, 1e-3, 1.0], device=dev)
    m = fr.rof_multichunk(x, q, f, w, scal, 5, 8, "square", "boyd",
                          _consts(64, 48))
    for a, b in zip(m[:4], (x, q, x, q)):
        assert torch.equal(a, b)
    ref = fr.rof_multichunk_plain(x, q, f, w, scal, 5, 8, "square", "boyd",
                                  _consts(64, 48))
    assert m[5].tolist() == ref[5].tolist()


def test_kernels_refuse_what_they_do_not_take(dev):
    x, q, f, w = _inputs(1, 32, 32, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="float32"):
        fr.rof_chunk(x.double(), q, f, w, scal, 3)
    with pytest.raises(ptt.ProstError, match="one device"):
        fr.rof_chunk(x, q.cpu(), f, w, scal, 3)
    *planes, f, w = _admm_inputs(1, 32, 32, dev)
    scal = torch.tensor([1.0, 8.0, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="one device"):
        fa.admm_chunk(*planes, f, w, scal, torch.full((3,), 1e-3), 3, 10,
                      1.7, "square", None)
    with pytest.raises(ptt.ProstError, match="float32"):
        fa.admm_chunk(*planes, f.double(), w, scal, None, 3, 10, 1.7,
                      "square", 10)


def _tv_problem(nx, ny, device):
    n = nx * ny
    f = np.random.RandomState(2).rand(n)
    u, q = ptt.Variable(n), ptt.Variable(2 * n)
    prob = ptt.MinMaxProblem([u], [q])
    prob.add_function(u, ptt.function.sum_1d("square", 1, f, 16.0))
    prob.add_function(q, ptt.function.conjugate(
        ptt.function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, ptt.block.gradient2d(nx, ny, 1))
    return prob.finalize().to(device)


@pytest.mark.parametrize("stepsize", ["alg1", "boyd"])
def test_fused_backend_on_card_matches_cpu(dev, stepsize):
    """The whole fused route on the card (both kernels, the phase plan,
    convergence inside a multichunk launch) against the same route on the
    CPU with the plain versions."""
    t = 2e-4
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=t,
                              tol_rel_dual=t, tol_abs_primal=t,
                              tol_abs_dual=t)
    opts = PDHGOptions(stepsize=stepsize, residual_iter=5,
                       scale_steps_operator=False)
    fr.reset_launch_counts()
    states = []
    for device in (dev, torch.device("cpu")):
        b = FusedROFPDHG(_tv_problem(48, 40, device), opts, sopts)
        s = b.run(b.initial_state(), 57, 0)
        s = b.run(s, 1200, int(s.iteration))
        states.append(s)
    assert fr.launch_counts["rof_chunk"] > 0
    assert fr.launch_counts["rof_multichunk"] > 0
    gpu, cpu = states
    assert bool(gpu.converged) and bool(cpu.converged)
    assert int(gpu.iteration) == int(cpu.iteration) < 1200
    for f in dataclasses.fields(gpu):
        a, b = getattr(gpu, f.name), getattr(cpu, f.name)
        assert a.is_cuda, f.name
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3,
                                       msg=f.name)


# ---------------------------------------------------------------------------
# the ADMM kernels
# ---------------------------------------------------------------------------

ADMM_PLANE_ATOL = {10: PLANE_ATOL, None: 5e-5}  # by cheby_degree


def _admm_inputs(seed, nx, ny, dev):
    """The seven state arrays (with mass on the dead z coordinates, which
    both versions zero at entry), f and w."""
    rng = np.random.RandomState(seed)
    arrs = [rng.rand(nx, ny) for _ in range(3)]
    arrs += [0.3 * rng.randn(2, nx, ny) for _ in range(3)]
    arrs += [0.1 * rng.randn(nx, ny), rng.rand(nx, ny),
             (rng.rand(nx, ny) > 0.3)]
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def _admm_close(out, ref, plane_atol, norm_rtol):
    for a, b in zip(out[:7], ref[:7]):
        torch.testing.assert_close(a, b, atol=plane_atol, rtol=0)
    for a, b in zip(out[7:], ref[7:]):
        torch.testing.assert_close(a, b, rtol=norm_rtol, atol=1e-7)


@pytest.mark.parametrize("degree", [10, None])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("ri", [1, 10])
def test_admm_chunk_matches_plain(dev, degree, dataterm, ri):
    *planes, f, w = _admm_inputs(7, 300, 200, dev)
    scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
    tols = 1e-3 / torch.arange(1, ri + 1, device=dev,
                               dtype=torch.float32) ** 1.3
    before = fa.launch_counts["admm_chunk"]
    out = fa.admm_chunk(*planes, f, w, scal, tols, ri, 10, 1.7, dataterm,
                        degree)
    ref = fa.admm_chunk_plain(*planes, f, w, scal, tols, ri, 10, 1.7,
                              dataterm, degree)
    torch.cuda.synchronize()
    assert fa.launch_counts["admm_chunk"] == before + 1
    assert all(t.is_cuda for t in out)
    _admm_close(out, ref, ADMM_PLANE_ATOL[degree], NORM_RTOL)


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_admm_multichunk_matches_plain(dev, tol):
    *planes, f, w = _admm_inputs(8, 300, 200, dev)
    scal = torch.tensor([1.0, 16.0, 1.0, 1.05, 0.0, 0.0, 0.0,
                         tol, tol, tol, tol], device=dev)
    consts = (float(np.sqrt(2 * 300 * 200)), float(np.sqrt(300 * 200)),
              0.8, 1.01)
    before = fa.launch_counts["admm_multichunk"]
    out = fa.admm_multichunk(*planes, f, w, scal, 10, 8, 1.7, 10, consts)
    ref = fa.admm_multichunk_plain(*planes, f, w, scal, 10, 8, 1.7, 10,
                                   consts)
    torch.cuda.synchronize()
    assert fa.launch_counts["admm_multichunk"] == before + 1
    _admm_close(out[:8], ref[:8], PLANE_ATOL, 1e-3)
    torch.testing.assert_close(out[8], ref[8], rtol=1e-6, atol=0)


def test_admm_converged_at_entry_returns_the_inputs(dev):
    *planes, f, w = _admm_inputs(9, 64, 48, dev)
    c = fa.admm_chunk(*planes, f, w, torch.tensor([1.0, 8.0, 1.0, 1.0],
                                                  device=dev),
                      None, 5, 10, 1.7, "square", 10)
    for a, b in zip(c[:7], planes):
        assert torch.equal(a, b)
    assert c[7].abs().sum().item() == 0.0
    scal = torch.tensor([0.9, 8.0, 1.0, 1.05, 2.0, 3.0, 11.0,
                         1e-3, 1e-3, 1e-3, 1e-3, 1.0], device=dev)
    consts = (float(np.sqrt(2 * 64 * 48)), float(np.sqrt(64 * 48)), 0.8, 1.01)
    m = fa.admm_multichunk(*planes, f, w, scal, 5, 8, 1.7, 10, consts)
    for a, b in zip(m[:7], planes):
        assert torch.equal(a, b)
    ref = fa.admm_multichunk_plain(*planes, f, w, scal, 5, 8, 1.7, 10,
                                   consts)
    assert m[8].tolist() == ref[8].tolist()


@pytest.mark.parametrize("projection", ["auto", "cgls"])
def test_fused_admm_backend_on_card_matches_cpu(dev, projection):
    """The whole fused ADMM route on the card (chunk launches, and in
    Chebyshev mode multichunk launches with convergence inside one) against
    the same route on the CPU with the plain versions."""
    t = 2e-4
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=t,
                              tol_rel_dual=t, tol_abs_primal=t,
                              tol_abs_dual=t)
    opts = ADMMOptions(residual_iter=5, projection=projection)
    fa.reset_launch_counts()
    states = []
    for device in (dev, torch.device("cpu")):
        b = FusedROFADMM(_tv_problem(48, 40, device), opts, sopts)
        s = b.run(b.initial_state(), 57, 0)
        s = b.run(s, 1500, int(s.iteration))
        states.append(s)
    assert fa.launch_counts["admm_chunk"] > 0
    if projection == "auto":
        assert fa.launch_counts["admm_multichunk"] > 0
    gpu, cpu = states
    assert bool(gpu.converged) and bool(cpu.converged)
    assert int(gpu.iteration) == int(cpu.iteration) < 1500
    for f in dataclasses.fields(gpu):
        a, b = getattr(gpu, f.name), getattr(cpu, f.name)
        assert a.is_cuda, f.name
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3,
                                       msg=f.name)


# ---------------------------------------------------------------------------
# the multilabel kernels
# ---------------------------------------------------------------------------

# small; ragged against the 32x8 blocks; more labels than the dual step
# holds in registers (its two-pass path)
ML_SHAPES = [(3, 64, 48), (5, 250, 190), (9, 40, 36)]


def _ml_inputs(seed, L, nx, ny, dev):
    """u, q (with mass on the dead coordinates, which both versions zero
    at entry), s, f."""
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.3 * rng.randn(2 * L, nx, ny),
            0.1 * rng.randn(nx, ny), rng.rand(L, nx, ny))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def _ml_consts(L, nx, ny):
    n = nx * ny
    return (float(np.sqrt(2 * n * L + n)), float(np.sqrt(n * L)), 1.5, 0.95,
            1.05, 0.8)


@pytest.mark.parametrize("shape", ML_SHAPES)
@pytest.mark.parametrize("ri", [1, 10])
def test_ml_chunk_matches_plain(dev, shape, ri):
    u, q, s, f = _ml_inputs(11, *shape, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 0.5, 1.0], device=dev)
    before = fm.launch_counts["ml_chunk"]
    out = fm.ml_chunk(u, q, s, f, scal, ri)
    ref = fm.ml_chunk_plain(u, q, s, f, scal, ri)
    torch.cuda.synchronize()
    assert fm.launch_counts["ml_chunk"] == before + 1
    assert all(t.is_cuda for t in out)
    _close(out, ref, n_planes=6)


@pytest.mark.parametrize("shape", ML_SHAPES)
@pytest.mark.parametrize("stepsize,tol", [
    ("alg1", 0.0), ("boyd", 5e-3), ("goldstein", 5e-3), ("boyd", 3e-2)])
def test_ml_multichunk_matches_plain(dev, shape, stepsize, tol):
    """A solve's start (u = q = s = 0) on random unaries; the 3e-2 boyd
    case converges within the launch."""
    L, nx, ny = shape
    _, _, _, f = _ml_inputs(12, L, nx, ny, dev)
    u = torch.zeros_like(f)
    q = torch.zeros(2 * L, nx, ny, device=dev)
    s = torch.zeros(nx, ny, device=dev)
    scal = torch.tensor([1.0, 1.0, 1.0, 0.5, 1.0, 0.5, 0.0, 0.0, 1.0,
                         tol, tol, tol, tol], device=dev)
    before = fm.launch_counts["ml_multichunk"]
    out = fm.ml_multichunk(u, q, s, f, scal, 10, 8, stepsize,
                           _ml_consts(L, nx, ny))
    ref = fm.ml_multichunk_plain(u, q, s, f, scal, 10, 8, stepsize,
                                 _ml_consts(L, nx, ny))
    torch.cuda.synchronize()
    assert fm.launch_counts["ml_multichunk"] == before + 1
    for a, b in zip(out[:6], ref[:6]):
        torch.testing.assert_close(a, b, atol=PLANE_ATOL, rtol=0)
    torch.testing.assert_close(out[6], ref[6], rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(out[7], ref[7], rtol=NORM_RTOL, atol=0)
    # converged flag and executed-chunk count exactly
    assert out[7][5:].tolist() == ref[7][5:].tolist()


def test_ml_converged_at_entry_returns_the_inputs(dev):
    u, q, s, f = _ml_inputs(13, 3, 40, 36, dev)
    c = fm.ml_chunk(u, q, s, f, torch.tensor([0.9, 1.1, 1.0, 0.5, 1.0, 1.0],
                                             device=dev), 5)
    for a, b in zip(c[:6], (u, q, s, u, q, s)):
        assert torch.equal(a, b)
    assert c[6].abs().sum().item() == 0.0
    scal = torch.tensor([0.9, 1.1, 1.0, 0.5, 1.0, 0.5, 2.0, 3.0, 11.0,
                         1e-3, 1e-3, 1e-3, 1e-3, 1.0], device=dev)
    m = fm.ml_multichunk(u, q, s, f, scal, 5, 8, "boyd",
                         _ml_consts(3, 40, 36))
    for a, b in zip(m[:6], (u, q, s, u, q, s)):
        assert torch.equal(a, b)
    ref = fm.ml_multichunk_plain(u, q, s, f, scal, 5, 8, "boyd",
                                 _ml_consts(3, 40, 36))
    assert m[7].tolist() == ref[7].tolist()


def test_ml_kernels_refuse_what_they_do_not_take(dev):
    u, q, s, f = _ml_inputs(14, 3, 32, 32, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 0.5, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="float32"):
        fm.ml_chunk(u.double(), q, s, f, scal, 3)
    with pytest.raises(ptt.ProstError, match="one device"):
        fm.ml_chunk(u, q, s.cpu(), f, scal, 3)


def _ml_problem(nx, ny, L, device):
    n = nx * ny
    f = np.random.RandomState(4).rand(n * L)
    u, q, s = ptt.Variable(n * L), ptt.Variable(2 * n * L), ptt.Variable(n)
    prob = ptt.MinMaxProblem([u], [q, s])
    prob.add_function(u, ptt.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(q, ptt.function.sum_norm2(2 * L, False, "ind_leq0",
                                                2.0, 1, 1))
    prob.add_function(s, ptt.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, ptt.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, ptt.block.sparse_kron_id(np.ones((1, L)), n))
    return prob.finalize().to(device)


@pytest.mark.parametrize("stepsize", ["goldstein", "boyd"])
def test_fused_ml_backend_on_card_matches_cpu(dev, stepsize):
    """The whole fused multilabel route on the card (both kernels, the
    phase plan, convergence inside a multichunk launch) against the same
    route on the CPU with the plain versions."""
    t = 1e-3
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=t,
                              tol_rel_dual=t, tol_abs_primal=t,
                              tol_abs_dual=t)
    opts = PDHGOptions(stepsize=stepsize, residual_iter=5,
                       scale_steps_operator=False)
    fm.reset_launch_counts()
    states = []
    for device in (dev, torch.device("cpu")):
        b = FusedROFPDHG(_ml_problem(40, 36, 3, device), opts, sopts)
        assert b.ml is not None
        s = b.run(b.initial_state(), 57, 0)
        s = b.run(s, 1500, int(s.iteration))
        states.append(s)
    assert fm.launch_counts["ml_chunk"] > 0
    assert fm.launch_counts["ml_multichunk"] > 0
    gpu, cpu = states
    assert bool(gpu.converged) == bool(cpu.converged)
    assert int(gpu.iteration) == int(cpu.iteration)
    for f in dataclasses.fields(gpu):
        a, b = getattr(gpu, f.name), getattr(cpu, f.name)
        assert a.is_cuda, f.name
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3,
                                       msg=f.name)


# ---------------------------------------------------------------------------
# the deblur and tight kernels
# ---------------------------------------------------------------------------

def _scaled_close(out, ref, n_planes):
    """Planes within PLANE_ATOL * max(1, |plane|max); norms NORM_RTOL
    relative with a floor of NORM_RTOL times the largest norm."""
    for a, b in zip(out[:n_planes], ref[:n_planes]):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, atol=PLANE_ATOL * scale, rtol=0)
    floor = NORM_RTOL * float(ref[n_planes].abs().max())
    torch.testing.assert_close(out[n_planes], ref[n_planes], rtol=NORM_RTOL,
                               atol=floor)


def _asym_kernel(k=5):
    """tests/test_fused_deblur.py's 5x5 blur: a diagonal and one corner."""
    ker = np.zeros((k, k))
    for i in range(k):
        ker[i, i] = 1.0
    ker[0, k - 1] = 0.5
    return ker / ker.sum()


def _motion_kernel(klen=9):
    """bench.py's 45-degree motion blur: 7 nonzero taps at 9x9."""
    kern = np.zeros((klen, klen))
    c = (klen - 1) / 2
    t = np.deg2rad(45.0)
    for i in np.linspace(-c, c, 4 * klen):
        kern[int(round(c + i * np.sin(t))), int(round(c + i * np.cos(t)))] = 1
    return kern / kern.sum()


def _deblur_inputs(seed, nx, ny, kernel, dev):
    """x, yv, q (with mass on q's boundary coordinates, which the route
    keeps), fb, sv and the taps of ``kernel`` (ky, kx)."""
    taps = fd.kernel_taps(torch.as_tensor(kernel.T, dtype=torch.float32))
    nx2, ny2 = nx + kernel.shape[1] - 1, ny + kernel.shape[0] - 1
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(nx, ny), rng.randn(nx2, ny2), 0.3 * rng.randn(2, nx, ny),
            rng.rand(nx2, ny2), 0.5 + rng.rand(nx2, ny2))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in arrs], taps


@pytest.mark.parametrize("case", ["motion", "asym_ragged"])
@pytest.mark.parametrize("ri", [1, 10])
def test_deblur_chunk_matches_plain(dev, case, ri):
    nx, ny, kernel = ((96, 80, _motion_kernel()) if case == "motion"
                      else (250, 190, _asym_kernel()))
    (x, yv, q, fb, sv), taps = _deblur_inputs(15, nx, ny, kernel, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0], device=dev)
    before = fd.launch_counts["deblur_chunk"]
    out = fd.deblur_chunk(x, yv, q, fb, sv, scal, ri, taps, 0.5, 0.2)
    ref = fd.deblur_chunk_plain(x, yv, q, fb, sv, scal, ri, taps, 0.5, 0.2)
    torch.cuda.synchronize()
    assert fd.launch_counts["deblur_chunk"] == before + 1
    assert all(t.is_cuda for t in out)
    _scaled_close(out, ref, 6)


def _pair_taps(L, dense=False):
    """P^T's taps of examples/example_multilabel_tight.py (k = L(L-1)/2
    pairs, +-1); ``dense`` adds weights of 0.25 at random places and
    empties row 0, which the kernel must fold like the plain version."""
    k = L * (L - 1) // 2
    pt_ = np.zeros((2 * L, 2 * k))
    idx = 0
    for i in range(L):
        for j in range(i + 1, L):
            pt_[i, idx], pt_[j, idx] = 1.0, -1.0
            pt_[i + L, idx + k], pt_[j + L, idx + k] = 1.0, -1.0
            idx += 1
    if dense:
        pt_ += 0.25 * (np.random.RandomState(3).rand(*pt_.shape) > 0.5)
        pt_[0] = 0.0
    return tuple((r, m, float(pt_[r, m])) for r in range(2 * L)
                 for m in range(2 * k) if pt_[r, m] != 0.0)


def _tight_inputs(seed, L, nx, ny, dev):
    k = L * (L - 1) // 2
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.2 * rng.randn(2 * L, nx, ny), 0.1 * rng.randn(2 * k, nx, ny),
            0.1 * rng.randn(nx, ny), rng.rand(L, nx, ny))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def _tight_consts(L):
    """The alpha preconditioner's segments of the example's model."""
    return tuple(float(np.float32(c))
                 for c in (1 / (L + 1), 1.0, 1 / L, 0.2, 1 / 3))


# ragged against the 32x8 blocks; L = 16 is the largest the matcher takes
# (4k = 480 taps)
TIGHT_CASES = [(4, 128, 96, False), (3, 250, 190, False), (3, 64, 48, True),
               (16, 40, 36, False)]


@pytest.mark.parametrize("case", TIGHT_CASES)
@pytest.mark.parametrize("ri", [1, 10])
def test_tight_chunk_matches_plain(dev, case, ri):
    L, nx, ny, dense = case
    u, v, q, p, s, f = _tight_inputs(16, L, nx, ny, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 1.0, 1.0], device=dev)
    taps = _pair_taps(L, dense)
    before = ft.launch_counts["tight_chunk"]
    out = ft.tight_chunk(u, v, q, p, s, f, scal, ri, taps, _tight_consts(L))
    ref = ft.tight_chunk_plain(u, v, q, p, s, f, scal, ri, taps,
                               _tight_consts(L))
    torch.cuda.synchronize()
    assert ft.launch_counts["tight_chunk"] == before + 1
    assert all(t.is_cuda for t in out)
    _scaled_close(out, ref, 10)


def test_deblur_tight_converged_at_entry_return_the_inputs(dev):
    (x, yv, q, fb, sv), taps = _deblur_inputs(17, 40, 36, _asym_kernel(),
                                              dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 100.0, 1.0, 1.0], device=dev)
    c = fd.deblur_chunk(x, yv, q, fb, sv, scal, 5, taps, 0.5, 0.2)
    for a, b in zip(c[:6], (x, yv, q, x, yv, q)):
        assert torch.equal(a, b)
    assert c[6].abs().sum().item() == 0.0
    state = _tight_inputs(18, 3, 40, 36, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 1.0, 1.0, 1.0], device=dev)
    c = ft.tight_chunk(*state, scal, 5, _pair_taps(3), _tight_consts(3))
    for a, b in zip(c[:10], state[:5] * 2):
        assert torch.equal(a, b)
    assert c[10].abs().sum().item() == 0.0


def test_conv_block_runs_in_full_float32(dev):
    """cuDNN would round a float32 convolution to TF32 (a 10-bit mantissa)
    by default: the block's products on the card agree with the CPU's to
    float32 rounding, and the global switch is left as it was."""
    nx, ny = 200, 150
    blk = BlockConv2D.create(0, 0, nx, ny, 1, _motion_kernel())
    x = torch.from_numpy(np.random.RandomState(19).rand(nx * ny)
                         .astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(20).rand(blk.nrows)
                         .astype(np.float32))
    flag = torch.backends.cudnn.allow_tf32
    card = dataclasses.replace(blk, kernel=blk.kernel.to(dev))
    for got, want in ((card.apply(x.to(dev)), blk.apply(x)),
                      (card.apply_adjoint(y.to(dev)), blk.apply_adjoint(y))):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    assert torch.backends.cudnn.allow_tf32 == flag


def _deblur_problem(nx, ny, device):
    rng = np.random.RandomState(5)
    kernel = _asym_kernel()
    nx2, ny2 = nx + 4, ny + 4
    u, v = ptt.Variable(nx * ny), ptt.Variable(nx2 * ny2)
    g = ptt.Variable(2 * nx * ny)
    prob = ptt.MinProblem([u], [v, g])
    prob.add_function(v, ptt.function.sum_1d("square", 1,
                                             rng.rand(nx2 * ny2), 40.0))
    prob.add_function(g, ptt.function.sum_norm2(2, False, "abs"))
    prob.add_constraint(u, v, ptt.block.conv2d(nx, ny, 1, kernel))
    prob.add_constraint(u, g, ptt.block.gradient2d(nx, ny, 1))
    return prob.finalize().to(device)


def _tight_problem(nx, ny, L, device, seed=6):
    n, k = nx * ny, L * (L - 1) // 2
    f = np.random.RandomState(seed).rand(n * L)
    pt_ = np.zeros((2 * L, 2 * k))
    for r, m, w in _pair_taps(L):
        pt_[r, m] = w
    u, v = ptt.Variable(n * L), ptt.Variable(2 * n * k)
    q, p, s = (ptt.Variable(2 * n * L), ptt.Variable(2 * n * k),
               ptt.Variable(n))
    prob = ptt.MinMaxProblem([u, v], [q, p, s])
    prob.add_function(u, ptt.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(p, ptt.function.sum_norm2(2, False, "ind_leq0",
                                                1.0, 1, 1))
    prob.add_function(s, ptt.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, ptt.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, ptt.block.sparse_kron_id(np.ones((1, L)), n))
    prob.add_dual_pair(v, p, ptt.block.identity())
    prob.add_dual_pair(v, q, ptt.block.sparse_kron_id(pt_, n))
    return prob.finalize().to(device)


@pytest.mark.parametrize("route", ["deblur", "tight"])
def test_fused_deblur_tight_backend_on_card_matches_cpu(dev, route):
    """The whole fused deblur or tight route on the card (the chunk kernel
    in the phase plan) against the same route on the CPU with the plain
    version, over 157 iterations of boyd with ri 5."""
    mod = fd if route == "deblur" else ft
    make = ((lambda d: _deblur_problem(40, 36, d)) if route == "deblur"
            else (lambda d: _tight_problem(40, 36, 3, d)))
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=0,
                              tol_rel_dual=0, tol_abs_primal=0,
                              tol_abs_dual=0)
    opts = PDHGOptions(stepsize="boyd", residual_iter=5,
                       scale_steps_operator=False)
    mod.reset_launch_counts()
    states = []
    for device in (dev, torch.device("cpu")):
        b = FusedROFPDHG(make(device), opts, sopts)
        assert getattr(b, route) is not None
        s = b.run(b.initial_state(), 57, 0)
        states.append(b.run(s, 157, 57))
    assert mod.launch_counts[f"{route}_chunk"] > 0
    gpu, cpu = states
    assert int(gpu.iteration) == int(cpu.iteration) == 157
    for f in dataclasses.fields(gpu):
        a, b = getattr(gpu, f.name), getattr(cpu, f.name)
        assert a.is_cuda, f.name
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3,
                                       msg=f.name)


# ---------------------------------------------------------------------------
# the volumetric kernels
# ---------------------------------------------------------------------------

# chip_smoke.py's shapes: vol256x8, a ragged volume (ny not a multiple of 32,
# nx not of 8), one slice, and the size the JAX package bands
VOL_SHAPES = [(8, 256, 256), (5, 190, 250), (1, 64, 96), (8, 512, 512)]


def _vol_inputs(seed, L, nx, ny, dev):
    """u, q (with mass on the dead coordinates, which both versions zero
    at entry, and on q_l's last label plane, which both keep), f, w."""
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(L, nx, ny), 0.3 * rng.randn(3, L, nx, ny),
            rng.rand(L, nx, ny), 2.0 * (rng.rand(L, nx, ny) > 0.3))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def _vol_consts(L, nx, ny):
    n = L * nx * ny
    return (float(np.sqrt(3 * n)), float(np.sqrt(n)), 1.5, 0.95, 1.05, 0.8)


@pytest.mark.parametrize("shape,dataterm", [
    (VOL_SHAPES[0], "square"), (VOL_SHAPES[1], "square"),
    (VOL_SHAPES[1], "wsquare"), (VOL_SHAPES[1], "abs"),
    (VOL_SHAPES[2], "square"), (VOL_SHAPES[3], "square")])
@pytest.mark.parametrize("ri", [1, 10])
def test_vol_chunk_matches_plain(dev, shape, dataterm, ri):
    u, q, f, w = _vol_inputs(21, *shape, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0], device=dev)
    before = fv.launch_counts["vol_chunk"]
    out = fv.vol_chunk(u, q, f, w, scal, ri, dataterm)
    ref = fv.vol_chunk_plain(u, q, f, w, scal, ri, dataterm)
    torch.cuda.synchronize()
    assert fv.launch_counts["vol_chunk"] == before + 1
    assert all(t.is_cuda for t in out)
    _close(out, ref)


@pytest.mark.parametrize("shape", VOL_SHAPES)
@pytest.mark.parametrize("stepsize,tol", [
    ("alg1", 0.0), ("boyd", 5e-3), ("goldstein", 5e-3)])
def test_vol_multichunk_matches_plain(dev, shape, stepsize, tol):
    """A solve's start (u = f, q = 0) on random data; at 5e-3 the rules
    adapt and the launch may converge within it."""
    L, nx, ny = shape
    f = _vol_inputs(22, L, nx, ny, dev)[2]
    q = torch.zeros(3, L, nx, ny, device=dev)
    scal = torch.tensor([1.0, 1.0, 1.0, 6.0, 1.0, 0.5, 0.0, 0.0, 1.0,
                         tol, tol, tol, tol], device=dev)
    consts = _vol_consts(L, nx, ny)
    before = fv.launch_counts["vol_multichunk"]
    out = fv.vol_multichunk(f, q, f, f, scal, 10, 8, "square", stepsize,
                            consts)
    ref = fv.vol_multichunk_plain(f, q, f, f, scal, 10, 8, "square",
                                  stepsize, consts)
    torch.cuda.synchronize()
    assert fv.launch_counts["vol_multichunk"] == before + 1
    for a, b in zip(out[:4], ref[:4]):
        torch.testing.assert_close(a, b, atol=PLANE_ATOL, rtol=0)
    torch.testing.assert_close(out[4], ref[4], rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(out[5], ref[5], rtol=NORM_RTOL, atol=0)
    # converged flag and executed-chunk count exactly
    assert out[5][5:].tolist() == ref[5][5:].tolist()


def test_vol_converged_at_entry_returns_the_inputs(dev):
    u, q, f, w = _vol_inputs(23, 3, 40, 36, dev)
    c = fv.vol_chunk(u, q, f, w, torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0, 1.0],
                                              device=dev), 5)
    for a, b in zip(c[:4], (u, q, u, q)):
        assert torch.equal(a, b)
    assert c[4].abs().sum().item() == 0.0
    scal = torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0, 0.5, 2.0, 3.0, 11.0,
                         1e-3, 1e-3, 1e-3, 1e-3, 1.0], device=dev)
    m = fv.vol_multichunk(u, q, f, w, scal, 5, 8, "square", "boyd",
                          _vol_consts(3, 40, 36))
    for a, b in zip(m[:4], (u, q, u, q)):
        assert torch.equal(a, b)
    ref = fv.vol_multichunk_plain(u, q, f, w, scal, 5, 8, "square", "boyd",
                                  _vol_consts(3, 40, 36))
    assert m[5].tolist() == ref[5].tolist()


def test_vol_kernels_refuse_what_they_do_not_take(dev):
    u, q, f, w = _vol_inputs(24, 3, 32, 32, dev)
    scal = torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0], device=dev)
    with pytest.raises(ptt.ProstError, match="float32"):
        fv.vol_chunk(u.double(), q, f, w, scal, 3)
    with pytest.raises(ptt.ProstError, match="one device"):
        fv.vol_chunk(u, q, f.cpu(), w, scal, 3)
    scal13 = torch.tensor([0.9, 1.1, 1.0, 6.0, 1.0, 0.5, 0.0, 0.0, 1.0,
                           0.0, 0.0, 0.0, 0.0])
    with pytest.raises(ptt.ProstError, match="one device"):
        fv.vol_multichunk(u, q, f, w, scal13, 3, 8, "square", "boyd",
                          _vol_consts(3, 32, 32))


def _vol_problem(nx, ny, L, device):
    f = np.random.RandomState(7).rand(nx * ny * L)
    n = nx * ny * L
    u, q = ptt.Variable(n), ptt.Variable(3 * n)
    prob = ptt.MinMaxProblem([u], [q])
    prob.add_function(u, ptt.function.sum_1d("square", 1, f, 6.0))
    prob.add_function(q, ptt.function.conjugate(
        ptt.function.sum_norm2(3, False, "abs")))
    prob.add_dual_pair(u, q, ptt.block.gradient3d(nx, ny, L))
    return prob.finalize().to(device)


def test_fused_vol_backend_on_card_matches_cpu(dev):
    """The whole fused volumetric route on the card (both kernels, the
    phase plan, convergence inside a multichunk launch) against the same
    route on the CPU with the plain versions."""
    t = 1e-3
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=t,
                              tol_rel_dual=t, tol_abs_primal=t,
                              tol_abs_dual=t)
    opts = PDHGOptions(stepsize="boyd", residual_iter=5,
                       scale_steps_operator=False)
    fv.reset_launch_counts()
    states = []
    for device in (dev, torch.device("cpu")):
        b = FusedROFPDHG(_vol_problem(40, 36, 3, device), opts, sopts)
        assert b.vol is not None
        s = b.run(b.initial_state(), 57, 0)
        s = b.run(s, 1500, int(s.iteration))
        states.append(s)
    assert fv.launch_counts["vol_chunk"] > 0
    assert fv.launch_counts["vol_multichunk"] > 0
    gpu, cpu = states
    assert bool(gpu.converged) == bool(cpu.converged)
    assert int(gpu.iteration) == int(cpu.iteration)
    for f in dataclasses.fields(gpu):
        a, b = getattr(gpu, f.name), getattr(cpu, f.name)
        assert a.is_cuda, f.name
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3,
                                       msg=f.name)


# ---------------------------------------------------------------------------
# the batched chunks (slice 7a): each instance of a batched launch is the
# single-instance kernel on that instance alone, bit for bit (the same
# kernels, the same reduction order per instance)
# ---------------------------------------------------------------------------

def _batched_scal(seed, B, a, b, dev, conv=None):
    """(5, B) rows of per-instance tau, sigma, theta, and the family's two
    scalars around ``a`` and ``b`` (+ a row of converged flags)."""
    rng = np.random.RandomState(seed)
    rows = [0.8 + 0.2 * rng.rand(B), 0.9 + 0.3 * rng.rand(B), np.ones(B),
            a * (0.5 + rng.rand(B)), b * (0.5 + rng.rand(B))]
    if conv is not None:
        rows.append(np.asarray(conv, np.float64))
    return torch.tensor(np.array(rows), dtype=torch.float32, device=dev)


def _instance(out, b, n_planes):
    """Instance b of a batched chunk's outputs, as a single chunk's."""
    return [o[b] for o in out[:n_planes]] + [out[n_planes][:, b]]


def _check_batched(many, one, plain, planes, scal, n_planes, count, *extra,
                   scaled=False):
    """``many`` on the batch against its plain version (PLANE_ATOL, norms
    NORM_RTOL; ``scaled``: each instance by ``_scaled_close``, the deblur
    and tight kernels' tolerances) and, instance by instance, against
    ``one`` bit for bit."""
    out = many(*planes, scal, count, *extra)
    ref = plain(*planes, scal, count, *extra)
    torch.cuda.synchronize()
    assert all(t.is_cuda for t in out)
    B = planes[0].shape[0]
    assert out[n_planes].shape == (4, B)
    if scaled:
        for b in range(B):
            _scaled_close(_instance(out, b, n_planes),
                          _instance(ref, b, n_planes), n_planes)
    else:
        _close(out, ref, n_planes)
    for b in range(B):
        single = one(*[p[b] for p in planes], scal[:, b], count, *extra)
        for a, s in zip(out[:n_planes], single[:n_planes]):
            assert torch.equal(a[b], s)
        assert torch.equal(out[n_planes][:, b], single[n_planes])
    return out


@pytest.mark.parametrize("B,nx,ny,dataterm", [
    (64, 128, 128, "square"), (5, 250, 190, "square"),
    (5, 250, 190, "wsquare"), (5, 250, 190, "abs"), (2, 1280, 1280, "square")])
def test_rof_chunk_batched_matches_plain_and_single(dev, B, nx, ny,
                                                    dataterm):
    rng = np.random.RandomState(31)
    arrs = (rng.rand(B, nx, ny), 0.3 * rng.randn(B, 2, nx, ny),
            rng.rand(B, nx, ny), 2.0 * (rng.rand(B, nx, ny) > 0.3))
    planes = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
    scal = _batched_scal(32, B, 16.0, 1.0, dev)
    before = fr.launch_counts["rof_chunk_batched"]
    _check_batched(fr.rof_chunk_batched, fr.rof_chunk,
                   fr.rof_chunk_batched_plain, planes, scal, 4, 10, dataterm)
    assert fr.launch_counts["rof_chunk_batched"] == before + 1


@pytest.mark.parametrize("B,L,nx,ny", [(8, 8, 256, 256), (3, 5, 250, 190),
                                       (2, 9, 40, 36)])
def test_ml_chunk_batched_matches_plain_and_single(dev, B, L, nx, ny):
    rng = np.random.RandomState(33)
    arrs = (rng.rand(B, L, nx, ny), 0.3 * rng.randn(B, 2 * L, nx, ny),
            0.1 * rng.randn(B, nx, ny), rng.rand(B, L, nx, ny))
    planes = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
    scal = _batched_scal(34, B, 1.0, 1.0, dev)
    before = fm.launch_counts["ml_chunk_batched"]
    _check_batched(fm.ml_chunk_batched, fm.ml_chunk,
                   fm.ml_chunk_batched_plain, planes, scal, 6, 10)
    assert fm.launch_counts["ml_chunk_batched"] == before + 1


@pytest.mark.parametrize("B,L,nx,ny,dataterm", [
    (8, 8, 256, 256, "square"), (3, 5, 190, 250, "square"),
    (3, 5, 190, 250, "wsquare"), (3, 5, 190, 250, "abs"),
    (2, 1, 64, 96, "square")])
def test_vol_chunk_batched_matches_plain_and_single(dev, B, L, nx, ny,
                                                    dataterm):
    rng = np.random.RandomState(35)
    arrs = (rng.rand(B, L, nx, ny), 0.3 * rng.randn(B, 3, L, nx, ny),
            rng.rand(B, L, nx, ny), 2.0 * (rng.rand(B, L, nx, ny) > 0.3))
    planes = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
    scal = _batched_scal(36, B, 6.0, 1.0, dev)
    before = fv.launch_counts["vol_chunk_batched"]
    _check_batched(fv.vol_chunk_batched, fv.vol_chunk,
                   fv.vol_chunk_batched_plain, planes, scal, 4, 10, dataterm)
    assert fv.launch_counts["vol_chunk_batched"] == before + 1


def test_batched_converged_flags_hold_their_instances(dev):
    """An instance whose flag is set gets its inputs back and zero norms;
    the others run as without it."""
    B, nx, ny = 4, 48, 40
    rng = np.random.RandomState(37)
    arrs = (rng.rand(B, nx, ny), 0.3 * rng.randn(B, 2, nx, ny),
            rng.rand(B, nx, ny), rng.rand(B, nx, ny))
    x, q, f, w = [torch.from_numpy(a.astype(np.float32)).to(dev)
                  for a in arrs]
    scal = _batched_scal(38, B, 8.0, 1.0, dev, conv=[0, 1, 0, 1])
    out = fr.rof_chunk_batched(x, q, f, w, scal, 5)
    free = fr.rof_chunk_batched(x, q, f, w, scal[:5], 5)
    for b in range(B):
        held = b % 2 == 1
        for a, s, inp in zip(out[:4], free[:4], (x, q, x, q)):
            assert torch.equal(a[b], inp[b] if held else s[b])
        assert torch.equal(out[4][:, b],
                           torch.zeros_like(out[4][:, b]) if held
                           else free[4][:, b])


def test_batched_kernels_refuse_what_they_do_not_take(dev):
    B, nx, ny = 2, 16, 16
    x = torch.rand(B, nx, ny, device=dev)
    q = torch.rand(B, 2, nx, ny, device=dev)
    scal = _batched_scal(39, B, 8.0, 1.0, dev)
    with pytest.raises(ptt.ProstError, match="float32"):
        fr.rof_chunk_batched(x.double(), q, x, x, scal, 3)
    with pytest.raises(ptt.ProstError, match="one device"):
        fr.rof_chunk_batched(x, q, x, x, scal.cpu(), 3)
    with pytest.raises(ptt.ProstError, match="scal must be"):
        fr.rof_chunk_batched(x, q, x, x, scal[:, :1], 3)


def _rof_ensemble(B, nx, ny, device):
    rng = np.random.RandomState(40)
    probs = []
    for _ in range(B):
        n = nx * ny
        grad = ptt.linop.BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
        prox_g = [ptt.prox.ProxElem1D(
            index=0, size=n, fun="square",
            coeffs=(1.0, rng.rand(n), float(rng.uniform(4, 32)), 0.0, 0.0,
                    0.0, 0.0))]
        pn = ptt.prox.ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                                    interleaved=False, fun="abs",
                                    coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0,
                                            0.0))
        probs.append(ptt.Problem.create(
            ptt.linop.LinearOperator.create([grad]), prox_g=prox_g,
            prox_fstar=[ptt.prox.ProxMoreau(index=0, size=2 * n, child=pn)],
            device=device))
    return probs


def test_batched_rof_route_on_card_matches_cpu(dev):
    """BatchedPDHG's fused ROF route on the card (the batched kernel, the
    vmapped generic steps and epilogue) against the same route on the CPU
    with the plain versions, to a tolerance at which some instances have
    converged before the ensemble stops."""
    from prost_tpu_torch.parallel import BatchedPDHG

    t = 1e-3
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=t,
                              tol_rel_dual=t, tol_abs_primal=t,
                              tol_abs_dual=t)
    opts = PDHGOptions(stepsize="boyd", residual_iter=10,
                       scale_steps_operator=False)
    fr.reset_launch_counts()
    states = []
    for device in (dev, torch.device("cpu")):
        b = BatchedPDHG(_rof_ensemble(6, 40, 36, device), opts, sopts)
        assert b.rof is not None
        s = b.run(b.initial_state(), 37, 0)
        s = b.run(s, 800, int(s.iteration[0]))
        states.append(s)
    assert fr.launch_counts["rof_chunk_batched"] > 0
    gpu, cpu = states
    assert gpu.converged.tolist() == cpu.converged.tolist()
    assert gpu.iteration.tolist() == cpu.iteration.tolist()
    for f in dataclasses.fields(gpu):
        a, b = getattr(gpu, f.name), getattr(cpu, f.name)
        assert a.is_cuda, f.name
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3,
                                       msg=f.name)


# ---------------------------------------------------------------------------
# the batched deblur and tight chunks (slice 7b)
# ---------------------------------------------------------------------------

def _deblur_frames(seed, B, nx, ny, kernel, dev):
    """B frames of ``_deblur_inputs`` and the taps of ``kernel``."""
    taps = fd.kernel_taps(torch.as_tensor(kernel.T, dtype=torch.float32))
    nx2, ny2 = nx + kernel.shape[1] - 1, ny + kernel.shape[0] - 1
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(B, nx, ny), rng.randn(B, nx2, ny2),
            0.3 * rng.randn(B, 2, nx, ny), rng.rand(B, nx2, ny2),
            0.5 + rng.rand(B, nx2, ny2))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in arrs], taps


def _tight_instances(seed, B, L, nx, ny, dev):
    return [torch.stack(t) for t in zip(*[
        _tight_inputs(seed + b, L, nx, ny, dev) for b in range(B)])]


@pytest.mark.parametrize("B,nx,ny,case", [(8, 96, 80, "motion"),
                                          (3, 250, 190, "asym"),
                                          (2, 37, 11, "motion")])
def test_deblur_chunk_batched_matches_plain_and_single(dev, B, nx, ny, case):
    kernel = _motion_kernel() if case == "motion" else _asym_kernel()
    planes, taps = _deblur_frames(41, B, nx, ny, kernel, dev)
    scal = _batched_scal(42, B, 100.0, 1.0, dev)
    before = fd.launch_counts["deblur_chunk_batched"]
    _check_batched(fd.deblur_chunk_batched, fd.deblur_chunk,
                   fd.deblur_chunk_batched_plain, planes, scal, 6, 10, taps,
                   0.5, 0.2, scaled=True)
    assert fd.launch_counts["deblur_chunk_batched"] == before + 1


@pytest.mark.parametrize("B,L,nx,ny", [(8, 4, 128, 128), (3, 3, 250, 190),
                                       (2, 16, 40, 36)])
def test_tight_chunk_batched_matches_plain_and_single(dev, B, L, nx, ny):
    planes = _tight_instances(43, B, L, nx, ny, dev)
    scal = _batched_scal(44, B, 1.0, 1.0, dev)
    before = ft.launch_counts["tight_chunk_batched"]
    _check_batched(ft.tight_chunk_batched, ft.tight_chunk,
                   ft.tight_chunk_batched_plain, planes, scal, 10, 10,
                   _pair_taps(L), _tight_consts(L), scaled=True)
    assert ft.launch_counts["tight_chunk_batched"] == before + 1


@pytest.mark.parametrize("route", ["deblur", "tight"])
def test_deblur_tight_batched_flags_hold_their_instances(dev, route):
    """A frame or instance whose flag is set gets its inputs back and zero
    norms; the others run as without it."""
    B = 4
    if route == "deblur":
        planes, taps = _deblur_frames(45, B, 40, 36, _asym_kernel(), dev)
        many, n_planes, extra = fd.deblur_chunk_batched, 6, (taps, 0.5, 0.2)
    else:
        planes = _tight_instances(46, B, 3, 40, 36, dev)
        many, n_planes = ft.tight_chunk_batched, 10
        extra = (_pair_taps(3), _tight_consts(3))
    scal = _batched_scal(47, B, 8.0, 1.0, dev, conv=[0, 1, 0, 1])
    out = many(*planes, scal, 5, *extra)
    free = many(*planes, scal[:5], 5, *extra)
    state = planes[:n_planes // 2]
    for b in range(B):
        held = b % 2 == 1
        for a, f, inp in zip(out[:n_planes], free[:n_planes], state * 2):
            assert torch.equal(a[b], inp[b] if held else f[b])
        assert torch.equal(out[n_planes][:, b],
                           torch.zeros_like(out[n_planes][:, b]) if held
                           else free[n_planes][:, b])


def test_deblur_tight_batched_refuse_what_they_do_not_take(dev):
    B = 2
    (x, yv, q, fb, sv), taps = _deblur_frames(48, B, 16, 12, _asym_kernel(),
                                              dev)
    scal = _batched_scal(49, B, 8.0, 1.0, dev)
    extra = (taps, 0.5, 0.2)
    with pytest.raises(ptt.ProstError, match="float32"):
        fd.deblur_chunk_batched(x.double(), yv, q, fb, sv, scal, 3, *extra)
    with pytest.raises(ptt.ProstError, match="one device"):
        fd.deblur_chunk_batched(x, yv, q, fb, sv, scal.cpu(), 3, *extra)
    with pytest.raises(ptt.ProstError, match="scal must be"):
        fd.deblur_chunk_batched(x, yv, q, fb, sv, scal[:, :1], 3, *extra)
    with pytest.raises(ptt.ProstError, match="fb must be"):
        fd.deblur_chunk_batched(x, yv, q, fb[:1], sv, scal, 3, *extra)
    u, v, qt, p, s, f = _tight_instances(50, B, 3, 16, 12, dev)
    extra = (_pair_taps(3), _tight_consts(3))
    with pytest.raises(ptt.ProstError, match="float32"):
        ft.tight_chunk_batched(u, v, qt, p, s.double(), f, scal, 3, *extra)
    with pytest.raises(ptt.ProstError, match="one device"):
        ft.tight_chunk_batched(u, v, qt, p, s, f.cpu(), scal, 3, *extra)
    with pytest.raises(ptt.ProstError, match="scal must be"):
        ft.tight_chunk_batched(u, v, qt, p, s, f, scal[:4], 3, *extra)
    with pytest.raises(ptt.ProstError, match="s must be"):
        ft.tight_chunk_batched(u, v, qt, p, s[:1], f, scal, 3, *extra)


def _deblur_ensemble(B, nx, ny, device):
    rng = np.random.RandomState(51)
    probs = []
    for _ in range(B):
        u, v = ptt.Variable(nx * ny), ptt.Variable((nx + 4) * (ny + 4))
        g = ptt.Variable(2 * nx * ny)
        prob = ptt.MinProblem([u], [v, g])
        prob.add_function(v, ptt.function.sum_1d(
            "square", 1, rng.rand((nx + 4) * (ny + 4)),
            float(rng.uniform(20, 60))))
        prob.add_function(g, ptt.function.sum_norm2(2, False, "abs"))
        prob.add_constraint(u, v, ptt.block.conv2d(nx, ny, 1, _asym_kernel()))
        prob.add_constraint(u, g, ptt.block.gradient2d(nx, ny, 1))
        probs.append(prob.finalize().to(device))
    return probs


@pytest.mark.parametrize("route", ["deblur", "tight"])
def test_batched_deblur_tight_route_on_card_matches_cpu(dev, route):
    """BatchedPDHG's fused deblur or tight route on the card (the batched
    kernel, the vmapped generic steps and epilogue) against the same route
    on the CPU with the plain versions, 157 iterations of boyd with ri 5."""
    from prost_tpu_torch.parallel import BatchedPDHG

    mod = fd if route == "deblur" else ft
    make = ((lambda d: _deblur_ensemble(4, 40, 36, d)) if route == "deblur"
            else (lambda d: [_tight_problem(40, 36, 3, d, seed)
                             for seed in (6, 7, 8)]))
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=0,
                              tol_rel_dual=0, tol_abs_primal=0,
                              tol_abs_dual=0)
    opts = PDHGOptions(stepsize="boyd", residual_iter=5,
                       scale_steps_operator=False)
    mod.reset_launch_counts()
    states = []
    for device in (dev, torch.device("cpu")):
        b = BatchedPDHG(make(device), opts, sopts)
        assert getattr(b, route) is not None
        s = b.run(b.initial_state(), 57, 0)
        states.append(b.run(s, 157, 57))
    assert mod.launch_counts[f"{route}_chunk_batched"] > 0
    gpu, cpu = states
    assert gpu.iteration.tolist() == cpu.iteration.tolist()
    for f in dataclasses.fields(gpu):
        a, b = getattr(gpu, f.name), getattr(cpu, f.name)
        assert a.is_cuda, f.name
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3,
                                       msg=f.name)


# ---------------------------------------------------------------------------
# the halo chunks (slice 8a): a halo-extended band of a row-partitioned
# plane, zeros beyond its edges (what the halo exchange delivers); its
# owned rows are the whole-plane kernel's, bit for bit (the same kernels,
# the row masks on global rows), and the bands' owned-row norms sum to the
# whole plane's in another order
# ---------------------------------------------------------------------------

# ragged cases: nx divisible by the 4 bands but not by the 8 rows of a
# thread block, ny not by its 32 columns
HALO_CASES = [("rof", 1, 188, 250, "abs"), ("rof", 1, 512, 512, "square"),
              ("rof", 1, 188, 250, "wsquare"), ("ml", 5, 252, 190, None),
              ("ml", 8, 256, 256, None), ("vol", 5, 188, 250, "wsquare"),
              ("vol", 8, 256, 256, "square")]


def _halo_planes(kind, L, nx, ny, seed, dev):
    """Whole planes of ``kind``, the dead dual coordinates zero."""
    rng = np.random.RandomState(seed)
    lead = () if kind == "rof" else (L,)
    nq = {"rof": (2,), "ml": (2 * L,), "vol": (3, L)}[kind]
    u = rng.rand(*lead, nx, ny)
    q = 0.3 * rng.randn(*nq, nx, ny)
    qx, qy = (q[:L], q[L:]) if kind == "ml" else (q[0], q[1])
    qx[..., -1, :] = 0.0
    qy[..., -1] = 0.0
    third = (0.1 * rng.randn(nx, ny) if kind == "ml"
             else rng.rand(*lead, nx, ny))
    last = (rng.rand(L, nx, ny) if kind == "ml"
            else 2.0 * (rng.rand(*lead, nx, ny) > 0.3))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (u, q, third, last)]


def _halo_head(kind):
    return {"rof": [0.9, 1.1, 1.0, 8.0, 1.0], "ml": [0.9, 1.1, 1.0, 0.7, 0.3],
            "vol": [0.9, 1.1, 1.0, 6.0, 1.0]}[kind]


def _halo_call(kind, dataterm, planes, scal, ri, nxg=None, plain=False):
    """The halo chunk (``nxg`` given) or the whole-plane chunk of ``kind``,
    its kernel or its plain version."""
    mod = {"rof": fr, "ml": fm, "vol": fv}[kind]
    name = f"{kind}_chunk" + ("_halo" if nxg else "") + ("_plain" * plain)
    extra = (nxg,) if nxg else ()
    if kind != "ml":
        extra += (dataterm,)
    return getattr(mod, name)(*planes, scal, ri, *extra)


def _bands(kind, dataterm, planes, shards, ri, dev, plain=False):
    """The outputs of each of ``shards`` halo bands: (rows, outputs)."""
    from prost_tpu_torch.parallel.spatial_fused import window

    nx = planes[0].shape[-2]
    rows, H = nx // shards, 2 * ri + 2
    out = []
    for rank in range(shards):
        lo = rank * rows - H
        ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
        scal = torch.tensor(_halo_head(kind) + [lo, H, H + rows],
                            device=dev)
        out.append(_halo_call(kind, dataterm, ext, scal, ri, nx, plain))
    return rows, H, out


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("kind,L,nx,ny,dataterm", HALO_CASES)
def test_halo_chunk_matches_plain(dev, kind, L, nx, ny, dataterm, shards):
    """Each band's halo kernel against its plain version (whole bands)."""
    planes = _halo_planes(kind, L, nx, ny, 41, dev)
    n = 6 if kind == "ml" else 4
    before = {"rof": fr, "ml": fm, "vol": fv}[kind].launch_counts[
        f"{kind}_chunk_halo"]
    _, _, got = _bands(kind, dataterm, planes, shards, 10, dev)
    _, _, ref = _bands(kind, dataterm, planes, shards, 10, dev, plain=True)
    torch.cuda.synchronize()
    for out, want in zip(got, ref):
        assert all(t.is_cuda for t in out)
        _close(out, want, n)
    after = {"rof": fr, "ml": fm, "vol": fv}[kind].launch_counts[
        f"{kind}_chunk_halo"]
    assert after == before + shards


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("kind,L,nx,ny,dataterm", HALO_CASES)
def test_halo_bands_match_whole_plane_kernel(dev, kind, L, nx, ny, dataterm,
                                             shards):
    """Owned rows of every band bit-equal to the whole-plane kernel's;
    owned-row norms summed over the bands within 1e-6 of its norms."""
    planes = _halo_planes(kind, L, nx, ny, 43, dev)
    n = 6 if kind == "ml" else 4
    ri = 10
    whole = _halo_call(kind, dataterm, planes,
                       torch.tensor(_halo_head(kind), device=dev), ri)
    rows, H, bands = _bands(kind, dataterm, planes, shards, ri, dev)
    total = torch.zeros(4, device=dev)
    for rank, out in enumerate(bands):
        for a, b in zip(out[:n], whole[:n]):
            assert torch.equal(a[..., H:H + rows, :],
                               b[..., rank * rows:(rank + 1) * rows, :])
        total = total + out[n]
    torch.testing.assert_close(total, whole[n], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["rof", "ml", "vol"])
def test_in_place_halo_chunk_on_card(dev, kind):
    """The in-place halo chunk the sharded routes call: the functional
    wrapper's outputs in the caller's buffers, bit for bit, and every
    buffer left as it was when the converged flag is set."""
    L = 1 if kind == "rof" else 3
    planes = _halo_planes(kind, L, 96, 72, 47, dev)
    mod = {"rof": fr, "ml": fm, "vol": fv}[kind]
    inplace = getattr(mod, f"{kind}_chunk_halo_")
    k = 3 if kind == "ml" else 2
    extra = () if kind == "ml" else ("square",)
    H, rows = 12, 48
    from prost_tpu_torch.parallel.spatial_fused import window

    ext = [window(a, rows - H, 2 * rows + H) for a in planes]
    scal = torch.tensor(_halo_head(kind) + [rows - H, H, H + rows],
                        device=dev)
    want = getattr(mod, f"{kind}_chunk_halo")(*ext, scal, 5, 96, *extra)
    cur = [t.clone() for t in ext[:k]]
    prev = [torch.full_like(t, 7.0) for t in cur]
    norms2 = inplace(*cur, *prev, *ext[k:], scal, 5, 96, *extra)
    torch.cuda.synchronize()
    for a, b in zip(cur + prev + [norms2], want):
        assert torch.equal(a, b)
    before = [t.clone() for t in cur + prev]
    held = torch.cat([scal, torch.ones(1, device=dev)])
    norms2 = inplace(*cur, *prev, *ext[k:], held, 5, 96, *extra)
    torch.cuda.synchronize()
    assert not norms2.any()
    for a, b in zip(cur + prev, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["rof", "ml", "vol"])
def test_sharded_route_on_one_card(dev, kind, tmp_path):
    """The halo route on a one-rank NCCL group (both edges receive zeros,
    row_offset = -halo) against the one-card fused route."""
    import torch.distributed as dist

    from prost_tpu_torch.parallel import (ShardedFusedMultilabel,
                                          ShardedFusedROF, ShardedFusedVol,
                                          make_mesh)

    if kind == "rof":
        prob, cls = _tv_problem(48, 40, dev), ShardedFusedROF
    elif kind == "ml":
        prob, cls = _ml_problem(48, 40, 4, dev), ShardedFusedMultilabel
    else:
        prob, cls = _vol_problem(48, 40, 3, dev), ShardedFusedVol
    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=0,
                              tol_rel_dual=0, tol_abs_primal=0,
                              tol_abs_dual=0)
    opts = PDHGOptions(stepsize="boyd", residual_iter=5,
                       scale_steps_operator=False)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        b = cls(prob, opts, sopts, make_mesh((1,), axis_names=("sp",)))
        s = b.run(b.initial_state(), 61, 0)
        one = FusedROFPDHG(prob, opts, sopts)
        ref = one.run(one.initial_state(), 61, 0)
        assert b.exchange.counts["exchanges"] == 12
        assert int(s.iteration) == int(ref.iteration) == 61
        for name in ("x", "y", "x_prev", "y_prev"):
            torch.testing.assert_close(getattr(s, name).full_tensor(),
                                       getattr(ref, name), atol=2e-5,
                                       rtol=0, msg=name)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the halo modes of slice 8b: deblur and tight chunks, one Chebyshev ADMM
# iteration; the same contract as slice 8a's (owned rows bit-equal to the
# whole-plane kernel, norms summed over the bands within 1e-6)
# ---------------------------------------------------------------------------

# (kind, variant, nx, ny, ri or Chebyshev degree): the deblur blurs of row
# reach 4 and 8 on grids of 256 and 128 rows, tight at L = 3 and 4, ADMM at
# degree 10 (halo 24); ragged against the 32x8 blocks, 4 bands each
HALO_8B_CASES = [("deblur", "asym", 252, 190, 2),
                 ("deblur", "motion", 120, 80, 1),
                 ("tight", 3, 248, 190, 5), ("tight", 4, 128, 96, 5),
                 ("admm", None, 300, 200, 10), ("admm", None, 188, 250, 10)]
N_8B = {"deblur": 6, "tight": 10, "admm": 7}  # planes before the norms


def _planes_8b(kind, variant, nx, ny, seed, dev):
    """The whole planes of ``kind`` and its constants: deblur (x, yv, q,
    fb, sv) and its taps, tight (u, v, q, p, s, f), its taps and
    preconditioner segments, ADMM (the 7 state arrays, f, w)."""
    if kind == "deblur":
        kernel = _asym_kernel() if variant == "asym" else _motion_kernel()
        planes, taps = _deblur_inputs(seed, nx, ny, kernel, dev)
        return planes, (taps, 0.5, 0.2)
    if kind == "tight":
        return (_tight_inputs(seed, variant, nx, ny, dev),
                (_pair_taps(variant), _tight_consts(variant)))
    return _admm_inputs(seed, nx, ny, dev), ()


def _halo_of_8b(kind, ri, consts):
    if kind == "deblur":
        return fd.deblur_halo_rows(ri, consts[0])
    return fa.admm_cheby_halo_rows(ri) if kind == "admm" else 2 * ri + 2


def _whole_8b(kind, planes, consts, ri):
    dev = planes[0].device
    if kind == "admm":
        return fa.admm_chunk(*planes, torch.tensor([1.3, 8.0, 1.0],
                                                   device=dev), None, 1, 0,
                             1.7, "wsquare", ri)
    head = [0.9, 1.1, 1.0, 100.0 if kind == "deblur" else 1.0, 1.0]
    scal = torch.tensor(head, device=dev)
    if kind == "deblur":
        return fd.deblur_chunk(*planes, scal, ri, *consts)
    return ft.tight_chunk(*planes, scal, ri, *consts)


def _bands_8b(kind, planes, consts, shards, ri, plain=False):
    """The outputs of each of ``shards`` halo bands: (rows, H, outputs)."""
    from prost_tpu_torch.parallel.spatial_fused import window

    dev = planes[0].device
    grid = planes[1].shape[-2] if kind == "deblur" else planes[0].shape[-2]
    nxg = planes[0].shape[-2]  # the image's rows
    rows, H = grid // shards, _halo_of_8b(kind, ri, consts)
    out = []
    for rank in range(shards):
        lo = rank * rows - H
        ext = [window(a, lo, lo + rows + 2 * H) for a in planes]
        if kind == "admm":
            fn = fa.admm_iter_halo_plain if plain else fa.admm_iter_halo
            out.append(fn(*ext, torch.tensor([1.3, 8.0, 1.0], device=dev),
                          ri, 1.7, nxg, lo, H, H + rows, "wsquare"))
            continue
        head = [0.9, 1.1, 1.0, 100.0 if kind == "deblur" else 1.0, 1.0]
        scal = torch.tensor(head + [lo, H, H + rows], device=dev)
        if kind == "deblur":
            taps, sig_q, tau_t = consts
            out.append(fd.deblur_chunk_plain(*ext, scal, ri, taps, sig_q,
                                             tau_t, nxg) if plain else
                       fd.deblur_chunk_halo(*ext, scal, ri, nxg, *consts))
        elif plain:
            out.append(ft.tight_chunk_halo_plain(*ext, scal, ri, nxg,
                                                 *consts))
        else:
            out.append(ft.tight_chunk_halo(*ext, scal, ri, nxg, *consts))
    return rows, H, out


def _counts_8b(kind):
    mod = {"deblur": fd, "tight": ft, "admm": fa}[kind]
    name = "admm_iter_halo" if kind == "admm" else f"{kind}_chunk_halo"
    return mod.launch_counts[name]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("kind,variant,nx,ny,ri", HALO_8B_CASES)
def test_halo_8b_matches_plain(dev, kind, variant, nx, ny, ri, shards):
    """Each band's halo kernel against its plain version (whole bands):
    the deblur and tight bars of their whole-plane tests, ADMM's of one
    Chebyshev iteration."""
    planes, consts = _planes_8b(kind, variant, nx, ny, 51, dev)
    before = _counts_8b(kind)
    _, _, got = _bands_8b(kind, planes, consts, shards, ri)
    _, _, ref = _bands_8b(kind, planes, consts, shards, ri, plain=True)
    torch.cuda.synchronize()
    assert _counts_8b(kind) == before + shards
    for out, want in zip(got, ref):
        assert all(t.is_cuda for t in out)
        if kind == "admm":
            _admm_close(out, want, ADMM_PLANE_ATOL[10], NORM_RTOL)
        else:
            _scaled_close(out, want, N_8B[kind])


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("kind,variant,nx,ny,ri", HALO_8B_CASES)
def test_halo_8b_bands_match_whole_plane_kernel(dev, kind, variant, nx, ny,
                                                ri, shards):
    """Owned rows of every band bit-equal to the whole-plane kernel's (the
    deblur x and q at the grid rows the image has; ADMM's against
    ``admm_chunk`` with count 1 in Chebyshev mode); owned-row norms summed
    over the bands within 1e-6 of its norms."""
    from prost_tpu_torch.parallel.spatial_fused import window

    planes, consts = _planes_8b(kind, variant, nx, ny, 53, dev)
    whole = _whole_8b(kind, planes, consts, ri)
    rows, H, bands = _bands_8b(kind, planes, consts, shards, ri)
    n = N_8B[kind]
    total = torch.zeros(4, device=dev)
    for rank, out in enumerate(bands):
        lo = rank * rows
        for i, (a, b) in enumerate(zip(out[:n], whole[:n])):
            assert torch.equal(a[..., H:H + rows, :],
                               window(b, lo, lo + rows)), (rank, i)
        total = total + out[n]
    torch.testing.assert_close(total, whole[n], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["deblur", "tight", "admm"])
def test_in_place_halo_8b_on_card(dev, kind):
    """The in-place forms the sharded routes call: the functional wrapper's
    outputs in the caller's buffers, bit for bit, and every buffer left as
    it was when the converged flag is set."""
    from prost_tpu_torch.parallel.spatial_fused import window

    variant, ri = {"deblur": ("asym", 2), "tight": (3, 5),
                   "admm": (None, 10)}[kind]
    planes, consts = _planes_8b(kind, variant, 124, 72, 57, dev)
    nxg = planes[0].shape[-2]
    grid = planes[1].shape[-2] if kind == "deblur" else nxg
    rows, H = grid // 2, _halo_of_8b(kind, ri, consts)
    ext = [window(a, rows - H, 2 * rows + H) for a in planes]
    k = {"deblur": 3, "tight": 5, "admm": 7}[kind]
    if kind == "admm":
        scal = torch.tensor([1.3, 8.0, 1.0], device=dev)
        tail = (ri, 1.7, nxg, rows - H, H, H + rows, "wsquare")
        want = fa.admm_iter_halo(*ext, scal, *tail)
        cur = [t.clone() for t in ext[:k]]
        norms2 = fa.admm_iter_halo_(*cur, *ext[k:], scal, *tail)
        bufs = cur
    else:
        head = [0.9, 1.1, 1.0, 100.0 if kind == "deblur" else 1.0, 1.0]
        scal = torch.tensor(head + [rows - H, H, H + rows], device=dev)
        mod, name = (fd, "deblur_chunk_halo") if kind == "deblur" else (
            ft, "tight_chunk_halo")
        want = getattr(mod, name)(*ext, scal, ri, nxg, *consts)
        cur = [t.clone() for t in ext[:k]]
        prev = [torch.full_like(t, 7.0) for t in cur]
        norms2 = getattr(mod, name + "_")(*cur, *prev, *ext[k:], scal, ri,
                                          nxg, *consts)
        bufs = cur + prev
    torch.cuda.synchronize()
    for a, b in zip(bufs + [norms2], want):
        assert torch.equal(a, b)
    before = [t.clone() for t in bufs]
    held = torch.cat([scal, torch.ones(1, device=dev)])
    if kind == "admm":
        norms2 = fa.admm_iter_halo_(*cur, *ext[k:], held, *tail)
    else:
        norms2 = getattr(mod, name + "_")(*cur, *prev, *ext[k:], held, ri,
                                          nxg, *consts)
    torch.cuda.synchronize()
    assert not norms2.any()
    for a, b in zip(bufs, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["deblur", "tight", "admm"])
def test_sharded_8b_route_on_one_card(dev, kind, tmp_path):
    """The deblur, tight and ADMM halo routes on a one-rank NCCL group
    (both edges receive zeros, row_offset = -halo) against the one-card
    fused routes."""
    import torch.distributed as dist

    from prost_tpu_torch.parallel import (ShardedFusedADMM,
                                          ShardedFusedDeblur,
                                          ShardedFusedTight, make_mesh)

    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=0,
                              tol_rel_dual=0, tol_abs_primal=0,
                              tol_abs_dual=0)
    if kind == "admm":
        prob = _tv_problem(48, 40, dev)
        opts = ADMMOptions(residual_iter=10, projection="cheby")
        cls, one_cls, names = ShardedFusedADMM, FusedROFADMM, (
            "x_half", "x_proj", "x_dual", "z_half", "z_proj", "z_dual",
            "cg_warm")
    else:
        prob = (_deblur_problem(44, 40, dev) if kind == "deblur"
                else _tight_problem(48, 40, 3, dev))
        opts = PDHGOptions(stepsize="boyd", residual_iter=2,
                           scale_steps_operator=False)
        cls, one_cls = (ShardedFusedDeblur if kind == "deblur"
                        else ShardedFusedTight), FusedROFPDHG
        names = ("x", "y", "x_prev", "y_prev")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        b = cls(prob, opts, sopts, make_mesh((1,), axis_names=("sp",)))
        s = b.run(b.initial_state(), 41, 0)
        one = one_cls(prob, opts, sopts)
        ref = one.run(one.initial_state(), 41, 0)
        assert b.exchange.counts["exchanges"] == (40 if kind == "admm"
                                                  else 20)
        assert int(s.iteration) == int(ref.iteration) == 41
        for name in names:
            torch.testing.assert_close(getattr(s, name).full_tensor(),
                                       getattr(ref, name), atol=2e-5,
                                       rtol=0, msg=name)
    finally:
        dist.destroy_process_group()


def test_dp_ensemble_on_one_card(dev, tmp_path):
    """BatchedPDHG over a one-rank dp mesh on an NCCL group takes the
    fused route and gives the one-card run's state, bit for bit."""
    import torch.distributed as dist

    from prost_tpu_torch.parallel import BatchedPDHG, make_mesh

    sopts = ptt.SolverOptions(verbose=False, tol_rel_primal=1e-3,
                              tol_rel_dual=1e-3, tol_abs_primal=1e-3,
                              tol_abs_dual=1e-3)
    opts = PDHGOptions(stepsize="boyd", residual_iter=10,
                       scale_steps_operator=False)
    one = BatchedPDHG(_rof_ensemble(6, 40, 36, dev), opts, sopts)
    ref = one.run(one.initial_state(), 301, 0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        b = BatchedPDHG(_rof_ensemble(6, 40, 36, dev), opts, sopts,
                        make_mesh((1,), axis_names=("dp",)))
        assert b.rof is not None and b.batch == 6
        s = b.run(b.initial_state(), 301, 0)
        assert b.flag_reduces > 0
        for f in dataclasses.fields(s):
            assert torch.equal(b.gather(getattr(s, f.name)),
                               getattr(ref, f.name)), f.name
        for a, c in zip(b.current_solution(s), one.current_solution(ref)):
            assert torch.equal(a, c)
    finally:
        dist.destroy_process_group()
