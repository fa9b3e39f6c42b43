"""Port parity: the fused ADMM route of prost_tpu_torch against prost_tpu,
and both ports' fused routes against the JAX package's banded routes for
planes beyond a TPU core's VMEM.

On the CPU the kernel wrappers run their plain PyTorch versions; they are
held against the JAX kernels in Pallas interpret mode (f32).  Tolerances:

* Chebyshev projection: the same operations in the same order, so the
  planes agree to 1e-5 absolute and the squared norms to 1e-5 relative
  (the order of the norm sums differs).
* CGLS projection: each CG step's alpha and beta come from whole-plane
  sums, whose order differs, and ten CG steps per iteration carry that
  difference into the iterates: 5e-5 absolute on the planes.
* Whole runs (every phase): 2e-5 absolute on the iterates over a few dozen
  iterations, the bar the JAX package holds its own fused ADMM route to.

The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend.admm import ADMMOptions as JOptions
from prost_tpu.backend.pdhg import PDHGOptions as JPOptions
from prost_tpu.ops import FusedROFADMM as JFused
from prost_tpu.ops import FusedROFPDHG as JFusedPDHG
from prost_tpu.ops import fused_admm as jfa
from prost_tpu_torch.backend import ADMMOptions as TOptions
from prost_tpu_torch.backend import BackendADMM as TBackend
from prost_tpu_torch.backend import PDHGOptions as TPOptions
from prost_tpu_torch.ops import FusedROFADMM as TFused
from prost_tpu_torch.ops import FusedROFPDHG as TFusedPDHG
from prost_tpu_torch.ops import fused_admm as tfa

NX, NY = 16, 24
PLANE_ATOL = {10: 1e-5, None: 5e-5}  # by cheby_degree (None: CGLS)
NORM_RTOL = {10: 1e-5, None: 1e-4}
RUN_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _planes(seed, nx=NX, ny=NY):
    """Seven state arrays (xh, xp, xd, zh, zp, zd, warm) with clean dead z
    coordinates, and f, w."""
    rng = np.random.RandomState(seed)
    xs = [rng.rand(nx, ny).astype(np.float32) for _ in range(3)]
    zs = []
    for _ in range(3):
        z = (0.3 * rng.randn(2, nx, ny)).astype(np.float32)
        z[0, -1, :] = 0.0
        z[1, :, -1] = 0.0
        zs.append(z)
    warm = (0.1 * rng.randn(nx, ny)).astype(np.float32)
    f = rng.rand(nx, ny).astype(np.float32)
    w = (rng.rand(nx, ny) > 0.3).astype(np.float32)
    return xs + zs + [warm], f, w


def _close(t_out, j_out, atol, rtol):
    for i, (a, b) in enumerate(zip(t_out[:7], j_out[:7])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   err_msg=f"array {i}")
    for a, b in zip(t_out[7:], j_out[7:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=1e-7)


@pytest.mark.parametrize("degree", [10, None])
@pytest.mark.parametrize("dataterm", ["square", "wsquare", "abs"])
@pytest.mark.parametrize("ri", [1, 7, 10])
def test_admm_chunk_matches_jax_kernel(degree, dataterm, ri):
    planes, f, w = _planes(ri)
    rho, lmb, radius = 1.3, 8.0, 1.0
    tols = np.float32(1e-3) / np.arange(1, ri + 1, dtype=np.float32) ** 1.3
    ref = jfa.admm_fused_chunk(
        *map(jnp.asarray, planes), jnp.asarray(f), jnp.asarray(w),
        jnp.float32(rho), lmb, radius, jnp.asarray(tols), ri, 10, 1.7,
        dataterm=dataterm, interpret=True, cheby_degree=degree)
    out = tfa.admm_chunk(
        *map(torch.from_numpy, planes), torch.from_numpy(f),
        torch.from_numpy(w), torch.tensor([rho, lmb, radius]),
        torch.from_numpy(tols), ri, 10, 1.7, dataterm, degree)
    _close(out, ref, PLANE_ATOL[degree], NORM_RTOL[degree])


def _consts(nx=NX, ny=NY):
    return (float(np.sqrt(2 * nx * ny)), float(np.sqrt(nx * ny)), 0.8, 1.01)


def _image(nx, ny, seed=42):
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, nx)
    xx, yy = np.meshgrid(x, np.linspace(0, 1, ny), indexing="ij")
    im = 0.4 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.09) + 0.3 * (xx > 0.7)
    return (im + 0.05 * rng.randn(nx, ny)).astype(np.float32)


def _solve_start(nx=NX, ny=NY):
    """A solve's first state: x_half = f = the test image, the rest zero."""
    f = _image(nx, ny)
    zero = np.zeros((nx, ny), np.float32)
    z = np.zeros((2, nx, ny), np.float32)
    return [f, zero, zero, z, z, z, zero], f


@pytest.mark.parametrize("tol,chunks_run", [
    (0.0, 8),     # no stop, no adaptation: every chunk runs
    (1e-2, 3),    # rho adapts and the launch converges in chunk 3
])
def test_admm_multichunk_matches_jax_kernel(tol, chunks_run):
    planes, f = _solve_start()
    scal = np.array([1.0, 16.0, 1.0, 1.05, 0.0, 0.0, 0.0,
                     tol, tol, tol, tol], np.float32)
    ref = jfa.admm_fused_multichunk(
        *map(jnp.asarray, planes), jnp.asarray(f), jnp.asarray(f),
        jnp.asarray(scal), 10, 8, 1.7, 10, _consts(), interpret=True)
    out = tfa.admm_multichunk(
        *map(torch.from_numpy, planes), torch.from_numpy(f),
        torch.from_numpy(f), torch.from_numpy(scal), 10, 8, 1.7, 10,
        _consts())
    # the residual norms after 80 iterations are norms of differences of
    # nearby iterates, which lose digits to cancellation: 1e-3 relative
    _close(out[:8], ref[:8], PLANE_ATOL[10], 1e-3)
    np.testing.assert_allclose(out[8].numpy(), np.asarray(ref[8]), rtol=1e-6)
    # converged flag and executed-chunk count exactly
    assert out[8][4:].tolist() == [float(tol == 1e-2), float(chunks_run)]
    assert out[8][4:].tolist() == np.asarray(ref[8][4:]).tolist()
    if tol > 0:
        assert float(out[8][0]) != 1.0  # rho adapted


def test_converged_at_entry_returns_the_inputs():
    planes, f, w = _planes(3)
    t = [torch.from_numpy(a) for a in planes]
    # dirty dead coordinates come back untouched: nothing ran
    t[3][0, -1, :] = 1.0
    f_t, w_t = torch.from_numpy(f), torch.from_numpy(w)
    c = tfa.admm_chunk(*t, f_t, w_t, torch.tensor([1.0, 8.0, 1.0, 1.0]),
                       None, 5, 10, 1.7, "square", 10)
    for a, b in zip(c[:7], t):
        assert torch.equal(a, b)
    assert torch.equal(c[7], torch.zeros(4))
    scal = torch.tensor([0.9, 8.0, 1.0, 1.05, 2.0, 3.0, 11.0,
                         1e-3, 1e-3, 1e-3, 1e-3, 1.0])
    m = tfa.admm_multichunk(*t, f_t, w_t, scal, 5, 8, 1.7, 10, _consts())
    for a, b in zip(m[:7], t):
        assert torch.equal(a, b)
    assert m[8].tolist() == pytest.approx([0.9, 1.05, 2.0, 3.0, 1.0, 0.0])


def test_wrappers_reject_bad_input():
    planes, f, w = _planes(1)
    t = [torch.from_numpy(a) for a in planes]
    f_t, w_t = torch.from_numpy(f), torch.from_numpy(w)
    scal = torch.tensor([1.0, 8.0, 1.0])
    with pytest.raises(ptt.ProstError, match="z_half must be"):
        tfa.admm_chunk(*t[:3], t[3][0], *t[4:], f_t, w_t, scal, None, 3, 10,
                       1.7, "square", 10)
    with pytest.raises(ptt.ProstError, match="data term"):
        tfa.admm_chunk(*t, f_t, w_t, scal, None, 3, 10, 1.7, "huber", 10)
    with pytest.raises(ptt.ProstError, match="CG tolerances"):
        tfa.admm_chunk(*t, f_t, w_t, scal, None, 3, 10, 1.7, "square", None)
    with pytest.raises(ptt.ProstError, match="degree >= 1"):
        tfa.admm_chunk(*t, f_t, w_t, scal, None, 3, 10, 1.7, "square", 0)
    with pytest.raises(ptt.ProstError, match="scal"):
        tfa.admm_multichunk(*t, f_t, w_t, scal, 3, 8, 1.7, 10, _consts())


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------

def _tv(mod, nx, ny, f, lmb=16.0, data_fun="square", a=1.0):
    n = nx * ny
    grad = mod.linop.BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    prox_g = [mod.prox.ProxElem1D(index=0, size=n, fun=data_fun,
                                  coeffs=(a, f, lmb, 0.0, 0.0, 0.0, 0.0))]
    fstar = mod.prox.ProxMoreau(index=0, size=2 * n, child=mod.prox.
                                ProxElemNorm2(
        index=0, size=2 * n, count=n, dim=2, interleaved=False, fun="abs",
        coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0)))
    return mod.Problem.create(mod.linop.LinearOperator.create([grad]),
                              prox_g=prox_g, prox_fstar=[fstar])


def _sopts(mod, t):
    return mod.SolverOptions(verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                             tol_abs_primal=t, tol_abs_dual=t)


def _assert_runs_agree(ts, js, atol=RUN_ATOL):
    assert int(ts.iteration) == int(js.iteration)
    assert bool(ts.converged) == bool(js.converged)
    for name in ("x_half", "x_proj", "x_dual", "z_half", "z_proj", "z_dual",
                 "cg_warm"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=atol,
                                   err_msg=name)
    for name in ("rho", "delta", "arb_l", "arb_u"):
        np.testing.assert_allclose(float(getattr(ts, name)),
                                   float(getattr(js, name)), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(float(ts.primal_residual),
                               float(js.primal_residual), rtol=1e-3)


@pytest.mark.parametrize("projection,ri,t,case", [
    ("auto", 10, 1e-3, "square"),   # B0 with adaptation, B, C
    ("auto", 5, 0.0, "abs"),
    ("cheby", 7, 1e-3, "wsquare"),
    ("cgls", 10, 1e-3, "square"),   # no B0: CGLS chunks only
])
def test_fused_backend_matches_jax_fused(projection, ri, t, case):
    """The port's FusedROFADMM on the CPU (plain versions) against the JAX
    FusedROFADMM in interpret mode: a first run of 3 iterations (phases A
    and C only), then one to 95 (A, B0, B, C)."""
    rng = np.random.RandomState(4)
    f = rng.rand(NX * NY).astype(np.float32)
    fun, a = ("abs" if case == "abs" else "square"), 1.0
    if case == "wsquare":
        a = (rng.rand(NX * NY) > 0.3).astype(np.float32)
    jb = JFused(_tv(pt, NX, NY, f, data_fun=fun, a=a),
                JOptions(residual_iter=ri, projection=projection),
                _sopts(pt, t), interpret=True)
    tb = TFused(_tv(ptt, NX, NY, f, data_fun=fun, a=a),
                TOptions(residual_iter=ri, projection=projection),
                _sopts(ptt, t))
    assert jb.mode == tb.mode == ("cgls" if projection == "cgls" else "cheby")
    js = jb.run(jb.run(jb.initial_state(), 3), 95)
    ts = tb.run(tb.initial_state(), 3, 0)
    ts = tb.run(ts, 95, 3)
    _assert_runs_agree(ts, js, 5e-5 if projection == "cgls" else RUN_ATOL)


def test_fused_backend_matches_generic_to_convergence():
    """Fused (plain versions) against the port's own generic Chebyshev
    path: the same stopping iteration and current solution."""
    f = np.random.RandomState(2).rand(NX * NY).astype(np.float32)
    prob = _tv(ptt, NX, NY, f)
    gb = TBackend(prob, TOptions(residual_iter=5, projection="cheby"),
                  _sopts(ptt, 3e-4))
    fb = TFused(prob, TOptions(residual_iter=5), _sopts(ptt, 3e-4))
    gs = gb.run(gb.initial_state(), 150, 0)
    fs = fb.run(fb.initial_state(), 150, 0)
    assert bool(fs.converged) and bool(gs.converged)
    assert int(fs.iteration) == int(gs.iteration) < 150
    for a, b in zip(fb.current_solution(fs), gb.current_solution(gs)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


def test_dct_projection_and_float64_take_the_generic_path():
    f = np.random.RandomState(3).rand(36)
    prob = _tv(ptt, 6, 6, f)
    assert TFused(prob, TOptions(projection="dct"),
                  _sopts(ptt, 0)).rof is None
    assert TFused(prob, TOptions(), _sopts(ptt, 0)).mode == "cheby"
    ptt.set_dtype(torch.float64)
    try:
        assert TFused(_tv(ptt, 6, 6, f), TOptions(),
                      _sopts(ptt, 0)).rof is None
    finally:
        ptt.set_dtype(torch.float32)


def test_dirty_z_warm_start_is_canonicalized():
    """Mass on the dead z coordinates of a warm start is projected off once
    per run, in both packages' fused routes."""
    nx, ny = 12, 16
    rng = np.random.RandomState(9)
    f = rng.rand(nx * ny).astype(np.float32)
    z = (0.2 * rng.randn(2, nx, ny)).astype(np.float32)
    z[0, -1, :] = 1.0
    z[1, :, -1] = -1.0
    opts = dict(residual_iter=5)
    jb = JFused(_tv(pt, nx, ny, f), JOptions(**opts), _sopts(pt, 0),
                interpret=True)
    tb = TFused(_tv(ptt, nx, ny, f), TOptions(**opts), _sopts(ptt, 0))
    js = dataclasses.replace(jb.initial_state(),
                             z_dual=jnp.asarray(z.reshape(-1)))
    ts = dataclasses.replace(tb.initial_state(),
                             z_dual=torch.from_numpy(z.reshape(-1)))
    js = jb.run(js, 20)
    ts = tb.run(ts, 20, 0)
    _assert_runs_agree(ts, js)
    zd = ts.z_dual.numpy().reshape(2, nx, ny)
    assert np.all(zd[0, -1, :] == 0.0) and np.all(zd[1, :, -1] == 0.0)


# ---------------------------------------------------------------------------
# large planes: the JAX package's banded routes (rows 5, 6 and 11 of the
# kernel table) against the port's one route at any size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("double_buffer", [False, True])
def test_fused_admm_matches_jax_banded(double_buffer):
    """JAX FusedROFADMM forced onto its banded Chebyshev route
    (admm_banded_chunk, 4 bands of 32 rows with a 24-row halo) against the
    port's whole-plane route over 40 iterations with adaptation."""
    nx, ny = 128, 32
    f = np.random.RandomState(13).rand(nx * ny).astype(np.float32)
    aopts = dict(residual_iter=10, projection="cheby")
    jb = JFused(_tv(pt, nx, ny, f, lmb=8.0), JOptions(**aopts),
                _sopts(pt, 1e-3), interpret=True)
    jb.mode = "banded"
    jb.rof["n_bands"] = 4
    jb.rof["double_buffer"] = double_buffer
    tb = TFused(_tv(ptt, nx, ny, f, lmb=8.0), TOptions(**aopts),
                _sopts(ptt, 1e-3))
    js = jb.run(jb.initial_state(), 40)
    ts = tb.run(tb.initial_state(), 40, 0)
    assert float(ts.rho) != 1.0  # adaptation fired
    _assert_runs_agree(ts, js)


@pytest.mark.parametrize("double_buffer", [False, True])
def test_fused_pdhg_matches_jax_banded(double_buffer):
    """JAX FusedROFPDHG forced onto its banded route (4 bands): with the
    double buffer it runs the banded multichunk (rof_fused_multichunk_banded)
    and the double-buffered banded chunk, without it the single-buffered
    banded chunk only.  The port runs its whole-plane kernels (plain
    versions here) at any size; 45 iterations of boyd with ri 4 run
    phases A, B0, B and C."""
    nx, ny = 96, 24
    f = np.random.RandomState(2).rand(nx * ny).astype(np.float32)
    popts = dict(stepsize="boyd", residual_iter=4, scale_steps_operator=False)
    jb = JFusedPDHG(_tv(pt, nx, ny, f), JPOptions(**popts), _sopts(pt, 1e-5),
                    interpret=True)
    jb.rof["n_bands"] = 4
    jb.rof["double_buffer"] = double_buffer
    tb = TFusedPDHG(_tv(ptt, nx, ny, f), TPOptions(**popts),
                    _sopts(ptt, 1e-5))
    js = jb.run(jb.initial_state(), 45)
    ts = tb.run(tb.initial_state(), 45, 0)
    assert int(ts.iteration) == int(js.iteration) == 45
    for name in ("x", "y", "x_prev", "y_prev"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   atol=RUN_ATOL, err_msg=name)
    np.testing.assert_allclose(float(ts.tau), float(js.tau), rtol=1e-6)
