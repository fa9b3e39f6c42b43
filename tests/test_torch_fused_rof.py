"""Port parity: the fused ROF route of prost_tpu_torch against prost_tpu.

On the CPU the kernel wrappers run their plain PyTorch versions; they are
held against the JAX kernels in Pallas interpret mode at 24x40 (f32, the
same operations in the same order: atol 1e-5 on the planes, rtol 1e-5 on
the norms).  The CUDA kernels are held against the plain versions on the
card by tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend import PDHGOptions as JOptions
from prost_tpu.ops import FusedROFPDHG as JFused
from prost_tpu.ops import fused_rof as jfr
from prost_tpu_torch.backend import BackendPDHG as TBackend
from prost_tpu_torch.backend import PDHGOptions as TOptions
from prost_tpu_torch.ops import FusedROFPDHG as TFused
from prost_tpu_torch.ops import fused_rof as tfr

NX, NY = 24, 40
PLANE_ATOL, NORM_RTOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _inputs(seed, nx=NX, ny=NY, clean=True):
    rng = np.random.RandomState(seed)
    x = rng.rand(nx, ny).astype(np.float32)
    q = (0.3 * rng.randn(2, nx, ny)).astype(np.float32)
    if clean:
        q[0, -1, :] = 0.0
        q[1, :, -1] = 0.0
    f = rng.rand(nx, ny).astype(np.float32)
    w = (rng.rand(nx, ny) > 0.3).astype(np.float32)
    return x, q, f, w


def _close(t_out, j_out, n_planes=4):
    for i, (a, b) in enumerate(zip(t_out[:n_planes], j_out[:n_planes])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PLANE_ATOL,
                                   err_msg=f"plane {i}")
    for a, b in zip(t_out[n_planes:], j_out[n_planes:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=NORM_RTOL,
                                   atol=1e-7)


@pytest.mark.parametrize("dataterm", ["square", "abs", "wsquare"])
@pytest.mark.parametrize("ri", [1, 7, 10])
def test_rof_chunk_matches_jax_kernel(ri, dataterm):
    x, q, f, w = _inputs(ri)
    args = (0.9, 1.1, 1.0, 8.0, 1.0)  # tau, sigma, theta, lmb, radius
    ref = jfr.rof_fused_chunk(jnp.asarray(x), jnp.asarray(q), jnp.asarray(f),
                              jnp.asarray(w), *args, ri, dataterm=dataterm,
                              interpret=True)
    scal = torch.tensor(args, dtype=torch.float32)
    out = tfr.rof_chunk(torch.from_numpy(x), torch.from_numpy(q),
                        torch.from_numpy(f), torch.from_numpy(w), scal, ri,
                        dataterm)
    _close(out, ref)


def _consts(nx=NX, ny=NY):
    return (float(np.sqrt(2 * nx * ny)), float(np.sqrt(nx * ny)), 1.5, 0.95,
            1.05, 0.8)


@pytest.mark.parametrize("stepsize,tol", [
    ("alg1", 0.0),
    ("goldstein", 1e-2),
    ("boyd", 1e-2),    # adapts and converges partway through the launch
    ("boyd", 1e-4),
])
@pytest.mark.parametrize("ri", [1, 7, 10])
def test_rof_multichunk_matches_jax_kernel(stepsize, tol, ri):
    x, _, f, w = _inputs(20 + ri)
    q = np.zeros((2, NX, NY), np.float32)
    scal = np.array([1.0, 1.0, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0,
                     tol, tol, tol, tol], np.float32)
    ref = jfr.rof_fused_multichunk(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(f), jnp.asarray(w),
        jnp.asarray(scal), ri, 8, "square", stepsize, _consts(),
        interpret=True)
    out = tfr.rof_multichunk(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(f),
        torch.from_numpy(w), torch.from_numpy(scal), ri, 8, "square",
        stepsize, _consts())
    _close(out, ref)
    # converged flag and executed-chunk count exactly
    assert out[5][5].item() == float(ref[5][5])
    assert out[5][6].item() == float(ref[5][6])


def test_multichunk_converges_partway():
    """The boyd case above stops inside the launch: fewer than k chunks
    run, and the outputs are those of the last executed chunk."""
    x, _, f, w = _inputs(27)
    q = np.zeros((2, NX, NY), np.float32)
    scal = torch.tensor([1.0, 1.0, 1.0, 16.0, 1.0, 0.5, 0.0, 0.0, 1.0,
                         1e-2, 1e-2, 1e-2, 1e-2])
    x_t, q_t = torch.from_numpy(x), torch.from_numpy(q)
    f_t, w_t = torch.from_numpy(f), torch.from_numpy(w)
    out = tfr.rof_multichunk(x_t, q_t, f_t, w_t, scal, 10, 8, "square",
                             "boyd", _consts())
    done = int(out[5][6])
    assert out[5][5].item() == 1.0 and 1 <= done < 8
    again = tfr.rof_multichunk(x_t, q_t, f_t, w_t, scal, 10, done, "square",
                               "boyd", _consts())
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_converged_at_entry_returns_the_inputs():
    """With the converged flag set nothing runs: the inputs come back, as
    a kernel launched after convergence returns at once."""
    x, q, f, w = (torch.from_numpy(a) for a in _inputs(3))
    c = tfr.rof_chunk(x, q, f, w, torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0,
                                                1.0]), 5)
    for a, b in zip(c[:4], (x, q, x, q)):
        assert torch.equal(a, b)
    assert torch.equal(c[4], torch.zeros(4))
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0, 0.5, 2.0, 3.0, 11.0,
                         1e-3, 1e-3, 1e-3, 1e-3, 1.0])
    m = tfr.rof_multichunk(x, q, f, w, scal, 5, 8, "square", "boyd",
                           _consts())
    for a, b in zip(m[:4], (x, q, x, q)):
        assert torch.equal(a, b)
    assert m[5].tolist() == pytest.approx([0.9, 1.1, 0.5, 2.0, 3.0, 1.0, 0.0])


def test_wrappers_reject_bad_input():
    x, q, f, w = (torch.from_numpy(a) for a in _inputs(1))
    scal = torch.tensor([0.9, 1.1, 1.0, 8.0, 1.0])
    with pytest.raises(ptt.ProstError, match="q must be"):
        tfr.rof_chunk(x, q[0], f, w, scal, 3)
    with pytest.raises(ptt.ProstError, match="data term"):
        tfr.rof_chunk(x, q, f, w, scal, 3, "huber")
    with pytest.raises(ptt.ProstError, match="scal"):
        tfr.rof_chunk(x, q, f, w, scal[:4], 3)


# ---------------------------------------------------------------------------
# structure matching and the backend
# ---------------------------------------------------------------------------

def _tv(mod, nx, ny, data_fun, data_coeffs, ball=False):
    n = nx * ny
    grad = mod.linop.BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    prox_g = [mod.prox.ProxElem1D(index=0, size=n, fun=data_fun,
                                  coeffs=data_coeffs)]
    if ball:
        fstar = mod.prox.ProxElemNorm2(
            index=0, size=2 * n, count=n, dim=2, interleaved=False,
            fun="ind_leq0", coeffs=(2.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    else:
        fstar = mod.prox.ProxMoreau(index=0, size=2 * n, child=mod.prox.
                                    ProxElemNorm2(
            index=0, size=2 * n, count=n, dim=2, interleaved=False,
            fun="abs", coeffs=(1.0, 0.0, 1.5, 0.0, 0.0, 0.0, 0.0)))
    return mod.Problem.create(mod.linop.LinearOperator.create([grad]),
                              prox_g=prox_g, prox_fstar=[fstar])


def _cases(nx, ny, seed=1):
    rng = np.random.RandomState(seed)
    n = nx * ny
    f = rng.rand(n)
    mask = (rng.rand(n) > 0.3).astype(np.float64)
    return {
        "square": ("square", (1.0, f, 16.0, 0.0, 0.0, 0.0, 0.0), False),
        "abs": ("abs", (1.0, f, 1.5, 0.0, 0.0, 0.0, 0.0), True),
        "wsquare": ("square", (mask, f * mask, 7.0, 0.0, 0.0, 0.0, 0.0),
                    False),
        "huber": ("huber", (1.0, f, 1.0, 0.0, 0.0, 0.5, 0.0), False),
    }


@pytest.mark.parametrize("case", ["square", "abs", "wsquare", "huber"])
def test_match_rof_structure_matches_jax(case):
    fun, coeffs, ball = _cases(8, 6)[case]
    jm = jfr.match_rof_structure(_tv(pt, 8, 6, fun, coeffs, ball))
    tm = tfr.match_rof_structure(_tv(ptt, 8, 6, fun, coeffs, ball))
    if jm is None:
        assert tm is None
        return
    for k in ("nx", "ny", "lmb", "radius", "dataterm"):
        assert tm[k] == jm[k], k
    for k in ("f", "w"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-7, err_msg=k)


def test_match_rejects_float64():
    fun, coeffs, ball = _cases(4, 4)["square"]
    ptt.set_dtype(torch.float64)
    try:
        assert tfr.match_rof_structure(_tv(ptt, 4, 4, fun, coeffs,
                                           ball)) is None
    finally:
        ptt.set_dtype(torch.float32)


def _sopts(mod, t):
    return mod.SolverOptions(verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                             tol_abs_primal=t, tol_abs_dual=t)


@pytest.mark.parametrize("case,stepsize,ri,t", [
    ("square", "boyd", 10, 0.0),
    ("square", "boyd", 5, 1e-5),
    ("square", "goldstein", 5, 1e-5),
    ("square", "alg1", 1, 0.0),
    ("abs", "boyd", 7, 0.0),
    ("wsquare", "boyd", 5, 0.0),
])
def test_fused_backend_matches_jax_fused(case, stepsize, ri, t):
    """The port's FusedROFPDHG on the CPU (plain versions) against the JAX
    FusedROFPDHG in interpret mode over 60 iterations: every phase of the
    run (align, multichunk, chunk, epilogue, tail) on the same inputs."""
    fun, coeffs, ball = _cases(NX, NY, 3)[case]
    jb = JFused(_tv(pt, NX, NY, fun, coeffs, ball),
                JOptions(stepsize=stepsize, residual_iter=ri,
                         scale_steps_operator=False), _sopts(pt, t),
                interpret=True)
    tb = TFused(_tv(ptt, NX, NY, fun, coeffs, ball),
                TOptions(stepsize=stepsize, residual_iter=ri,
                         scale_steps_operator=False), _sopts(ptt, t))
    assert jb.rof is not None and tb.rof is not None
    js = jb.run(jb.initial_state(), 60)
    ts = tb.run(tb.initial_state(), 60, 0)
    assert int(ts.iteration) == int(js.iteration)
    assert bool(ts.converged) == bool(js.converged)
    for name in ("x", "y", "x_prev", "y_prev", "kx", "kty"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=2e-5,
                                   err_msg=name)
    for name in ("tau", "sigma"):
        np.testing.assert_allclose(float(getattr(ts, name)),
                                   float(getattr(js, name)), rtol=1e-6)
    np.testing.assert_allclose(float(ts.primal_residual),
                               float(js.primal_residual), rtol=1e-3)


def test_fused_backend_matches_generic_to_convergence():
    """Fused (plain versions) vs the port's own generic path: the same
    stopping iteration and current solution."""
    fun, coeffs, ball = _cases(12, 16, 2)["square"]
    opts = TOptions(stepsize="boyd", residual_iter=5,
                    scale_steps_operator=False)
    prob = _tv(ptt, 12, 16, fun, coeffs, ball)
    gb = TBackend(prob, opts, _sopts(ptt, 1e-3))
    fb = TFused(prob, opts, _sopts(ptt, 1e-3))
    gs = gb.run(gb.initial_state(), 400, 0)
    fs = fb.run(fb.initial_state(), 400, 0)
    assert bool(fs.converged) and bool(gs.converged)
    assert int(fs.iteration) == int(gs.iteration) < 400
    for a, b in zip(fb.current_solution(fs), gb.current_solution(gs)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4)


def test_alg2_and_reference_residuals_take_the_generic_path():
    fun, coeffs, ball = _cases(6, 5)["square"]
    prob = _tv(ptt, 6, 5, fun, coeffs, ball)
    assert TFused(prob, TOptions(stepsize="alg2"), _sopts(ptt, 0)).rof is None
    assert TFused(prob, TOptions(reference_residuals=True),
                  _sopts(ptt, 0)).rof is None
    assert TFused(prob, TOptions(), _sopts(ptt, 0)).rof is not None


def test_dirty_dual_warm_start_is_canonicalized():
    """The fused route's one trajectory deviation from the generic path:
    mass on the dead dual coordinates of a warm start is projected off
    once per run (the generic path lets it decay).  Clean warm starts
    follow the generic path; dirty ones reach the same solution; the port
    agrees with the JAX fused route on both."""
    nx = ny = 16
    n = nx * ny
    rng = np.random.RandomState(17)
    f = rng.rand(n).astype(np.float32)
    coeffs = (1.0, f, 16.0, 0.0, 0.0, 0.0, 0.0)
    y0 = (0.1 * rng.randn(2, nx, ny)).astype(np.float32)
    clean = y0.copy()
    clean[0, -1, :] = 0.0
    clean[1, :, -1] = 0.0
    dirty = y0.copy()
    dirty[0, -1, :] = 1.0
    dirty[1, :, -1] = -1.0

    def run(mod, cls, y, iters, **kw):
        opts = (TOptions if mod is ptt else JOptions)(
            stepsize="boyd", residual_iter=5, scale_steps_operator=False)
        b = cls(_tv(mod, nx, ny, "square", coeffs), opts, _sopts(mod, 0),
                **kw)
        s = b.initial_state()
        if mod is ptt:
            s = dataclasses.replace(s, y=torch.from_numpy(y.reshape(-1)))
            return b.run(s, iters, 0)
        return b.run(dataclasses.replace(s, y=jnp.asarray(y.reshape(-1))),
                     iters)

    fs = run(ptt, TFused, clean, 26)
    gs = run(ptt, TBackend, clean, 26)
    np.testing.assert_allclose(fs.x.numpy(), gs.x.numpy(), atol=1e-6)

    fd = run(ptt, TFused, dirty, 1001)
    gd = run(ptt, TBackend, dirty, 1001)
    np.testing.assert_allclose(fd.x.numpy(), gd.x.numpy(), atol=5e-4)
    q = fd.y.numpy().reshape(2, nx, ny)
    assert np.all(q[0, -1, :] == 0.0) and np.all(q[1, :, -1] == 0.0)

    jd = run(pt, JFused, dirty, 26, interpret=True)
    td = run(ptt, TFused, dirty, 26)
    np.testing.assert_allclose(td.y.numpy(), np.asarray(jd.y), atol=2e-5)
    np.testing.assert_allclose(td.x.numpy(), np.asarray(jd.x), atol=2e-5)
