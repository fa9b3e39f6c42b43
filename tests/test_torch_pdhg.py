"""Port parity: the generic PDHG backend of prost_tpu_torch against
prost_tpu's ``BackendPDHG`` on the same problem and the same iterations.

f64 (JAX in x64 mode): rtol 1e-9, the same expressions in the same order,
so only the order of the norm sums differs.  f32: atol 2e-5 on the
iterates, the bar the JAX package holds its own fused path to.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend import BackendPDHG as JBackend
from prost_tpu.backend import PDHGOptions as JOptions
from prost_tpu_torch.backend import BackendPDHG as TBackend
from prost_tpu_torch.backend import PDHGOptions as TOptions


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


class _x64:
    def __enter__(self):
        jax.config.update("jax_enable_x64", True)
        pt.set_dtype(jnp.float64)
        ptt.set_dtype(torch.float64)

    def __exit__(self, *a):
        ptt.set_dtype(torch.float32)
        pt.set_dtype(jnp.float32)
        jax.config.update("jax_enable_x64", False)


def _model(mod, nx, ny, f, lmb, dataterm="square"):
    """TV denoising through the modeling API of either package."""
    n = nx * ny
    u, q = mod.Variable(n), mod.Variable(2 * n)
    prob = mod.MinMaxProblem([u], [q])
    prob.add_function(u, mod.function.sum_1d(dataterm, 1, f, lmb))
    prob.add_function(q, mod.function.conjugate(
        mod.function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, 1))
    return prob.finalize()


def _sopts(mod, t):
    return mod.SolverOptions(verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                             tol_abs_primal=t, tol_abs_dual=t)


def _pair(stepsize, ri, t, nx=10, ny=12, iters=60, **kw):
    f = np.random.RandomState(4).rand(nx * ny)
    jopts = JOptions(stepsize=stepsize, residual_iter=ri, alg2_gamma=0.3,
                     **kw)
    topts = TOptions(stepsize=stepsize, residual_iter=ri, alg2_gamma=0.3,
                     **kw)
    jb = JBackend(_model(pt, nx, ny, f, 8.0), jopts, _sopts(pt, t))
    tb = TBackend(_model(ptt, nx, ny, f, 8.0), topts, _sopts(ptt, t))
    js = jb.run(jb.initial_state(), iters)
    ts = tb.run(tb.initial_state(), iters, 0)
    return jb, js, tb, ts


def _assert_states(js, ts, rtol, atol, res_rtol=None):
    """Iterates and step sizes at (rtol, atol); the residual norms at
    ``res_rtol`` (in f32 they are norms of differences of nearby iterates,
    so cancellation costs digits: the JAX package's own f32 bar is 1e-3)."""
    for name in ("x", "y", "kx", "kty", "x_prev", "y_prev", "tau", "sigma",
                 "theta", "arg_alpha", "arb_l", "arb_u"):
        np.testing.assert_allclose(ts.__dict__[name].numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    for name in ("primal_residual", "dual_residual", "primal_var_norm",
                 "dual_var_norm"):
        np.testing.assert_allclose(float(getattr(ts, name)),
                                   float(getattr(js, name)),
                                   rtol=res_rtol or rtol, err_msg=name)
    assert int(ts.iteration) == int(js.iteration)
    assert bool(ts.converged) == bool(js.converged)


@pytest.mark.parametrize("ri", [1, 10])
@pytest.mark.parametrize("stepsize", ["alg1", "goldstein", "boyd", "alg2"])
def test_generic_f64_matches_jax(stepsize, ri):
    with _x64():
        _, js, _, ts = _pair(stepsize, ri, 1e-3)
        _assert_states(js, ts, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("ri", [1, 10])
@pytest.mark.parametrize("stepsize", ["alg1", "goldstein", "boyd"])
def test_generic_f32_matches_jax(stepsize, ri):
    _, js, _, ts = _pair(stepsize, ri, 1e-3)
    assert ts.x.dtype == torch.float32
    _assert_states(js, ts, rtol=1e-5, atol=2e-5, res_rtol=1e-3)


def test_reference_residuals_mode_matches_jax():
    with _x64():
        _, js, _, ts = _pair("boyd", 1, 1e-3, reference_residuals=True)
        _assert_states(js, ts, rtol=1e-9, atol=1e-12)


def test_convergence_holds_the_state():
    """After the device sets ``converged`` the planned iterations leave the
    state as it was: the run stops where the JAX while-loop stops, and the
    current solution matches."""
    with _x64():
        jb, js, tb, ts = _pair("boyd", 5, 2e-3, iters=5000)
        assert bool(js.converged) and int(js.iteration) < 5000
        _assert_states(js, ts, rtol=1e-9, atol=1e-12)
        for a, b in zip(tb.current_solution(ts), jb.current_solution(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-12)


def test_resume_from_host_iteration():
    """Two runs split at an epoch equal one run (the solver's pattern)."""
    with _x64():
        f = np.random.RandomState(1).rand(80)
        opts = TOptions(stepsize="boyd", residual_iter=10)
        tb = TBackend(_model(ptt, 8, 10, f, 8.0), opts, _sopts(ptt, 1e-4))
        s0 = tb.initial_state()
        one = tb.run(s0, 57, 0)
        two = tb.run(tb.run(s0, 23, 0), 57, 23)
        for name in ("x", "y", "tau", "sigma", "iteration"):
            assert torch.equal(getattr(one, name), getattr(two, name))


@pytest.mark.parametrize("f64", [False, True])
def test_normest_matches_jax(f64):
    """Both packages start the power iteration from numpy's RandomState
    vector, so they pick the same step sizes."""
    f = np.random.RandomState(2).rand(9 * 13)
    if f64:
        with _x64():
            jn = float(_model(pt, 9, 13, f, 4.0).normest())
            tn = float(_model(ptt, 9, 13, f, 4.0).normest())
        np.testing.assert_allclose(tn, jn, rtol=1e-12)
    else:
        jn = float(_model(pt, 9, 13, f, 4.0).normest())
        tn = float(_model(ptt, 9, 13, f, 4.0).normest())
        np.testing.assert_allclose(tn, jn, rtol=1e-5)


def test_warm_start_and_current_solution_match_jax():
    with _x64():
        nx, ny = 8, 9
        rng = np.random.RandomState(6)
        f = rng.rand(nx * ny)
        x0, y0 = rng.rand(nx * ny), 0.2 * rng.randn(2 * nx * ny)
        jo = dataclasses.replace(_sopts(pt, 0.0), x0=x0, y0=y0)
        to = dataclasses.replace(_sopts(ptt, 0.0), x0=x0, y0=y0)
        jb = JBackend(_model(pt, nx, ny, f, 8.0), JOptions(residual_iter=3),
                      jo)
        tb = TBackend(_model(ptt, nx, ny, f, 8.0), TOptions(residual_iter=3),
                      to)
        js, ts = jb.run(jb.initial_state(), 31), tb.run(tb.initial_state(),
                                                        31, 0)
        for a, b in zip(tb.current_solution(ts), jb.current_solution(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-12)


def test_wrong_warm_start_size_raises():
    f = np.random.RandomState(0).rand(16)
    o = dataclasses.replace(_sopts(ptt, 0.0), x0=np.zeros(5))
    b = TBackend(_model(ptt, 4, 4, f, 1.0), TOptions(), o)
    with pytest.raises(ptt.ProstError, match="wrong size"):
        b.initial_state()
