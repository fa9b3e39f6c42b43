"""Port parity: the generic ADMM backend of prost_tpu_torch (and its CGLS
and DCT pieces) against prost_tpu's on the same problem and inputs.

f64 (JAX in x64 mode): rtol 1e-9 on the iterates, the same expressions in
the same order, so only the order of sums and the FFT's rounding differ.
f32: atol 2e-5 on the iterates, the bar the JAX package holds its own
fused ADMM path to; residual norms rtol 1e-3 (norms of differences of
nearby iterates lose digits to cancellation).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.fft
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.backend.admm import ADMMOptions as JOptions
from prost_tpu.backend.admm import BackendADMM as JBackend
from prost_tpu.backend.admm import _dct_project as j_dct_project
from prost_tpu.backend.admm import dct_projection_plan as j_plan
from prost_tpu.backend.cgls import cgls_solve as j_cgls
from prost_tpu_torch import interop
from prost_tpu_torch.backend import ADMMOptions as TOptions
from prost_tpu_torch.backend import BackendADMM as TBackend
from prost_tpu_torch.backend import cgls_solve as t_cgls
from prost_tpu_torch.backend.admm import _dct_project as t_dct_project
from prost_tpu_torch.backend.admm import dct2, dct_projection_plan, idct2


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


def _model(mod, nx, ny, f, lmb, **kw):
    """TV denoising in the saddle-point form through either package."""
    n = nx * ny
    u, q = mod.Variable(n), mod.Variable(2 * n)
    prob = mod.MinMaxProblem([u], [q], **kw)
    prob.add_function(u, mod.function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, mod.function.conjugate(
        mod.function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, 1))
    return prob


def _sopts(mod, rel, abs_, **kw):
    return mod.SolverOptions(verbose=False, tol_rel_primal=rel,
                             tol_rel_dual=rel, tol_abs_primal=abs_,
                             tol_abs_dual=abs_, **kw)


def _pair(projection, nx=12, ny=10, iters=50, ri=5):
    """The same generic run in both packages; tolerances under which the
    Boyd rho adaptation fires."""
    f = np.random.RandomState(5).rand(nx * ny)
    jb = JBackend(_model(pt, nx, ny, f, 4.0).finalize(),
                  JOptions(residual_iter=ri, projection=projection),
                  _sopts(pt, 1e-2, 1e-3))
    tb = TBackend(_model(ptt, nx, ny, f, 4.0).finalize(),
                  TOptions(residual_iter=ri, projection=projection),
                  _sopts(ptt, 1e-2, 1e-3))
    js = jb.run(jb.initial_state(), iters)
    ts = tb.run(tb.initial_state(), iters, 0)
    return jb, js, tb, ts


def _assert_states(js, ts, rtol, atol, res_rtol):
    for name in ("x_half", "x_proj", "x_dual", "z_half", "z_proj", "z_dual",
                 "cg_warm", "rho", "delta", "arb_l", "arb_u"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    for name in ("primal_residual", "dual_residual", "primal_var_norm",
                 "dual_var_norm"):
        np.testing.assert_allclose(float(getattr(ts, name)),
                                   float(getattr(js, name)), rtol=res_rtol,
                                   err_msg=name)
    assert int(ts.iteration) == int(js.iteration)
    assert bool(ts.converged) == bool(js.converged)


@pytest.mark.parametrize("projection", ["cgls", "cheby", "dct"])
def test_generic_f64_matches_jax(projection):
    with _x64():
        _, js, _, ts = _pair(projection)
        assert float(js.rho) != pytest.approx(1.0)  # adaptation fired
        _assert_states(js, ts, rtol=1e-9, atol=1e-12, res_rtol=1e-9)


@pytest.mark.parametrize("projection", ["cgls", "cheby", "dct"])
def test_generic_f32_matches_jax(projection):
    _, js, _, ts = _pair(projection)
    assert float(js.rho) != pytest.approx(1.0)
    _assert_states(js, ts, rtol=0.0, atol=2e-5, res_rtol=1e-3)


def test_current_solution_and_warm_start_match_jax():
    nx, ny = 8, 9
    f = np.random.RandomState(6).rand(nx * ny)
    x0 = np.random.RandomState(7).rand(nx * ny)
    with _x64():
        jb = JBackend(_model(pt, nx, ny, f, 8.0).finalize(),
                      JOptions(residual_iter=3), _sopts(pt, 0.0, 0.0, x0=x0))
        tb = TBackend(_model(ptt, nx, ny, f, 8.0).finalize(),
                      TOptions(residual_iter=3),
                      _sopts(ptt, 0.0, 0.0, x0=x0))
        np.testing.assert_allclose(tb.initial_state().z_half.numpy(),
                                   np.asarray(jb.initial_state().z_half),
                                   rtol=1e-12)
        js = jb.run(jb.initial_state(), 20)
        ts = tb.run(tb.initial_state(), 20, 0)
        for a, b in zip(tb.current_solution(ts), jb.current_solution(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-12)


def test_convergence_holds_the_state():
    """Iterations issued after convergence leave the state as it was."""
    nx, ny = 8, 8
    f = np.random.RandomState(8).rand(nx * ny)
    tb = TBackend(_model(ptt, nx, ny, f, 8.0).finalize(),
                  TOptions(residual_iter=5), _sopts(ptt, 1e-2, 1e-2))
    s = tb.run(tb.initial_state(), 60, 0)
    assert bool(s.converged) and int(s.iteration) < 60
    s2 = tb.run(s, 80, 60)
    assert int(s2.iteration) == int(s.iteration)
    assert torch.equal(s2.x_half, s.x_half)


def test_unknown_projection_and_missing_plan_raise():
    rng = np.random.RandomState(9)
    f = rng.rand(16)
    prob = _model(ptt, 4, 4, f, 8.0).finalize()
    with pytest.raises(ptt.ProstError, match="Unknown projection"):
        TBackend(prob, TOptions(projection="lsqr"), _sopts(ptt, 0, 0))
    prob = _model(ptt, 4, 4, f, 8.0, scaling="custom",
                  scaling_left=0.5 + rng.rand(32),
                  scaling_right=0.5 + rng.rand(16)).finalize()
    with pytest.raises(ptt.ProstError, match="requires"):
        TBackend(prob, TOptions(projection="cheby"), _sopts(ptt, 0, 0))


@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_cgls_solve_matches_jax(shift):
    """cgls_solve on a dense operator in f64: same iterate, same number of
    steps, with the early exit (tol 1e-3 stops after 13-15 steps, before
    maxit) and without (an unreachable tol runs all steps after the 10 eps
    clamp).  A tighter tol runs CG past ~n steps on this 20-column system,
    where lost orthogonality amplifies the two BLAS summation orders far
    beyond 1e-9."""
    rng = np.random.RandomState(10)
    a = rng.randn(30, 20)
    b = rng.randn(30)
    x0 = 0.1 * rng.randn(20)
    with _x64():
        for tol, maxit in ((1e-3, 50), (0.0, 8)):
            jx, jk = j_cgls(lambda v: jnp.asarray(a) @ v,
                            lambda v: jnp.asarray(a).T @ v, jnp.asarray(b),
                            jnp.asarray(x0), shift, tol, maxit)
            ta = torch.from_numpy(a)
            tx, tk = t_cgls(lambda v: ta @ v, lambda v: ta.T @ v,
                            torch.from_numpy(b), torch.from_numpy(x0), shift,
                            tol, maxit)
            assert int(tk) == int(jk) and (int(jk) < maxit) == (tol > 0)
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                       rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [7, 8])
def test_dct_matches_scipy(n):
    """The orthonormal DCT-II on torch.fft and its inverse, odd and even
    lengths, against scipy in f64 (1e-12: FFT rounding)."""
    x = np.random.RandomState(n).randn(3, n, n + 3)
    for dim in (1, 2):
        y = dct2(torch.from_numpy(x), dim)
        np.testing.assert_allclose(
            y.numpy(), scipy.fft.dct(x, type=2, norm="ortho", axis=dim),
            atol=1e-12)
        np.testing.assert_allclose(idct2(y, dim).numpy(), x, atol=1e-12)


def test_dct_projection_matches_jax_f64():
    """The exact graph projection in f64: port and JAX solve the same
    system, and the solution satisfies (I + K~^T K~) u = rhs."""
    nx, ny = 9, 12
    f = np.random.RandomState(11).rand(nx * ny)
    rhs = np.random.RandomState(12).randn(nx * ny)
    with _x64():
        jp = _model(pt, nx, ny, f, 8.0).finalize()
        tp = _model(ptt, nx, ny, f, 8.0).finalize()
        plan = dct_projection_plan(tp)
        assert plan == j_plan(jp)
        u = t_dct_project(plan, torch.from_numpy(rhs))
        np.testing.assert_allclose(
            u.numpy(), np.asarray(j_dct_project(j_plan(jp), jnp.asarray(rhs))),
            atol=1e-12)
        sq = torch.sqrt(tp.scaling_left)
        st = torch.sqrt(tp.scaling_right)
        m = u + st * tp.linop.apply_adjoint(sq * sq * tp.linop.apply(st * u))
        np.testing.assert_allclose(m.numpy(), rhs, atol=1e-10)


def test_state_round_trip_through_interop():
    """A JAX ADMM state handed to the port continues on the same
    trajectory: 20 JAX iterations, then 20 more in each package."""
    nx, ny = 10, 8
    f = np.random.RandomState(13).rand(nx * ny)
    jb = JBackend(_model(pt, nx, ny, f, 8.0).finalize(),
                  JOptions(residual_iter=5, projection="cheby"),
                  _sopts(pt, 1e-3, 1e-4))
    tb = TBackend(_model(ptt, nx, ny, f, 8.0).finalize(),
                  TOptions(residual_iter=5, projection="cheby"),
                  _sopts(ptt, 1e-3, 1e-4))
    js = jb.run(jb.initial_state(), 20)
    fields = {k: np.asarray(v) for k, v in vars(js).items()}
    ts = interop.admm_state_from_numpy(fields, torch.device("cpu"))
    back = interop.admm_state_to_numpy(ts)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert ts.iteration.dtype == torch.int32
    assert ts.converged.dtype == torch.bool
    js2 = jb.run(js, 40)
    ts2 = tb.run(ts, 40, int(ts.iteration))
    assert int(ts2.iteration) == int(js2.iteration)
    np.testing.assert_allclose(ts2.x_half.numpy(), np.asarray(js2.x_half),
                               atol=2e-5)
    np.testing.assert_allclose(float(ts2.rho), float(js2.rho), rtol=1e-6)


def _image(size, seed=42):
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, size)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    im = 0.4 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.09) + 0.3 * (xx > 0.7)
    return (im + 0.05 * rng.randn(size, size)).reshape(-1)


def _energy(u, f, lmb, size):
    u2 = np.asarray(u, np.float64).reshape(size, size)
    gx = np.diff(u2, axis=0, append=u2[-1:, :])
    gy = np.diff(u2, axis=1, append=u2[:, -1:])
    return (lmb / 2 * np.sum((u2.ravel() - f) ** 2)
            + np.sum(np.sqrt(gx ** 2 + gy ** 2)))


def test_solve_admm_matches_jax():
    """``ptt.solve`` with ``backend_admm(residual_iter=10)`` on the
    saddle-point model against ``pt.solve``.  The port takes its fused
    route (Chebyshev projection, plain versions on the CPU); the JAX
    package on the CPU takes its generic CGLS path.  Two inexact inner
    solvers of one system: compared by where they end (energy 1e-4
    relative, iterate 1e-3)."""
    size, lmb = 24, 16.0
    f = _image(size)
    opts = dict(max_iters=3000, num_cback_calls=10, verbose=False,
                tol_rel_primal=1e-5, tol_rel_dual=1e-5, tol_abs_primal=1e-5,
                tol_abs_dual=1e-5)
    jres = pt.solve(_model(pt, size, size, f, lmb),
                    pt.backend_admm(residual_iter=10), pt.options(**opts))
    tprob = _model(ptt, size, size, f, lmb)
    made = []
    backend = ptt.backend_admm(residual_iter=10)
    create = backend.create
    backend.create = lambda p, o: made.append(create(p, o)) or made[-1]
    tres = ptt.solve(tprob, backend, ptt.options(**opts))
    assert made[0].mode == "cheby"
    assert tres.result.value == jres.result.value == "converged"
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), atol=1e-3)
    np.testing.assert_allclose(_energy(tres.x, f, lmb, size),
                               _energy(jres.x, f, lmb, size), rtol=1e-4)


def test_min_problem_form_takes_the_generic_path():
    """The constrained form of examples/example_rof_admm.py (prox_f, no
    prox_fstar) is not matched as ROF by either package: both run generic
    ADMM (CGLS), and agree to f32."""
    size = 8
    n = size * size
    f = _image(size)

    def run(mod):
        u, z = mod.Variable(n), mod.Variable(2 * n)
        prob = mod.MinProblem([u], [z])
        prob.add_function(u, mod.function.sum_1d("square", 1, f, 16.0))
        prob.add_function(z, mod.function.sum_norm2(2, False, "abs"))
        prob.add_constraint(u, z, mod.block.gradient2d(size, size, 1))
        made = []
        backend = mod.backend_admm(rho0=15.0, residual_iter=4)
        create = backend.create
        backend.create = lambda p, o: made.append(create(p, o)) or made[-1]
        res = mod.solve(prob, backend, mod.options(
            max_iters=40, num_cback_calls=10, verbose=False,
            tol_rel_primal=0.0, tol_rel_dual=0.0, tol_abs_primal=0.0,
            tol_abs_dual=0.0))
        return res, made[0], z

    (jres, jb, _), (tres, tb, tz) = run(pt), run(ptt)
    assert jb.rof is None and tb.rof is None
    assert tres.iterations == jres.iterations == 40
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), atol=2e-5)
    np.testing.assert_allclose(tres.z, np.asarray(jres.z), atol=2e-4)
    np.testing.assert_allclose(tz.val, tres.z)
