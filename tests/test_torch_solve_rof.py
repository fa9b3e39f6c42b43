"""Slice 1 as a whole: ROF denoising by PDHG through the port's modeling
API, against the JAX package's solve and the f64 graph-ADMM oracle; the
numpy hand-over of solver state and problem; and the import boundary."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu_torch import interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _image(size, seed=42):
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, size)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    im = 0.4 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.09) + 0.3 * (xx > 0.7)
    return (im + 0.05 * rng.randn(size, size)).reshape(-1)


def _model(mod, size, f, lmb):
    n = size * size
    u, q = mod.Variable(n), mod.Variable(2 * n)
    prob = mod.MinMaxProblem([u], [q])
    prob.add_function(u, mod.function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, mod.function.conjugate(
        mod.function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, mod.block.gradient2d(size, size, 1))
    return prob, u, q


def _opts(mod, t, max_iters):
    return mod.options(max_iters=max_iters, num_cback_calls=10,
                       verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                       tol_abs_primal=t, tol_abs_dual=t)


def _grad_matrix(size):
    d = sp.diags([-np.ones(size), np.ones(size - 1)], [0, 1],
                 shape=(size, size)).tolil()
    d[-1, -1] = 0.0  # Neumann: zero last difference
    eye = sp.eye(size)
    return sp.vstack([sp.kron(d, eye), sp.kron(eye, d)]).tocsr()


def test_modeling_solve_matches_jax_and_oracle():
    """The port's solve (fused route, plain versions on the CPU) at 32x32,
    boyd, residual_iter 10, against the JAX package's solve and against an
    independent f64 optimum."""
    size, lmb = 32, 16.0
    n = size * size
    f = _image(size)
    backend = dict(stepsize="boyd", residual_iter=10)

    jprob, ju, _ = _model(pt, size, f, lmb)
    jres = pt.solve(jprob, pt.backend_pdhg(**backend),
                    _opts(pt, 1e-5, 3000))
    tprob, tu, tq = _model(ptt, size, f, lmb)
    tres = ptt.solve(tprob, ptt.backend_pdhg(**backend),
                     _opts(ptt, 1e-5, 3000))

    # boyd over a long horizon: a one-ulp difference in a norm can flip an
    # adaptation decision, so the runs are compared by where they end
    assert tres.result.value == jres.result.value == "converged"
    assert abs(tres.iterations - jres.iterations) <= 50
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), atol=1e-3)
    np.testing.assert_allclose(tu.val, tres.x)
    assert tq.val.shape == (2 * n,)

    from oracles import (graph_admm_with_dual, prox_group_l2,
                         prox_weighted_square, rof_energy)

    K = _grad_matrix(size)
    x_grad = tres.x.astype(np.float64)
    np.testing.assert_allclose(
        K @ x_grad,
        ptt.linop.BlockGradient2D(row=0, col=0, nx=size, ny=size, L=1).apply(
            torch.from_numpy(x_grad)).numpy(), atol=1e-12)
    u_star, _, _ = graph_admm_with_dual(
        K, prox_weighted_square(f, lmb), prox_group_l2((2, n)), rho=30.0)
    e_opt = rof_energy(K, u_star, f, lmb, n)
    e_port = rof_energy(K, x_grad, f, lmb, n)
    e_jax = rof_energy(K, np.asarray(jres.x, np.float64), f, lmb, n)
    assert e_port >= e_opt - 1e-7 * e_opt
    assert e_port - e_opt <= 1e-4 * e_opt
    # both stop at the 1e-5 tolerance, inside the oracle's 1e-4 bar
    np.testing.assert_allclose(e_port, e_jax, rtol=1e-4)


def test_problem_arrays_match_jax():
    """Both packages finalize the same problem: structure, prox
    coefficients and preconditioners."""
    size = 6
    f = _image(size)
    ja = interop.problem_arrays(_model(pt, size, f, 8.0)[0].finalize())
    ta = interop.problem_arrays(_model(ptt, size, f, 8.0)[0].finalize())

    def compare(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                compare(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                compare(x, y, f"{path}[{i}]")
        elif isinstance(a, np.ndarray):
            np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=path)
        else:
            assert a == b, path

    compare(ta, ja, "problem")
    assert ta["scaling_left"].dtype == np.float32


def test_state_round_trip_through_interop():
    """A JAX solver state handed to the port continues on the same
    trajectory: 30 JAX iterations, then 30 more in each package."""
    from prost_tpu.backend import BackendPDHG as JBackend
    from prost_tpu.backend import PDHGOptions as JOptions
    from prost_tpu_torch.backend import BackendPDHG as TBackend
    from prost_tpu_torch.backend import PDHGOptions as TOptions

    size = 10
    f = _image(size)
    sopts = dict(verbose=False, tol_rel_primal=1e-4, tol_rel_dual=1e-4,
                 tol_abs_primal=1e-4, tol_abs_dual=1e-4)
    jb = JBackend(_model(pt, size, f, 8.0)[0].finalize(),
                  JOptions(stepsize="boyd", residual_iter=5),
                  pt.SolverOptions(**sopts))
    tb = TBackend(_model(ptt, size, f, 8.0)[0].finalize(),
                  TOptions(stepsize="boyd", residual_iter=5),
                  ptt.SolverOptions(**sopts))
    js = jb.run(jb.initial_state(), 30)
    fields = {k: np.asarray(v) for k, v in vars(js).items()}
    ts = interop.pdhg_state_from_numpy(fields, torch.device("cpu"))
    back = interop.pdhg_state_to_numpy(ts)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert ts.iteration.dtype == torch.int32 and ts.converged.dtype == \
        torch.bool
    js2 = jb.run(js, 60)
    ts2 = tb.run(ts, 60, int(ts.iteration))
    assert int(ts2.iteration) == int(js2.iteration)
    np.testing.assert_allclose(ts2.x.numpy(), np.asarray(js2.x), atol=2e-5)
    np.testing.assert_allclose(ts2.y.numpy(), np.asarray(js2.y), atol=2e-5)
    np.testing.assert_allclose(float(ts2.tau), float(js2.tau), rtol=1e-6)


def test_device_without_card_or_choice_raises(monkeypatch):
    """With no card and no set_device the port does not quietly take the
    CPU: device() and the problems that need it raise, naming the way to
    ask for the CPU; after set_device("cpu") both work."""
    from prost_tpu_torch import config

    monkeypatch.setattr(config, "_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ptt.ProstError, match=r'set_device\("cpu"\)'):
        ptt.device()
    prob = _model(ptt, 4, _image(4), 8.0)[0]
    with pytest.raises(ptt.ProstError, match="No CUDA card"):
        prob.finalize()
    ptt.set_device("cpu")
    assert ptt.device() == torch.device("cpu")
    assert prob.finalize().scaling_left.device.type == "cpu"


def test_import_leaves_jax_out():
    code = ("import sys, prost_tpu_torch, prost_tpu_torch.ops, "
            "prost_tpu_torch.ops.fused_multilabel, "
            "prost_tpu_torch.ops.fused_deblur, "
            "prost_tpu_torch.ops.fused_tight, prost_tpu_torch.ops.fused_vol, "
            "prost_tpu_torch.parallel, prost_tpu_torch.parallel.mesh, "
            "prost_tpu_torch.parallel.spatial, "
            "prost_tpu_torch.parallel.spatial_fused, "
            "prost_tpu_torch.interop; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'prost_tpu' not in sys.modules, 'prost_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_solver_callbacks_and_dual_solve():
    """Callbacks see host arrays at the epochs; solve_dual un-swaps."""
    size = 8
    f = _image(size)
    seen = []

    def cb(it, x, y):
        seen.append((it, x.shape, y.shape))
        return False

    prob, _, _ = _model(ptt, size, f, 8.0)
    opts = _opts(ptt, 0.0, 50)
    opts.interm_cb = cb
    res = ptt.solve(prob, ptt.backend_pdhg(residual_iter=5), opts)
    assert res.result == ptt.ConvergenceResult.STOPPED_MAX_ITERS
    assert res.iterations == 50
    assert all(s[1] == (size * size,) for s in seen)
    port_epochs = [s[0] for s in seen]

    seen.clear()
    jprob, _, _ = _model(pt, size, f, 8.0)
    jopts = _opts(pt, 0.0, 50)
    jopts.interm_cb = cb
    pt.solve(jprob, pt.backend_pdhg(residual_iter=5), jopts)
    assert port_epochs == [s[0] for s in seen]

    core = _model(ptt, size, f, 8.0)[0].finalize()
    dual = ptt.Solver(core, ptt.backend_pdhg(residual_iter=5).create,
                      ptt.SolverOptions(verbose=False, max_iters=20,
                                        solve_dual=True)).solve()
    assert dual.x.shape == (size * size,)
    assert dual.y.shape == (2 * size * size,)


@pytest.mark.parametrize("scaling", ["alpha", "identity", "custom"])
def test_problem_scalings_match_jax(scaling):
    size = 5
    n = size * size
    f = _image(size)
    rng = np.random.RandomState(8)
    kw = {"scaling": scaling}
    if scaling == "custom":
        kw.update(scaling_left=0.5 + rng.rand(2 * n),
                  scaling_right=0.5 + rng.rand(n))

    def build(mod):
        u, q = mod.Variable(n), mod.Variable(2 * n)
        prob = mod.MinMaxProblem([u], [q], **kw)
        prob.add_function(u, mod.function.sum_1d("square", 1, f, 4.0))
        prob.add_function(q, mod.function.conjugate(
            mod.function.sum_norm2(2, False, "abs")))
        prob.add_dual_pair(u, q, mod.block.gradient2d(size, size, 1))
        return interop.problem_arrays(prob.finalize())

    ja, ta = build(pt), build(ptt)
    for k in ("scaling_left", "scaling_right"):
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-7, err_msg=k)


def test_min_problem_form_matches_jax():
    """The constrained form min g(x) + f(z) s.t. z = Kx: prox_f becomes
    prox_fstar by Moreau in the backend, the generic path runs."""
    size = 8
    n = size * size
    f = _image(size)

    def run(mod):
        u, z = mod.Variable(n), mod.Variable(2 * n)
        prob = mod.MinProblem([u], [z])
        prob.add_function(u, mod.function.sum_1d("square", 1, f, 8.0))
        prob.add_function(z, mod.function.sum_norm2(2, False, "abs"))
        prob.add_constraint(u, z, mod.block.gradient2d(size, size, 1))
        res = mod.solve(prob, mod.backend_pdhg(stepsize="alg1",
                                               residual_iter=4),
                        _opts(mod, 0.0, 40))
        return res, u, z

    (jres, _, _), (tres, tu, tz) = run(pt), run(ptt)
    assert tres.iterations == jres.iterations == 40
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), atol=2e-5)
    np.testing.assert_allclose(tres.z, np.asarray(jres.z), atol=2e-4)
    np.testing.assert_allclose(tz.val, tres.z)
