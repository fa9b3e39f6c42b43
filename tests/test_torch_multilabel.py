"""Slice 3 as a whole: the fast multilabel relaxation (BASELINE config 3,
examples/example_multilabel_fast.py) through the port's modeling API,
against the JAX package and the f64 graph-ADMM oracle; the kron block and
the generic path on the two-block problem; the numpy hand-over of the
problem and of a solver state; and the image and unaries that
chip_smoke.py builds for config 3 on the card."""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu_torch import interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
sys.path.insert(0, REPO)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


@pytest.fixture
def x64():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    pt.set_dtype(jnp.float64)
    ptt.set_dtype(torch.float64)
    yield
    ptt.set_dtype(torch.float32)
    pt.set_dtype(jnp.float32)
    jax.config.update("jax_enable_x64", False)


def _model(mod, nx, ny, L, f, lmb):
    """examples/example_multilabel_fast.py's problem in package ``mod``."""
    n = nx * ny
    u = mod.Variable(n * L)
    q = mod.Variable(2 * n * L)
    s = mod.Variable(n)
    prob = mod.MinMaxProblem([u], [q, s])
    prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(q, mod.function.sum_norm2(2 * L, False, "ind_leq0",
                                                1 / lmb, 1, 1))
    prob.add_function(s, mod.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, mod.block.sparse_kron_id(np.ones((1, L)), n))
    return prob, u, q, s


def _unaries(size, L):
    from example_multilabel_fast import unaries
    from _common import synthetic_image

    return unaries(synthetic_image(size, size, 1), L)


def _sopts(mod, t, **kw):
    return mod.SolverOptions(verbose=False, tol_rel_primal=t, tol_rel_dual=t,
                             tol_abs_primal=t, tol_abs_dual=t, **kw)


# ---------------------------------------------------------------------------
# the kron block and its factories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("given", ["dense", "scipy"])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_block_kron_id_matches_jax_and_is_adjoint(x64, given, alpha):
    """kron(M, I_d) with a small M holding zeros and negatives: apply,
    adjoint and the preconditioner sums against the JAX block in f64."""
    from prost_tpu.linop import BlockKronId as JKron

    rng = np.random.RandomState(4)
    m = rng.randn(3, 4) * (rng.rand(3, 4) > 0.3)
    mat = sp.csr_matrix(m) if given == "scipy" else m
    d = 7
    x = rng.randn(4 * d)
    y = rng.randn(3 * d)
    jb = JKron.create(0, 0, d, mat)
    tb = ptt.linop.BlockKronId.create(0, 0, d, mat)
    assert (tb.nrows, tb.ncols) == (jb.nrows, jb.ncols) == (3 * d, 4 * d)
    kx = tb.apply(torch.from_numpy(x)).numpy()
    kty = tb.apply_adjoint(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(kx, np.asarray(jb.apply(x)), rtol=1e-12)
    np.testing.assert_allclose(kty, np.asarray(jb.apply_adjoint(y)),
                               rtol=1e-12)
    np.testing.assert_allclose(kx @ y, x @ kty, rtol=1e-12)
    np.testing.assert_allclose(kx, np.kron(m, np.eye(d)) @ x, rtol=1e-12)
    for name in ("row_sum", "col_sum"):
        np.testing.assert_allclose(
            getattr(tb, name)(alpha).numpy(),
            np.asarray(getattr(jb, name)(alpha)), rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("factory", ["sparse_kron_id", "dense_kron_id"])
def test_kron_factories_place_the_block(factory):
    """Both factories give the block its size and place: the two-block K
    of the model applied by both packages."""
    nx, ny, L = 5, 4, 3
    n = nx * ny
    out = []
    for mod in (pt, ptt):
        u, s = mod.Variable(n * L), mod.Variable(n)
        prob = mod.MinMaxProblem([u], [s])
        prob.add_function(u, mod.function.sum_1d("ind_geq0"))
        prob.add_function(s, mod.function.sum_1d("zero"))
        prob.add_dual_pair(u, s, getattr(mod.block, factory)(
            np.ones((1, L)), n))
        out.append(prob.finalize().linop)
    x = np.random.RandomState(1).rand(n * L).astype(np.float32)
    np.testing.assert_allclose(out[1].apply(torch.from_numpy(x)).numpy(),
                               np.asarray(out[0].apply(x)), rtol=1e-6)
    np.testing.assert_allclose(out[1].apply(torch.from_numpy(x)).numpy(),
                               x.reshape(L, n).sum(axis=0), rtol=1e-6)


# ---------------------------------------------------------------------------
# the finalized problem, the generic path and the state hand-over
# ---------------------------------------------------------------------------

def _compare(a, b, path):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _compare(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=path)
    else:
        assert a == b, path


def test_problem_arrays_match_jax():
    """Both packages finalize the model alike: the proxes (ind_geq0 with
    the unaries as a vector d, the 2L-dimensional planar ball, the zero
    function with d = 1) and the alpha preconditioner Sigma = [1/2; 1/L],
    Tau = 1/5."""
    nx, ny, L = 6, 5, 3
    f = _unaries(6, L)[: nx * ny * L]
    ja = interop.problem_arrays(_model(pt, nx, ny, L, f, 0.5)[0].finalize())
    ta = interop.problem_arrays(_model(ptt, nx, ny, L, f, 0.5)[0].finalize())
    _compare(ta, ja, "problem")
    n = nx * ny
    np.testing.assert_allclose(ta["scaling_left"][: 2 * n * L], 0.5)
    np.testing.assert_allclose(ta["scaling_left"][2 * n * L:], 1.0 / L,
                               rtol=1e-7)
    np.testing.assert_allclose(ta["scaling_right"], 0.2, rtol=1e-7)


def _backends(nx, ny, L, opts, t=0.0):
    from prost_tpu.backend import BackendPDHG as JBackend
    from prost_tpu.backend import PDHGOptions as JOptions
    from prost_tpu_torch.backend import BackendPDHG as TBackend
    from prost_tpu_torch.backend import PDHGOptions as TOptions

    f = np.random.RandomState(6).rand(nx * ny * L)
    jb = JBackend(_model(pt, nx, ny, L, f, 0.5)[0].finalize(),
                  JOptions(**opts), _sopts(pt, t))
    tb = TBackend(_model(ptt, nx, ny, L, f, 0.5)[0].finalize(),
                  TOptions(**opts), _sopts(ptt, t))
    return jb, tb


@pytest.mark.parametrize("stepsize", ["boyd", "goldstein"])
def test_generic_path_matches_jax(stepsize):
    """The port's generic PDHG on the two-block model (both blocks' apply
    and adjoint, the vector-d ind_geq0, the 2L-ball, the shift) against the
    JAX package's over 60 iterations."""
    jb, tb = _backends(10, 8, 3, dict(stepsize=stepsize, residual_iter=5))
    js = jb.run(jb.initial_state(), 60)
    ts = tb.run(tb.initial_state(), 60, 0)
    for name in ("x", "y", "kx", "kty"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(float(ts.tau), float(js.tau), rtol=1e-6)


def test_jax_state_continues_on_the_port():
    """A JAX solver state after 30 generic iterations, handed to the port
    through interop, continues on the same trajectory through the port's
    fused multilabel route as the JAX generic path goes on."""
    from prost_tpu_torch.backend import PDHGOptions as TOptions
    from prost_tpu_torch.ops import FusedROFPDHG as TFused

    opts = dict(stepsize="boyd", residual_iter=5)
    jb, tb = _backends(10, 8, 3, opts, t=1e-4)
    js = jb.run(jb.initial_state(), 30)
    fields = {k: np.asarray(v) for k, v in vars(js).items()}
    ts = interop.pdhg_state_from_numpy(fields, torch.device("cpu"))
    fb = TFused(tb.problem, TOptions(**opts), tb.solver_opts)
    assert fb.ml is not None
    js2 = jb.run(js, 90)
    ts2 = fb.run(ts, 90, int(ts.iteration))
    assert int(ts2.iteration) == int(js2.iteration) == 90
    np.testing.assert_allclose(ts2.x.numpy(), np.asarray(js2.x), atol=2e-5)
    np.testing.assert_allclose(ts2.y.numpy(), np.asarray(js2.y), atol=2e-5)
    np.testing.assert_allclose(float(ts2.tau), float(js2.tau), rtol=1e-6)


# ---------------------------------------------------------------------------
# the whole slice: modeling -> solve -> fused route
# ---------------------------------------------------------------------------

def _grad_matrix(nx, ny, L):
    """K of gradient2d(nx, ny, L), label_first=False, as scipy sparse."""
    def d(k):
        m = sp.diags([-np.ones(k), np.ones(k - 1)], [0, 1],
                     shape=(k, k)).tolil()
        m[-1, -1] = 0.0  # Neumann: zero last difference
        return m

    eye_l = sp.eye(L)
    gx = sp.kron(eye_l, sp.kron(d(nx), sp.eye(ny)))
    gy = sp.kron(eye_l, sp.kron(sp.eye(nx), d(ny)))
    return sp.vstack([gx, gy]).tocsr()


def test_modeling_solve_matches_jax_and_oracle():
    """example_multilabel_fast's model at 12x12 with 4 labels through
    ptt.solve (the fused multilabel route, plain versions on the CPU)
    against pt.solve and the f64 graph-ADMM optimum of the sum-to-one
    relaxation: energy within 1e-3 of the optimum (the JAX example test's
    bar; the solve stops at the 1e-5 tolerance), partition of unity within
    5e-2 and u >= 0."""
    from oracles import (graph_admm, multilabel_energy, prox_group_l2,
                         prox_simplex_linear)

    size, L, lmb = 12, 4, 0.5
    n = size * size
    f = _unaries(size, L)
    opts = dict(max_iters=20000, num_cback_calls=10, verbose=False,
                tol_rel_primal=1e-5, tol_rel_dual=1e-5, tol_abs_primal=1e-5,
                tol_abs_dual=1e-5)
    backend = dict(stepsize="boyd", residual_iter=10)
    jprob = _model(pt, size, size, L, f, lmb)[0]
    jres = pt.solve(jprob, pt.backend_pdhg(**backend), pt.options(**opts))
    tprob, tu, _, _ = _model(ptt, size, size, L, f, lmb)

    class Recorded(ptt.modeling.Backend):
        def create(self, problem, solver_opts):
            self.made = super().create(problem, solver_opts)
            return self.made

    tbackend = Recorded("pdhg", ptt.backend_pdhg(**backend).opts)
    tres = ptt.solve(tprob, tbackend, ptt.options(**opts))
    assert tbackend.made.ml is not None  # the fused multilabel route
    assert tres.result.value == jres.result.value == "converged"

    K = _grad_matrix(size, size, L)
    u = tres.x.astype(np.float64)
    np.testing.assert_allclose(
        K @ u, ptt.linop.BlockGradient2D(row=0, col=0, nx=size, ny=size,
                                         L=L).apply(
            torch.from_numpy(u)).numpy(), atol=1e-12)
    np.testing.assert_allclose(tu.val, tres.x)
    sums = tres.x.reshape(L, n).sum(axis=0)
    np.testing.assert_allclose(sums, 1.0, atol=5e-2)
    assert tres.x.min() >= 0.0

    u_star, _ = graph_admm(K, prox_simplex_linear(f, L, n),
                           prox_group_l2((2 * L, n), weight=lmb))
    e_opt = multilabel_energy(K, u_star, f, lmb, L, n)
    e_port = multilabel_energy(K, u, f, lmb, L, n)
    e_jax = multilabel_energy(K, np.asarray(jres.x, np.float64), f, lmb, L, n)
    assert e_port - e_opt <= 1e-3 * (1.0 + abs(e_opt))
    assert e_port >= e_opt - 1e-4 * (1.0 + abs(e_opt))
    # both stop at the 1e-5 tolerance, inside the oracle's bar
    np.testing.assert_allclose(e_port, e_jax, rtol=1e-3)
    np.testing.assert_allclose(tres.x, np.asarray(jres.x), atol=5e-3)


# ---------------------------------------------------------------------------
# what chip_smoke.py builds for config 3 on the card (no image library)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cow", "house"])
def test_png_decoder_matches_pil(name):
    from PIL import Image

    import chip_smoke

    path = os.path.join(REPO, "data", f"{name}.png")
    ours = chip_smoke.read_png_rgb(path)
    ref = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("name,rows,cols", [
    ("flowers", 512, 512), ("cow", 256, 256), ("dog", 256, 256),
    ("junction_gray", 128, 128), ("dog", 190, 250)])
def test_fixture_gray_matches_bench_pil(name, rows, cols):
    """chip_smoke.py's gray image is bench.py's, bit for bit: PIL's
    convert("L") and BILINEAR resize to (rows, cols), then / 255 in
    float32, at the sizes of configs 2 and 3, vol256x8 and tight128x4 (and
    a ragged downscale)."""
    from PIL import Image

    import chip_smoke

    path = os.path.join(REPO, "data", f"{name}.png")
    im = Image.open(path).convert("L").resize((cols, rows), Image.BILINEAR)
    ref = np.asarray(im, np.float32) / 255.0
    ours = chip_smoke.fixture_gray(name, rows, cols)
    assert ours.dtype == np.float32 and ours.shape == (rows, cols)
    np.testing.assert_array_equal(ours, ref)


def test_unaries_match_the_example():
    from example_multilabel_fast import unaries

    import chip_smoke

    gray = chip_smoke.cow_gray(20, 24)  # (ny, nx)
    assert gray.shape == (20, 24) and 0.0 <= gray.min() <= gray.max() <= 1.0
    np.testing.assert_allclose(chip_smoke.ml_unaries(gray, 5),
                               unaries(gray[..., None], 5), rtol=1e-6)
