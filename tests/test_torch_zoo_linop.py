"""Port parity: the linop zoo of prost_tpu_torch (sparse, dense, id-kron
and zero blocks), its block factories and the debug entry points
(``eval_linop``, ``get_all_variables``) against prost_tpu, and the dual ROF
model on ``block.sparse`` as a whole.

The same inputs, made with numpy from a seed, go through the JAX block and
its port in float64 (JAX in x64 mode) and against the dense matrix.  The
cases mirror the JAX package's tests/test_linop.py (with its random block
grid) and test_modeling.py's block registry.  Tolerance 1e-10 relative:
the same products summed in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu import linop as jlinop
from prost_tpu.modeling import block as jblock
from prost_tpu_torch import linop as tlinop
from prost_tpu_torch.config import ProstError
from prost_tpu_torch.modeling import block as tblock

TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    pt.set_dtype(jnp.float64)
    ptt.set_dtype(torch.float64)
    yield
    ptt.set_dtype(torch.float32)
    pt.set_dtype(jnp.float32)
    jax.config.update("jax_enable_x64", False)


def _check(jblk, tblk, dense, seed=0):
    """apply, adjoint, row and column sums of both blocks against each
    other and against the dense matrix."""
    rng = np.random.RandomState(seed)
    m, n = dense.shape
    assert (tblk.nrows, tblk.ncols) == (jblk.nrows, jblk.ncols) == (m, n)
    x, y = rng.randn(n), rng.randn(m)
    pairs = (
        (tblk.apply(torch.from_numpy(x)), jblk.apply(jnp.asarray(x)),
         dense @ x),
        (tblk.apply_adjoint(torch.from_numpy(y)),
         jblk.apply_adjoint(jnp.asarray(y)), dense.T @ y),
        (tblk.row_sum(1.0), jblk.row_sum(1.0), np.abs(dense).sum(axis=1)),
        (tblk.col_sum(1.5), jblk.col_sum(1.5),
         (np.abs(dense) ** 1.5).sum(axis=0)),
    )
    for t, j, want in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
        np.testing.assert_allclose(t.numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("given", ["dense", "scipy", "triple"])
def test_block_sparse_vs_dense(x64, given):
    rng = np.random.RandomState(3)
    m = (rng.rand(20, 15) < 0.3) * rng.randn(20, 15)
    m[4] = 0.0      # an empty row
    m[:, 7] = 0.0   # an empty column
    if given == "scipy":
        K = sp.csc_matrix(m)
    elif given == "triple":
        r, c = np.nonzero(m)
        K = (r, c, m[r, c])
    else:
        K = m
    _check(jlinop.BlockSparse.create(0, 0, 20, 15, K),
           tlinop.BlockSparse.create(0, 0, 20, 15, K), m)


def test_block_sparse_is_sorted_and_deterministic():
    """The forward copy is row-sorted and the adjoint copy column-sorted,
    as the JAX block's; two applies give the same bits."""
    rng = np.random.RandomState(13)
    m = (rng.rand(300, 200) < 0.05) * rng.randn(300, 200)
    jb = jlinop.BlockSparse.create(0, 0, 300, 200, sp.coo_matrix(m))
    tb = tlinop.BlockSparse.create(0, 0, 300, 200, sp.coo_matrix(m))
    for name in ("rows_f", "cols_f", "rows_a", "cols_a"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    np.testing.assert_array_equal(tb.len_f.numpy(), (m != 0).sum(axis=1))
    np.testing.assert_array_equal(tb.len_a.numpy(), (m != 0).sum(axis=0))
    x = torch.from_numpy(rng.randn(200).astype(np.float32))
    y = torch.from_numpy(rng.randn(300).astype(np.float32))
    assert torch.equal(tb.apply(x), tb.apply(x))
    assert torch.equal(tb.apply_adjoint(y), tb.apply_adjoint(y))


def test_block_dense(x64):
    m = np.random.RandomState(4).randn(12, 17)
    _check(jlinop.BlockDense.create(0, 0, m), tlinop.BlockDense.create(0, 0, m),
           m)


@pytest.mark.parametrize("sparse_m", [False, True])
def test_id_kron_block(x64, sparse_m):
    rng = np.random.RandomState(5)
    M = rng.randn(4, 6)
    d = 7
    given = sp.csr_matrix(M) if sparse_m else M
    _check(jlinop.BlockIdKron.create(0, 0, d, given),
           tlinop.BlockIdKron.create(0, 0, d, given), np.kron(np.eye(d), M))


def test_block_zero(x64):
    _check(jlinop.BlockZero(row=0, col=0, nrows=8, ncols=5),
           tlinop.BlockZero(row=0, col=0, nrows=8, ncols=5), np.zeros((8, 5)))


def _grid(mod, seed):
    """The JAX test's random grid of sparse/dense/zero blocks
    (test_linop_sparse_zero.m:6-60), built with ``mod``'s blocks."""
    rng = np.random.RandomState(seed)
    grid_r, grid_c = rng.randint(2, 5), rng.randint(2, 5)
    row_sizes = rng.randint(3, 9, grid_r)
    col_sizes = rng.randint(3, 9, grid_c)
    row_off = np.concatenate([[0], np.cumsum(row_sizes)])
    col_off = np.concatenate([[0], np.cumsum(col_sizes)])
    blocks = []
    dense = np.zeros((row_off[-1], col_off[-1]))
    for i in range(grid_r):
        for j in range(grid_c):
            kind = rng.randint(3)
            m = np.zeros((row_sizes[i], col_sizes[j]))
            r0, c0 = int(row_off[i]), int(col_off[j])
            if kind == 0:
                m = (rng.rand(*m.shape) < 0.4) * rng.randn(*m.shape)
                blocks.append(mod.BlockSparse.create(r0, c0, *m.shape, m))
            elif kind == 1:
                m = rng.randn(*m.shape)
                blocks.append(mod.BlockDense.create(r0, c0, m))
            else:
                blocks.append(mod.BlockZero(row=r0, col=c0,
                                            nrows=int(m.shape[0]),
                                            ncols=int(m.shape[1])))
            dense[row_off[i]:row_off[i + 1], col_off[j]:col_off[j + 1]] = m
    return mod.LinearOperator.create(blocks), dense


@pytest.mark.parametrize("seed", range(5))
def test_random_block_grid_composition(x64, seed):
    JK, dense = _grid(jlinop, seed)
    TK, _ = _grid(tlinop, seed)
    _check(JK, TK, dense, seed)


def test_overlap_rejected():
    b1 = tlinop.BlockZero(row=0, col=0, nrows=5, ncols=5)
    b2 = tlinop.BlockZero(row=4, col=4, nrows=5, ncols=5)
    with pytest.raises(ProstError):
        tlinop.LinearOperator.create([b1, b2])


def test_dual_linop_is_negative_transpose(x64):
    rng = np.random.RandomState(7)
    m = rng.randn(9, 6)
    D = tlinop.DualLinearOperator(
        child=tlinop.LinearOperator.create([tlinop.BlockDense.create(0, 0,
                                                                      m)]))
    x, y = rng.randn(9), rng.randn(6)
    np.testing.assert_allclose(D.apply(torch.from_numpy(x)).numpy(),
                               -m.T @ x, **TOL)
    np.testing.assert_allclose(D.apply_adjoint(torch.from_numpy(y)).numpy(),
                               -m @ y, **TOL)
    np.testing.assert_allclose(D.row_sum(1.0).numpy(), np.abs(m).sum(axis=0),
                               **TOL)


# every block factory of tests/test_modeling.py's registry
_K = np.random.RandomState(3).randn(4, 6)
BLOCKS = {
    "sparse": (lambda b: b.sparse(_K), 4, 6),
    "sparse_scipy": (lambda b: b.sparse(sp.csr_matrix(_K)), 4, 6),
    "dense": (lambda b: b.dense(_K), 4, 6),
    "diags": (lambda b: b.diags(5, 5, [1.0, -2.0], [0, 1]), 5, 5),
    "identity": (lambda b: b.identity(), 7, 7),
    "zero": (lambda b: b.zero(), 4, 9),
    "gradient2d": (lambda b: b.gradient2d(4, 5, 2), 80, 40),
    "gradient3d": (lambda b: b.gradient3d(4, 5, 2), 120, 40),
    "sparse_kron_id": (lambda b: b.sparse_kron_id(_K, 3), 12, 18),
    "dense_kron_id": (lambda b: b.dense_kron_id(_K, 3), 12, 18),
    "id_kron_sparse": (lambda b: b.id_kron_sparse(_K, 3), 12, 18),
    "id_kron_dense": (lambda b: b.id_kron_dense(_K, 3), 12, 18),
}


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_factory_and_eval_linop_match_jax(x64, name, adjoint):
    """Each factory builds a block of its declared size, and the port's
    ``eval_linop`` equals the JAX package's: result, row and column
    sums."""
    build, m, n = BLOCKS[name]
    blk, sz = build(tblock)(0, 0, m, n)
    assert sz == (m, n) and (blk.nrows, blk.ncols) == (m, n)
    x = np.random.RandomState(1).randn(m if adjoint else n)
    jout = pt.eval_linop([(build(jblock), 0, 0, m, n)], x, adjoint)
    tout = ptt.eval_linop([(build(tblock), 0, 0, m, n)], x, adjoint)
    for t, j in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(t, np.asarray(j), **TOL)
    assert tout[3] >= 0


def test_eval_linop_two_blocks(x64):
    """A 2x1 grid of blocks, as eval_linop.m takes a list."""
    K = np.arange(12.0).reshape(3, 4)
    facs = [(tblock.dense(K), 0, 0, 3, 4), (tblock.sparse(-K), 3, 0, 3, 4)]
    out, rs, cs, ms = ptt.eval_linop(facs, np.ones(4))
    np.testing.assert_allclose(out, np.r_[K @ np.ones(4), -K @ np.ones(4)],
                               **TOL)
    np.testing.assert_allclose(rs, np.r_[np.abs(K).sum(1), np.abs(K).sum(1)],
                               **TOL)
    np.testing.assert_allclose(cs, 2 * np.abs(K).sum(0), **TOL)
    assert ms >= 0


def test_get_all_variables():
    """x -> p_vars, z -> pc_vars, y -> d_vars, w -> dc_vars, each packed in
    list order; tensors are read to the host."""
    res = type("R", (), {"x": np.arange(5.0), "z": None,
                         "y": torch.arange(10.0, 16.0),
                         "w": np.arange(20.0, 22.0)})()
    a, b = ptt.Variable(2), ptt.Variable(3)
    c, d = ptt.Variable(6), ptt.Variable(2)
    ptt.get_all_variables(res, (a, b), (), (c,), [d])
    np.testing.assert_array_equal(a.val, [0, 1])
    np.testing.assert_array_equal(b.val, [2, 3, 4])
    np.testing.assert_array_equal(c.val, np.arange(10.0, 16.0))
    np.testing.assert_array_equal(d.val, [20, 21])


# ------------------------------------------------------------ the slice

def _image(size, seed=42):
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, size)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    im = 0.4 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.09) + 0.3 * (xx > 0.7)
    return (im + 0.05 * rng.randn(size, size)).reshape(-1)


def _grad(nx, ny):
    """The forward-difference gradient as a sparse matrix, in
    ``gradient2d``'s layout (spmat_gradient2d.m of example_rof_dual.py)."""
    dy = sp.spdiags(np.vstack([np.r_[-np.ones(ny - 1), 0], np.ones(ny)]),
                    [0, 1], ny, ny)
    dy = sp.kron(sp.eye(nx), dy)
    dx = sp.spdiags(np.vstack([np.r_[-np.ones(ny * (nx - 1)), np.zeros(ny)],
                               np.ones(nx * ny)]), [0, ny], nx * ny, nx * ny)
    return sp.vstack([dx, dy]).tocsc()


def _rof_dual(mod, nx, ny, f, lmb):
    """example_rof_dual.py's model: min over (q, w = -grad^T q) of
    I(||q_i|| <= 1) + 1/(2 lmb) ||w + lmb f||^2; u is the dual variable of
    the constraint."""
    n = nx * ny
    q, w = mod.Variable(2 * n), mod.Variable(n)
    prob = mod.MinProblem([q], [w])
    prob.add_function(q, mod.function.sum_norm2(2, False, "ind_leq0", 1, 1,
                                                1))
    prob.add_function(w, mod.function.sum_1d("square", 1, -f * lmb,
                                             1 / lmb))
    prob.add_constraint(q, w, mod.block.sparse(-_grad(nx, ny).T.tocsc()))
    return prob


def _rof_primal(mod, nx, ny, f, lmb):
    n = nx * ny
    u, q = mod.Variable(n), mod.Variable(2 * n)
    prob = mod.MinMaxProblem([u], [q])
    prob.add_function(u, mod.function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, mod.function.conjugate(
        mod.function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, 1))
    return prob


def _rof_energy(u, f, lmb, nx, ny):
    g = _grad(nx, ny) @ u
    n = nx * ny
    return float(0.5 * lmb * np.sum((u - f) ** 2)
                 + np.sum(np.sqrt(g[:n] ** 2 + g[n:] ** 2)))


def _opts(mod, max_iters, tol):
    return mod.options(max_iters=max_iters, num_cback_calls=10,
                       verbose=False, tol_rel_primal=tol, tol_rel_dual=tol,
                       tol_abs_primal=tol, tol_abs_dual=tol)


def test_sparse_gradient_is_gradient2d(x64):
    """-grad^T as ``block.sparse`` applies as BlockGradient2D's negated
    adjoint, and its adjoint as the negated gradient."""
    nx, ny = 12, 9
    rng = np.random.RandomState(0)
    blk, _ = tblock.sparse(-_grad(nx, ny).T.tocsc())(0, 0, nx * ny,
                                                     2 * nx * ny)
    g = tlinop.BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    p, u = torch.from_numpy(rng.randn(2 * nx * ny)), torch.from_numpy(
        rng.randn(nx * ny))
    np.testing.assert_allclose(blk.apply(p).numpy(),
                               -g.apply_adjoint(p).numpy(), **TOL)
    np.testing.assert_allclose(blk.apply_adjoint(u).numpy(),
                               -g.apply(u).numpy(), **TOL)


def test_rof_dual_on_block_sparse_matches_primal_and_jax():
    """The dual ROF model on ``block.sparse`` at 32x32 (lmb 16, goldstein,
    residual_iter 100), its u recovered with ``get_all_variables``: the
    fused matchers refuse it (generic route), and its ROF energy matches
    the port's primal ROF solve (fused route, plain versions; boyd
    converges slower on this model, so it takes 10000 iterations to come
    within 4e-5 of the dual solve's energy) and the JAX package's solve of
    the same dual model, within 1e-4 relative."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.modeling import Backend

    nx = ny = 32
    n, lmb = nx * ny, 16.0
    f = _image(nx)
    made = {}

    class Recorded(Backend):
        def create(self, problem, solver_opts):
            made["b"] = super().create(problem, solver_opts)
            return made["b"]

    backend = dict(stepsize="goldstein", residual_iter=100)
    tres = ptt.solve(_rof_dual(ptt, nx, ny, f, lmb),
                     Recorded("pdhg", PDHGOptions(**backend)),
                     _opts(ptt, 4000, 1e-7))
    b = made["b"]
    assert (b.rof, b.ml, b.deblur, b.tight, b.vol) == (None,) * 5
    u = ptt.Variable(n)
    ptt.get_all_variables(tres, (), (), (u,), ())
    e_dual = _rof_energy(u.val.astype(np.float64), f, lmb, nx, ny)

    jres = pt.solve(_rof_dual(pt, nx, ny, f, lmb), pt.backend_pdhg(**backend),
                    _opts(pt, 4000, 1e-7))
    ju = pt.Variable(n)
    pt.get_all_variables(jres, (), (), (ju,), ())
    e_jax = _rof_energy(np.asarray(ju.val, np.float64), f, lmb, nx, ny)

    pres = ptt.solve(_rof_primal(ptt, nx, ny, f, lmb),
                     ptt.backend_pdhg(stepsize="boyd", residual_iter=10),
                     _opts(ptt, 10000, 1e-7))
    e_primal = _rof_energy(pres.x.astype(np.float64), f, lmb, nx, ny)
    assert abs(e_dual - e_primal) <= 1e-4 * e_primal
    assert abs(e_dual - e_jax) <= 1e-4 * e_jax
