"""Port parity: prox and linop pieces of prost_tpu_torch against prost_tpu.

The same inputs, made with numpy from a seed, go through the JAX function
and its port, in float64 (JAX in x64 mode) with rtol 1e-10: both evaluate
the same expressions, so only libm-level rounding differs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu import linop as jlinop
from prost_tpu import prox as jprox
from prost_tpu_torch import linop as tlinop
from prost_tpu_torch import prox as tprox

RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    pt.set_dtype(jnp.float64)
    ptt.set_dtype(torch.float64)
    yield
    ptt.set_dtype(torch.float32)
    pt.set_dtype(jnp.float32)
    jax.config.update("jax_enable_x64", False)


# (alpha, beta) per function: inside each function's documented domain
_PARAMS = {
    "zero": (0.0, 0.0), "abs": (0.0, 0.0), "square": (0.0, 0.0),
    "ind_leq0": (0.0, 0.0), "ind_geq0": (0.0, 0.0), "ind_eq0": (0.0, 0.0),
    "ind_box01": (0.0, 0.0), "max_pos0": (0.0, 0.0), "l0": (0.0, 0.0),
    "huber": (0.5, 0.0), "lq": (1.5, 0.0), "lq_plus_eps": (1.5, 0.1),
    "truncquad": (2.0, 0.3), "trunclin": (1.0, 0.4),
}


def _both(v):
    """(jax value, torch value) of a float or numpy coefficient."""
    if np.ndim(v) == 0:
        return float(v), float(v)
    return jnp.asarray(v), torch.from_numpy(np.asarray(v, np.float64))


def _eval_1d(fun, coeffs, arg, tau_diag, tau_scal, invert):
    jc, tc = zip(*(_both(c) for c in coeffs))
    n = arg.size
    jp = jprox.ProxElem1D(index=0, size=n, fun=fun, coeffs=tuple(jc))
    tp = tprox.ProxElem1D(index=0, size=n, fun=fun, coeffs=tuple(tc))
    ja = np.asarray(jp.eval_local(jnp.asarray(arg), jnp.asarray(tau_diag),
                                  tau_scal, invert))
    ta = tp.eval_local(torch.from_numpy(arg), torch.from_numpy(tau_diag),
                       tau_scal, invert).numpy()
    return ja, ta


def test_fun1d_table_is_complete():
    from prost_tpu.prox.fun1d import FUN_1D as JFUN

    assert set(tprox.FUN_1D) == set(JFUN) == set(_PARAMS)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("fun", sorted(_PARAMS))
def test_fun1d_scalar_coeffs_match_jax(x64, fun, invert):
    rng = np.random.RandomState(abs(hash(fun)) % 2**31)
    n = 257
    arg = 2.0 * rng.randn(n)
    tau_diag = 0.5 + rng.rand(n)
    alpha, beta = _PARAMS[fun]
    coeffs = (1.3, 0.2, 0.8, 0.1, 0.05, alpha, beta)
    ja, ta = _eval_1d(fun, coeffs, arg, tau_diag, 0.7, invert)
    np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fun", sorted(_PARAMS))
def test_fun1d_vector_coeffs_match_jax(x64, fun):
    rng = np.random.RandomState(7)
    n = 300
    arg = 2.0 * rng.randn(n)
    tau_diag = 0.5 + rng.rand(n)
    alpha, beta = _PARAMS[fun]
    a = 0.5 + rng.rand(n)
    a[::17] = 0.0  # degenerate entries take the linear branch
    b = rng.randn(n)
    coeffs = (a, b, 1.1, 0.0, 0.0, alpha, beta)
    ja, ta = _eval_1d(fun, coeffs, arg, tau_diag, 1.3, False)
    np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.8, 1.0, 2.5])
def test_fun1d_lq_branches_match_jax(x64, alpha):
    rng = np.random.RandomState(11)
    n = 200
    arg = 3.0 * rng.randn(n)
    tau_diag = 0.2 + rng.rand(n)
    coeffs = (1.0, 0.0, 1.0, 0.0, 0.0, alpha, 0.0)
    ja, ta = _eval_1d("lq", coeffs, arg, tau_diag, 0.5, False)
    np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("fun,coeffs", [
    ("abs", (1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0)),
    ("ind_leq0", (2.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0)),
    ("square", (1.2, 0.3, 0.7, 0.1, 0.2, 0.0, 0.0)),
])
@pytest.mark.parametrize("dim", [2, 3])
def test_norm2_and_moreau_match_jax(x64, interleaved, fun, coeffs, dim):
    rng = np.random.RandomState(3)
    count = 64
    n = dim * count
    arg = rng.randn(n)
    arg[:dim] = 0.0 if not interleaved else arg[:dim]  # a zero vector
    # the preconditioner is averaged per vector (diagsteps False)
    tau_vec = 0.5 + rng.rand(count)
    tau_diag = (np.tile(tau_vec, dim) if not interleaved
                else np.repeat(tau_vec, dim))
    kw = dict(index=0, size=n, count=count, dim=dim,
              interleaved=interleaved, fun=fun)
    jn = jprox.ProxElemNorm2(coeffs=coeffs, **kw)
    tn = tprox.ProxElemNorm2(coeffs=coeffs, **kw)
    for jp, tp in ((jn, tn),
                   (jprox.ProxMoreau(index=0, size=n, child=jn),
                    tprox.ProxMoreau(index=0, size=n, child=tn))):
        for invert in (False, True):
            ja = np.asarray(jp.eval_local(jnp.asarray(arg),
                                          jnp.asarray(tau_diag), 0.9, invert))
            ta = tp.eval_local(torch.from_numpy(arg),
                               torch.from_numpy(tau_diag), 0.9,
                               invert).numpy()
            np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)


def test_prox_zero_and_apply_proxs_match_jax(x64):
    rng = np.random.RandomState(5)
    arg = rng.randn(50)
    tau = 0.5 + rng.rand(50)
    jps = [jprox.ProxZero(index=0, size=20),
           jprox.ProxElem1D(index=20, size=30, fun="abs",
                            coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))]
    tps = [tprox.ProxZero(index=0, size=20),
           tprox.ProxElem1D(index=20, size=30, fun="abs",
                            coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))]
    ja = np.asarray(jprox.apply_proxs(jps, jnp.asarray(arg),
                                      jnp.asarray(tau), 0.8))
    ta = tprox.apply_proxs(tps, torch.from_numpy(arg), torch.from_numpy(tau),
                           0.8).numpy()
    np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("L,label_first", [(1, False), (2, False), (2, True)])
def test_gradient2d_matches_jax_and_is_adjoint(x64, L, label_first):
    nx, ny = 7, 11
    rng = np.random.RandomState(L + 2 * label_first)
    kw = dict(row=0, col=0, nx=nx, ny=ny, L=L, label_first=label_first)
    jb, tb = jlinop.BlockGradient2D(**kw), tlinop.BlockGradient2D(**kw)
    x = rng.randn(jb.ncols)
    y = rng.randn(jb.nrows)
    jk, jkt = (np.asarray(jb.apply(jnp.asarray(x))),
               np.asarray(jb.apply_adjoint(jnp.asarray(y))))
    tk = tb.apply(torch.from_numpy(x)).numpy()
    tkt = tb.apply_adjoint(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(tk, jk, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tkt, jkt, rtol=RTOL, atol=ATOL)
    # adjointness <Kx, y> == <x, K^T y>
    np.testing.assert_allclose(tk @ y, x @ tkt, rtol=1e-12)
    np.testing.assert_array_equal(tb.row_sum(1.0).numpy(), 2.0)
    np.testing.assert_array_equal(tb.col_sum(1.0).numpy(), 4.0)


def test_linear_operator_blocks_match_jax(x64):
    """Two gradient blocks side by side (the scatter-add path), and the
    dual view -K^T."""
    rng = np.random.RandomState(9)
    nx, ny = 5, 6
    blocks = lambda mod: [  # noqa: E731
        mod.BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1),
        mod.BlockGradient2D(row=2 * nx * ny, col=nx * ny, nx=nx, ny=ny, L=1)]
    jl = jlinop.LinearOperator.create(blocks(jlinop))
    tl = tlinop.LinearOperator.create(blocks(tlinop))
    assert (tl.nrows, tl.ncols) == (jl.nrows, jl.ncols)
    x = rng.randn(jl.ncols)
    y = rng.randn(jl.nrows)
    np.testing.assert_allclose(tl.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.apply(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tl.apply_adjoint(torch.from_numpy(y)).numpy(),
        np.asarray(jl.apply_adjoint(jnp.asarray(y))), rtol=RTOL, atol=ATOL)
    td = tlinop.DualLinearOperator(child=tl)
    jd = jlinop.DualLinearOperator(child=jl)
    np.testing.assert_allclose(td.apply(torch.from_numpy(y)).numpy(),
                               np.asarray(jd.apply(jnp.asarray(y))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.row_sum(1.0).numpy(),
                               np.asarray(jl.row_sum(1.0)))


def test_block_overlap_is_rejected_like_jax():
    kw = dict(nx=4, ny=4, L=1)
    with pytest.raises(ptt.ProstError, match="overlap"):
        tlinop.LinearOperator.create([
            tlinop.BlockGradient2D(row=0, col=0, **kw),
            tlinop.BlockGradient2D(row=4, col=2, **kw)])
    with pytest.raises(pt.ProstError, match="overlap"):
        jlinop.LinearOperator.create([
            jlinop.BlockGradient2D(row=0, col=0, **kw),
            jlinop.BlockGradient2D(row=4, col=2, **kw)])


@pytest.mark.parametrize("indices,sizes,total", [
    ([0, 10], [10, 5], 20),       # trailing gap
    ([5, 12], [3, 2], 20),        # leading and inner gaps
    ([0, 8, 3], [3, 12, 5], 20),  # tiled, unsorted
    ([0, 4], [6, 5], 20),         # overlap
])
def test_host_validators_match_jax(indices, sizes, total):
    from prost_tpu._native import host as jhost
    from prost_tpu_torch._native import host as thost

    try:
        want = jhost.prox_gaps(indices, sizes, total)
    except ValueError:
        with pytest.raises(ValueError):
            thost.prox_gaps(indices, sizes, total)
    else:
        assert thost.prox_gaps(indices, sizes, total) == want
