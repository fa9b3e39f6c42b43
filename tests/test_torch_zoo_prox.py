"""Port parity: the prox zoo of prost_tpu_torch (elem-ops, combinators,
standalone proxes, 2D functions, spectral proxes) and its function
factories against prost_tpu.

The same inputs, made with numpy from a seed, go through the JAX class and
its port in float64 (JAX in x64 mode).  The cases mirror the JAX package's
own prox tests (tests/test_prox_zoo.py, test_prox_spectral.py,
test_prox_epi_polyhedral.py, test_modeling.py's factory registry) with
their seeds and shapes.  Tolerances: closed forms within 1e-10 relative
(the same expressions; only libm-level rounding differs); iterative and
eigh-based ones within 1e-8 (the same sweeps, omega and tol for the
polyhedral epigraph; LAPACK's eigenvectors in another basis for the
spectral proxes, whose outputs do not depend on it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as ssp
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu.modeling import function as jfn
from prost_tpu_torch.common import tree_to
from prost_tpu_torch.config import ProstError
from prost_tpu_torch.modeling import function as tfn

CLOSED = dict(rtol=1e-10, atol=1e-12)
ITERATIVE = dict(rtol=1e-8, atol=1e-10)


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


def _jax_eval(p, arg, tau_diag, tau_scal, invert):
    return np.asarray(p.eval_local(jnp.asarray(arg), jnp.asarray(tau_diag),
                                   tau_scal, invert))


def _torch_eval(p, arg, tau_diag, tau_scal, invert):
    p = tree_to(p, torch.device("cpu"), torch.float64)
    return p.eval_local(torch.from_numpy(arg), torch.from_numpy(tau_diag),
                        tau_scal, invert).numpy()


def _both(make, size, arg, tau_diag=None, tau_scal=1.0, invert=False):
    """(JAX result, port result) of ``make(function_module)(0, size)``."""
    if tau_diag is None:
        tau_diag = np.ones(size)
    ja = _jax_eval(make(jfn)(0, size), arg, tau_diag, tau_scal, invert)
    ta = _torch_eval(make(tfn)(0, size), arg, tau_diag, tau_scal, invert)
    return ja, ta


def _projsplx(y):
    """Simplex-projection oracle (the reference test helper projsplx.m)."""
    s = np.sort(y)[::-1]
    css = (np.cumsum(s) - 1) / np.arange(1, len(y) + 1)
    rho = np.max(np.where(s > css)[0])
    return np.maximum(y - css[rho], 0)


# ------------------------------------------------------------ elem-ops

@pytest.mark.parametrize("interleaved", [True, False])
def test_simplex_matches_jax_and_oracle(x64, interleaved):
    rng = np.random.RandomState(3)
    count, dim = 50, 8
    x0 = rng.randn(count * dim) * 2
    ja, ta = _both(lambda fn: fn.sum_ind_simplex(dim, interleaved),
                   count * dim, x0)
    np.testing.assert_allclose(ta, ja, **CLOSED)
    vecs = (x0.reshape(count, dim) if interleaved
            else x0.reshape(dim, count).T)
    res = ta.reshape(count, dim) if interleaved else ta.reshape(dim, count).T
    for i in range(count):
        np.testing.assert_allclose(res[i], _projsplx(vecs[i]), atol=1e-12)


def test_simplex_with_ties_and_large_dim(x64):
    """Ties inside a vector (the sort's order among equal entries must not
    matter) and a dim above the reference's shell-sort cap region."""
    rng = np.random.RandomState(21)
    count, dim = 6, 40
    x0 = np.round(rng.randn(count * dim), 1)
    ja, ta = _both(lambda fn: fn.sum_ind_simplex(dim, False), count * dim,
                   x0)
    np.testing.assert_allclose(ta, ja, **CLOSED)
    np.testing.assert_allclose(ta.reshape(dim, count).sum(axis=0), 1.0,
                               atol=1e-12)


def test_ind_sum_elemop(x64):
    rng = np.random.RandomState(4)
    count, dim = 30, 5
    x0 = rng.randn(count * dim)
    ja, ta = _both(lambda fn: fn.sum_ind_sum(dim, True), count * dim, x0)
    np.testing.assert_allclose(ta, ja, **CLOSED)
    np.testing.assert_allclose(ta.reshape(count, dim).sum(axis=1), 1.0,
                               atol=1e-12)


# ------------------------------------------------------------ standalone

def test_soc_projection(x64):
    rng = np.random.RandomState(5)
    count, dim = 40, 4
    x0 = rng.randn(count * dim) * 2
    ja, ta = _both(lambda fn: fn.sum_ind_soc(dim), count * dim, x0)
    np.testing.assert_allclose(ta, ja, **CLOSED)


@pytest.mark.parametrize("alpha", [0.5, 2.0])
def test_soc_projection_general_alpha(x64, alpha):
    rng = np.random.RandomState(15)
    count, dim = 12, 3
    x0 = rng.randn(count * dim) * 2
    ja, ta = _both(lambda fn: fn.sum_ind_soc(dim, alpha=alpha), count * dim,
                   x0)
    np.testing.assert_allclose(ta, ja, **CLOSED)


@pytest.mark.parametrize("per_instance", [False, True])
def test_halfspace_projection(x64, per_instance):
    rng = np.random.RandomState(6)
    count, dim = 30, 3
    x0 = rng.randn(count * dim) * 2
    a = rng.randn(dim * count if per_instance else dim)
    b = rng.randn(count) if per_instance else 0.5
    ja, ta = _both(lambda fn: fn.sum_ind_halfspace(dim, False, a, b),
                   count * dim, x0)
    np.testing.assert_allclose(ta, ja, **CLOSED)


@pytest.mark.parametrize("per_instance", [False, True])
def test_epi_quad_projection(x64, per_instance):
    rng = np.random.RandomState(7)
    count, dim = 25, 3
    x0 = rng.randn(count * dim) * 2
    if per_instance:
        a, c = 0.5 + rng.rand(count), rng.randn(count)
        b = rng.randn((dim - 1) * count)
    else:
        a, c = 0.8, 0.1
        b = np.repeat(rng.randn(dim - 1), count)
    ja, ta = _both(lambda fn: fn.sum_ind_epi_quad(dim, False, a, b, c),
                   count * dim, x0)
    np.testing.assert_allclose(ta, ja, **CLOSED)


@pytest.mark.parametrize("two_sets", [False, True])
def test_ind_sum_standalone_weighted(x64, two_sets):
    rng = np.random.RandomState(8)
    size = 40
    x0 = rng.randn(size)
    taus = rng.rand(size) + 0.5
    inds = np.arange(0, 20)  # 4 groups of 5
    kw = dict(dim2=4, inds2=np.arange(20, 36), s2=-0.5) if two_sets else {}
    for invert in (False, True):
        ja, ta = _both(lambda fn: fn.sum_ind_sum2(5, inds, 1.0, **kw), size,
                       x0, taus, 0.9, invert)
        np.testing.assert_allclose(ta, ja, **CLOSED)
    np.testing.assert_allclose(ta[:20].reshape(4, 5).sum(axis=1), 1.0,
                               atol=1e-12)


def _range_matrix(rng, size, k):
    As = ssp.random(size, k, density=0.3, random_state=rng, format="csr")
    As = As + ssp.random(size, k, density=0.05, random_state=rng) * 2.0
    Ad = np.asarray(As.todense())
    Ad[:k] += np.eye(k)  # full column rank
    return ssp.csr_matrix(Ad * (Ad != 0))


@pytest.mark.parametrize("kind", ["dense", "sparse", "sparse_AA", "torch"])
def test_ind_range(x64, kind):
    rng = np.random.RandomState(9 if kind == "dense" else 10)
    if kind == "dense":
        size, k = 30, 5
        A = rng.randn(size, k)
        jA = tA = A
    else:
        size, k = 40, 6
        A = _range_matrix(rng, size, k)
        jA = A
        tA = (torch.from_numpy(A.toarray()).to_sparse_csr()
              if kind == "torch" else A)
    AA = (A.T @ A).todense() if kind == "sparse_AA" else None
    x0 = rng.randn(size)
    ja = _jax_eval(jfn.ind_range(jA, AA)(0, size), x0, np.ones(size), 1.0,
                   False)
    tp = tfn.ind_range(tA, AA)(0, size)
    if kind != "dense":
        assert tp.A.layout == torch.sparse_csr  # not densified
    ta = _torch_eval(tp, x0, np.ones(size), 1.0, False)
    np.testing.assert_allclose(ta, ja, **ITERATIVE)
    Ad = A if kind == "dense" else A.toarray()
    np.testing.assert_allclose(
        ta, Ad @ np.linalg.solve(Ad.T @ Ad, Ad.T @ x0), atol=1e-10)


# ------------------------------------------------------------ combinators

def test_transform_matches_jax_and_coeffs(x64):
    """transform(sum_1d(f), a..e) == sum_1d(f, a..e)."""
    rng = np.random.RandomState(11)
    n = 48
    a, b, c, d, e = 1.3, 0.2, 1.7, 0.5, 0.6
    x0 = rng.randn(n) * 2
    taus = rng.rand(n) + 0.5
    for invert in (False, True):
        ja, ta = _both(lambda fn: fn.transform(fn.sum_1d("abs"), a, b, c, d,
                                               e), n, x0, taus, 0.7, invert)
        np.testing.assert_allclose(ta, ja, **CLOSED)
        _, direct = _both(lambda fn: fn.sum_1d("abs", a, b, c, d, e), n, x0,
                          taus, 0.7, invert)
        np.testing.assert_allclose(ta, direct, rtol=1e-9, atol=1e-12)


def test_transform_of_simplex_with_unaries(x64):
    """The simplex multilabel's data term: transform(sum_ind_simplex, d=f)
    (array d, a child without diagonal steps), and its preconditioner
    averaging passed through to the child."""
    rng = np.random.RandomState(16)
    L, n = 5, 30
    f = rng.rand(L * n)
    x0 = rng.randn(L * n)
    taus = np.repeat(rng.rand(n) + 0.5, L).reshape(n, L).T.reshape(-1)

    def make(fn):
        return fn.transform(fn.sum_ind_simplex(L, False), 1, 0, 1, f)

    ja, ta = _both(make, L * n, x0, taus, 0.8)
    np.testing.assert_allclose(ta, ja, **CLOSED)
    tp = tree_to(make(tfn)(0, L * n), torch.device("cpu"), torch.float64)
    jp = make(jfn)(0, L * n)
    assert tp.diagsteps is False and jp.diagsteps is False
    assert tp.get_separable_structure() == jp.get_separable_structure()
    seg = rng.rand(L * n)
    np.testing.assert_allclose(
        tp.average_precond(torch.from_numpy(seg)).numpy(),
        np.asarray(jp.average_precond(jnp.asarray(seg))), **CLOSED)


@pytest.mark.parametrize("a", [0.0, np.array([1.0, 0.0, 2.0])])
def test_transform_rejects_zero_a(a):
    with pytest.raises(ProstError):
        tfn.transform(tfn.sum_1d("abs"), a=a)(0, 3)


def test_permute_conjugation(x64):
    """prox of f(Px) == P^{-1} prox_f(P x), against the JAX package."""
    rng = np.random.RandomState(12)
    n = 32
    perm = rng.permutation(n)
    bvec = rng.randn(n)
    x0 = rng.randn(n)
    taus = rng.rand(n) + 0.5
    ja, ta = _both(lambda fn: fn.permute(fn.sum_1d("abs", 1.0, bvec), perm),
                   n, x0, taus)
    np.testing.assert_allclose(ta, ja, **CLOSED)
    _, inner = _both(lambda fn: fn.sum_1d("abs", 1.0, bvec), n, x0[perm],
                     taus[perm])
    np.testing.assert_allclose(ta, inner[np.argsort(perm)], **CLOSED)


@pytest.mark.parametrize("seed", range(10))
def test_conjugate_transform_shift_identity(x64, seed):
    """conjugate(f(. - b)) == transform(conjugate(f); d=b), through both
    packages' eval_prox (test_prox_conj_trans.m)."""
    rng = np.random.RandomState(seed)
    N = 200
    b = rng.rand(N)
    y = rng.rand(N)
    tau = float(rng.rand())
    Tau = rng.rand(N)
    outs = []
    for mod in (pt, ptt):
        fn = mod.function
        x1, ms = mod.eval_prox(
            fn.conjugate(fn.sum_1d("abs", 1, b, 1, 0, 0)), y, tau, Tau)
        x2, _ = mod.eval_prox(
            fn.transform(fn.conjugate(fn.sum_1d("abs", 1, 0, 1, 0, 0)),
                         1, 0, 1, b, 0), y, tau, Tau)
        np.testing.assert_allclose(x1, x2, atol=1e-12)
        assert ms >= 0
        outs.append(x1)
    np.testing.assert_allclose(outs[1], outs[0], **CLOSED)


# ------------------------------------------------------------ fun2d

def test_fun2d_table_is_complete():
    from prost_tpu.prox import FUN_2D as JFUN

    assert set(ptt.prox.FUN_2D) == set(JFUN)


def _fun2d_params(name):
    base = name.split(":")[-1]
    return {"huber": (0.5, 0.0), "lq": (1.5, 0.0), "lq_plus_eps": (1.5, 0.1),
            "truncquad": (2.0, 0.3), "trunclin": (1.0, 0.4),
            "ind_l1_ball": (1.3, 0.0)}.get(base, (0.0, 0.0))


@pytest.mark.parametrize("name", sorted(ptt.prox.FUN_2D))
def test_fun2d_matches_jax(x64, name):
    from prost_tpu.prox import FUN_2D as JFUN

    rng = np.random.RandomState(sorted(ptt.prox.FUN_2D).index(name))
    y1, y2 = 2.0 * rng.randn(2, 97)
    tau = 0.5 + rng.rand(97)
    alpha, beta = _fun2d_params(name)
    j1, j2 = JFUN[name](jnp.asarray(y1), jnp.asarray(y2), jnp.asarray(tau),
                        alpha, beta)
    t1, t2 = ptt.prox.FUN_2D[name](torch.from_numpy(y1),
                                   torch.from_numpy(y2),
                                   torch.from_numpy(tau), alpha, beta)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), **CLOSED)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), **CLOSED)


# ------------------------------------------------------------ spectral

COEFFS = (1.1, 0.2, 0.9, 0.1, 0.3, 0.0, 0.0)


@pytest.mark.parametrize("fun", ["abs", "square", "ind_geq0"])
def test_eigen_2x2(x64, fun):
    rng = np.random.RandomState(0)
    count = 50
    mats = rng.randn(count, 2, 2)
    mats[:5] = np.eye(2) * rng.randn(5, 1, 1)  # repeated eigenvalues
    seg = mats.reshape(count, 4).T.reshape(-1)
    for coeffs in ((1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0), COEFFS):
        ja, ta = _both(lambda fn: fn.sum_eigen_2x2(False, fun, *coeffs),
                       4 * count, seg, tau_scal=0.7)
        np.testing.assert_allclose(ta, ja, **CLOSED)


def _repeated(rng, count, n):
    """Symmetric matrices with a repeated eigenvalue each."""
    w = rng.randn(count, n)
    w[:, 1] = w[:, 0]
    q = np.linalg.qr(rng.randn(count, n, n))[0]
    return np.einsum("cij,cj,ckj->cik", q, w, q)


@pytest.mark.parametrize("n", [3, 5, 8])
@pytest.mark.parametrize("repeated", [False, True])
def test_eigen_nxn(x64, n, repeated):
    rng = np.random.RandomState(1)
    count = 20
    mats = _repeated(rng, count, n) if repeated else rng.randn(count, n, n)
    dim = n * n
    seg = mats.reshape(count, dim).T.reshape(-1)
    make = (tfn.sum_eigen_3x3 if n == 3 else
            lambda *a: tfn.sum_eigen_nxn(n, *a))
    ja = _jax_eval((jfn.sum_eigen_3x3 if n == 3 else
                    lambda *a: jfn.sum_eigen_nxn(n, *a))(False, "abs")(
        0, dim * count), seg, np.ones(dim * count), 0.5, False)
    ta = _torch_eval(make(False, "abs")(0, dim * count), seg,
                     np.ones(dim * count), 0.5, False)
    np.testing.assert_allclose(ta, ja, **ITERATIVE)


@pytest.mark.parametrize("fun,n", [("sum_1d:abs", 2), ("sum_1d:abs", 4),
                                   ("sum_1d:square", 3),
                                   ("ind_l1_ball", 3),
                                   ("moreau:ind_l1_ball", 3)])
def test_singular_nx2(x64, fun, n):
    rng = np.random.RandomState(2)
    count = 40
    mats = rng.randn(count, n, 2)
    mats[0] = 0.0  # the zero matrix
    mats[1, :, 1] = 2.0 * mats[1, :, 0]  # rank one
    mats[2] = 0.0
    mats[2, 0, 0] = mats[2, 1, 1] = 1.5  # equal singular values
    dim = 2 * n
    seg = np.concatenate([mats[:, :, 0], mats[:, :, 1]], axis=1).T.reshape(-1)
    coeffs = (1.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0)
    ja, ta = _both(lambda fn: fn.sum_singular_nx2(dim, False, fun, *coeffs),
                   dim * count, seg, tau_scal=0.3)
    np.testing.assert_allclose(ta, ja, **CLOSED)


def _bivectors(rng, n, count, s1, s2):
    tri = ([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)] if n == 4 else
           [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4),
            (2, 3), (2, 4), (3, 4)])
    comps = []
    for i in range(count):
        q, _ = np.linalg.qr(rng.randn(n, n))
        m = np.zeros((n, n))
        m[0, 1], m[1, 0] = s1[i], -s1[i]
        m[2, 3], m[3, 2] = s2[i], -s2[i]
        M = q @ m @ q.T
        comps.append([M[a, b] for a, b in tri])
    return np.array(comps)


@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize("conjugate", [False, True])
@pytest.mark.parametrize("repeated", [False, True])
def test_mass_norm(x64, n, conjugate, repeated):
    """Mass norm and comass-ball projection, on random 2-vectors and on
    isoclinic ones (s1 == s2: a doubly repeated eigenvalue pair of M M^T,
    where the choice of the second plane is free)."""
    rng = np.random.RandomState(4)
    count = 16
    dim = 6 if n == 4 else 10
    if repeated:
        s = rng.rand(count) * 2 + 0.5
        seg = _bivectors(rng, n, count, s, s).T.reshape(-1)
    else:
        seg = rng.randn(dim * count) * 1.5

    def make(fn):
        return (fn.sum_ind_comass_ball(n, False) if conjugate
                else fn.sum_mass_norm(n, False, cost=1.2))

    ja, ta = _both(make, dim * count, seg, tau_scal=0.8)
    np.testing.assert_allclose(ta, ja, **ITERATIVE)


@pytest.mark.parametrize("n", [4, 5])
def test_mass_comass_moreau_identity(x64, n):
    rng = np.random.RandomState(5)
    count = 12
    dim = 6 if n == 4 else 10
    seg = rng.randn(dim * count) * 1.5
    tau = 0.8
    ones = np.ones(dim * count)
    lhs = _torch_eval(tfn.sum_mass_norm(n, False)(0, dim * count), seg, ones,
                      tau, False)
    proj = _torch_eval(tfn.sum_ind_comass_ball(n, False)(0, dim * count),
                       seg / tau, ones, 1.0, False)
    np.testing.assert_allclose(lhs, seg - tau * proj, atol=1e-10)


# ------------------------------------------------------------ epi polyhedral

def _polyhedral(rng, d, m, n_pts, **kw):
    A, b = rng.randn(m, d), rng.randn(m)
    args = (d + 1, False, np.tile(A.reshape(-1), n_pts), np.tile(b, n_pts),
            np.full(n_pts, m), np.arange(n_pts) * m)
    return (lambda fn: fn.sum_ind_epi_polyhedral(*args, **kw)), A, b


@pytest.mark.parametrize("d", [1, 2, 3])
def test_epi_polyhedral_matches_jax(x64, d):
    rng = np.random.RandomState(17 + d)
    m, n_pts = 12, 40
    make, _, _ = _polyhedral(rng, d, m, n_pts, sweeps=600)
    arg = np.concatenate([10.0 * rng.randn(n_pts, d).T.reshape(-1),
                          10.0 * rng.randn(n_pts)])
    ja, ta = _both(make, n_pts * (d + 1), arg)
    np.testing.assert_allclose(ta, ja, **ITERATIVE)


@pytest.mark.parametrize("d", [1, 2])
def test_epi_polyhedral_reference_scale(x64, d):
    """The reference test's data regime (m=25, x0/y0 ~ 1000*randn) with
    the JAX test's settings (sweeps=20000, tol=1e-12, omega=1.9)."""
    rng = np.random.RandomState(8954 + d)
    m, n_pts = 25, 16
    make, _, _ = _polyhedral(rng, d, m, n_pts, sweeps=20000, tol=1e-12,
                             omega=1.9)
    x0 = 1000.0 * rng.randn(n_pts, d)
    y0 = 1000.0 * rng.randn(n_pts)
    arg = np.concatenate([x0.T.reshape(-1), y0])
    ja, ta = _both(make, n_pts * (d + 1), arg)
    np.testing.assert_allclose(ta, ja, rtol=1e-8, atol=1e-6)


def test_epi_polyhedral_early_exit_is_exact(x64, monkeypatch):
    """The blocked sweeps with the device stop flag give the early exit's
    result: equal to a run that reads the flag after every sweep, and
    within the JAX test's bound of a long fixed sweep budget."""
    rng = np.random.RandomState(11)
    d, m, n_pts = 2, 6, 10
    make, _, _ = _polyhedral(rng, d, m, n_pts, sweeps=400)
    size = n_pts * (d + 1)
    arg = 10 * rng.randn(size)
    ja, blocked = _both(make, size, arg)
    np.testing.assert_allclose(blocked, ja, **ITERATIVE)
    cls = ptt.prox.ProxIndEpiPolyhedral
    monkeypatch.setattr(cls, "SWEEP_BLOCK", 1)
    per_sweep = _torch_eval(make(tfn)(0, size), arg, np.ones(size), 1.0,
                            False)
    np.testing.assert_array_equal(blocked, per_sweep)
    monkeypatch.setattr(cls, "SWEEP_BLOCK", 7)
    np.testing.assert_array_equal(
        blocked, _torch_eval(make(tfn)(0, size), arg, np.ones(size), 1.0,
                             False))
    slow, _, _ = _polyhedral(np.random.RandomState(11), d, m, n_pts,
                             sweeps=5000, tol=0.0)
    np.testing.assert_allclose(
        blocked, _torch_eval(slow(tfn)(0, size), arg, np.ones(size), 1.0,
                             False), atol=1e-4)


def test_epi_polyhedral_ragged_counts_and_feasible_identity(x64):
    rng = np.random.RandomState(3)
    d, n_pts = 2, 8
    counts = rng.randint(2, 7, size=n_pts)
    idx = np.concatenate([[0], np.cumsum(counts)[:-1]])
    As = [rng.randn(c, d) for c in counts]
    bs = [rng.rand(c) + 0.5 for c in counts]
    rep_a = np.concatenate([a.reshape(-1) for a in As])
    rep_b = np.concatenate(bs)

    def make(fn):
        return fn.sum_ind_epi_polyhedral(d + 1, False, rep_a, rep_b, counts,
                                         idx, sweeps=500)

    x0 = 0.1 * rng.randn(n_pts, d)
    y_in = np.array([np.max(A @ x + 1.0) for A, x in zip(As, x0)])
    arg = np.concatenate([x0.T.reshape(-1), y_in])
    ja, ta = _both(make, n_pts * (d + 1), arg)
    np.testing.assert_array_equal(ta, arg)  # feasible: the identity
    np.testing.assert_allclose(ta, ja, **ITERATIVE)
    y_bad = np.array([np.max(A @ x - b) - 3.0
                      for A, b, x in zip(As, bs, x0)])
    arg = np.concatenate([x0.T.reshape(-1), y_bad])
    ja, ta = _both(make, n_pts * (d + 1), arg)
    np.testing.assert_allclose(ta, ja, **ITERATIVE)


# ------------------------------------------------------------ factories

# every factory of tests/test_modeling.py's registry, with the JAX test's
# sizes
FACTORIES = {
    "zero": (lambda fn, r: fn.zero(), 12),
    "sum_1d": (lambda fn, r: fn.sum_1d("huber", alpha=0.5), 12),
    "sum_norm2": (lambda fn, r: fn.sum_norm2(3, False, "abs"), 12),
    "sum_ind_simplex": (lambda fn, r: fn.sum_ind_simplex(4, False), 12),
    "sum_ind_sum": (lambda fn, r: fn.sum_ind_sum(4, False), 12),
    "sum_ind_sum2": (lambda fn, r: fn.sum_ind_sum2(3, [0, 1, 2, 3, 4, 5],
                                                    1.0), 12),
    "sum_ind_soc": (lambda fn, r: fn.sum_ind_soc(6, False), 12),
    "sum_ind_halfspace": (lambda fn, r: fn.sum_ind_halfspace(
        4, False, np.ones(4), 1.0), 12),
    "sum_ind_epi_quad": (lambda fn, r: fn.sum_ind_epi_quad(
        4, False, 1.0, np.zeros(3), 0.0), 12),
    "sum_ind_epi_polyhedral": (lambda fn, r: fn.sum_ind_epi_polyhedral(
        3, False, np.tile([1.0, -1.0, 0.5, 2.0], 4), np.tile([0.1, 0.2], 4),
        np.full(4, 2), np.arange(4) * 2), 12),
    "sum_eigen_2x2": (lambda fn, r: fn.sum_eigen_2x2(False, "ind_geq0"), 16),
    "sum_eigen_3x3": (lambda fn, r: fn.sum_eigen_3x3(False, "abs"), 18),
    "sum_eigen_nxn": (lambda fn, r: fn.sum_eigen_nxn(4, False, "square"),
                      32),
    "sum_singular_nx2": (lambda fn, r: fn.sum_singular_nx2(
        6, False, "sum_1d:abs"), 12),
    "sum_mass_norm": (lambda fn, r: fn.sum_mass_norm(4, False), 12),
    "sum_ind_comass_ball": (lambda fn, r: fn.sum_ind_comass_ball(5, False),
                            20),
    "ind_range": (lambda fn, r: fn.ind_range(r.randn(12, 3)), 12),
    "conjugate": (lambda fn, r: fn.conjugate(fn.sum_1d("abs")), 12),
    "transform": (lambda fn, r: fn.transform(fn.sum_1d("abs"), 2.0, 1.0),
                  12),
    "permute": (lambda fn, r: fn.permute(fn.sum_1d("abs"),
                                         np.arange(12)[::-1]), 12),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_function_factory_matches_jax(x64, name):
    """Each factory builds a prox of the right size, and ``eval_prox`` of
    the port equals the JAX package's on the same input."""
    build, size = FACTORIES[name]
    arg = np.random.RandomState(2).randn(size)
    tau_diag = 0.5 + np.random.RandomState(3).rand(size)
    prox = build(tfn, np.random.RandomState(1))(0, size)
    assert prox.index == 0 and prox.size == size
    jout, _ = pt.eval_prox(build(jfn, np.random.RandomState(1)), arg, 0.7,
                           tau_diag)
    tout, ms = ptt.eval_prox(build(tfn, np.random.RandomState(1)), arg, 0.7,
                             tau_diag)
    assert tout.shape == (size,) and ms >= 0
    tol = ITERATIVE if name in ("sum_ind_epi_polyhedral", "ind_range",
                                "sum_eigen_3x3", "sum_eigen_nxn",
                                "sum_mass_norm", "sum_ind_comass_ball") \
        else CLOSED
    np.testing.assert_allclose(tout, np.asarray(jout), **tol)


def test_factories_check_sizes():
    with pytest.raises(ProstError):
        tfn.sum_ind_simplex(4, False)(0, 10)
    with pytest.raises(ProstError):
        tfn.sum_ind_soc(3, True)
    with pytest.raises(ProstError):
        tfn.sum_mass_norm(3, False)
    with pytest.raises(ProstError):
        tfn.permute(tfn.sum_1d("abs"), np.arange(5))(0, 6)
    with pytest.raises(ProstError):
        tfn.ind_range(np.ones((5, 2)))(0, 6)


def test_eval_prox_debug_path():
    res, ms = ptt.eval_prox(tfn.sum_1d("abs", 1, 0, 1),
                            np.array([3.0, -2.0, 0.5]), tau=1.0)
    np.testing.assert_allclose(res, [2.0, -1.0, 0.0], atol=1e-6)
    assert ms >= 0


# ------------------------------------------------------------ the slice

def _simplex_ml(mod, nx, ny, L, f, lmb):
    """The simplex multilabel model: the unaries and the simplex in g, the
    2L-ball of radius lmb on grad u, no sum-to-one dual."""
    n = nx * ny
    u, q = mod.Variable(n * L), mod.Variable(2 * n * L)
    prob = mod.MinMaxProblem([u], [q])
    prob.add_function(u, mod.function.transform(
        mod.function.sum_ind_simplex(L, False), 1, 0, 1, f))
    prob.add_function(q, mod.function.sum_norm2(2 * L, False, "ind_leq0",
                                                1 / lmb, 1, 1))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    return prob, u


def _ml_energy(u, f, lmb, L, nx, ny):
    u = u.reshape(L, nx, ny)
    gx = np.zeros_like(u)
    gy = np.zeros_like(u)
    gx[:, :-1] = u[:, 1:] - u[:, :-1]
    gy[:, :, :-1] = u[:, :, 1:] - u[:, :, :-1]
    return float(u.reshape(-1) @ f
                 + lmb * np.sum(np.sqrt(np.sum(gx ** 2 + gy ** 2, axis=0))))


def _sum_ml(mod, nx, ny, L, f, lmb):
    """The same convex problem with the sum enforced through the dual s
    (the fast multilabel model of example_multilabel_fast.py)."""
    n = nx * ny
    u = mod.Variable(n * L)
    q, s = mod.Variable(2 * n * L), mod.Variable(n)
    prob = mod.MinMaxProblem([u], [q, s])
    prob.add_function(u, mod.function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(q, mod.function.sum_norm2(2 * L, False, "ind_leq0",
                                                1 / lmb, 1, 1))
    prob.add_function(s, mod.function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, mod.block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, mod.block.sparse_kron_id(np.ones((1, L)), n))
    return prob


def test_simplex_multilabel_solve_matches_sum_model():
    """The simplex multilabel model at 16x16x4 through the port's solve:
    the generic route (the fused matchers refuse it), every pixel's u on
    the simplex, and its energy against the same convex problem posed with
    the sum-to-one dual, solved by the port (fused route, plain versions)
    and by the JAX package.  (The JAX package cannot solve a model with
    ``transform`` itself: its ProxTransform checks ``a`` in __post_init__,
    which fails on jit's tracers.)"""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.modeling import Backend

    nx = ny = 16
    L, lmb, n = 4, 0.5, 16 * 16
    rng = np.random.RandomState(42)
    gray = rng.rand(ny, nx)
    means = np.linspace(0, 1, L)
    f = np.stack([(gray - m) ** 2 for m in means]).transpose(0, 2, 1)
    f = f.reshape(-1)
    opts = dict(max_iters=4000, num_cback_calls=10, verbose=False,
                tol_rel_primal=1e-6, tol_rel_dual=1e-6, tol_abs_primal=1e-6,
                tol_abs_dual=1e-6)
    made = {}

    class Recorded(Backend):
        def create(self, problem, solver_opts):
            made["b"] = super().create(problem, solver_opts)
            return made["b"]

    tprob, tu = _simplex_ml(ptt, nx, ny, L, f, lmb)
    ptt.solve(tprob, Recorded("pdhg", PDHGOptions(stepsize="boyd",
                                                  residual_iter=10)),
              ptt.options(**opts))
    b = made["b"]
    assert (b.rof, b.ml, b.deblur, b.tight, b.vol) == (None,) * 5
    u = tu.val.reshape(L, n).astype(np.float64)
    assert u.min() >= 0.0
    np.testing.assert_allclose(u.sum(axis=0), 1.0, atol=1e-5)
    e_t = _ml_energy(u.reshape(-1), f, lmb, L, nx, ny)

    backend = dict(stepsize="boyd", residual_iter=10)
    jres = pt.solve(_sum_ml(pt, nx, ny, L, f, lmb),
                    pt.backend_pdhg(**backend), pt.options(**opts))
    sres = ptt.solve(_sum_ml(ptt, nx, ny, L, f, lmb),
                     ptt.backend_pdhg(**backend), ptt.options(**opts))
    e_j = _ml_energy(np.asarray(jres.x, np.float64), f, lmb, L, nx, ny)
    e_s = _ml_energy(sres.x.astype(np.float64), f, lmb, L, nx, ny)
    assert abs(e_s - e_j) <= 1e-4 * abs(e_j)
    assert abs(e_t - e_j) <= 1e-3 * abs(e_j)
