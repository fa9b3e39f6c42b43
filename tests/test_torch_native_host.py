"""The port's native host runtime (prost_tpu_torch/_native) against its
numpy versions and against the JAX package's runtime (prost_tpu/_native,
which imports no JAX): exactly where the outputs are integers or copied
values, within 1e-13 relative for the float64 sums (the JAX package
builds with -march=native, which contracts multiply-adds; the port builds
portable code).  Mirrors tests/test_native.py."""

import os
import threading

import numpy as np
import pytest
import scipy.sparse as sp

from prost_tpu._native import host as jhost
from prost_tpu_torch._native import host


@pytest.fixture
def numpy_host(monkeypatch):
    """The port's runtime with its numpy versions (no library loaded)."""
    monkeypatch.setattr(host, "_load", lambda: None)
    assert not host.available()
    return host


def test_native_library_builds_into_build_dir():
    assert host.available()
    path = host.library_path()
    assert os.path.dirname(path) == host.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.exists(path)


def test_concurrent_builds_make_one_library(tmp_path, monkeypatch):
    """Builds from several threads, each with its own lock-file handle:
    one compiles, the others find its library; no temporary is left."""
    monkeypatch.setattr(host, "BUILD_DIR", str(tmp_path))
    path = host.library_path()
    oks = []
    threads = [threading.Thread(target=lambda: oks.append(host._build(path)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads)
    assert oks == [True] * 4
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(path), "libprost_host.lock"])


def test_coo_sort_perm(numpy_host):
    rng = np.random.RandomState(0)
    r = rng.randint(0, 50, 500).astype(np.int32)
    c = rng.randint(0, 40, 500).astype(np.int32)
    ref = np.lexsort((c, r))
    for perm in (host.coo_sort_perm(r, c), jhost.coo_sort_perm(r, c)):
        # permutations may differ among equal keys: compare the sorted keys
        np.testing.assert_array_equal(np.sort(perm), np.arange(500))
        np.testing.assert_array_equal(r[perm], r[ref])
        np.testing.assert_array_equal(c[perm], c[ref])
    np.testing.assert_array_equal(numpy_host.coo_sort_perm(r, c), ref)


def _unique_keys(rng, n):
    """(r, c) pairs without repeats: every sort gives one permutation."""
    flat = rng.choice(60 * 70, n, replace=False)
    return (flat // 70).astype(np.int32), (flat % 70).astype(np.int32)


def test_coo_sort_perm_unique_keys_exact(numpy_host):
    r, c = _unique_keys(np.random.RandomState(9), 900)
    native = host.coo_sort_perm(r, c)
    np.testing.assert_array_equal(native, jhost.coo_sort_perm(r, c))
    np.testing.assert_array_equal(native, numpy_host.coo_sort_perm(r, c))


@pytest.mark.parametrize("case", [
    ([0, 4, 9], [4, 5, 1], 10),   # exact tiling
    ([0, 5], [4, 5], 10),         # gap
    ([0, 3], [4, 7], 10),         # overlap
    ([1], [9], 10),               # start != 0
    ([0], [9], 10),               # short
    ([9, 0, 4], [1, 4, 5], 10),   # unsorted tiling
])
def test_check_prox_domain(case):
    native = host.check_prox_domain(*case)
    assert native == jhost.check_prox_domain(*case)
    assert (native is None) == (case[0] in ([0, 4, 9], [9, 0, 4]))


def test_check_prox_domain_numpy(numpy_host):
    assert numpy_host.check_prox_domain([0, 4, 9], [4, 5, 1], 10) is None
    assert numpy_host.check_prox_domain([0, 5], [4, 5], 10) is not None
    assert numpy_host.check_prox_domain([0, 3], [4, 7], 10) is not None
    assert numpy_host.check_prox_domain([1], [9], 10) is not None
    assert numpy_host.check_prox_domain([0], [9], 10) is not None


@pytest.mark.parametrize("native", [True, False])
def test_prox_gaps(native, monkeypatch):
    if not native:
        monkeypatch.setattr(host, "_load", lambda: None)
    assert host.prox_gaps([2, 8], [3, 2], 12) == [(0, 2), (5, 3), (10, 2)]
    assert host.prox_gaps([2, 8], [3, 2], 12) == jhost.prox_gaps([2, 8],
                                                                [3, 2], 12)
    assert host.prox_gaps([0], [12], 12) == []
    with pytest.raises(ValueError):
        host.prox_gaps([0, 3], [5, 5], 12)


@pytest.mark.parametrize("native", [True, False])
def test_check_block_overlap_randomized(native, monkeypatch):
    """The sweep over sorted rows gives the O(n^2) oracle's verdict over
    random block grids, as the JAX package's runtime does."""
    if not native:
        monkeypatch.setattr(host, "_load", lambda: None)
    rng = np.random.RandomState(1)
    for _ in range(20):
        n = rng.randint(2, 12)
        rows = rng.randint(0, 30, n)
        cols = rng.randint(0, 30, n)
        nrows = rng.randint(1, 10, n)
        ncols = rng.randint(1, 10, n)
        hit = any(cols[i] < cols[j] + ncols[j] and cols[j] < cols[i] + ncols[i]
                  and rows[i] < rows[j] + nrows[j]
                  and rows[j] < rows[i] + nrows[i]
                  for i in range(n) for j in range(i + 1, n))
        got = host.check_block_overlap(rows, cols, nrows, ncols)
        assert (got is not None) == hit
        assert (jhost.check_block_overlap(rows, cols, nrows, ncols)
                is not None) == hit


def test_csr_roundtrip_and_matvec(monkeypatch):
    assert host.available()
    rng = np.random.RandomState(2)
    A = sp.random(200, 150, 0.05, random_state=2).tocsr()
    x = rng.rand(150)
    outs = []
    for h in (host, jhost):
        outs.append((h.csr_to_csc(200, 150, A.indptr, A.indices, A.data),
                     h.csr_matvec(200, A.indptr, A.indices, A.data, x),
                     h.csr_row_alpha_sum(200, A.indptr, A.data, 1.5)))
    (cp, ri, vt), mv, rs = outs[0]
    B = A.tocsc()
    np.testing.assert_array_equal(cp, B.indptr)
    np.testing.assert_array_equal(ri, B.indices)
    np.testing.assert_array_equal(vt, B.data)
    (jcp, jri, jvt), jmv, jrs = outs[1]
    np.testing.assert_array_equal(cp, jcp)
    np.testing.assert_array_equal(ri, jri)
    np.testing.assert_array_equal(vt, jvt)
    np.testing.assert_allclose(mv, jmv, rtol=1e-13)
    np.testing.assert_allclose(rs, jrs, rtol=1e-13)
    np.testing.assert_allclose(mv, A @ x, rtol=1e-13)
    np.testing.assert_allclose(
        rs, np.asarray(abs(A).power(1.5).sum(axis=1)).ravel(), rtol=1e-13)
    # the numpy versions
    monkeypatch.setattr(host, "_load", lambda: None)
    numpy_host = host
    ncp, nri, nvt = numpy_host.csr_to_csc(200, 150, A.indptr, A.indices,
                                          A.data)
    np.testing.assert_array_equal(ncp, cp)
    np.testing.assert_array_equal(nri, ri)
    np.testing.assert_array_equal(nvt, vt)
    np.testing.assert_allclose(
        numpy_host.csr_matvec(200, A.indptr, A.indices, A.data, x), mv,
        rtol=1e-13)
    np.testing.assert_allclose(
        numpy_host.csr_row_alpha_sum(200, A.indptr, A.data, 1.5), rs,
        rtol=1e-13)


def test_problem_assembly_uses_the_loader(monkeypatch):
    """Problem.create fills prox gaps and LinearOperator.create checks
    block overlap through the loader's entry points."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.linop import BlockZero, LinearOperator

    calls = []
    for name in ("prox_gaps", "check_block_overlap"):
        fn = getattr(host, name)
        monkeypatch.setattr(host, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    ptt.set_device("cpu")
    u, q = ptt.Variable(4), ptt.Variable(4)
    prob = ptt.MinMaxProblem([u], [q])
    prob.add_function(u, ptt.function.sum_1d("square"))
    prob.add_dual_pair(u, q, ptt.block.identity())
    core = prob.finalize()
    assert len(core.prox_fstar) == 1  # the gap filled with a zero prox
    with pytest.raises(ptt.ProstError):
        LinearOperator.create([BlockZero(row=0, col=0, nrows=5, ncols=5),
                               BlockZero(row=4, col=4, nrows=5, ncols=5)])
    assert set(calls) == {"prox_gaps", "check_block_overlap"}
