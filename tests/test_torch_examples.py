"""Port parity: the ROF-family examples of prost_tpu_torch.examples
against the JAX package's examples/, at the sizes tests/test_examples.py
runs them.

Each case runs the JAX example's ``run()`` and the port's with the same
arguments on the CPU (the port's fused routes through their kernels'
plain versions), holds the port's energies or gaps to the JAX example's
(within ENERGY_RTOL relative; the iterates within U_ATOL), checks the
route the port took, and holds the port's result to the invariant
tests/test_examples.py holds the JAX example to (the same oracles and
bounds).  The two examples' iteration counts may differ: the JAX examples
run the generic path on the CPU, the port the fused route, and each stops
at its own convergence test."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import prost_tpu_torch as ptt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ENERGY_RTOL = 2e-6
U_ATOL = 5e-4


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def both(name, **kw):
    """(JAX example's output, port example's output) of ``run(**kw)``."""
    import importlib

    jax_ex = importlib.import_module(name)
    port_ex = importlib.import_module(f"prost_tpu_torch.examples.{name}")
    return jax_ex.run(verbose=False, **kw), port_ex.run(verbose=False, **kw)


def assert_close_energy(jo, to, key="energy", rtol=ENERGY_RTOL):
    assert abs(to[key] - jo[key]) <= rtol * abs(jo[key]), (to[key], jo[key])


def _grad(n_side, L=1):
    from prost_tpu_torch.examples.example_rof_dual import spmat_gradient2d

    return sp.csr_matrix(spmat_gradient2d(n_side, n_side, L))


def test_rof_primaldual_gap():
    jo, to = both("example_rof_primaldual", size=32, max_iters=4000,
                  gap_tol=1e-5)
    assert to["route"] == "FusedROFPDHG:rof"
    assert to["gap_per_px"] < 1e-5
    assert_close_energy(jo, to)
    np.testing.assert_allclose(to["u"], jo["u"], atol=U_ATOL)


def test_rof_energy_matches_independent_oracle():
    """The port's ROF at gap 1e-7 against the f64 graph-ADMM oracle and its
    duality-gap certificate (tests/test_examples.py's check)."""
    from prost_tpu_torch.examples.example_rof_primaldual import run
    from oracles import (graph_admm_with_dual, prox_group_l2,
                         prox_weighted_square, rof_dual_gap, rof_energy)

    size = 16
    n = size * size
    out = run(size=size, max_iters=20000, gap_tol=1e-7, verbose=False)
    f64 = np.asarray(out["f"], np.float64)
    lmb = out["lmb"]
    K = _grad(size)
    u_star, y_star, _ = graph_admm_with_dual(
        K, prox_weighted_square(f64, lmb), prox_group_l2((2, n)), rho=30.0)
    e_opt = rof_energy(K, u_star, f64, lmb, n)
    assert rof_dual_gap(K, u_star, f64, lmb, n, p=y_star) < 1e-8 * e_opt
    e_our = rof_energy(K, np.asarray(out["u"], np.float64), f64, lmb, n)
    assert e_our >= e_opt - 1e-7 * e_opt
    assert e_our - e_opt <= 1e-4 * e_opt


def test_rof_primal_subvars():
    jo, to = both("example_rof_primal", size=24, max_iters=3000)
    assert to["route"] == "FusedROFPDHG:generic"
    np.testing.assert_allclose(to["u"], jo["u"], atol=U_ATOL)
    f, lmb, u = to["f"], to["lmb"], to["u"]
    n = f.size
    K = _grad(24)

    def en(v):
        g = K @ v
        return lmb / 2 * np.sum((v - f) ** 2) + np.sum(
            np.sqrt(g[:n] ** 2 + g[n:] ** 2))

    assert en(u) < en(f)
    assert abs(en(u) - en(jo["u"])) <= ENERGY_RTOL * en(jo["u"])


def test_rof_dual_recovers_primal():
    """The dual solve's recovered u is the primal solve's
    (example_rof_dual.m:44-49), and the JAX example's."""
    from prost_tpu_torch import block, function

    jo, to = both("example_rof_dual", size=24, max_iters=8000)
    assert to["route"] == "FusedROFPDHG:generic"
    assert_close_energy(jo, to)
    np.testing.assert_allclose(to["u"], jo["u"], atol=U_ATOL)
    f, lmb = to["f"], to["lmb"]
    nx = ny = 24
    n = nx * ny
    u = ptt.Variable(n)
    q = ptt.Variable(2 * n)
    prob = ptt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, function.sum_norm2(2, False, "ind_leq0", 1, 1, 1))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))
    ptt.solve(prob, ptt.backend_pdhg(), ptt.options(
        max_iters=8000, verbose=False,
        tol_rel_primal=1e-7, tol_rel_dual=1e-7,
        tol_abs_primal=1e-7, tol_abs_dual=1e-7))
    np.testing.assert_allclose(to["u"], u.val, atol=2e-2)


def test_tvl1_energy_matches_oracle():
    from oracles import graph_admm, prox_group_l2, prox_l1, tvl1_energy

    size = 16
    n = size * size
    jo, to = both("example_tvl1", size=size, max_iters=30000)
    assert to["route"] == "FusedROFPDHG:rof"
    assert_close_energy(jo, to)
    u, f, lmb = np.asarray(to["u"], np.float64), to["f"], to["lmb"]
    assert not np.allclose(u, f)
    K = _grad(size)
    u_star, _ = graph_admm(K, prox_l1(f, lmb), prox_group_l2((2, n)),
                           iters=20000, tol=1e-11)
    e_opt = tvl1_energy(K, u_star, f, lmb, n)
    e_our = tvl1_energy(K, u, f, lmb, n)
    assert e_our - e_opt <= 1e-4 * (1.0 + e_opt)
    assert e_our >= e_opt - 1e-4 * e_opt


def test_tv_inpaint_energy_matches_oracle():
    from oracles import (graph_admm, inpaint_energy, prox_group_l2,
                         prox_weighted_square)

    size = 16
    n = size * size
    jo, to = both("example_tv_inpaint", size=size, max_iters=30000)
    assert to["route"] == "FusedROFPDHG:rof"
    assert_close_energy(jo, to)
    np.testing.assert_array_equal(to["mask"], jo["mask"])
    u, f, m, lmb = (np.asarray(to["u"], np.float64), to["f"], to["mask"],
                    to["lmb"])
    assert np.all(np.isfinite(u))
    K = _grad(size)
    u_star, _ = graph_admm(K, prox_weighted_square(f, lmb, m),
                           prox_group_l2((2, n)), iters=20000, tol=1e-11)
    e_opt = inpaint_energy(K, u_star, f, m, lmb, n)
    e_our = inpaint_energy(K, u, f, m, lmb, n)
    assert e_our - e_opt <= 1e-4 * (1.0 + e_opt)
    assert e_our >= e_opt - 1e-4 * e_opt


def test_nonconvex_rof_stationary_local_minimum():
    """alg2 on the generic path: the energy of the JAX example, a fixed
    point (doubling the iterations no longer moves it) and a local minimum
    of the f64 Mumford-Shah energy under single-pixel moves."""
    from prost_tpu_torch.examples.example_nonconvex_rof import run

    jo, out1 = both("example_nonconvex_rof", size=24, max_iters=3000)
    assert out1["route"] == "FusedROFPDHG:generic"
    assert_close_energy(jo, out1)
    out2 = run(size=24, max_iters=6000, verbose=False)
    assert np.abs(out1["u"] - out2["u"]).max() <= 1e-3
    f = np.asarray(out2["f"], np.float64)
    assert out1["energy"] < 0.05 * f.size

    n = 24 * 24
    lam, alpha = 0.05, 30.0
    u = np.asarray(out2["u"], np.float64)
    G = _grad(24)

    def ms_energy(uu):
        g = (G @ uu).reshape(2, n)
        return 0.5 * np.sum((uu - f) ** 2) + np.sum(
            np.minimum(alpha * (g ** 2).sum(axis=0), lam))

    e0 = ms_energy(u)
    rng = np.random.RandomState(0)
    for px in rng.choice(n, size=40, replace=False):
        for eps in (-0.05, -0.01, 0.01, 0.05):
            up = u.copy()
            up[px] += eps
            assert ms_energy(up) >= e0 - 1e-6 * (1.0 + abs(e0))


def test_rof_admm_matches_pdhg_energy():
    from prost_tpu_torch.examples.example_rof_primaldual import run as run_pd

    jo, to = both("example_rof_admm", size=24, max_iters=600)
    assert to["route"] == "FusedROFADMM:generic"
    assert_close_energy(jo, to)
    out_pd = run_pd(size=24, max_iters=4000, gap_tol=1e-6, verbose=False)
    assert abs(to["energy"] - out_pd["energy"]) < 2e-3 * out_pd["energy"]


def test_custom_prox_example_runs_as_a_script():
    r = subprocess.run(
        [sys.executable, "-m", "prost_tpu_torch.examples.example_custom_prox",
         "--cpu"], capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "result: converged" in r.stdout
    assert "wire round trip: K applies within 0.0e+00" in r.stdout


def test_sharded_example_paths_agree():
    """Two gloo ranks: both sharded paths take the same trajectory, and
    the JAX example's over two devices."""
    from prost_tpu_torch.examples import example_sharded
    from prost_tpu_torch.parallel.launch import run_ranks

    kw = dict(size=32, n_shards=2, max_iters=200, verbose=False)
    outs = run_ranks(2, example_sharded.run, kw, device="cpu")
    for out in outs:
        assert out["n_shards"] == 2
        assert out["diff"] < 1e-5
        assert out["route"] == ["ShardedPDHG:generic",
                                "ShardedFusedROF:halo"]
    from example_sharded import run as jax_run

    jo = jax_run(interpret=True, **kw)
    np.testing.assert_allclose(outs[0]["u"], jo["u"], atol=1e-5)


def test_sharded_example_refuses_another_shard_count():
    from prost_tpu_torch.examples.example_sharded import run

    with pytest.raises(ptt.ProstError, match="shards"):
        run(size=16, n_shards=2, max_iters=10, verbose=False)
