"""Port parity: prost_tpu_torch.util (checkpoint/resume and the profiling
helpers) against prost_tpu.util.

Resume is exact: a run split by ``save_state`` / ``load_state`` equals
the straight run bit for bit on the generic PDHG, the generic ADMM, a
batched ensemble on its fused route (split where a chunk starts) and,
on two gloo ranks, the sharded generic and halo routes.  The port's
resumed run lands where the JAX package's resumed run lands (f64, within
1e-10).  The profiling helpers keep the JAX package's contracts on the
CPU."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import prost_tpu as pt
import prost_tpu_torch as ptt
from prost_tpu_torch import interop
from prost_tpu_torch.util import (compiled_memory_analysis, load_state,
                                  memory_stats, save_state, timed, trace)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _rof_problem(mod, nx=12, ny=12, seed=0, lmb=5.0):
    n = nx * ny
    f = np.random.RandomState(seed).rand(n).astype(np.float32)
    L, P = mod.linop, mod.prox
    grad = L.BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    prox_g = [P.ProxElem1D(index=0, size=n, fun="square",
                           coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))]
    pn = P.ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                         interleaved=False, fun="abs",
                         coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    return mod.Problem.create(
        L.LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[P.ProxMoreau(index=0, size=2 * n, child=pn)])


def _sopts(mod, tol=1e-7):
    return mod.SolverOptions(verbose=False, tol_rel_primal=tol,
                             tol_rel_dual=tol, tol_abs_primal=tol,
                             tol_abs_dual=tol)


def _pdhg(nx=12, ny=12):
    from prost_tpu_torch.backend import BackendPDHG, PDHGOptions

    return BackendPDHG(_rof_problem(ptt, nx, ny),
                       PDHGOptions(scale_steps_operator=False), _sopts(ptt))


def assert_states_equal(a, b):
    assert type(a) is type(b)
    for k in vars(a):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def _split_run(backend, split, until, path, it=lambda s: int(s.iteration)):
    state = backend.run(backend.initial_state(), split, 0)
    save_state(path, state)
    loaded = load_state(path, backend.initial_state())
    assert_states_equal(loaded, state)
    assert it(loaded) == split
    return backend.run(loaded, until, it(loaded))


def test_checkpoint_resume_is_exact_pdhg(tmp_path):
    """100 iterations, checkpoint, 100 more: every field equals 200
    straight iterations bit for bit."""
    b = _pdhg()
    resumed = _split_run(b, 100, 200, str(tmp_path / "ckpt.npz"))
    assert_states_equal(resumed, b.run(b.initial_state(), 200, 0))


def test_checkpoint_resume_is_exact_admm(tmp_path):
    from prost_tpu_torch.backend import ADMMOptions, BackendADMM

    b = BackendADMM(_rof_problem(ptt), ADMMOptions(residual_iter=5),
                    _sopts(ptt))
    resumed = _split_run(b, 45, 90, str(tmp_path / "admm.npz"))
    assert_states_equal(resumed, b.run(b.initial_state(), 90, 0))


def test_checkpoint_resume_is_exact_batched(tmp_path):
    """A 4-instance ROF ensemble on the batched fused route, split where a
    chunk starts (iteration 41 of residual_iter 10)."""
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.parallel import BatchedPDHG

    b = BatchedPDHG([_rof_problem(ptt, seed=s, lmb=4.0 + s)
                     for s in range(4)],
                    PDHGOptions(residual_iter=10, scale_steps_operator=False),
                    _sopts(ptt, 0.0))
    assert b.rof is not None
    resumed = _split_run(b, 41, 95, str(tmp_path / "batched.npz"),
                         it=lambda s: int(s.iteration[0]))
    assert resumed.x.shape == (4, 144)
    assert_states_equal(resumed, b.run(b.initial_state(), 95, 0))


@pytest.mark.parametrize("kind,split", [("pdhg", 81), ("admm", 80)])
def test_checkpoint_resume_is_exact_fused(tmp_path, kind, split):
    """The fused ROF routes (their kernels' plain versions here), split
    where a multichunk starts: 1 + 8 ri for PDHG (iteration 0 is a generic
    step), 8 ri for ADMM."""
    from prost_tpu_torch.backend import ADMMOptions, PDHGOptions
    from prost_tpu_torch.ops import FusedROFADMM, FusedROFPDHG

    prob = _rof_problem(ptt, 16, 16)
    if kind == "pdhg":
        b = FusedROFPDHG(prob, PDHGOptions(residual_iter=10), _sopts(ptt, 0))
    else:
        b = FusedROFADMM(prob, ADMMOptions(residual_iter=10), _sopts(ptt, 0))
    assert b.rof is not None
    resumed = _split_run(b, split, 200, str(tmp_path / f"{kind}.npz"))
    assert_states_equal(resumed, b.run(b.initial_state(), 200, 0))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    from prost_tpu_torch.backend import ADMMOptions, BackendADMM

    b = _pdhg()
    path = str(tmp_path / "ckpt.npz")
    save_state(path, b.initial_state())
    with pytest.raises(ValueError, match="mismatch"):
        load_state(path, {"wrong": torch.zeros(3)})
    with pytest.raises(ValueError, match="mismatch"):
        load_state(path, _pdhg(10, 12).initial_state())  # other shapes
    admm = BackendADMM(_rof_problem(ptt), ADMMOptions(), _sopts(ptt))
    with pytest.raises(ValueError, match="mismatch"):
        load_state(path, admm.initial_state())  # another class
    with pytest.raises(ValueError):
        save_state(path, {"x": torch.zeros(3)})


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    pt.set_dtype(jnp.float64)
    ptt.set_dtype(torch.float64)
    yield
    ptt.set_dtype(torch.float32)
    pt.set_dtype(jnp.float32)
    jax.config.update("jax_enable_x64", False)


def test_resumed_state_matches_jax(x64, tmp_path):
    """Both packages run 100 iterations, checkpoint, load and run on to
    200: the port's resumed state is the JAX package's (f64)."""
    from prost_tpu.backend import BackendPDHG as JBackend
    from prost_tpu.backend import PDHGOptions as JOptions
    from prost_tpu.util import load_state as jload, save_state as jsave

    jb = JBackend(_rof_problem(pt), JOptions(scale_steps_operator=False),
                  _sopts(pt))
    js = jb.run(jb.initial_state(), 100)
    jsave(str(tmp_path / "jax.npz"), js)
    js = jb.run(jload(str(tmp_path / "jax.npz"), jb.initial_state()), 200)

    ts = _split_run(_pdhg(), 100, 200, str(tmp_path / "port.npz"))
    got = interop.pdhg_state_to_numpy(ts)
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(getattr(js, k)),
                                   rtol=1e-10, atol=1e-12, err_msg=k)


def test_sharded_checkpoint_resume_is_exact(tmp_path):
    """ShardedPDHG and ShardedFusedROF on 2 gloo ranks: the state saved
    whole, loaded back onto the mesh with its placements, resumed equal to
    the straight run bit for bit."""
    from torch_spatial_worker import run_ranks

    path = str(tmp_path / "sharded.npz")
    out = run_ranks(2, {"ckpt": ("checkpoint_resume", {"path": path})},
                    str(tmp_path / "pg"))
    for rank in out:
        for name, r in rank["ckpt"].items():
            assert r["placed"], name
            for k, v in r["straight"].items():
                np.testing.assert_array_equal(r["resumed"][k], v,
                                              err_msg=f"{name}.{k}")


def test_timed_returns_ms():
    out, ms = timed(lambda x: x * 2.0, torch.ones(1000))
    torch.testing.assert_close(out, torch.full((1000,), 2.0))
    assert ms >= 0
    calls = []
    out, ms = timed(lambda: calls.append(1) or 3, warmup=2, repeats=4)
    assert out == 3 and len(calls) == 6 and ms >= 0


def test_memory_helpers_on_the_cpu():
    assert memory_stats() == {}
    assert memory_stats("cpu") == {}
    assert compiled_memory_analysis(lambda x: x @ x.T,
                                    torch.ones((64, 64))) == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(256) * 2.0
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)


def test_solver_memory_report_uses_memory_stats(capsys):
    """The Solver's report reads ``util.memory_stats``: nothing on the
    CPU."""
    from prost_tpu_torch.solver import Solver

    Solver._print_memory_report(torch.device("cpu"))
    assert "device memory" not in capsys.readouterr().out
