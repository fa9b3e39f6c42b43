"""One rank of the port's spatially sharded runs for
tests/test_torch_spatial.py (not collected: it imports no ``jax``, so a
rank process started with the spawn method never loads it).

``run_ranks`` starts ``world`` rank processes on a gloo group that meets
through a file, runs the same jobs on every rank and returns each rank's
results; a rank that fails or hangs fails the call.  Each job is a
function of this module named in the job list with its keyword arguments;
the problems are made here from numpy seeds, the same as the JAX tests'.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import traceback
from datetime import timedelta

import numpy as np

# seconds for the whole group, and for the gloo group's collectives
GROUP_TIMEOUT_S = 240
PG_TIMEOUT_S = 60


# ---------------------------------------------------------------------------
# problems (the JAX tests' models, in the port)
# ---------------------------------------------------------------------------

def rof_problem(nx, ny, f, lmb):
    """tests/test_fused_rof.py's ``rof_problem`` in the port."""
    import prost_tpu_torch as ptt

    n = nx * ny
    grad = ptt.linop.BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    prox_g = [ptt.prox.ProxElem1D(index=0, size=n, fun="square",
                                  coeffs=(1.0, f.astype(np.float32), lmb,
                                          0.0, 0.0, 0.0, 0.0))]
    pn = ptt.prox.ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                                interleaved=False, fun="abs",
                                coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    return ptt.Problem.create(
        ptt.linop.LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[ptt.prox.ProxMoreau(index=0, size=2 * n, child=pn)])


def ml_problem(nx, ny, L, lmb, seed):
    """tests/test_fused_multilabel.py's ``ml_problem`` in the port."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.modeling import block, function

    n = nx * ny
    f = np.random.RandomState(seed).rand(n * L).astype(np.float32)
    u, q, s = ptt.Variable(n * L), ptt.Variable(2 * n * L), ptt.Variable(n)
    prob = ptt.MinMaxProblem([u], [q, s])
    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(q, function.sum_norm2(2 * L, False, "ind_leq0",
                                            1 / lmb, 1, 1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))
    return prob.finalize()


def vol_problem(L, nx, ny, f, lmb):
    """tests/test_fused_vol.py's ``vol_problem`` in the port."""
    import prost_tpu_torch as ptt

    n = L * nx * ny
    grad = ptt.linop.BlockGradient3D(row=0, col=0, nx=nx, ny=ny, L=L)
    prox_g = [ptt.prox.ProxElem1D(index=0, size=n, fun="square",
                                  coeffs=(1.0, f.astype(np.float32), lmb,
                                          0.0, 0.0, 0.0, 0.0))]
    pn = ptt.prox.ProxElemNorm2(index=0, size=3 * n, count=n, dim=3,
                                interleaved=False, fun="abs",
                                coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    return ptt.Problem.create(
        ptt.linop.LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[ptt.prox.ProxMoreau(index=0, size=3 * n, child=pn)])


def problem(kind):
    """The problem of each route test (tests/test_spatial_fused.py's)."""
    if kind == "rof":
        f = np.random.RandomState(5).rand(64 * 32).astype(np.float32)
        return rof_problem(64, 32, f, 12.0)
    if kind == "ml":
        return ml_problem(32, 16, 3, 0.4, 8)
    f = np.random.RandomState(23).rand(3 * 64 * 16).astype(np.float32)
    return vol_problem(3, 64, 16, f, 6.0)


def solver_opts(**kw):
    import prost_tpu_torch as ptt

    kw.setdefault("verbose", False)
    for k in ("tol_rel_primal", "tol_rel_dual", "tol_abs_primal",
              "tol_abs_dual"):
        kw.setdefault(k, 0.0)
    return ptt.SolverOptions(**kw)


# ---------------------------------------------------------------------------
# jobs: each runs on every rank and returns picklable results
# ---------------------------------------------------------------------------

def _mesh(world):
    from prost_tpu_torch.parallel import make_mesh

    return make_mesh((world,), axis_names=("sp",))


def route(world, kind, ri, iters, start=None):
    """A halo route on ``problem(kind)`` from the initial state (or from
    the whole JAX state ``start`` at its iteration) to ``iters``: the
    gathered state and this rank's exchange counts."""
    from prost_tpu_torch import interop
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.parallel import (ShardedFusedMultilabel,
                                          ShardedFusedROF, ShardedFusedVol)

    cls = {"rof": ShardedFusedROF, "ml": ShardedFusedMultilabel,
           "vol": ShardedFusedVol}[kind]
    opts = PDHGOptions(stepsize="boyd", residual_iter=ri,
                       scale_steps_operator=False)
    mesh = _mesh(world)
    b = cls(problem(kind), opts, solver_opts(), mesh)
    if start is None:
        state, it0 = b.initial_state(), 0
    else:
        state = interop.sharded_pdhg_state_from_numpy(start, mesh, "cpu")
        it0 = int(start["iteration"])
    state = b.run(state, iters, it0)
    return {"state": interop.sharded_pdhg_state_to_numpy(state),
            "counts": dict(b.exchange.counts),
            "halo": b.halo, "rows": b.rows}


def sharded_pdhg(world, iters):
    """``ShardedPDHG`` on tests/test_parallel.py's 16x16 ROF problem."""
    from prost_tpu_torch import interop
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.parallel import ShardedPDHG

    f = np.random.RandomState(2).rand(256).astype(np.float32)
    tols = {k: 1e-6 for k in ("tol_rel_primal", "tol_rel_dual",
                              "tol_abs_primal", "tol_abs_dual")}
    b = ShardedPDHG(rof_problem(16, 16, f, 5.0),
                    PDHGOptions(scale_steps_operator=False),
                    solver_opts(**tols), _mesh(world))
    state = b.initial_state()
    placements = str(state.x.placements)
    state = b.run(state, iters, 0)
    return {"state": interop.sharded_pdhg_state_to_numpy(state),
            "placements": placements,
            "local": int(state.x.to_local().numel())}


def solve(world):
    """A full solve through the Solver with ShardedFusedROF
    (tests/test_spatial_fused.py's), beside the one-process fused solve."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.ops import FusedROFPDHG
    from prost_tpu_torch.parallel import ShardedFusedROF

    f = np.random.RandomState(6).rand(32 * 32).astype(np.float32)
    prob = rof_problem(32, 32, f, 8.0)
    popts = PDHGOptions(stepsize="boyd", residual_iter=3,
                        scale_steps_operator=False)
    sopts = solver_opts(max_iters=3000, tol_rel_primal=1e-5,
                        tol_rel_dual=1e-5, tol_abs_primal=1e-5,
                        tol_abs_dual=1e-5)
    mesh = _mesh(world)
    res = ptt.Solver(prob, lambda p, o: ShardedFusedROF(p, popts, o, mesh),
                     sopts).solve()
    one = ptt.Solver(prob, lambda p, o: FusedROFPDHG(p, popts, o),
                     sopts).solve()
    return {"result": res.result.value, "iterations": res.iterations,
            "x": res.x, "one_result": one.result.value,
            "one_iterations": one.iterations, "one_x": one.x}


def geometry(world):
    """The errors of a geometry the halo routes refuse, and of meshes that
    do not fit the group."""
    from prost_tpu_torch import ProstError
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.parallel import ShardedFusedROF, make_mesh

    f = np.random.RandomState(7).rand(24 * 24).astype(np.float32)
    prob = rof_problem(24, 24, f, 8.0)
    mesh = _mesh(world)
    out = {}
    for name, ri in (("halo", 10), ("ok", 1)):
        try:
            ShardedFusedROF(prob, PDHGOptions(residual_iter=ri,
                                              scale_steps_operator=False),
                            solver_opts(), mesh)
            out[name] = None
        except ProstError as e:
            out[name] = str(e)
    f = np.random.RandomState(7).rand(30 * 24).astype(np.float32)
    try:
        ShardedFusedROF(rof_problem(30, 24, f, 8.0),
                        PDHGOptions(residual_iter=1,
                                    scale_steps_operator=False),
                        solver_opts(), mesh)
        out["divisible"] = None
    except ProstError as e:
        out["divisible"] = str(e)
    for name, shape, dev in (("too_many", (world + 1,), None),
                             ("backend", (world,), "cuda")):
        try:
            make_mesh(shape, axis_names=("sp",), device_type=dev)
            out[name] = None
        except (ValueError, ProstError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


# ---------------------------------------------------------------------------
# the rank process and its launcher
# ---------------------------------------------------------------------------

def rank_main(rank, world, init_file, jobs, results):
    """One rank: join the gloo group, run ``jobs`` ({name: (function,
    kwargs)}) in order, put (rank, {name: result}, None) or (rank, None,
    traceback) on ``results``."""
    import torch
    import torch.distributed as dist

    import prost_tpu_torch as ptt

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=timedelta(seconds=PG_TIMEOUT_S))
        ptt.set_device("cpu")
        out = {name: globals()[fn](world, **kw)
               for name, (fn, kw) in jobs.items()}
        results.put((rank, out, None))
    except Exception:  # the parent reports the rank's traceback
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world, jobs, init_file):
    """Run ``jobs`` on ``world`` spawned gloo ranks; returns each rank's
    results, a list indexed by rank.  Raises if a rank fails or the group
    does not finish within GROUP_TIMEOUT_S; every rank process is gone
    when it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, init_file, jobs, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in range(world):
            rank, out, err = results.get(timeout=GROUP_TIMEOUT_S)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            got[rank] = out
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(got))} gave "
                      f"no result within {GROUP_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(world)]
