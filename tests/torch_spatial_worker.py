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


def blur_kernel(k):
    """tests/test_fused_deblur.py's blur: a diagonal and one corner."""
    ker = np.zeros((k, k))
    for i in range(k):
        ker[i, i] = 1.0
    ker[0, k - 1] = 0.5
    return ker / ker.sum()


def deblur_problem(nx, ny, lmb, seed, k):
    """tests/test_fused_deblur.py's ``deblur_problem`` in the port."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.modeling import block, function

    rng = np.random.RandomState(seed)
    rng.rand(nx * ny)  # the JAX model draws an unused image first
    nx2, ny2 = nx + k - 1, ny + k - 1
    u, v = ptt.Variable(nx * ny), ptt.Variable(nx2 * ny2)
    g = ptt.Variable(2 * nx * ny)
    prob = ptt.MinProblem([u], [v, g])
    prob.add_function(v, function.sum_1d("square", 1, rng.rand(nx2 * ny2),
                                         lmb))
    prob.add_function(g, function.sum_norm2(2, False, "abs"))
    prob.add_constraint(u, v, block.conv2d(nx, ny, 1, blur_kernel(k)))
    prob.add_constraint(u, g, block.gradient2d(nx, ny, 1))
    return prob.finalize()


def pair_matrix(L):
    """tests/test_fused_tight.py's ``pair_local_matrix``."""
    k = L * (L - 1) // 2
    P = np.zeros((2 * k, 2 * L))
    idx = 0
    for i in range(L):
        for j in range(i + 1, L):
            P[idx, i], P[idx, j] = 1.0, -1.0
            P[idx + k, i + L], P[idx + k, j + L] = 1.0, -1.0
            idx += 1
    return P


def tight_problem(nx, ny, L, lmb, seed):
    """tests/test_fused_tight.py's ``tight_problem`` in the port."""
    import prost_tpu_torch as ptt
    from prost_tpu_torch.modeling import block, function

    n, k = nx * ny, L * (L - 1) // 2
    f = np.random.RandomState(seed).rand(n * L)
    u, v = ptt.Variable(n * L), ptt.Variable(2 * n * k)
    q, p, s = ptt.Variable(2 * n * L), ptt.Variable(2 * n * k), ptt.Variable(n)
    prob = ptt.MinMaxProblem([u, v], [q, p, s])
    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(p, function.sum_norm2(2, False, "ind_leq0", 1 / lmb, 1,
                                            1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))
    prob.add_dual_pair(v, p, block.identity())
    prob.add_dual_pair(v, q, block.sparse_kron_id(pair_matrix(L).T, n))
    return prob.finalize()


def problem(kind):
    """The problem of each route test (tests/test_spatial_fused.py's)."""
    if kind in ("rof", "admm"):
        f = np.random.RandomState(5).rand(64 * 32).astype(np.float32)
        if kind == "admm":  # test_sharded_fused_admm_matches_single_device
            f = np.random.RandomState(17).rand(128 * 32).astype(np.float32)
            return rof_problem(128, 32, f, 8.0)
        return rof_problem(64, 32, f, 12.0)
    if kind == "admm65":  # 144 rows hold the halo of Chebyshev degree 65
        f = np.random.RandomState(19).rand(144 * 16).astype(np.float32)
        return rof_problem(144, 16, f, 8.0)
    if kind == "ml":
        return ml_problem(32, 16, 3, 0.4, 8)
    if kind == "tight":
        return tight_problem(64, 12, 3, 0.6, 9)
    if kind == "deblur":  # a blur of row reach 2, nx2 = 128
        return deblur_problem(126, 12, 25.0, 4, 3)
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

    from prost_tpu_torch.parallel import ShardedFusedDeblur, ShardedFusedTight

    cls = {"rof": ShardedFusedROF, "ml": ShardedFusedMultilabel,
           "vol": ShardedFusedVol, "tight": ShardedFusedTight,
           "deblur": ShardedFusedDeblur}[kind]
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
            "halo": b.halo, "rows": b.rows,
            "light": type(b.call).__name__}


def admm_route(world, iters, start=None, kind="admm", degree=10):
    """ShardedFusedADMM (Chebyshev of ``degree``, residual_iter 10) on
    ``problem(kind)`` from the initial state (or from the whole JAX state
    ``start`` at its iteration) to ``iters``: the gathered state and this
    rank's exchange counts."""
    from prost_tpu_torch import interop
    from prost_tpu_torch.backend import ADMMOptions
    from prost_tpu_torch.parallel import ShardedFusedADMM

    mesh = _mesh(world)
    b = ShardedFusedADMM(problem(kind),
                         ADMMOptions(residual_iter=10, projection="cheby",
                                     cheby_degree=degree),
                         solver_opts(), mesh)
    if start is None:
        state, it0 = b.initial_state(), 0
    else:
        state = interop.sharded_admm_state_from_numpy(start, mesh, "cpu")
        it0 = int(start["iteration"])
    state = b.run(state, iters, it0)
    return {"state": interop.sharded_admm_state_to_numpy(state),
            "counts": dict(b.exchange.counts), "halo": b.halo,
            "rows": b.rows}


def ensemble_problems(kind):
    """tests/test_parallel.py's dp ensembles: 8 ROF instances of 16x16
    (lmb 4 .. 48), 4 tight instances of 12x12, L = 3."""
    if kind == "rof":
        rng = np.random.RandomState(8)
        return [rof_problem(16, 16, rng.rand(256).astype(np.float32), lmb)
                for lmb in (4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0)]
    return [tight_problem(12, 12, 3, 1.0, i) for i in range(4)]


def ensemble(world, kind, iters):
    """BatchedPDHG over a dp mesh of ``world`` ranks: every instance's
    state gathered, the route taken and the flag all-reduces."""
    import torch

    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.parallel import BatchedPDHG, make_mesh

    b = BatchedPDHG(ensemble_problems(kind),
                    PDHGOptions(stepsize="boyd", residual_iter=5,
                                scale_steps_operator=False),
                    solver_opts(), make_mesh((world,), axis_names=("dp",)))
    s = b.run(b.initial_state(), iters, 0)
    state = {k: b.gather(v).numpy() for k, v in vars(s).items()}
    sol = [v.numpy() for v in b.current_solution(s)]
    return {"state": state, "solution": sol, "local": b.batch,
            "route": kind if getattr(b, kind) is not None else None,
            "flag_reduces": b.flag_reduces,
            "x_shape": tuple(torch.as_tensor(s.x).shape)}


def errors_8b(world):
    """The errors of what the deblur, tight and ADMM routes and the dp
    ensemble refuse (tests/test_spatial_fused.py:181-195, :315-323;
    tests/test_parallel.py:196-211)."""
    from prost_tpu_torch import ProstError
    from prost_tpu_torch.backend import ADMMOptions, PDHGOptions
    from prost_tpu_torch.parallel import (BatchedPDHG, ShardedFusedADMM,
                                          ShardedFusedDeblur,
                                          ShardedFusedTight, make_mesh)

    mesh = _mesh(world)
    pdhg = dict(stepsize="boyd", scale_steps_operator=False)
    f = np.random.RandomState(1).rand(64 * 32).astype(np.float32)
    cases = {
        "deblur_alg2": lambda: ShardedFusedDeblur(
            problem("deblur"), PDHGOptions(stepsize="alg2", residual_iter=2,
                                           scale_steps_operator=False),
            solver_opts(), mesh),
        "tight_reference": lambda: ShardedFusedTight(
            problem("tight"), PDHGOptions(residual_iter=2,
                                          reference_residuals=True, **pdhg),
            solver_opts(), mesh),
        # nx2 = 130 over 4 ranks
        "deblur_divisible": lambda: ShardedFusedDeblur(
            deblur_problem(128, 12, 25.0, 4, 3),
            PDHGOptions(residual_iter=2, **pdhg), solver_opts(), mesh),
        # 32 rows per rank < the halo (2 * 10 + 2) * 2 = 44 at ri 10
        "deblur_halo": lambda: ShardedFusedDeblur(
            problem("deblur"), PDHGOptions(residual_iter=10, **pdhg),
            solver_opts(), mesh),
        # 16 rows per rank < the halo 22 at ri 10
        "tight_halo": lambda: ShardedFusedTight(
            problem("tight"), PDHGOptions(residual_iter=10, **pdhg),
            solver_opts(), mesh),
        "tight_divisible": lambda: ShardedFusedTight(
            tight_problem(30, 12, 3, 0.6, 9), PDHGOptions(residual_iter=2,
                                                          **pdhg),
            solver_opts(), mesh),
        "admm_cgls": lambda: ShardedFusedADMM(
            rof_problem(64, 32, f, 8.0), ADMMOptions(projection="cgls"),
            solver_opts(), mesh),
        # 16 rows per rank < the Chebyshev halo 24 at degree 10
        "admm_halo": lambda: ShardedFusedADMM(
            rof_problem(64, 32, f, 8.0), ADMMOptions(projection="cheby"),
            solver_opts(), mesh),
        "admm_divisible": lambda: ShardedFusedADMM(
            rof_problem(66, 32, np.resize(f, 66 * 32), 8.0),
            ADMMOptions(projection="cheby", cheby_degree=2), solver_opts(),
            mesh),
        "ensemble_batch": lambda: BatchedPDHG(
            ensemble_problems("tight")[:3], mesh=make_mesh(
                (world,), axis_names=("dp",))),
    }
    out = {}
    for name, make in cases.items():
        try:
            make()
            out[name] = None
        except ProstError as e:
            out[name] = str(e)
    return out


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


def checkpoint_resume(world, path, iters=41, split=21):
    """ShardedPDHG and ShardedFusedROF on ``problem("rof")``: run to
    ``split`` (where a chunk starts), ``save_state`` to ``path`` (every
    rank calls it), load into ``initial_state()``'s layout and run on to
    ``iters``, beside a straight run; per route the gathered states of
    both and whether the loaded vectors kept the mesh's placements."""
    from torch.distributed.tensor import DTensor

    from prost_tpu_torch import interop
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.parallel import ShardedFusedROF, ShardedPDHG
    from prost_tpu_torch.util import load_state, save_state

    opts = PDHGOptions(stepsize="boyd", residual_iter=5,
                       scale_steps_operator=False)
    out = {}
    for cls in (ShardedPDHG, ShardedFusedROF):
        b = cls(problem("rof"), opts, solver_opts(), _mesh(world))
        state = b.run(b.initial_state(), split, 0)
        save_state(path, state)
        like = b.initial_state()
        loaded = load_state(path, like)
        placed = all(
            isinstance(v, DTensor) == isinstance(getattr(like, k), DTensor)
            and (not isinstance(v, DTensor)
                 or v.placements == getattr(like, k).placements)
            for k, v in vars(loaded).items())
        resumed = b.run(loaded, iters, int(loaded.iteration))
        straight = b.run(b.initial_state(), iters, 0)
        out[cls.__name__] = {
            "resumed": interop.sharded_pdhg_state_to_numpy(resumed),
            "straight": interop.sharded_pdhg_state_to_numpy(straight),
            "placed": placed}
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
