"""Multi-card solving: spatial sharding and hand-scheduled halo exchange.

No reference counterpart (the reference is single-GPU); this demonstrates
the scale-out layer on one big ROF problem, its pixel rows split over the
ranks of the default process group:

1. ``ShardedPDHG``      -- the state vectors as DTensors sharded over an
                          ``sp`` mesh, the generic step on them.
2. ``ShardedFusedROF``  -- the hand-scheduled alternative: the fused halo
                          chunk kernel on each rank's band with one
                          explicit halo exchange and one 4-scalar
                          all-reduce per residual_iter chunk.

Both take the same trajectory.  ``run`` works on the ranks of the running
process group, or starts a one-rank group on ``config.device()`` when
there is none.  ``--cards N`` runs N ranks, one per card (NCCL);
``--virtual N`` runs N ranks on the CPU (gloo).

Usage: python -m prost_tpu_torch.examples.example_sharded [--size N]
       [--cards N | --virtual N] [--cpu]
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from ._common import (add_std_args, flatten_image, route_name,
                      synthetic_image, use_cpu)


def run(size=256, n_shards=None, max_iters=2000, verbose=True,
        interpret=None):
    """``n_shards``, where given, must be the process group's size.
    ``interpret`` is kept for the JAX example's signature and has no
    effect: the port has no interpret mode (on the CPU the halo chunks'
    plain versions run)."""
    import torch
    import torch.distributed as dist

    from prost_tpu_torch.config import ProstError, device

    if dist.is_initialized():
        return _on_group(size, n_shards, max_iters, verbose)
    dev = device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{os.path.join(tmp, 'pg')}", rank=0,
            world_size=1)
        try:
            return _on_group(size, n_shards, max_iters, verbose)
        finally:
            dist.destroy_process_group()


def _on_group(size, n_shards, max_iters, verbose):
    import torch.distributed as dist

    from prost_tpu_torch.config import ProstError

    world = dist.get_world_size()
    if n_shards is not None and n_shards != world:
        raise ProstError(f"example_sharded: {n_shards} shards asked for, "
                         f"the process group has {world} ranks.")
    return _solve_both(size, world, max_iters, verbose)


def _solve_both(size, n_shards, max_iters, verbose):
    import prost_tpu_torch as pt
    from prost_tpu_torch import block, function
    from prost_tpu_torch.backend.pdhg import PDHGOptions
    from prost_tpu_torch.common import to_numpy
    from prost_tpu_torch.parallel import (ShardedFusedROF, ShardedPDHG,
                                          make_mesh)
    from prost_tpu_torch.parallel.spatial import whole

    mesh = make_mesh((n_shards,), axis_names=("sp",))

    nx = ny = size
    n = nx * ny
    lmb = 16.0
    rng = np.random.RandomState(42)
    f = flatten_image(synthetic_image(ny, nx, 1)) + 0.05 * rng.randn(n)

    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, function.sum_norm2(2, False, "ind_leq0", 1, 1, 1))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))
    core = prob.finalize()

    # halo width = 2*residual_iter + 2 rows must fit in one shard;
    # shrink the chunk for small demo sizes
    ri = min(10, max(1, (nx // n_shards - 2) // 2))
    popts = PDHGOptions(stepsize="boyd", residual_iter=ri,
                        scale_steps_operator=False)
    sopts = pt.SolverOptions(verbose=False, tol_rel_primal=1e-5,
                             tol_rel_dual=1e-5, tol_abs_primal=1e-5,
                             tol_abs_dual=1e-5)

    results, routes, iters, seconds = {}, [], [], []
    for name, make in [
        ("auto (ShardedPDHG)",
         lambda: ShardedPDHG(core, popts, sopts, mesh=mesh)),
        ("halo-scheduled (ShardedFusedROF)",
         lambda: ShardedFusedROF(core, popts, sopts, mesh)),
    ]:
        backend = make()
        state = backend.initial_state()
        t0 = time.time()
        state = backend.run(state, max_iters, 0)
        it = int(state.iteration)  # host read = sync
        dt = time.time() - t0
        results[name] = to_numpy(whole(state.x))
        routes.append(route_name(backend))
        iters.append(it)
        seconds.append(dt)
        if verbose:
            print(f"route: {routes[-1]}")
            print(f"{name}: {it} its over {n_shards} shards in {dt:.3f}s "
                  f"({it / dt:.0f} it/s), "
                  f"primal res {float(state.primal_residual):.3e}")

    vals = list(results.values())
    diff = float(np.max(np.abs(vals[0] - vals[1])))
    if verbose:
        print(f"max |auto - halo| = {diff:.2e} (same algorithm, same "
              "trajectory)")
    return {"u": vals[1], "diff": diff, "n_shards": n_shards,
            "route": routes, "iterations": iters, "seconds": seconds}


def main():
    ap = add_std_args(argparse.ArgumentParser(), size=256)
    ap.add_argument("--cards", type=int, default=None,
                    help="run N ranks, one per CUDA card (NCCL)")
    ap.add_argument("--virtual", type=int, default=None,
                    help="run N ranks on the CPU (gloo)")
    args = ap.parse_args()
    kwargs = {"size": args.size, "max_iters": args.max_iters or 2000}
    if args.cards or args.virtual:
        from prost_tpu_torch.parallel.launch import run_ranks

        world = args.cards or args.virtual
        outs = run_ranks(world, run, {**kwargs, "n_shards": world},
                         device="cpu" if args.virtual else None)
        return 0 if outs[0]["diff"] < 1e-5 else 1
    if args.cpu:
        use_cpu()
    return 0 if run(**kwargs)["diff"] < 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
