"""Batched ROF ensemble: many problem instances solved together.

The capability the single-GPU reference lacks (BASELINE config 5): B
independent ROF instances (different noisy images) solved by one
``BatchedPDHG``, whose fused route runs one batched chunk launch for all
instances.  On one card this measures batched throughput; with a process
group of several ranks the batch axis is split over a ``dp`` mesh.

Usage: python -m prost_tpu_torch.examples.example_ensemble [--size N]
       [--batch B] [--iters K] [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ._common import (add_std_args, flatten_image, route_name,
                      synthetic_image, use_cpu)


def build_problems(size, batch, lmb=16.0):
    import prost_tpu_torch as pt
    from prost_tpu_torch.linop import BlockGradient2D, LinearOperator
    from prost_tpu_torch.prox import ProxElem1D, ProxElemNorm2, ProxMoreau

    ny = nx = size
    n = nx * ny
    base = flatten_image(synthetic_image(ny, nx, 1))
    rng = np.random.RandomState(0)
    problems = []
    for _ in range(batch):
        f = (base + 0.05 * rng.randn(n)).astype(np.float32)
        grad = BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
        prox_g = [ProxElem1D(index=0, size=n, fun="square",
                             coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))]
        pn = ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                           interleaved=False, fun="abs",
                           coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
        problems.append(pt.Problem.create(
            LinearOperator.create([grad]), prox_g=prox_g,
            prox_fstar=[ProxMoreau(index=0, size=2 * n, child=pn)]))
    return problems


def run(size=64, batch=16, iters=500, verbose=True):
    import torch.distributed as dist

    import prost_tpu_torch as pt
    from prost_tpu_torch.backend.pdhg import PDHGOptions
    from prost_tpu_torch.common import to_numpy
    from prost_tpu_torch.parallel import BatchedPDHG, make_mesh

    problems = build_problems(size, batch)
    mesh = None
    ndev = dist.get_world_size() if dist.is_initialized() else 1
    if ndev > 1 and batch % ndev == 0:
        mesh = make_mesh((ndev,), axis_names=("dp",))

    solver = BatchedPDHG(
        problems,
        PDHGOptions(stepsize="boyd", residual_iter=10,
                    scale_steps_operator=False),
        pt.SolverOptions(verbose=False, tol_rel_primal=0, tol_rel_dual=0,
                         tol_abs_primal=0, tol_abs_dual=0),
        mesh=mesh,
    )
    state = solver.initial_state()
    state = solver.run(state, 10, 0)
    assert int(state.iteration[0]) == 10  # sync + sanity

    t0 = time.perf_counter()
    state = solver.run(state, 10 + iters, 10)
    done = int(state.iteration[0])  # host read = sync
    dt = time.perf_counter() - t0
    assert done == 10 + iters

    inst_iters_per_sec = batch * iters / dt
    route = route_name(solver)
    if verbose:
        print(f"route: {route}")
        print(f"{batch} instances x {iters} iterations in {dt:.3f}s")
        print(f"batched throughput: {inst_iters_per_sec:,.0f} "
              f"instance-iterations/s "
              f"({'split over ' + str(ndev) + ' ranks' if mesh else '1 device'})")
    x, z, y, w = solver.current_solution(state)
    return {"x": to_numpy(x), "throughput": inst_iters_per_sec,
            "devices": ndev if mesh else 1, "route": route}


def main():
    ap = add_std_args(argparse.ArgumentParser(), size=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=500)
    args = ap.parse_args()
    if args.cpu:
        use_cpu()
    run(size=args.size, batch=args.batch, iters=args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
