"""ROF denoising solved with the graph-projection ADMM backend.

The ADMM counterpart of example_rof_primaldual (the reference exposes this
as the commented-out `prost.backend.admm('rho0', 15)` option in
example_tvl1.m:55 and example_multilabel_tight.m:104):

    min_{u,g}  lmb/2 ||u - f||^2 + ||g||_{2,1}   s.t.  g = grad u

A MinProblem's constrained form matches no fused ADMM route, so the
generic ADMM (CGLS projection) runs it.

Usage: python -m prost_tpu_torch.examples.example_rof_admm [--size N]
       [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ._common import (add_std_args, apply_linop, fixture_or_synthetic,
                      flatten_image, route_name, use_cpu)


def run(size=128, max_iters=1000, rho0=15.0, verbose=True,
        image="lion"):
    import prost_tpu_torch as pt
    from prost_tpu_torch import block, function

    ny = nx = size
    n = nx * ny
    lmb = 16.0
    rng = np.random.RandomState(42)
    # same observation as example_rof_primaldual (lion fixture), so the
    # ADMM-vs-PDHG energy cross-check compares the same problem
    f = flatten_image(fixture_or_synthetic(image, ny, nx, 1)) \
        + 0.05 * rng.randn(n)

    u = pt.Variable(n)
    g = pt.Variable(2 * n)
    prob = pt.MinProblem([u], [g])
    prob.add_function(u, function.sum_1d("square", 1, f, lmb))
    prob.add_function(g, function.sum_norm2(2, False, "abs"))
    prob.add_constraint(u, g, block.gradient2d(nx, ny, 1))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-6, tol_rel_dual=1e-6,
        tol_abs_primal=1e-6, tol_abs_dual=1e-6,
    )
    backend = pt.backend_admm(rho0=rho0)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    core = prob.finalize()
    gv = apply_linop(core.linop, u.val)
    energy = lmb / 2 * np.sum((u.val - f) ** 2) + np.sum(
        np.sqrt(gv[:n] ** 2 + gv[n:] ** 2)
    )
    route = route_name(backend)
    if verbose:
        print(f"route: {route}")
        print(f"solved in {dt:.3f}s, {res.iterations} its "
              f"({res.iterations / dt:.1f} it/s), {res.result.value}")
        print(f"energy = {energy:.6f}")
    return {"u": u.val, "f": f, "energy": energy, "lmb": lmb,
            "iterations": res.iterations, "result": res.result,
            "route": route}


def main():
    args = add_std_args(argparse.ArgumentParser()).parse_args()
    if args.cpu:
        use_cpu()
    run(size=args.size, max_iters=args.max_iters or 1000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
