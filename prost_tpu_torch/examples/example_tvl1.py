"""TV-L1 denoising of salt & pepper noise.

Counterpart of the reference's example_tvl1.m:

    min_u  lmb ||u - f||_1 + ||grad u||_{2,1}

It takes the fused ROF route with the ``abs`` data term.

Usage: python -m prost_tpu_torch.examples.example_tvl1 [--size N] [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ._common import (add_std_args, apply_linop, fixture_or_synthetic,
                      flatten_image, route_name, use_cpu)


def run(size=128, max_iters=50000, verbose=True, image="fisch"):
    import prost_tpu_torch as pt
    from prost_tpu_torch import block, function

    ny = nx = size
    n = nx * ny
    lmb = 1.0
    rng = np.random.RandomState(42)
    # the reference runs TV-L1 on Fisch.jpg (example_tvl1.m:5)
    f = flatten_image(fixture_or_synthetic(image, ny, nx, 1))
    # salt & pepper: 25% white, 25% black (example_tvl1.m:10-14)
    pix = rng.permutation(n)
    nbad = round(0.25 * n)
    f[pix[:nbad]] = 1.0
    f[pix[nbad:2 * nbad]] = 0.0

    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("abs", 1, f, lmb))
    prob.add_function(q, function.sum_norm2(2, False, "ind_leq0", 1, 1, 1))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-7, tol_rel_dual=1e-7,
        tol_abs_primal=1e-7, tol_abs_dual=1e-7,
    )
    backend = pt.backend_pdhg(stepsize="boyd", residual_iter=10)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    core = prob.finalize()
    g = apply_linop(core.linop, u.val)
    energy = lmb * np.sum(np.abs(u.val - f)) + np.sum(
        np.sqrt(g[:n] ** 2 + g[n:] ** 2)
    )
    route = route_name(backend)
    if verbose:
        print(f"route: {route}")
        print(f"solved in {dt:.3f}s, {res.iterations} its, {res.result.value}")
        print(f"energy_pd = {energy:.6f}")
    return {"u": u.val, "f": f, "energy": energy,
            "iterations": res.iterations, "lmb": lmb, "route": route}


def main():
    args = add_std_args(argparse.ArgumentParser()).parse_args()
    if args.cpu:
        use_cpu()
    run(size=args.size, max_iters=args.max_iters or 50000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
