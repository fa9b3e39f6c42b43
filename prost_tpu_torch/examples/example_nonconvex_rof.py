"""Nonconvex ROF: Mumford-Shah (truncated quadratic) regularizer.

Counterpart of the reference's example_nonconvex_rof.m:

    min_u  1/2 ||u - f||^2 + sum_i min(alpha ||grad u_i||^2, lambda)

solved with the accelerated (alg2) PDHG and the conjugate of the truncquad
norm2 function (the nonconvex prox is handled pointwise in closed form).
alg2 changes its steps every iteration, so the generic PDHG runs it.

Usage: python -m prost_tpu_torch.examples.example_nonconvex_rof
       [--size N] [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ._common import (add_std_args, apply_linop, fixture_or_synthetic,
                      flatten_image, route_name, use_cpu)


def run(size=128, max_iters=2000, verbose=True, image="house"):
    import prost_tpu_torch as pt
    from prost_tpu_torch import block, function

    ny = nx = size
    n = nx * ny
    rng = np.random.RandomState(42)
    # piecewise-constant subject (house-facade fixture): the class of
    # image truncated-quadratic regularizers are built for
    f = flatten_image(fixture_or_synthetic(image, ny, nx, 1)) \
        + 0.05 * rng.randn(n)

    lam, alpha = 0.05, 30.0

    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", 1, f, 1))
    prob.add_function(q, function.conjugate(
        function.sum_norm2(2, False, "truncquad", 1, 0, 1, 0, 0, alpha, lam)
    ))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        x0=np.zeros(n),
    )
    backend = pt.backend_pdhg(stepsize="alg2", residual_iter=10,
                              alg2_gamma=0.25)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    core = prob.finalize()
    g = apply_linop(core.linop, u.val)
    gn2 = g[:n] ** 2 + g[n:] ** 2
    energy = 0.5 * np.sum((u.val - f) ** 2) + np.sum(
        np.minimum(alpha * gn2, lam)
    )
    route = route_name(backend)
    if verbose:
        print(f"route: {route}")
        print(f"solved in {dt:.3f}s, {res.iterations} its, {res.result.value}")
        print(f"Mumford-Shah energy = {energy:.6f}")
    return {"u": u.val, "f": f, "energy": energy,
            "iterations": res.iterations, "route": route}


def main():
    args = add_std_args(argparse.ArgumentParser()).parse_args()
    if args.cpu:
        use_cpu()
    run(size=args.size, max_iters=args.max_iters or 2000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
