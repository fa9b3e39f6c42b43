"""ROF denoising in constrained (min_problem) form, with sub-variables.

Counterpart of the reference's example_rof_primal.m:

    min_{u,g}  lmb/2 ||u - f||^2 + ||g||_{2,1}   s.t.  g = grad u

demonstrating sub-variable partitioning of the data term (the reference
splits u into three sub-variables, example_rof_primal.m:19-26).  Three
data-term proxes take it off the fused routes: the generic PDHG runs it.

Usage: python -m prost_tpu_torch.examples.example_rof_primal [--size N]
       [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ._common import (add_std_args, fixture_or_synthetic, flatten_image,
                      route_name, use_cpu)


def run(size=128, max_iters=5000, verbose=True, image="lion"):
    import prost_tpu_torch as pt
    from prost_tpu_torch import block, function

    ny = nx = size
    n = nx * ny
    lmb = 10.0
    rng = np.random.RandomState(42)
    # the reference denoises lion.png (example_rof_primal.m:3)
    f = flatten_image(fixture_or_synthetic(image, ny, nx, 1)) \
        + 0.05 * rng.randn(n)

    u = pt.Variable(n)
    g = pt.Variable(2 * n)
    # sub-variables partition u; each carries its own slice of the data term
    # (the reference uses fixed splits 100/500/rest; scale to the image)
    n1, n2 = max(1, n // 8), max(1, n // 2)
    u1 = pt.SubVariable(u, n1)
    u2 = pt.SubVariable(u, n2)
    u3 = pt.SubVariable(u, n - n1 - n2)

    prob = pt.MinProblem([u], [g])
    prob.add_function(u1, function.sum_1d("square", 1, f[:n1], lmb))
    prob.add_function(u2, function.sum_1d("square", 1, f[n1:n1 + n2], lmb))
    prob.add_function(u3, function.sum_1d("square", 1, f[n1 + n2:], lmb))
    prob.add_function(g, function.sum_norm2(2, False, "abs"))
    prob.add_constraint(u, g, block.gradient2d(nx, ny, 1))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-6, tol_rel_dual=1e-6,
        tol_abs_primal=1e-6, tol_abs_dual=1e-6,
    )
    backend = pt.backend_pdhg(stepsize="boyd", residual_iter=10)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0
    route = route_name(backend)
    if verbose:
        print(f"route: {route}")
        print(f"solved in {dt:.3f}s, {res.iterations} its, {res.result.value}")

    assert u1.val.shape == (n1,) and np.allclose(u1.val, u.val[:n1])
    return {"u": u.val, "g": g.val, "iterations": res.iterations,
            "result": res.result, "f": f, "lmb": lmb, "route": route}


def main():
    args = add_std_args(argparse.ArgumentParser()).parse_args()
    if args.cpu:
        use_cpu()
    run(size=args.size, max_iters=args.max_iters or 5000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
