"""ROF denoising solved through its *dual* problem.

Counterpart of the reference's example_rof_dual.m: the dual of ROF is

    min_q  I(||q||_2 <= 1) + 1/(2 lmb) ||div q + lmb f||^2 - lmb/2||f||^2

posed as a min_problem over (q, w) with w = -grad^T q, -grad^T an explicit
sparse matrix (``block.sparse``); the primal solution u is recovered from
the *dual variables of the dual problem* via get_all_variables
(example_rof_dual.m:44-49).  The generic PDHG runs it.

Usage: python -m prost_tpu_torch.examples.example_rof_dual [--size N]
       [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ._common import (add_std_args, fixture_or_synthetic, flatten_image,
                      route_name, use_cpu)


def spmat_gradient2d(nx, ny, L):
    """The forward-difference gradient as a scipy sparse matrix
    (spmat_gradient2d.m): the x differences of all labels, then the y
    differences, Neumann at the far edges."""
    import scipy.sparse as sp

    dy = sp.spdiags(
        np.vstack([np.r_[-np.ones(ny - 1), 0], np.ones(ny)]),
        [0, 1], ny, ny)
    dy = sp.kron(sp.eye(nx), dy)
    dx = sp.spdiags(
        np.vstack([np.r_[-np.ones(ny * (nx - 1)), np.zeros(ny)],
                   np.ones(nx * ny)]),
        [0, ny], nx * ny, nx * ny)
    return sp.vstack([sp.kron(sp.eye(L), dx), sp.kron(sp.eye(L), dy)]).tocsc()


def run(size=128, max_iters=20000, verbose=True, image="dog"):
    import prost_tpu_torch as pt
    from prost_tpu_torch import block, function

    ny = nx = size
    n = nx * ny
    lmb = 0.3
    rng = np.random.RandomState(42)
    # the reference's dual solve runs on dog.png (example_rof_dual.m:3)
    f = flatten_image(fixture_or_synthetic(image, ny, nx, 1)) \
        + 0.05 * rng.randn(n)

    # -grad^T as an explicit sparse matrix (the reference uses
    # prost.block.sparse(-grad'), example_rof_dual.m:22)
    grad = spmat_gradient2d(nx, ny, 1)

    q = pt.Variable(2 * n)
    w = pt.Variable(n)
    prob = pt.MinProblem([q], [w])
    # I(||q_i|| <= 1) per pixel
    prob.add_function(q, function.sum_norm2(2, False, "ind_leq0", 1, 1, 1))
    # 1/(2 lmb) || . + lmb f||^2 => sum_1d('square', 1, -lmb f, 1/lmb)
    prob.add_function(w, function.sum_1d("square", 1, -f * lmb, 1 / lmb))
    prob.add_constraint(q, w, block.sparse(-grad.T.tocsc()))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-7, tol_rel_dual=1e-7,
        tol_abs_primal=1e-7, tol_abs_dual=1e-7,
    )
    backend = pt.backend_pdhg(stepsize="goldstein", residual_iter=100)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    # primal u = dual variable y of the dual problem
    u = pt.Variable(n)
    pt.get_all_variables(res, (), (), (u,), ())
    route = route_name(backend)
    if verbose:
        print(f"route: {route}")
        print(f"solved in {dt:.3f}s, {res.iterations} its, {res.result.value}")

    g = grad @ u.val
    en_primal = lmb / 2 * np.sum((u.val - f) ** 2) + np.sum(
        np.sqrt(g[:n] ** 2 + g[n:] ** 2)
    )
    return {"u": u.val, "energy": en_primal, "f": f, "lmb": lmb,
            "iterations": res.iterations, "route": route}


def main():
    args = add_std_args(argparse.ArgumentParser()).parse_args()
    if args.cpu:
        use_cpu()
    run(size=args.size, max_iters=args.max_iters or 20000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
