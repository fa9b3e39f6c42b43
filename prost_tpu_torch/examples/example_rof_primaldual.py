"""ROF image denoising, saddle-point form, solved with PDHG.

Counterpart of the reference's example_rof_primaldual.m (with the
primal-dual-gap stopping callback of example_rof_pdgap.m):

    min_u  lmb/2 ||u - f||^2 + ||grad u||_{2,1}

It takes the fused ROF route (``FusedROFPDHG``: the ROF chunk and
multichunk kernels on the card).

Usage: python -m prost_tpu_torch.examples.example_rof_primaldual
       [--size N] [--gap-tol T] [--max-iters K] [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ._common import (add_std_args, apply_linop, fixture_or_synthetic,
                      flatten_image, route_name, use_cpu)


def run(size=128, max_iters=10000, gap_tol=1e-5, verbose=True,
        image="lion"):
    import prost_tpu_torch as pt
    from prost_tpu_torch import block, function

    ny = nx = size
    n = nx * ny
    lmb = 16.0
    rng = np.random.RandomState(42)
    # the reference denoises lion.png (example_rof_primaldual.m:3)
    im = fixture_or_synthetic(image, ny, nx, 1)
    f = flatten_image(im) + 0.05 * rng.randn(n)

    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, function.conjugate(function.sum_norm2(2, False, "abs")))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))

    core = prob.finalize()
    K = core.linop

    def energies(x, y):
        """Primal and dual ROF energies (example_rof_pdgap.m:4-15)."""
        g = apply_linop(K, x)
        en_primal = lmb / 2 * np.sum((x - f) ** 2) + np.sum(
            np.sqrt(g[:n] ** 2 + g[n:] ** 2)
        )
        div = apply_linop(K, y, adjoint=True)
        en_dual = f @ div - 1 / (2 * lmb) * np.sum(div**2)
        return en_primal, en_dual

    state = {}

    def pd_gap_callback(it, x, y):
        ep, ed = energies(x, y)
        gap_per_px = (ep - ed) / n
        state["gap"] = gap_per_px
        if verbose:
            print(f"  it {it:5d}: primal={ep:.6f} dual={ed:.6f} "
                  f"gap/px={gap_per_px:.3e}")
        return gap_per_px < gap_tol

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=25, verbose=verbose,
        tol_rel_primal=0, tol_rel_dual=0,
        tol_abs_primal=0, tol_abs_dual=0,  # stop on gap only
        interm_cb=pd_gap_callback,
    )
    backend = pt.backend_pdhg(stepsize="boyd")
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    ep, ed = energies(res.x, res.y)
    route = route_name(backend)
    if verbose:
        print(f"route: {route}")
        print(f"solved in {dt:.3f}s, {res.iterations} iterations "
              f"({res.iterations / dt:.1f} it/s)")
        print(f"result: {res.result.value}, final gap/px = {(ep - ed) / n:.3e}")
    return {"u": u.val, "gap_per_px": (ep - ed) / n, "energy": ep,
            "iterations": res.iterations, "seconds": dt,
            "f": f, "lmb": lmb, "route": route}


def main():
    ap = add_std_args(argparse.ArgumentParser(), size=256)
    ap.add_argument("--gap-tol", type=float, default=1e-5)
    args = ap.parse_args()
    if args.cpu:
        use_cpu()
    out = run(size=args.size, max_iters=args.max_iters or 10000,
              gap_tol=args.gap_tol)
    return 0 if out["gap_per_px"] < args.gap_tol else 1


if __name__ == "__main__":
    sys.exit(main())
