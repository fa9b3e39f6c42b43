"""TV deblurring: convolution operator + TV regularizer, two constraints.

Counterpart of the reference's example_deblurring.m:

    min_u  lmb/2 ||B u - f_blurred||^2 + ||grad u||_{2,1}

posed as a min_problem with two constrained variables v = B u (blur) and
g = grad u (example_deblurring.m:28-37).  B is the full 2D convolution
with a motion-blur kernel (``block.conv2d``; ``convmtx2`` builds the same
operator as a sparse matrix).  It takes the fused deblur route.

Usage: python -m prost_tpu_torch.examples.example_deblurring [--size N]
       [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ._common import (add_std_args, apply_linop, fixture_or_synthetic,
                      flatten_image, route_name, use_cpu)


def motion_kernel(length=9, angle_deg=45.0):
    """Simple motion-blur kernel (fspecial('motion') analog)."""
    k = np.zeros((length, length))
    c = (length - 1) / 2
    t = np.deg2rad(angle_deg)
    for i in np.linspace(-c, c, 4 * length):
        y = int(round(c + i * np.sin(t)))
        x = int(round(c + i * np.cos(t)))
        if 0 <= y < length and 0 <= x < length:
            k[y, x] = 1.0
    return k / k.sum()


def convmtx2(kernel, ny, nx):
    """Full 2D convolution matrix: (ny2*nx2) x (ny*nx), column-major
    (y fastest) layout matching flatten_image."""
    import scipy.sparse as sp

    ky, kx = kernel.shape
    ny2, nx2 = ny + ky - 1, nx + kx - 1

    def shift(nout, nin, d):
        return sp.eye(nout, nin, -d, format="csr")

    B = sp.csr_matrix((ny2 * nx2, ny * nx))
    for dy in range(ky):
        for dx in range(kx):
            w = kernel[dy, dx]
            if w:
                B = B + w * sp.kron(shift(nx2, nx, dx), shift(ny2, ny, dy))
    return B.tocsc(), ny2, nx2


def run(size=128, max_iters=25000, verbose=True, image="flowers"):
    import prost_tpu_torch as pt
    from prost_tpu_torch import block, function

    ny = nx = size
    n = nx * ny
    lmb = 100.0
    rng = np.random.RandomState(42)
    # the reference deblurs flowers.png (example_deblurring.m:3)
    f = flatten_image(fixture_or_synthetic(image, ny, nx, 1))

    kernel = motion_kernel(min(9, max(3, size // 14)))
    B, ny2, nx2 = convmtx2(kernel, ny, nx)
    f_blurred = B @ f + 0.05 * rng.randn(ny2 * nx2)

    u = pt.Variable(n)
    v = pt.Variable(ny2 * nx2)
    g = pt.Variable(2 * n)
    prob = pt.MinProblem([u], [v, g])
    prob.add_function(v, function.sum_1d("square", 1, f_blurred, lmb))
    prob.add_function(g, function.sum_norm2(2, False, "abs"))
    # the conv block instead of the reference's sparse convmtx2 matrix;
    # block.sparse(B) gives the identical operator
    prob.add_constraint(u, v, block.conv2d(nx, ny, 1, kernel))
    prob.add_constraint(u, g, block.gradient2d(nx, ny, 1))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-4, tol_rel_dual=1e-4,
        tol_abs_primal=1e-4, tol_abs_dual=1e-4,
    )
    backend = pt.backend_pdhg(stepsize="boyd", residual_iter=10)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    core = prob.finalize()
    Ku = apply_linop(core.linop, u.val)
    gv = Ku[ny2 * nx2:]
    energy = lmb / 2 * np.sum((Ku[: ny2 * nx2] - f_blurred) ** 2) + np.sum(
        np.sqrt(gv[:n] ** 2 + gv[n:] ** 2)
    )
    route = route_name(backend)
    if verbose:
        print(f"route: {route}")
        print(f"solved in {dt:.3f}s, {res.iterations} its, {res.result.value}")
        print(f"energy = {energy:.6f}")
    return {"u": u.val, "f": f, "f_blurred": f_blurred, "energy": energy,
            "iterations": res.iterations, "lmb": lmb, "kernel": kernel,
            "route": route}


def main():
    args = add_std_args(argparse.ArgumentParser()).parse_args()
    if args.cpu:
        use_cpu()
    run(size=args.size, max_iters=args.max_iters or 25000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
