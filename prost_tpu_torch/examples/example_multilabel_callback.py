"""Multilabel segmentation with per-iteration solution visualization.

Counterpart of the reference's example_multilabel_callback.m (used by
example_multilabel_fast.m:62 and example_multilabel_tight.m:105): an
interm callback that, at every callback epoch, maps the raw primal
iterate back into the labeling variable with ``get_all_variables``,
renders the current soft segmentation next to the input image, and
returns an ``is_converged`` flag the solver honors.

The reference calls ``imshow([im, u])``; headless here, each epoch's
side-by-side panel is written to ``--out-dir`` as a PNG (plus a one-line
progress print, the callback's ``fprintf``).  Passing --stop-at-gap
additionally demonstrates callback-forced convergence: the callback
computes the per-pixel label-sum violation and returns True below the
threshold, ending the solve early like the pd-gap callback in
example_rof_primaldual.  The callback epochs fall on chunk boundaries, so
the solve takes the fused multilabel route.

Usage: python -m prost_tpu_torch.examples.example_multilabel_callback
       [--size N] [--labels L] [--out-dir DIR] [--image cow|junction_gray]
       [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

from ._common import (add_std_args, load_fixture_image, route_name,
                      synthetic_image, use_cpu, write_png)
from .example_multilabel_fast import unaries


def run(size=64, L=8, max_iters=2000, verbose=True, image="cow",
        out_dir=None, stop_at_violation=None):
    import prost_tpu_torch as pt
    from prost_tpu_torch import block, function
    from prost_tpu_torch.modeling import get_all_variables

    ny = nx = size
    n = nx * ny
    lmb = 0.5
    if image is not None:
        im = load_fixture_image(image, size=size)[..., None]
    else:
        im = synthetic_image(ny, nx, 1)
    f = unaries(im, L)

    u = pt.Variable(n * L)
    q = pt.Variable(2 * n * L)
    s = pt.Variable(n)
    prob = pt.MinMaxProblem([u], [q, s])
    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(q, function.sum_norm2(2 * L, False, "ind_leq0",
                                            1 / lmb, 1, 1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))

    gray = im[..., 0]  # (ny, nx)
    panels = []

    def interm_cb(it, x, y):
        """The example_multilabel_callback.m port: scatter (x, y) back
        into the modeling variables, render [input | argmax labeling],
        optionally force convergence on small constraint violation."""
        uu = pt.Variable(n * L)
        res = type("R", (), {"x": x, "y": y, "z": None, "w": None})()
        get_all_variables(res, [uu], [], [], [])
        lab = uu.val.reshape(L, nx, ny)           # label-outermost layout
        soft = lab.transpose(2, 1, 0)             # (ny, nx, L)
        seg = np.argmax(soft, axis=-1) / max(L - 1, 1)
        panel = np.concatenate([gray, seg], axis=1)
        violation = float(np.abs(soft.sum(-1) - 1.0).max())
        if verbose:
            print(f"  cb it={it}: label-sum violation {violation:.3e}")
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            write_png(os.path.join(out_dir, f"iter_{it:06d}.png"),
                      (np.clip(panel, 0, 1) * 255 + 0.5).astype(np.uint8))
        panels.append((it, panel))
        return (stop_at_violation is not None
                and violation < stop_at_violation)

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-5, tol_rel_dual=1e-5,
        tol_abs_primal=1e-5, tol_abs_dual=1e-5,
        interm_cb=interm_cb,
    )
    backend = pt.backend_pdhg(stepsize="boyd", residual_iter=10)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0
    route = route_name(backend)
    if verbose:
        print(f"route: {route}")
        print(f"solved in {dt:.3f}s, {res.iterations} its, "
              f"{res.result.value}; {len(panels)} callback panels")
    return {"u": u.val, "panels": panels, "iterations": res.iterations,
            "result": res.result, "route": route}


def main():
    ap = add_std_args(argparse.ArgumentParser(), size=64)
    ap.add_argument("--labels", type=int, default=8)
    ap.add_argument("--image", type=str, default="cow")
    ap.add_argument("--out-dir", type=str, default=None,
                    help="write per-epoch [input|labeling] PNG panels here")
    ap.add_argument("--stop-at-gap", type=float, default=None,
                    help="force convergence when the per-pixel label-sum "
                         "violation drops below this")
    args = ap.parse_args()
    if args.cpu:
        use_cpu()
    image = None if args.image == "synthetic" else args.image
    run(size=args.size, L=args.labels, max_iters=args.max_iters or 2000,
        image=image, out_dir=args.out_dir,
        stop_at_violation=args.stop_at_gap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
