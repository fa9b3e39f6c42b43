#!/usr/bin/env python3
"""Probe the generic solves of the linop and prox zoo on one CUDA card.

    python3 tools/zoo_probe.py        # from the root of the repository

Prints, with the card's name and power limit:

1. ``BlockSparse``'s sorted-segment sums at 512x512 (-grad^T, 1046528
   nonzeros, forward and adjoint): ``torch.segment_reduce`` on the values
   as a vector (cub's segmented reduce) and as one column (the form the
   block uses), a padded gather-sum, and cuSPARSE's CSR product (for
   comparison only), each timed with CUDA events and checked for the same
   bits on two calls;
2. the dual ROF of ``chip_smoke.py`` (config 1's ROF on ``block.sparse``,
   goldstein, residual_iter 100) after 200 (a warm-up), 2000, 4000 and
   8000 iterations:
   it/s, the energy of u, its own primal-dual gap, and the distance to
   config 1's primal solve;
3. the simplex multilabel model of ``chip_smoke.py`` after 200, 2000 and
   4000 iterations: it/s, energy, its lower bound and the distance to config
   3's fused energy.

These are the readings behind ``chip_smoke.py``'s DUAL_ROF_ITERS,
SIMPLEX_ML_RTOL and SIMPLEX_GAP_RTOL.  Without a card it exits 2.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def segment_sums(c, card):
    import torch

    import prost_tpu_torch as ptt
    from prost_tpu_torch.common import tree_to

    dev = ptt.device()
    nx = ny = c.ROF_SIZE
    n = nx * ny
    blk = tree_to(ptt.block.sparse(-c.sparse_gradient(nx, ny).T)(
        0, 0, n, 2 * n)[0], dev)
    rng = np.random.RandomState(0)
    for label, vals, idx, lens, x in (
            ("forward", blk.vals_f, blk.cols_f, blk.len_f,
             torch.as_tensor(rng.randn(2 * n), dtype=torch.float32,
                             device=dev)),
            ("adjoint", blk.vals_a, blk.rows_a, blk.len_a,
             torch.as_tensor(rng.randn(n), dtype=torch.float32,
                             device=dev))):
        prod = vals * torch.index_select(x, 0, idx)
        lens_h = lens.cpu().numpy()
        starts = np.concatenate([[0], np.cumsum(lens_h)[:-1]])
        k = np.arange(int(lens_h.max()))[None, :]
        valid = torch.as_tensor(k < lens_h[:, None], device=dev)
        pos = torch.as_tensor(np.where(k < lens_h[:, None],
                                       starts[:, None] + k, 0), device=dev)
        crow = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
        csr = torch.sparse_csr_tensor(crow, idx.long(), vals,
                                      size=(lens.numel(), x.numel()))
        forms = {
            "segment_reduce, a vector": lambda: torch.segment_reduce(
                prod, "sum", lengths=lens, unsafe=True),
            "segment_reduce, one column": lambda: torch.segment_reduce(
                prod[:, None], "sum", lengths=lens, axis=0,
                unsafe=True)[:, 0],
            "padded gather-sum": lambda: torch.where(
                valid, prod[pos], torch.zeros((), device=dev)).sum(dim=1),
            "cuSPARSE csr @ x (with the product)": lambda: csr @ x,
        }
        ref = forms["segment_reduce, one column"]()
        for name, fn in forms.items():
            a, b = fn(), fn()
            print(f"{label} {name}: {c.time_ms(fn, 50):.4f} ms, two calls "
                  f"bit-equal {torch.equal(a, b)}, max diff to the column "
                  f"form {float(torch.max(torch.abs(a - ref))):.3e} [{card}]")
        print(f"{label} gather and product: "
              f"{c.time_ms(lambda: vals * torch.index_select(x, 0, idx), 50):.4f}"
              f" ms [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("zoo_probe: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as c
    import prost_tpu_torch as ptt
    from prost_tpu_torch.backend import PDHGOptions
    from prost_tpu_torch.ops import cuda_build

    ptt.set_device("cuda:0")
    card = c.card_line()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}")
    segment_sums(c, card)

    with ThreadPoolExecutor(2) as pool:  # the two fused routes' kernels
        list(pool.map(cuda_build.load, ("fused_rof", "fused_multilabel")))
    _, e_pdhg, d_pdhg = c.phase_solve(card)
    _, e_ml = c.phase_ml_solve(card)

    nx, lmb = c.ROF_SIZE, c.ROF_LMB
    n = nx * nx
    f = c.test_image(nx, nx).reshape(-1)
    for iters in (200, 2000, 4000, 8000):  # 200: a warm-up
        backend = c.recording("pdhg", PDHGOptions(stepsize="goldstein",
                                                  residual_iter=100))
        res, backend, dt = c.run_model(
            backend, c.rof_dual_model(nx, nx, f, lmb), 2 * n, iters,
            tol=1e-7)
        uv = ptt.Variable(n)
        ptt.get_all_variables(res, (), (), (uv,), ())
        e = c.rof_energy(uv.val, f, lmb, nx, nx)
        d = c.rof_dual_energy(res.x, f, lmb, nx, nx)
        print(f"dual ROF {iters}: {c.rates(res, backend, dt)}; energy "
              f"{e:.8f}, own gap {(e - d) / e:.3e} of it, vs config 1's "
              f"{e_pdhg:.8f}: {(e - e_pdhg) / e_pdhg:+.3e} (its dual energy "
              f"{d_pdhg:.8f}) [{card}]")

    L, size = c.ML_LABELS, c.ML_SIZE
    fml = c.ml_unaries(c.cow_gray(size, size), L)
    for iters in (200, 2000, 4000):
        backend = c.recording("pdhg", PDHGOptions(stepsize="boyd",
                                                  residual_iter=10))
        res, backend, dt = c.run_model(
            backend, c.simplex_ml_model(size, size, L, fml, c.ML_LMB),
            size * size * L, iters)
        e = c.ml_energy(res.x, fml, c.ML_LMB, L, size, size)
        d = c.ml_dual_energy(res.y, fml, c.ML_LMB, L, size, size)
        print(f"simplex multilabel {iters}: {c.rates(res, backend, dt)}; "
              f"energy {e:.8f}, lower bound {d:.8f}, own gap "
              f"{(e - d) / e:.3e}, vs config 3's {e_ml:.8f}: "
              f"{(e - e_ml) / e_ml:+.3e} [{card}]")
    print(f"zoo_probe: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
