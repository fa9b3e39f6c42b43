"""Extending the framework with a custom prox operator and block.

The reference exposes extension hooks through custom.cpp and CMake custom
sources; here extension is plain subclassing:

* a custom prox = a dataclass subclass of ``Prox`` with ``eval_local``
* a custom block = a dataclass subclass of ``Block`` with apply /
  apply_adjoint / row_sum / col_sum
* optional: ``register_prox`` / ``register_block`` with the wire format,
  so problems that use them serialize to JSON

This example adds an elastic-net prox (lmb1 |x - f| + lmb2/2 (x - f)^2)
and a scaled-permutation block, registers both with the wire format,
solves a small denoising problem with them and rebuilds that problem from
its JSON spec.

Usage: python -m prost_tpu_torch.examples.example_custom_prox [--cpu]
"""

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from prost_tpu_torch.linop import Block
from prost_tpu_torch.prox import Prox
from prost_tpu_torch.prox.base import effective_tau

from ._common import route_name, use_cpu


@dataclasses.dataclass(eq=False)
class ProxElasticNet(Prox):
    """prox of lmb1 |x - f| + lmb2/2 (x - f)^2."""

    index: int
    size: int
    lmb1: float
    lmb2: float
    f: torch.Tensor = None

    @property
    def diagsteps(self):
        return True

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        tau = effective_tau(tau_diag, tau_scal, invert_tau)
        d = arg - self.f
        shrunk = torch.sign(d) * torch.clamp(torch.abs(d) - tau * self.lmb1,
                                             min=0.0)
        return self.f + shrunk / (1.0 + tau * self.lmb2)


@dataclasses.dataclass(eq=False)
class BlockScaledPermute(Block):
    """y = s * x[perm], a toy structured operator."""

    row: int
    col: int
    n: int
    s: float
    perm: torch.Tensor = None

    @property
    def nrows(self):
        return self.n

    @property
    def ncols(self):
        return self.n

    def apply(self, x_seg):
        return self.s * x_seg[self.perm]

    def apply_adjoint(self, y_seg):
        return self.s * torch.zeros_like(y_seg).index_add_(0, self.perm,
                                                           y_seg)

    def row_sum(self, alpha):
        from prost_tpu_torch.config import dtype

        return torch.full((self.n,), abs(self.s) ** alpha, dtype=dtype())

    def col_sum(self, alpha):
        return self.row_sum(alpha)


def register_with_wire():
    """Register both classes with the wire format (idempotent)."""
    from prost_tpu_torch.modeling import wire

    wire.register_prox(
        "elastic_net", ProxElasticNet,
        lambda p: {"lmb1": p.lmb1, "lmb2": p.lmb2, "f": wire._enc(p.f)},
        lambda idx, size, data, name: ProxElasticNet(
            index=idx, size=size, lmb1=data["lmb1"], lmb2=data["lmb2"],
            f=wire._wire_arr(data["f"])))
    wire.register_block(
        "scaled_permute", BlockScaledPermute,
        lambda b: {"n": b.n, "s": b.s, "perm": wire._enc(b.perm)},
        lambda row, col, data: BlockScaledPermute(
            row=row, col=col, n=data["n"], s=data["s"],
            perm=torch.as_tensor(np.asarray(wire._dec(data["perm"])),
                                 dtype=torch.int64)))


def run(verbose=True):
    """Solve the elastic-net model with the custom prox and block, then
    rebuild its problem from JSON; {"result", "u", "iterations",
    "wire_diff", "route"}."""
    import prost_tpu_torch as pt
    from prost_tpu_torch.config import device, dtype
    from prost_tpu_torch.modeling import wire

    register_with_wire()

    # --- use them through the modeling layer ---------------------------
    n = 256
    rng = np.random.RandomState(0)
    f = rng.rand(n).astype(np.float32)
    perm = np.argsort(rng.rand(n))

    u = pt.Variable(n)
    q = pt.Variable(n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(
        u, lambda idx, cnt: ProxElasticNet(
            index=idx, size=cnt, lmb1=0.3, lmb2=2.0,
            f=torch.as_tensor(f, dtype=dtype())))
    # dual of lmb |z|: ball indicator via built-in factory
    prob.add_function(q, pt.function.conjugate(pt.function.sum_1d("abs")))
    prob.add_dual_pair(
        u, q,
        lambda row, col, nrows, ncols: (
            BlockScaledPermute(row=row, col=col, n=n, s=0.5,
                               perm=torch.as_tensor(perm)),
            (n, n)))

    backend = pt.backend_pdhg()
    res = pt.solve(prob, backend,
                   pt.options(max_iters=2000, verbose=verbose,
                              tol_rel_primal=1e-6, tol_rel_dual=1e-6,
                              tol_abs_primal=1e-6, tol_abs_dual=1e-6))
    route = route_name(backend)

    # --- the problem through JSON and back -----------------------------
    core = prob.finalize()
    rebuilt = wire.from_spec(json.loads(json.dumps(wire.to_spec(core))))
    x = torch.as_tensor(rng.randn(n), dtype=dtype(), device=device())
    diff = float(torch.max(torch.abs(core.linop.apply(x)
                                     - rebuilt.linop.apply(x))))
    if verbose:
        print(f"route: {route}")
        print("result:", res.result.value, "| u[:4] =", u.val[:4])
        print(f"wire round trip: K applies within {diff:.1e}")
    return {"result": res.result, "u": u.val, "iterations": res.iterations,
            "wire_diff": diff, "route": route}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        use_cpu()
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
