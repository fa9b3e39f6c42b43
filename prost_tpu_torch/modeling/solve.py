"""solve / options / backend factories / debug eval entry points
(counterpart of ``prost_tpu/modeling/solve.py``; matlab/+prost/{solve.m,
options.m, +backend/pdhg.m, +backend/admm.m, get_all_variables.m,
eval_prox.m, eval_linop.m}).

The debug entry points evaluate on ``config.device()``, the card unless
the caller chose the CPU, and time with ``torch.cuda.synchronize()`` on
the card."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..backend import ADMMOptions, PDHGOptions
from ..common import to_numpy, tree_to
from ..config import device as config_device, dtype as config_dtype
from ..solver import Solver, SolverOptions
from .problems import _GraphProblem


@dataclasses.dataclass
class Backend:
    """A backend factory; ``instance`` is the backend it made last (its
    ``rof`` / ``ml`` / ``deblur`` / ``tight`` / ``vol`` say which fused
    route the solve took)."""

    kind: str
    opts: object
    instance: object = dataclasses.field(default=None, init=False,
                                         repr=False, compare=False)

    def create(self, problem, solver_opts):
        # FusedROFPDHG / FusedROFADMM take the fused route (CUDA kernels on
        # the card, their plain versions on the CPU) when the problem
        # structure matches; otherwise they behave exactly like
        # BackendPDHG / BackendADMM
        from ..ops import FusedROFADMM, FusedROFPDHG

        if self.kind == "pdhg":
            self.instance = FusedROFPDHG(problem, self.opts, solver_opts)
        else:
            self.instance = FusedROFADMM(problem, self.opts, solver_opts)
        return self.instance


def backend_pdhg(**kw) -> Backend:
    """PDHG backend with MATLAB defaults (+backend/pdhg.m)."""
    return Backend("pdhg", PDHGOptions(**kw))


def backend_admm(**kw) -> Backend:
    """Graph-projection ADMM backend with MATLAB defaults
    (+backend/admm.m)."""
    return Backend("admm", ADMMOptions(**kw))


def options(**kw) -> SolverOptions:
    """Solver options with MATLAB defaults (options.m)."""
    return SolverOptions(**kw)


def solve(problem, backend: Optional[Backend] = None,
          opts: Optional[SolverOptions] = None):
    """Finalize a modeling-layer problem, solve it, and scatter the solution
    back into the variables (solve.m).  Returns the SolverResult."""
    backend = backend or backend_pdhg()
    opts = opts or SolverOptions()
    core = problem.finalize() if isinstance(problem, _GraphProblem) else problem
    solver = Solver(core, backend.create, opts)
    result = solver.solve()
    if isinstance(problem, _GraphProblem):
        problem.fill_variables(result)
    return result


def get_all_variables(result, p_vars=(), pc_vars=(), d_vars=(), dc_vars=()):
    """Scatter a SolverResult's four vectors into variable lists
    (get_all_variables.m): x -> p_vars, z -> pc_vars, y -> d_vars,
    w -> dc_vars, each packed contiguously in list order."""
    for flat, var_list in (
        (result.x, p_vars),
        (result.z, pc_vars),
        (result.y, d_vars),
        (result.w, dc_vars),
    ):
        flat = to_numpy(flat)
        idx = 0
        for v in var_list:
            v.val = flat[idx: idx + v.dim]
            idx += v.dim


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def eval_prox(func, arg, tau=1.0, tau_diag=None, invert_tau=False):
    """Debug entry point: evaluate a function factory's prox on a host
    vector on ``config.device()``; returns (result, wall_ms of one call
    after a warm-up call) like prost.eval_prox (eval_prox.m)."""
    dev, dt = config_device(), config_dtype()
    arg = np.asarray(arg).reshape(-1)
    prox = tree_to(func(0, arg.size), dev, dt)
    arg_t = torch.as_tensor(arg, dtype=dt, device=dev)
    tau_d = (torch.ones(arg.size, dtype=dt, device=dev) if tau_diag is None
             else torch.as_tensor(np.asarray(tau_diag).reshape(-1), dtype=dt,
                                  device=dev))
    out = prox.eval_local(arg_t, tau_d, tau, invert_tau)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    out = prox.eval_local(arg_t, tau_d, tau, invert_tau)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return to_numpy(out), ms


def eval_linop(block_factories, x, adjoint=False):
    """Debug entry point: evaluate a linear operator built from a list of
    ``(block_factory, row, col, nrows, ncols)`` tuples on a host vector on
    ``config.device()``; returns (result, row_sums, col_sums, wall_ms
    averaged over 5 calls after a warm-up call) like prost.eval_linop
    (eval_linop.m).  The sums are computed on the CPU, as ``Problem.create``
    computes them."""
    from ..linop import LinearOperator

    dev, dt = config_device(), config_dtype()
    blocks = [factory(row, col, nrows, ncols)[0]
              for factory, row, col, nrows, ncols in block_factories]
    linop = LinearOperator.create(blocks)
    row_sums, col_sums = linop.row_sum(1.0), linop.col_sum(1.0)
    linop = tree_to(linop, dev)
    x = torch.as_tensor(np.asarray(x).reshape(-1), dtype=dt, device=dev)
    fn = linop.apply_adjoint if adjoint else linop.apply
    out = fn(x)  # warm-up
    _sync(dev)
    repeats = 5
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(x)
        _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / repeats
    return to_numpy(out), to_numpy(row_sums), to_numpy(col_sums), ms
