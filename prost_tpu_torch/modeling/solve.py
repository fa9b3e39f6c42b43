"""solve / options / backend factories (counterpart of
``prost_tpu/modeling/solve.py``; the debug eval entry points come with a
later slice)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..backend import ADMMOptions, PDHGOptions
from ..solver import Solver, SolverOptions
from .problems import _GraphProblem


@dataclasses.dataclass
class Backend:
    kind: str
    opts: object

    def create(self, problem, solver_opts):
        # FusedROFPDHG / FusedROFADMM take the fused route (CUDA kernels on
        # the card, their plain versions on the CPU) when the problem
        # structure matches; otherwise they behave exactly like
        # BackendPDHG / BackendADMM
        from ..ops import FusedROFADMM, FusedROFPDHG

        if self.kind == "pdhg":
            return FusedROFPDHG(problem, self.opts, solver_opts)
        return FusedROFADMM(problem, self.opts, solver_opts)


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

