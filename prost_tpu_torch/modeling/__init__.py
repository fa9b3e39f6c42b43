"""Modeling layer: variables, problems, function/block factories, solve
(counterpart of ``prost_tpu/modeling``, the part slices 1-2 need)."""

from . import block, function
from .problems import MinMaxProblem, MinProblem
from .solve import Backend, backend_admm, backend_pdhg, options, solve
from .variable import SubVariable, Variable

__all__ = [
    "Variable",
    "SubVariable",
    "MinMaxProblem",
    "MinProblem",
    "function",
    "block",
    "solve",
    "options",
    "Backend",
    "backend_pdhg",
    "backend_admm",
]
