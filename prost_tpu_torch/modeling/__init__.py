"""Modeling layer: variables, problems, function/block factories, solve
(counterpart of ``prost_tpu/modeling``, the part slice 1 needs)."""

from . import block, function
from .problems import MinMaxProblem, MinProblem
from .solve import Backend, backend_pdhg, options, solve
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
]
