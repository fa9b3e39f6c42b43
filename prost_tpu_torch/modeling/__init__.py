"""Modeling layer: variables, problems, function/block factories, solve,
the debug entry points and the JSON wire format (``wire``), the
counterpart of ``prost_tpu/modeling``."""

from . import block, function, wire
from .problems import MinMaxProblem, MinProblem
from .solve import (
    Backend,
    backend_admm,
    backend_pdhg,
    eval_linop,
    eval_prox,
    get_all_variables,
    options,
    solve,
)
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
    "eval_prox",
    "eval_linop",
    "get_all_variables",
    "wire",
]
