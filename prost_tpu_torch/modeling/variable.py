"""Variables and sub-variables (counterpart of
``prost_tpu/modeling/variable.py``; matlab/+prost/variable.m, sub_variable.m).

A Variable owns `dim` contiguous entries of the flat primal or dual vector;
SubVariables partition their parent.  `idx` is assigned when the variable is
registered with a problem; `val` is filled with the solution after solve.
"""

from __future__ import annotations

import numpy as np


class Variable:
    def __init__(self, dim: int):
        self.dim = int(dim)
        self.val = np.zeros(self.dim)
        self.sub_vars: list[SubVariable] = []
        self.idx: int | None = None

    def __repr__(self):
        return f"Variable(dim={self.dim}, idx={self.idx})"


class SubVariable:
    def __init__(self, parent: Variable, dim: int):
        self.dim = int(dim)
        self.parent = parent
        self.val = np.zeros(self.dim)
        self.idx: int | None = None
        parent.sub_vars.append(self)

    def __repr__(self):
        return f"SubVariable(dim={self.dim}, idx={self.idx})"
