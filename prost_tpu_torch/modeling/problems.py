"""Problem graphs: min-max (saddle-point) and constrained-min forms
(counterpart of ``prost_tpu/modeling/problems.py``).

Python counterparts of matlab/+prost/min_max_problem.m and min_problem.m:
variables get contiguous indices; ``add_function`` routes a function factory
to prox_g / prox_fstar (or prox_f) by variable ownership; ``add_dual_pair``
/ ``add_constraint`` places a block at the variable pair's (row, col) with
replace-on-duplicate and size checking; ``finalize`` builds the core
Problem (zero-prox gap filling and preconditioning happen there).
"""

from __future__ import annotations

import numpy as np

from ..config import ProstError
from ..linop import LinearOperator
from ..problem import Problem


def _assign_indices(variables):
    """Assign contiguous indices to variables and their sub-variables
    (min_max_problem.m:21-66); returns the total dimension."""
    idx = 0
    for v in variables:
        v.idx = idx
        sub_idx = 0
        for sv in v.sub_vars:
            sv.idx = idx + sub_idx
            sub_idx += sv.dim
        if v.sub_vars and sub_idx != v.dim:
            raise ProstError(
                "Size of subvariables does not match size of parent variable."
            )
        idx += v.dim
    return idx


def _find(variables, var):
    """Locate var (variable or sub-variable) -> (idx, dim) or None."""
    for v in variables:
        for sv in v.sub_vars:
            if sv is var:
                return sv.idx, sv.dim
        if v is var:
            return v.idx, v.dim
    return None


def _replace_or_append(proxs, new):
    """Replace a prox covering the same index, else append
    (private/add_prox.m:1-20)."""
    for i, p in enumerate(proxs):
        if p.index == new.index:
            proxs[i] = new
            return
    proxs.append(new)


class _GraphProblem:
    """Shared machinery; subclasses define where row-side functions go."""

    _row_prox_attr: str  # "prox_fstar" (min-max) or "prox_f" (min)

    def __init__(self, primals, row_vars, scaling="alpha", scaling_alpha=1.0,
                 scaling_left=None, scaling_right=None):
        self.primal_vars = list(primals)
        self.row_vars = list(row_vars)
        self.ncols = _assign_indices(self.primal_vars)
        self.nrows = _assign_indices(self.row_vars)
        self.prox_g = []
        self.prox_f = []
        self.prox_gstar = []
        self.prox_fstar = []
        self.blocks = {}  # (row, col) -> Block
        self.scaling = scaling
        self.scaling_alpha = scaling_alpha
        self.scaling_left = scaling_left
        self.scaling_right = scaling_right

    # ------------------------------------------------------------------
    def add_function(self, var, func):
        hit = _find(self.primal_vars, var)
        if hit is not None:
            idx, dim = hit
            _replace_or_append(self.prox_g, func(idx, dim))
            return self
        hit = _find(self.row_vars, var)
        if hit is not None:
            idx, dim = hit
            _replace_or_append(getattr(self, self._row_prox_attr), func(idx, dim))
            return self
        raise ProstError("Variable not registered in problem!")

    def _add_block(self, pv, rv, block):
        p = _find(self.primal_vars, pv)
        r = _find(self.row_vars, rv)
        if p is None or r is None:
            raise ProstError("Variable pair not registered in problem.")
        col, primal_dim = p
        row, row_dim = r
        blk, sz = block(row, col, row_dim, primal_dim)
        if sz[0] != row_dim or sz[1] != primal_dim:
            raise ProstError(
                "Size of block does not fit size of variable pair: "
                f"block is {sz}, variables are ({row_dim}, {primal_dim})."
            )
        self.blocks[(row, col)] = blk  # replace-on-duplicate
        return self

    # ------------------------------------------------------------------
    def finalize(self) -> Problem:
        if not self.blocks:
            raise ProstError("Problem has no blocks (no dual pairs added).")
        # fill empty sides with the zero function (min_max_problem.m:217-227)
        from ..prox.standalone import ProxZero

        if not self.prox_g and not self.prox_gstar:
            self.prox_g.append(ProxZero(index=0, size=self.ncols))
        if not self.prox_f and not self.prox_fstar:
            getattr(self, self._row_prox_attr).append(
                ProxZero(index=0, size=self.nrows)
            )
        linop = LinearOperator.create(list(self.blocks.values()))
        if linop.nrows > self.nrows or linop.ncols > self.ncols:
            raise ProstError("Blocks exceed the variable dimensions.")
        return Problem.create(
            linop,
            prox_g=self.prox_g,
            prox_f=self.prox_f,
            prox_gstar=self.prox_gstar,
            prox_fstar=self.prox_fstar,
            nrows=self.nrows,
            ncols=self.ncols,
            scaling=self.scaling,
            scaling_alpha=self.scaling_alpha,
            scaling_left=self.scaling_left,
            scaling_right=self.scaling_right,
        )

    def _scatter(self, variables, flat):
        flat = np.asarray(flat)
        for v in variables:
            v.val = flat[v.idx : v.idx + v.dim]
            for sv in v.sub_vars:
                sv.val = flat[sv.idx : sv.idx + sv.dim]


class MinMaxProblem(_GraphProblem):
    """Saddle-point form min_x max_y g(x) + <Kx, y> - f*(y)
    (min_max_problem.m).  Functions on dual variables populate prox_fstar;
    ``add_dual_pair`` couples a primal and a dual variable through a block.
    """

    _row_prox_attr = "prox_fstar"

    def __init__(self, primals, duals, **kw):
        super().__init__(primals, duals, **kw)
        self.dual_vars = self.row_vars

    def add_dual_pair(self, pv, dv, block):
        return self._add_block(pv, dv, block)

    def fill_variables(self, result):
        """Scatter result.x into primal vars, result.y into dual vars
        (min_max_problem.m:189-215)."""
        self._scatter(self.primal_vars, result.x)
        self._scatter(self.dual_vars, result.y)


class MinProblem(_GraphProblem):
    """Constrained form min g(x) + f(z) s.t. z = Kx (min_problem.m).
    Functions on constrained variables populate prox_f; ``add_constraint``
    couples a primal and a constrained variable through a block."""

    _row_prox_attr = "prox_f"

    def __init__(self, primals, constraineds, **kw):
        super().__init__(primals, constraineds, **kw)
        self.constrained_vars = self.row_vars

    def add_constraint(self, pv, cv, block):
        return self._add_block(pv, cv, block)

    def fill_variables(self, result):
        """Scatter result.x into primal vars, result.z into constrained vars
        (min_problem.m:189-215)."""
        self._scatter(self.primal_vars, result.x)
        self._scatter(self.constrained_vars, result.z)
