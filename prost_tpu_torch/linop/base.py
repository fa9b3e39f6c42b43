"""Linear operator layer: block-structured K (counterpart of
``prost_tpu/linop/base.py``).

* A ``Block`` is a pair of functions on its local segment,
  ``apply(x_seg) -> y_seg_contribution`` and ``apply_adjoint(y_seg)``, plus
  whole-vector ``row_sum(alpha)`` / ``col_sum(alpha)`` for the Pock-Chambolle
  preconditioner.
* ``LinearOperator`` owns blocks with disjoint output rectangles (the
  overlap check runs on the host at creation) and evaluates ``y = K x`` as
  a sum of block contributions over static slices.
* ``DualLinearOperator`` is the -K^T view used by ``Problem.dualize``.
"""

from __future__ import annotations

import dataclasses

import torch

from .._native import host
from ..config import ProstError


class Block:
    """Base for blocks; subclasses are dataclasses with row/col/nrows/ncols."""

    row: int
    col: int
    nrows: int
    ncols: int

    def apply(self, x_seg):
        """K_block @ x_seg, returns (nrows,) contribution."""
        raise NotImplementedError

    def apply_adjoint(self, y_seg):
        """K_block^T @ y_seg, returns (ncols,) contribution."""
        raise NotImplementedError

    def row_sum(self, alpha: float):
        """(nrows,) vector of sum_j |K_ij|^alpha."""
        raise NotImplementedError

    def col_sum(self, alpha: float):
        """(ncols,) vector of sum_i |K_ij|^alpha."""
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class LinearOperator:
    nrows: int
    ncols: int
    blocks: tuple = ()

    @staticmethod
    def create(blocks) -> "LinearOperator":
        """Validate non-overlap and compute the bounding size."""
        blocks = tuple(blocks)
        if not blocks:
            raise ProstError("LinearOperator: no blocks.")
        hit = host.check_block_overlap(
            [b.row for b in blocks], [b.col for b in blocks],
            [b.nrows for b in blocks], [b.ncols for b in blocks],
        )
        if hit is not None:
            a, b = blocks[hit[0]], blocks[hit[1]]
            raise ProstError(
                f"LinearOperator: blocks overlap at "
                f"({a.row},{a.col}) and ({b.row},{b.col})."
            )
        nrows = max(b.row + b.nrows for b in blocks)
        ncols = max(b.col + b.ncols for b in blocks)
        return LinearOperator(nrows=nrows, ncols=ncols, blocks=blocks)

    def apply(self, x):
        """y = K x."""
        if len(self.blocks) == 1:
            b = self.blocks[0]
            if b.row == 0 and b.nrows == self.nrows:
                return b.apply(x[b.col: b.col + b.ncols])
        y = x.new_zeros(self.nrows)
        for b in self.blocks:
            y[b.row: b.row + b.nrows] += b.apply(x[b.col: b.col + b.ncols])
        return y

    def apply_adjoint(self, y):
        """x = K^T y."""
        if len(self.blocks) == 1:
            b = self.blocks[0]
            if b.col == 0 and b.ncols == self.ncols:
                return b.apply_adjoint(y[b.row: b.row + b.nrows])
        x = y.new_zeros(self.ncols)
        for b in self.blocks:
            x[b.col: b.col + b.ncols] += b.apply_adjoint(
                y[b.row: b.row + b.nrows])
        return x

    def row_sum(self, alpha: float):
        from ..config import dtype

        s = torch.zeros(self.nrows, dtype=dtype())
        for b in self.blocks:
            s[b.row: b.row + b.nrows] += b.row_sum(alpha)
        return s

    def col_sum(self, alpha: float):
        from ..config import dtype

        s = torch.zeros(self.ncols, dtype=dtype())
        for b in self.blocks:
            s[b.col: b.col + b.ncols] += b.col_sum(alpha)
        return s


@dataclasses.dataclass(eq=False)
class DualLinearOperator:
    """View representing -K^T."""

    child: LinearOperator = None

    @property
    def nrows(self):
        return self.child.ncols

    @property
    def ncols(self):
        return self.child.nrows

    @property
    def blocks(self):
        return self.child.blocks

    def apply(self, x):
        return -self.child.apply_adjoint(x)

    def apply_adjoint(self, y):
        return -self.child.apply(y)

    def row_sum(self, alpha: float):
        return self.child.col_sum(alpha)

    def col_sum(self, alpha: float):
        return self.child.row_sum(alpha)
