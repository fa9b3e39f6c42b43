"""Concrete block types (counterpart of ``prost_tpu/linop/blocks.py``; the
part slices 3-5 need: ``BlockDiags`` and ``BlockKronId``).

A kron block's matvec is a reshaped matrix product: kron(M, I_d) x is
M @ x.reshape(c, d).  M is stored dense however it was given, as the JAX
package does: the per-pixel coupling matrices these blocks express are
small (L x L'), so the product stays a plain ``torch.matmul``.

``BlockDiags`` evaluates a banded matrix of constant diagonals as a static
sum of shifted scaled slices, in the order of its diagonals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import dtype as config_dtype
from .base import Block


@dataclasses.dataclass(eq=False)
class BlockDiags(Block):
    """Banded matrix with constant-valued diagonals (block_diags.cu).

    offsets: column offset of each diagonal; factors: the constant value on
    each diagonal.  y[r] += f_k * x[r + ofs_k]."""

    row: int
    col: int
    nrows: int
    ncols: int
    offsets: tuple = ()
    factors: torch.Tensor = None  # (ndiags,)

    @staticmethod
    def create(row, col, nrows, ncols, factors, offsets) -> "BlockDiags":
        offsets = tuple(int(o) for o in np.asarray(offsets).ravel())
        return BlockDiags(
            row=row, col=col, nrows=nrows, ncols=ncols, offsets=offsets,
            factors=torch.as_tensor(np.asarray(factors, np.float64).ravel(),
                                    dtype=config_dtype()))

    def _ranges(self):
        """Valid output-row range [r0, r1) of each diagonal."""
        for k, ofs in enumerate(self.offsets):
            r0 = max(0, -ofs)
            r1 = min(self.nrows, self.ncols - ofs)
            if r1 > r0:
                yield k, ofs, r0, r1

    def apply(self, x_seg):
        y = x_seg.new_zeros(self.nrows)
        for k, ofs, r0, r1 in self._ranges():
            y[r0:r1] += self.factors[k] * x_seg[r0 + ofs: r1 + ofs]
        return y

    def apply_adjoint(self, y_seg):
        x = y_seg.new_zeros(self.ncols)
        for k, ofs, r0, r1 in self._ranges():
            x[r0 + ofs: r1 + ofs] += self.factors[k] * y_seg[r0:r1]
        return x

    def row_sum(self, alpha: float):
        s = torch.zeros(self.nrows, dtype=config_dtype())
        for k, ofs, r0, r1 in self._ranges():
            s[r0:r1] += torch.abs(self.factors[k]) ** alpha
        return s

    def col_sum(self, alpha: float):
        s = torch.zeros(self.ncols, dtype=config_dtype())
        for k, ofs, r0, r1 in self._ranges():
            s[r0 + ofs: r1 + ofs] += torch.abs(self.factors[k]) ** alpha
        return s


@dataclasses.dataclass(eq=False)
class BlockKronId(Block):
    """K = kron(M, I_d): y.reshape(m, d) = M @ x.reshape(c, d).

    Covers the block kinds sparse_kron_id and dense_kron_id; M is
    densified."""

    row: int
    col: int
    diaglength: int
    data: torch.Tensor = None  # (m, c) dense

    @staticmethod
    def create(row, col, diaglength, matrix) -> "BlockKronId":
        if hasattr(matrix, "toarray"):
            matrix = matrix.toarray()
        m = torch.as_tensor(np.asarray(matrix), dtype=config_dtype())
        return BlockKronId(row=row, col=col, diaglength=diaglength, data=m)

    @property
    def nrows(self):
        return self.data.shape[0] * self.diaglength

    @property
    def ncols(self):
        return self.data.shape[1] * self.diaglength

    def apply(self, x_seg):
        X = x_seg.reshape(self.data.shape[1], self.diaglength)
        return (self.data @ X).reshape(-1)

    def apply_adjoint(self, y_seg):
        Y = y_seg.reshape(self.data.shape[0], self.diaglength)
        return (self.data.T @ Y).reshape(-1)

    def row_sum(self, alpha: float):
        per_row = torch.sum(torch.abs(self.data) ** alpha, dim=1)
        return torch.repeat_interleave(per_row, self.diaglength)

    def col_sum(self, alpha: float):
        per_col = torch.sum(torch.abs(self.data) ** alpha, dim=0)
        return torch.repeat_interleave(per_col, self.diaglength)
