"""Concrete block types (counterpart of ``prost_tpu/linop/blocks.py``; the
part slice 3 needs: ``BlockKronId``).

A kron block's matvec is a reshaped matrix product: kron(M, I_d) x is
M @ x.reshape(c, d).  M is stored dense however it was given, as the JAX
package does: the per-pixel coupling matrices these blocks express are
small (L x L'), so the product stays a plain ``torch.matmul``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import dtype as config_dtype
from .base import Block


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
