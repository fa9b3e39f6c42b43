"""Concrete block types: sparse, dense, diags, kron variants, zero
(counterpart of ``prost_tpu/linop/blocks.py``).

``BlockSparse`` keeps two sorted COO copies, row-sorted for the forward
apply and column-sorted for the adjoint, both sorted on the host by the
native runtime (``host.coo_sort_perm``), and evaluates a gather, a product
and a sum over each sorted segment (``torch.segment_reduce`` with the
segments' lengths, in order).  Each output is one segment's sum in a fixed order, so
two applies give the same bits on the card as on the CPU; a scatter-add
(``index_add_``) would sum with atomics in no fixed order there.

A kron block's matvec is a reshaped matrix product: kron(M, I_d) x is
M @ x.reshape(c, d), and kron(I_n, M) x is x.reshape(n, c) @ M^T.  M is
stored dense however it was given, as the JAX package does: the per-pixel
coupling matrices these blocks express are small (L x L'), so the product
stays a plain ``torch.matmul``, as does ``BlockDense``'s.

``BlockDiags`` evaluates a banded matrix of constant diagonals as a static
sum of shifted scaled slices, in the order of its diagonals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import dtype as config_dtype
from .base import Block


def _as_coo(matrix):
    """Accept scipy.sparse, a dense array, or a (rows, cols, vals) triple;
    return numpy COO arrays."""
    if isinstance(matrix, tuple) and len(matrix) == 3:
        r, c, v = matrix
        return np.asarray(r), np.asarray(c), np.asarray(v)
    if hasattr(matrix, "tocoo"):
        coo = matrix.tocoo()
        return coo.row, coo.col, coo.data
    m = np.asarray(matrix)
    r, c = np.nonzero(m)
    return r, c, m[r, c]


def _segment_sum(values, lengths):
    """Sum of each run of ``values`` whose lengths are ``lengths`` (empty
    runs give 0), left to right within a run.  The values go in as one
    column: on the card that takes ``segment_reduce``'s kernel with a
    thread a run, summing in order (the 1-D form takes cub's segmented
    reduce, a thread block a run, 4-10x slower on the short runs of a
    sparse operator)."""
    return torch.segment_reduce(values[:, None], "sum", lengths=lengths,
                                axis=0, unsafe=True)[:, 0]


@dataclasses.dataclass(eq=False)
class BlockSparse(Block):
    """General sparse matrix block (block_sparse.cu)."""

    row: int
    col: int
    nrows: int
    ncols: int
    # row-sorted COO (forward) and col-sorted COO (adjoint), with the
    # length of each row's (column's) run
    rows_f: torch.Tensor = None
    cols_f: torch.Tensor = None
    vals_f: torch.Tensor = None
    len_f: torch.Tensor = None   # (nrows,)
    rows_a: torch.Tensor = None
    cols_a: torch.Tensor = None
    vals_a: torch.Tensor = None
    len_a: torch.Tensor = None   # (ncols,)

    @staticmethod
    def create(row, col, nrows, ncols, matrix) -> "BlockSparse":
        from .._native import host

        r, c, v = _as_coo(matrix)
        r = np.ascontiguousarray(r, np.int32)
        c = np.ascontiguousarray(c, np.int32)
        v = np.asarray(v, np.float64)
        fwd = host.coo_sort_perm(r, c)
        adj = host.coo_sort_perm(c, r)
        dt = config_dtype()

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)

        return BlockSparse(
            row=row, col=col, nrows=nrows, ncols=ncols,
            rows_f=t(r[fwd]), cols_f=t(c[fwd]), vals_f=t(v[fwd], dt),
            len_f=t(np.bincount(r, minlength=nrows).astype(np.int64)),
            rows_a=t(r[adj]), cols_a=t(c[adj]), vals_a=t(v[adj], dt),
            len_a=t(np.bincount(c, minlength=ncols).astype(np.int64)),
        )

    def apply(self, x_seg):
        prod = self.vals_f * torch.index_select(x_seg, 0, self.cols_f)
        return _segment_sum(prod, self.len_f)

    def apply_adjoint(self, y_seg):
        prod = self.vals_a * torch.index_select(y_seg, 0, self.rows_a)
        return _segment_sum(prod, self.len_a)

    def row_sum(self, alpha: float):
        return _segment_sum(torch.abs(self.vals_f) ** alpha, self.len_f)

    def col_sum(self, alpha: float):
        return _segment_sum(torch.abs(self.vals_a) ** alpha, self.len_a)


@dataclasses.dataclass(eq=False)
class BlockDense(Block):
    """Dense matrix block (block_dense.cu): a plain matrix product."""

    row: int
    col: int
    nrows: int
    ncols: int
    data: torch.Tensor = None  # (nrows, ncols)

    @staticmethod
    def create(row, col, matrix) -> "BlockDense":
        m = torch.as_tensor(np.asarray(matrix), dtype=config_dtype())
        return BlockDense(row=row, col=col, nrows=m.shape[0],
                          ncols=m.shape[1], data=m)

    def apply(self, x_seg):
        return self.data @ x_seg

    def apply_adjoint(self, y_seg):
        return self.data.T @ y_seg

    def row_sum(self, alpha: float):
        return torch.sum(torch.abs(self.data) ** alpha, dim=1)

    def col_sum(self, alpha: float):
        return torch.sum(torch.abs(self.data) ** alpha, dim=0)


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


@dataclasses.dataclass(eq=False)
class BlockIdKron(Block):
    """K = kron(I_n, M): y.reshape(n, m) = x.reshape(n, c) @ M^T.

    Covers the block kinds id_kron_sparse and id_kron_dense; M is
    densified."""

    row: int
    col: int
    ncopies: int
    data: torch.Tensor = None  # (m, c) dense

    @staticmethod
    def create(row, col, ncopies, matrix) -> "BlockIdKron":
        if hasattr(matrix, "toarray"):
            matrix = matrix.toarray()
        m = torch.as_tensor(np.asarray(matrix), dtype=config_dtype())
        return BlockIdKron(row=row, col=col, ncopies=ncopies, data=m)

    @property
    def nrows(self):
        return self.data.shape[0] * self.ncopies

    @property
    def ncols(self):
        return self.data.shape[1] * self.ncopies

    def apply(self, x_seg):
        X = x_seg.reshape(self.ncopies, self.data.shape[1])
        return (X @ self.data.T).reshape(-1)

    def apply_adjoint(self, y_seg):
        Y = y_seg.reshape(self.ncopies, self.data.shape[0])
        return (Y @ self.data).reshape(-1)

    def row_sum(self, alpha: float):
        per_row = torch.sum(torch.abs(self.data) ** alpha, dim=1)
        return per_row.repeat(self.ncopies)

    def col_sum(self, alpha: float):
        per_col = torch.sum(torch.abs(self.data) ** alpha, dim=0)
        return per_col.repeat(self.ncopies)


@dataclasses.dataclass(eq=False)
class BlockZero(Block):
    """Structural zero block (block_zero.cu)."""

    row: int
    col: int
    nrows: int
    ncols: int

    def apply(self, x_seg):
        return x_seg.new_zeros(self.nrows)

    def apply_adjoint(self, y_seg):
        return y_seg.new_zeros(self.ncols)

    def row_sum(self, alpha: float):
        return torch.zeros(self.nrows, dtype=config_dtype())

    def col_sum(self, alpha: float):
        return torch.zeros(self.ncols, dtype=config_dtype())
