"""Block factories: each returns ``(row, col, nrows, ncols) -> (Block, sz)``
(counterpart of ``prost_tpu/modeling/block.py``; matlab/+prost/+block).
``sz`` is the block's own (nrows, ncols), checked by the problem against
the variable pair's dimensions."""

from __future__ import annotations

import numpy as np

from ..linop import (BlockConv2D, BlockDense, BlockDiags, BlockGradient2D,
                     BlockGradient3D, BlockIdKron, BlockKronId, BlockSparse,
                     BlockZero)


def _shape(K):
    return int(K.shape[0]), int(K.shape[1])


def sparse(K):
    """General sparse (or dense-as-sparse) matrix block (sparse.m)."""
    m, n = _shape(K)
    return lambda row, col, nrows, ncols: (
        BlockSparse.create(row, col, m, n, K), (m, n))


def dense(K):
    """Dense matrix block (dense.m)."""
    m, n = _shape(K)
    return lambda row, col, nrows, ncols: (
        BlockDense.create(row, col, K), (m, n))


def diags(nrows, ncols, factors, offsets):
    """Banded matrix of constant diagonals (diags.m)."""
    return lambda row, col, _r, _c: (
        BlockDiags.create(row, col, nrows, ncols, factors, offsets),
        (nrows, ncols))


def identity(scal=1.0):
    """(Scaled) identity; sized by the variable pair (identity.m)."""
    return lambda row, col, nrows, ncols: (
        BlockDiags.create(row, col, nrows, ncols, [scal], [0]),
        (nrows, ncols))


def zero():
    """Structural zero block sized by the variable pair (zero.m)."""
    return lambda row, col, nrows, ncols: (
        BlockZero(row=row, col=col, nrows=nrows, ncols=ncols),
        (nrows, ncols))


def gradient2d(nx, ny, L, label_first=False):
    """Forward-difference gradient, Neumann boundary (gradient2d.m)."""
    sz = (2 * nx * ny * L, nx * ny * L)
    return lambda row, col, nrows, ncols: (
        BlockGradient2D(row=row, col=col, nx=nx, ny=ny, L=L,
                        label_first=label_first), sz)


def gradient3d(nx, ny, L, label_first=False):
    """Gradient with a Dirichlet label-axis difference (gradient3d.m)."""
    sz = (3 * nx * ny * L, nx * ny * L)
    return lambda row, col, nrows, ncols: (
        BlockGradient3D(row=row, col=col, nx=nx, ny=ny, L=L,
                        label_first=label_first), sz)


def sparse_kron_id(K, diaglength):
    """kron(K, I_diaglength) for small sparse K (sparse_kron_id.m)."""
    m, n = _shape(K)
    return lambda row, col, nrows, ncols: (
        BlockKronId.create(row, col, diaglength, K),
        (m * diaglength, n * diaglength))


def dense_kron_id(K, diaglength):
    """kron(K, I_diaglength) for dense K (dense_kron_id.m)."""
    return sparse_kron_id(K, diaglength)


def id_kron_sparse(K, ncopies):
    """kron(I_ncopies, K) for small sparse K (id_kron_sparse.m)."""
    m, n = _shape(K)
    return lambda row, col, nrows, ncols: (
        BlockIdKron.create(row, col, ncopies, K),
        (m * ncopies, n * ncopies))


def id_kron_dense(K, ncopies):
    """kron(I_ncopies, K) for dense K (id_kron_dense.m)."""
    return id_kron_sparse(K, ncopies)


def conv2d(nx, ny, L, kernel):
    """Full 2D convolution with a (ky, kx) kernel, channels independent
    (the JAX package's replacement for the reference's sparse convmtx2
    pattern, example_deblurring.m:33-37).  Output size
    (nx+kx-1)*(ny+ky-1)*L."""
    ky, kx = np.asarray(kernel).shape
    sz = ((nx + kx - 1) * (ny + ky - 1) * L, nx * ny * L)
    return lambda row, col, nrows, ncols: (
        BlockConv2D.create(row, col, nx, ny, L, kernel), sz)
