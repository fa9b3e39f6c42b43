"""Block factories: each returns ``(row, col, nrows, ncols) -> (Block, sz)``
(counterpart of ``prost_tpu/modeling/block.py``: the factories slices 1-3
need).  ``sz`` is the block's own (nrows, ncols), checked by the problem
against the variable pair's dimensions."""

from __future__ import annotations

from ..linop import BlockGradient2D, BlockKronId


def _shape(K):
    return int(K.shape[0]), int(K.shape[1])


def gradient2d(nx, ny, L, label_first=False):
    """Forward-difference gradient, Neumann boundary (gradient2d.m)."""
    sz = (2 * nx * ny * L, nx * ny * L)
    return lambda row, col, nrows, ncols: (
        BlockGradient2D(row=row, col=col, nx=nx, ny=ny, L=L,
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
