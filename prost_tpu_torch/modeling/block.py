"""Block factories: each returns ``(row, col, nrows, ncols) -> (Block, sz)``
(counterpart of ``prost_tpu/modeling/block.py``: the factories slice 1
needs).  ``sz`` is the block's own (nrows, ncols), checked by the problem
against the variable pair's dimensions."""

from __future__ import annotations

from ..linop import BlockGradient2D


def gradient2d(nx, ny, L, label_first=False):
    """Forward-difference gradient, Neumann boundary (gradient2d.m)."""
    sz = (2 * nx * ny * L, nx * ny * L)
    return lambda row, col, nrows, ncols: (
        BlockGradient2D(row=row, col=col, nx=nx, ny=ny, L=L,
                        label_first=label_first), sz)
