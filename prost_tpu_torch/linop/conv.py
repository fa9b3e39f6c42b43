"""2D convolution block (counterpart of ``prost_tpu/linop/conv.py``).

    apply(u)          = full 2D convolution of each channel with the kernel:
                        (nx, ny) -> (nx2, ny2) = (nx + kx - 1, ny + ky - 1)
    apply_adjoint(v)  = valid cross-correlation with the same kernel

Channels (L) convolve independently (kron(I_L, B) semantics).  The kernel
is given (ky, kx) in image convention and stored transposed to (kx, ky),
because the plane view is (x, y) with y fastest (flat index
y + ny*x + nx*ny*c), as in the JAX package.

The JAX package computes these with ``lax.conv`` outside any kernel; here
``torch.nn.functional.conv2d`` does.  On the card cuDNN would run a float32
convolution in TF32 by default (``torch.backends.cudnn.allow_tf32``), which
rounds to a 10-bit mantissa; every convolution of this block runs in full
float32, with TF32 switched off for the call only.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..config import dtype as config_dtype
from .base import Block


@contextlib.contextmanager
def _full_f32():
    """cuDNN convolutions in full float32 inside the block, the global
    switch put back after."""
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = old


def _conv(img, kernel, pad):
    """Cross-correlation of each (H, W) plane of ``img`` (L, H, W) with the
    2D ``kernel``, zero padding ``pad`` = (rows, cols) on both sides."""
    with _full_f32():
        out = F.conv2d(img[:, None], kernel[None, None].to(img.dtype),
                       padding=pad)
    return out[:, 0]


@dataclasses.dataclass(eq=False)
class BlockConv2D(Block):
    row: int
    col: int
    nx: int
    ny: int
    L: int
    kx: int
    ky: int
    kernel: torch.Tensor = None  # (kx, ky)

    @staticmethod
    def create(row, col, nx, ny, L, kernel) -> "BlockConv2D":
        """``kernel`` is (ky, kx) in image convention; it is stored
        transposed to (kx, ky)."""
        k = torch.as_tensor(np.asarray(kernel).T.copy(), dtype=config_dtype())
        return BlockConv2D(row=row, col=col, nx=nx, ny=ny, L=L,
                           kx=k.shape[0], ky=k.shape[1], kernel=k)

    @property
    def nx2(self):
        return self.nx + self.kx - 1

    @property
    def ny2(self):
        return self.ny + self.ky - 1

    @property
    def nrows(self):
        return self.nx2 * self.ny2 * self.L

    @property
    def ncols(self):
        return self.nx * self.ny * self.L

    def _full(self, u, kernel):
        # full convolution: the flipped kernel, the input padded by k - 1
        return _conv(u, torch.flip(kernel, (0, 1)), (self.kx - 1, self.ky - 1))

    def apply(self, x_seg):
        u = x_seg.reshape(self.L, self.nx, self.ny)
        return self._full(u, self.kernel).reshape(-1)

    def apply_adjoint(self, y_seg):
        v = y_seg.reshape(self.L, self.nx2, self.ny2)
        return _conv(v, self.kernel, (0, 0)).reshape(-1)

    def row_sum(self, alpha: float):
        ones = torch.ones((self.L, self.nx, self.ny), dtype=config_dtype())
        return self._full(ones, torch.abs(self.kernel) ** alpha).reshape(-1)

    def col_sum(self, alpha: float):
        ones = torch.ones((self.L, self.nx2, self.ny2), dtype=config_dtype())
        return _conv(ones, torch.abs(self.kernel) ** alpha,
                     (0, 0)).reshape(-1)
