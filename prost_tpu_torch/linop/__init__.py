"""Linear-operator layer (counterpart of ``prost_tpu/linop``), the part
that slices 1-6 need."""

from .base import Block, DualLinearOperator, LinearOperator
from .blocks import BlockDiags, BlockKronId
from .conv import BlockConv2D
from .gradient import BlockGradient2D, BlockGradient3D

__all__ = [
    "Block",
    "LinearOperator",
    "DualLinearOperator",
    "BlockConv2D",
    "BlockDiags",
    "BlockKronId",
    "BlockGradient2D",
    "BlockGradient3D",
]
