"""Linear-operator layer: block-structured K (counterpart of
``prost_tpu/linop``)."""

from .base import Block, DualLinearOperator, LinearOperator
from .blocks import (BlockDense, BlockDiags, BlockIdKron, BlockKronId,
                     BlockSparse, BlockZero)
from .conv import BlockConv2D
from .gradient import BlockGradient2D, BlockGradient3D

__all__ = [
    "Block",
    "LinearOperator",
    "DualLinearOperator",
    "BlockConv2D",
    "BlockDense",
    "BlockDiags",
    "BlockIdKron",
    "BlockKronId",
    "BlockSparse",
    "BlockZero",
    "BlockGradient2D",
    "BlockGradient3D",
]
