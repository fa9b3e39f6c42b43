"""Linear-operator layer (counterpart of ``prost_tpu/linop``), the part
that slices 1-3 need."""

from .base import Block, DualLinearOperator, LinearOperator
from .blocks import BlockKronId
from .gradient import BlockGradient2D

__all__ = [
    "Block",
    "LinearOperator",
    "DualLinearOperator",
    "BlockKronId",
    "BlockGradient2D",
]
