"""Linear-operator layer (counterpart of ``prost_tpu/linop``), the part
that slice 1 (ROF by PDHG) needs."""

from .base import Block, DualLinearOperator, LinearOperator
from .gradient import BlockGradient2D

__all__ = [
    "Block",
    "LinearOperator",
    "DualLinearOperator",
    "BlockGradient2D",
]
