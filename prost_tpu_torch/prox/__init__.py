"""Proximal-operator layer (counterpart of ``prost_tpu/prox``), the part
that slice 1 (ROF by PDHG) needs."""

from .base import Prox, ProxSeparableSum, apply_proxs, check_domain
from .combinators import ProxMoreau
from .elemop import ProxElem1D, ProxElemNorm2
from .fun1d import FUN_1D
from .standalone import ProxZero

__all__ = [
    "Prox",
    "ProxSeparableSum",
    "apply_proxs",
    "check_domain",
    "ProxMoreau",
    "ProxElem1D",
    "ProxElemNorm2",
    "FUN_1D",
    "ProxZero",
]
