"""Proximal-operator layer (counterpart of ``prost_tpu/prox``)."""

from .base import Prox, ProxSeparableSum, apply_proxs, check_domain
from .combinators import ProxMoreau, ProxPermute, ProxTransform
from .elemop import (
    ProxElem1D,
    ProxElemIndSimplex,
    ProxElemIndSum,
    ProxElemNorm2,
)
from .fun1d import FUN_1D
from .fun2d import FUN_2D
from .spectral import (
    ProxElemEigen2x2,
    ProxElemEigenNxN,
    ProxElemMassNorm,
    ProxElemSingularNx2,
)
from .standalone import (
    ProxIndEpiPolyhedral,
    ProxIndEpiQuad,
    ProxIndHalfspace,
    ProxIndRange,
    ProxIndSOC,
    ProxIndSum,
    ProxZero,
)

__all__ = [
    "Prox",
    "ProxSeparableSum",
    "apply_proxs",
    "check_domain",
    "ProxMoreau",
    "ProxPermute",
    "ProxTransform",
    "ProxElem1D",
    "ProxElemNorm2",
    "ProxElemIndSimplex",
    "ProxElemIndSum",
    "FUN_1D",
    "FUN_2D",
    "ProxElemEigen2x2",
    "ProxElemEigenNxN",
    "ProxElemSingularNx2",
    "ProxElemMassNorm",
    "ProxZero",
    "ProxIndSOC",
    "ProxIndHalfspace",
    "ProxIndEpiQuad",
    "ProxIndEpiPolyhedral",
    "ProxIndSum",
    "ProxIndRange",
]
