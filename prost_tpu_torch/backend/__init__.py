"""Algorithm backends (counterpart of ``prost_tpu/backend``): PDHG, and
graph-projection ADMM with its CGLS inner solver."""

from .admm import ADMMOptions, ADMMState, BackendADMM
from .cgls import cgls_solve
from .pdhg import BackendPDHG, PDHGOptions, PDHGState

__all__ = [
    "ADMMOptions",
    "ADMMState",
    "BackendADMM",
    "BackendPDHG",
    "PDHGOptions",
    "PDHGState",
    "cgls_solve",
]
