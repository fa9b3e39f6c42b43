"""Algorithm backends (counterpart of ``prost_tpu/backend``): PDHG.  ADMM
and CGLS come with slice 2."""

from .pdhg import BackendPDHG, PDHGOptions, PDHGState

__all__ = [
    "BackendPDHG",
    "PDHGOptions",
    "PDHGState",
]
