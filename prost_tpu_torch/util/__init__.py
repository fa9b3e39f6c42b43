"""Auxiliary subsystems: profiling/observability and checkpoint/resume
(counterpart of ``prost_tpu/util``)."""

from .checkpoint import load_state, save_state
from .profiling import (
    compiled_memory_analysis,
    memory_stats,
    timed,
    trace,
)

__all__ = [
    "save_state",
    "load_state",
    "trace",
    "timed",
    "memory_stats",
    "compiled_memory_analysis",
]
