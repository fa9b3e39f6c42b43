"""Fused iterations with hand-written CUDA kernels (counterpart of
``prost_tpu/ops``): the ROF route of slice 1."""

from .fused_rof import (FusedROFPDHG, launch_counts, match_rof_structure,
                        reset_launch_counts, rof_chunk, rof_chunk_plain,
                        rof_multichunk, rof_multichunk_plain)

__all__ = [
    "FusedROFPDHG",
    "match_rof_structure",
    "rof_chunk",
    "rof_chunk_plain",
    "rof_multichunk",
    "rof_multichunk_plain",
    "launch_counts",
    "reset_launch_counts",
]
