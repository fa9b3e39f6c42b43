"""Fused iterations with hand-written CUDA kernels (counterpart of
``prost_tpu/ops``): the ROF route by PDHG and by ADMM, the fast
multilabel, TV-deblurring, tight-multilabel and volumetric-TV routes by
PDHG, and the batched ROF, multilabel, deblur, tight and volumetric chunks
of the ensembles and the halo chunks of spatial sharding
(``prost_tpu_torch.parallel``)."""

from .fused_admm import (FusedROFADMM, admm_chunk, admm_chunk_plain,
                         admm_multichunk, admm_multichunk_plain)
from .fused_deblur import (deblur_chunk, deblur_chunk_batched,
                           deblur_chunk_batched_plain, deblur_chunk_plain,
                           match_deblur_structure)
from .fused_multilabel import (match_multilabel_structure, ml_chunk,
                               ml_chunk_batched, ml_chunk_batched_plain,
                               ml_chunk_halo, ml_chunk_halo_plain,
                               ml_chunk_plain, ml_multichunk,
                               ml_multichunk_plain)
from .fused_rof import (FusedROFPDHG, launch_counts, match_rof_structure,
                        reset_launch_counts, rof_chunk, rof_chunk_batched,
                        rof_chunk_batched_plain, rof_chunk_halo,
                        rof_chunk_halo_plain, rof_chunk_plain,
                        rof_multichunk, rof_multichunk_plain)
from .fused_tight import (match_tight_structure, tight_chunk,
                          tight_chunk_batched, tight_chunk_batched_plain,
                          tight_chunk_plain)
from .fused_vol import (match_vol_structure, vol_chunk, vol_chunk_batched,
                        vol_chunk_batched_plain, vol_chunk_halo,
                        vol_chunk_halo_plain, vol_chunk_plain,
                        vol_multichunk, vol_multichunk_plain)

__all__ = [
    "FusedROFADMM",
    "FusedROFPDHG",
    "match_rof_structure",
    "match_multilabel_structure",
    "match_deblur_structure",
    "match_tight_structure",
    "match_vol_structure",
    "admm_chunk",
    "admm_chunk_plain",
    "admm_multichunk",
    "admm_multichunk_plain",
    "rof_chunk",
    "rof_chunk_plain",
    "rof_chunk_batched",
    "rof_chunk_batched_plain",
    "rof_chunk_halo",
    "rof_chunk_halo_plain",
    "rof_multichunk",
    "rof_multichunk_plain",
    "ml_chunk",
    "ml_chunk_plain",
    "ml_chunk_batched",
    "ml_chunk_batched_plain",
    "ml_chunk_halo",
    "ml_chunk_halo_plain",
    "ml_multichunk",
    "ml_multichunk_plain",
    "deblur_chunk",
    "deblur_chunk_plain",
    "deblur_chunk_batched",
    "deblur_chunk_batched_plain",
    "tight_chunk",
    "tight_chunk_plain",
    "tight_chunk_batched",
    "tight_chunk_batched_plain",
    "vol_chunk",
    "vol_chunk_plain",
    "vol_chunk_batched",
    "vol_chunk_batched_plain",
    "vol_chunk_halo",
    "vol_chunk_halo_plain",
    "vol_multichunk",
    "vol_multichunk_plain",
    "launch_counts",
    "reset_launch_counts",
]
