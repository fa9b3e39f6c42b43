"""Many problem instances at once, or one problem over many ranks
(counterpart of ``prost_tpu/parallel``): batched ensembles of B instances
of one structure (``BatchedPDHG``, ``stack_problems``), on one card or with
the batch axis split over the ranks of a ``dp`` mesh, and spatial sharding
of one problem's pixel rows over the ranks of a ``torch.distributed`` mesh
(``make_mesh``): the generic path on DTensors (``ShardedPDHG``) and the
halo-exchange fused routes for ROF, fast multilabel, volumetric TV, tight
multilabel and deblurring (``ShardedFusedROF``, ``ShardedFusedMultilabel``,
``ShardedFusedVol``, ``ShardedFusedTight``, ``ShardedFusedDeblur``) and
for Chebyshev ADMM (``ShardedFusedADMM``)."""

from .ensemble import BatchedPDHG, stack_problems
from .mesh import make_mesh
from .spatial import ShardedPDHG
from .spatial_fused import (HaloExchange, ShardedFusedADMM,
                            ShardedFusedDeblur, ShardedFusedMultilabel,
                            ShardedFusedROF, ShardedFusedTight,
                            ShardedFusedVol)

__all__ = ["BatchedPDHG", "stack_problems", "make_mesh", "ShardedPDHG",
           "HaloExchange", "ShardedFusedROF", "ShardedFusedMultilabel",
           "ShardedFusedVol", "ShardedFusedTight", "ShardedFusedDeblur",
           "ShardedFusedADMM"]
