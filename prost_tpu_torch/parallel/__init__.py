"""Many problem instances at once, or one problem over many ranks
(counterpart of ``prost_tpu/parallel``): batched ensembles of B instances
of one structure on one card (``BatchedPDHG``, ``stack_problems``), and
spatial sharding of one problem's pixel rows over the ranks of a
``torch.distributed`` mesh (``make_mesh``): the generic path on DTensors
(``ShardedPDHG``) and the halo-exchange fused routes for ROF, fast
multilabel and volumetric TV (``ShardedFusedROF``,
``ShardedFusedMultilabel``, ``ShardedFusedVol``)."""

from .ensemble import BatchedPDHG, stack_problems
from .mesh import make_mesh
from .spatial import ShardedPDHG
from .spatial_fused import (HaloExchange, ShardedFusedMultilabel,
                            ShardedFusedROF, ShardedFusedVol)

__all__ = ["BatchedPDHG", "stack_problems", "make_mesh", "ShardedPDHG",
           "HaloExchange", "ShardedFusedROF", "ShardedFusedMultilabel",
           "ShardedFusedVol"]
