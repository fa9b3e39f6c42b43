"""Many problem instances at once (counterpart of ``prost_tpu/parallel``):
batched ensembles of B instances of one structure on one card.  Sharding
over several cards comes with a later slice."""

from .ensemble import BatchedPDHG, stack_problems

__all__ = ["BatchedPDHG", "stack_problems"]
