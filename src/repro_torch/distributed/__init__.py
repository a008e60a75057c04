"""Distributed helpers of the port: the batch split of a mesh dispatch."""
from .sharding import batch_sharding, constrain_batch

__all__ = ["batch_sharding", "constrain_batch"]
