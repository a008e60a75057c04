"""Distributed helpers of the port: the logical-axis sharding rules and the
batch split of a mesh dispatch, the int8 error-feedback all-reduce, and the
GPipe pipeline."""
from . import collectives, pipeline, sharding
from .sharding import batch_sharding, constrain_batch

__all__ = ["batch_sharding", "collectives", "constrain_batch", "pipeline", "sharding"]
