from .base import SHAPES, ArchConfig, ShapeCell, cell_applicable, input_specs, torch_dtype
from .registry import ASSIGNED, REGISTRY, get, names

__all__ = [
    "SHAPES",
    "ArchConfig",
    "ShapeCell",
    "cell_applicable",
    "input_specs",
    "torch_dtype",
    "ASSIGNED",
    "REGISTRY",
    "get",
    "names",
]
