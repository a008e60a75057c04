from .base import ArchConfig, torch_dtype
from .registry import REGISTRY, get, names

__all__ = ["ArchConfig", "torch_dtype", "REGISTRY", "get", "names"]
