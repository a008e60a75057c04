"""Registry of the ported architectures (``--arch <id>``).

Mirror of ``src/repro/configs/registry.py``. Only DiT-XL/2, the paper's
own architecture, is registered: the ten LM-family configs come with the
LM substrate (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from . import dit_xl2
from .base import ArchConfig

_ALL = [dit_xl2.CONFIG]

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in _ALL}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def names() -> list[str]:
    return list(REGISTRY)
