"""Registry of all selectable architectures (``--arch <id>``).

Mirror of ``src/repro/configs/registry.py``: the ten assigned LM-family
configs and DiT-XL/2, the paper's own, in the reference's order.
"""
from __future__ import annotations

from . import (
    arctic_480b,
    command_r_35b,
    dit_xl2,
    internvl2_2b,
    minicpm_2b,
    musicgen_medium,
    qwen2_moe_a2_7b,
    qwen3_0_6b,
    smollm_360m,
    xlstm_125m,
    zamba2_7b,
)
from .base import ArchConfig

_ALL = [
    minicpm_2b.CONFIG,
    smollm_360m.CONFIG,
    qwen3_0_6b.CONFIG,
    command_r_35b.CONFIG,
    xlstm_125m.CONFIG,
    qwen2_moe_a2_7b.CONFIG,
    arctic_480b.CONFIG,
    internvl2_2b.CONFIG,
    zamba2_7b.CONFIG,
    musicgen_medium.CONFIG,
    dit_xl2.CONFIG,  # the paper's own architecture
]

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in _ALL}

ASSIGNED = [c.name for c in _ALL if c.name != "dit-xl2"]  # the 10 assigned archs


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def names() -> list[str]:
    return list(REGISTRY)
