"""Feed-forward blocks: the ungated MLP the DiT uses. Mirror of the
ungated part of ``src/repro/nn/mlp.py``; the gated SwiGLU / GeGLU blocks
belong to the LM substrate, a later slice (ROADMAP.md, queue 1)."""
from __future__ import annotations

import dataclasses

import torch

from . import core


@dataclasses.dataclass(frozen=True)
class MlpCfg:
    d_model: int
    d_ff: int
    act: str = "gelu"  # a key of nn.core.ACTIVATIONS
    bias: bool = False


def init(gen: torch.Generator, cfg: MlpCfg, *, lead: tuple = (), dtype=torch.float32) -> dict:
    if cfg.act not in core.ACTIVATIONS:
        raise NotImplementedError(f"MLP activation {cfg.act!r} is not ported")
    kw = dict(bias=cfg.bias, lead=lead, dtype=dtype)
    return {
        "wi": core.dense_init(gen, cfg.d_model, cfg.d_ff, **kw),
        "wo": core.dense_init(gen, cfg.d_ff, cfg.d_model, **kw),
    }


def apply(params: dict, cfg: MlpCfg, x: torch.Tensor) -> torch.Tensor:
    act = core.ACTIVATIONS[cfg.act]
    return core.dense(params["wo"], act(core.dense(params["wi"], x)))
