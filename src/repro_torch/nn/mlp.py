"""Feed-forward blocks: the gated SwiGLU / GeGLU blocks of the LM stack
(``wg``, ``wu``, ``wd``) and the ungated MLP (``wi``, ``wo``) the DiT and
musicgen use. Mirror of ``src/repro/nn/mlp.py``."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import core

GATED = ("swiglu", "geglu")


@dataclasses.dataclass(frozen=True)
class MlpCfg:
    d_model: int
    d_ff: int
    act: str = "gelu"  # swiglu | geglu | a key of nn.core.ACTIVATIONS
    bias: bool = False


def init(gen: torch.Generator, cfg: MlpCfg, *, lead: tuple = (), dtype=torch.float32) -> dict:
    if cfg.act not in GATED and cfg.act not in core.ACTIVATIONS:
        raise NotImplementedError(f"MLP activation {cfg.act!r} is not ported")
    kw = dict(bias=cfg.bias, lead=lead, dtype=dtype)
    if cfg.act in GATED:
        return {
            "wg": core.dense_init(gen, cfg.d_model, cfg.d_ff, axes=("embed", "mlp"), **kw),
            "wu": core.dense_init(gen, cfg.d_model, cfg.d_ff, axes=("embed", "mlp"), **kw),
            "wd": core.dense_init(gen, cfg.d_ff, cfg.d_model, axes=("mlp", "embed"), **kw),
        }
    return {
        "wi": core.dense_init(gen, cfg.d_model, cfg.d_ff, axes=("embed", "mlp"), **kw),
        "wo": core.dense_init(gen, cfg.d_ff, cfg.d_model, axes=("mlp", "embed"), **kw),
    }


def apply(params: dict, cfg: MlpCfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.act in GATED:
        gate = F.silu if cfg.act == "swiglu" else core.ACTIVATIONS["gelu"]
        return core.dense(params["wd"], gate(core.dense(params["wg"], x))
                          * core.dense(params["wu"], x))
    act = core.ACTIVATIONS[cfg.act]
    return core.dense(params["wo"], act(core.dense(params["wi"], x)))
