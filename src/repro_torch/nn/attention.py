"""Bidirectional multi-head attention, as the DiT blocks use it.

Mirror of the part of ``src/repro/nn/attention.py`` that ``nn/dit.py``
reaches: projections with bias, RoPE, full (non-causal) attention, no KV
cache. The causal, windowed, qk-norm and cached paths belong to the LM
substrate, a later slice (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import core
from .rotary import apply_rope


@dataclasses.dataclass(frozen=True)
class AttentionCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    bias: bool = False
    causal: bool = True
    window: int | None = None


def init(gen: torch.Generator, cfg: AttentionCfg, *, lead: tuple = (),
         dtype=torch.float32) -> dict:
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {
        "wq": core.dense_init(gen, cfg.d_model, qd, bias=cfg.bias, lead=lead, dtype=dtype),
        "wk": core.dense_init(gen, cfg.d_model, kvd, bias=cfg.bias, lead=lead, dtype=dtype),
        "wv": core.dense_init(gen, cfg.d_model, kvd, bias=cfg.bias, lead=lead, dtype=dtype),
        "wo": core.dense_init(gen, qd, cfg.d_model, bias=cfg.bias, lead=lead, dtype=dtype),
    }


def apply(params: dict, cfg: AttentionCfg, x: torch.Tensor, *,
          positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), full bidirectional attention."""
    if cfg.causal or cfg.window is not None or cfg.qk_norm:
        raise NotImplementedError(
            "only the DiT's bidirectional attention is ported; causal, windowed "
            "and qk-norm attention come with the LM substrate (ROADMAP.md, queue 1)")
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = core.dense(params["wq"], x).reshape(b, s, h, hd)
    k = core.dense(params["wk"], x).reshape(b, s, kvh, hd)
    v = core.dense(params["wv"], x).reshape(b, s, kvh, hd)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    g = h // kvh
    q = q.reshape(b, s, kvh, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k).to(torch.float32) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits, dim=-1)
    y = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v).reshape(b, s, h * hd)
    return core.dense(params["wo"], y)
