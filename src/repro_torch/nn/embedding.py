"""Token embedding + LM head. Mirror of ``src/repro/nn/embedding.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import core
from .core import val


def embed_init(gen: torch.Generator, vocab: int, d_model: int, *, dtype=torch.float32) -> dict:
    return {"table": core.tag(core.normal_init(gen, (vocab, d_model), stddev=0.02, dtype=dtype),
                              ("vocab", "embed"))}


def embed(params: dict, tokens: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    # F.embedding, not ``table[tokens]``: the same rows, and on the card its
    # backward sorts the ids and sums each row's gradients in a fixed order
    # (indexing's backward adds them with atomics), so a train step repeats
    # bit for bit
    y = F.embedding(tokens, val(params["table"]))
    return y * torch.full((), scale, dtype=y.dtype, device=y.device) if scale != 1.0 else y


def head_init(gen: torch.Generator, d_model: int, vocab: int, *, dtype=torch.float32) -> dict:
    return {"w": core.tag(core.normal_init(gen, (d_model, vocab), stddev=0.02, dtype=dtype),
                          ("embed", "vocab"))}


def logits(params: dict | None, x: torch.Tensor, *,
           tied_table: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ W`` of the head, or ``x @ table.T`` of a tied embedding."""
    if tied_table is not None:
        return x @ val(tied_table).to(x.dtype).T
    return x @ val(params["w"]).to(x.dtype)
