"""Rotary position embeddings (RoPE). Mirror of ``src/repro/nn/rotary.py``."""
from __future__ import annotations

import torch

from .core import divide


def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for half the head dim. float32."""
    half = head_dim // 2
    exps = divide(torch.arange(0, half, dtype=torch.float32, device=device), float(half))
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE to ``x`` of shape (..., seq, heads, head_dim), split-halves
    convention (rotate_half), fp32 internally. ``positions`` broadcasts
    against the seq dim."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta=theta, device=x.device)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., seq, half)
    angles = angles[..., None, :]  # (..., seq, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)
