"""Bit-width classification of (difference) tensors — paper §III-B / §V-B.

Mirror of ``src/repro/core/ditto/classify.py``. Element classes over an
int domain tensor: zero (d == 0), low (|d| <= LOW_BIT_MAX, signed 4-bit)
and full (otherwise). Fractions are ``float32(count) / n`` computed as a
true float32 division, as in the reference, so an exact tie in Defo's
cycle comparison falls the same way in both.
"""
from __future__ import annotations

import torch

from ...kernels.common import LOW_BIT_MAX
from ...nn.core import divide


def _fraction(mask: torch.Tensor) -> torch.Tensor:
    return divide(mask.sum().to(torch.float32), float(mask.numel()))


def element_classes(d: torch.Tensor) -> dict:
    """Fractions of zero / low(<=4b, excl zero) / full elements."""
    a = d.to(torch.int32).abs()
    zero = a == 0
    low = (a > 0) & (a <= LOW_BIT_MAX)
    full = a > LOW_BIT_MAX
    return {
        "zero": _fraction(zero),
        "low": _fraction(low),
        "full": _fraction(full),
        "zero_mask": zero,
        "low_mask": low,
        "full_mask": full,
    }


def bitwidth_requirement(d: torch.Tensor) -> torch.Tensor:
    """Per-element minimum bits (0 for zero values, else ceil(log2)+sign)."""
    a = d.to(torch.int32).abs()
    bits = torch.ceil(torch.log2((a.clamp(min=1) + 1).to(torch.float32))).to(torch.int32) + 1
    return torch.where(a == 0, 0, bits)


def tile_classes(d: torch.Tensor, tile: tuple[int, int] = (128, 128)) -> dict:
    """Per-tile class over the last two dims (pad-free: dims must divide)."""
    tq, tk = tile
    m, k = d.shape[-2:]
    lead = d.shape[:-2]
    dd = d.reshape(lead + (m // tq, tq, k // tk, tk))
    amax = dd.to(torch.int32).abs().amax(dim=(-3, -1))
    return {
        "zero": amax == 0,
        "low": (amax > 0) & (amax <= LOW_BIT_MAX),
        "full": amax > LOW_BIT_MAX,
        "amax": amax,
    }


def spatial_diff(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Diffy-style spatial differences along ``axis``: the first row keeps
    its full value, later rows store deltas to the previous row. Exact in
    the int domain."""
    q32 = q.to(torch.int32)
    n = q.shape[axis]
    first = q32.narrow(axis, 0, 1)
    d = q32.narrow(axis, 1, n - 1) - q32.narrow(axis, 0, n - 1)
    return torch.cat([first, d], dim=axis)
