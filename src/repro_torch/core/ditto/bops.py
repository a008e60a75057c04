"""Bit-Operations accounting (paper §III-B, refs [5],[50]).

Mirror of ``src/repro/core/ditto/bops.py``. BOPs of one MAC =
bits_activation * bits_weight: A8W8 costs 64 BOPs per MAC; difference
processing pays zero -> 0, low (|Δ| <= LOW_BIT_MAX) -> 32, full -> 64.
``bops_mixed`` prices element-granular fractions, ``bops_tile_mix`` the
measured tile-class histogram of the kernels (``tile_hist``).
"""
from __future__ import annotations

import torch

from ...kernels.common import LOW_BIT_MAX

W_BITS = 8
A_FULL = 8
A_LOW = 4


def bops_act(macs: float, q=None) -> float:
    """Direct quantized execution: all MACs at full activation width."""
    return float(macs) * A_FULL * W_BITS


def bops_mixed(macs: float, zero: float, low: float, full: float) -> float:
    """Difference execution with zero-skipping and 4-bit ops."""
    return float(macs) * (low * A_LOW * W_BITS + full * A_FULL * W_BITS)


def tile_fractions(hist) -> tuple[float, float, float]:
    """(zero, low, full) fractions from a tile-class histogram
    (n_zero, n_low, n_full); all-zero histograms price as all-zero work."""
    z, l, f = (float(v) for v in hist)
    total = z + l + f
    if total <= 0:
        return (1.0, 0.0, 0.0)
    return (z / total, l / total, f / total)


def bops_tile_mix(macs: float, hist) -> float:
    """BOPs of one diff matmul from its measured tile-class histogram:
    class-0 tiles cost 0, class-1 tiles A_LOW, class-2 tiles A_FULL."""
    zero, low, full = tile_fractions(hist)
    return bops_mixed(macs, zero, low, full)


def bops_elementwise(d: torch.Tensor, macs_per_element: float) -> float:
    """Exact BOPs from a difference tensor (no class rounding)."""
    a = d.to(torch.int32).abs()
    low = (a > 0) & (a <= LOW_BIT_MAX)
    full = a > LOW_BIT_MAX
    bops = (int(low.sum()) * A_LOW + int(full.sum()) * A_FULL) * W_BITS
    return float(bops) * macs_per_element
