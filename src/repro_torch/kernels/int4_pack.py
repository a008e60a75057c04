"""Packed-int4 lane format of low-class difference tiles, on tensors.

Mirror of ``src/repro/kernels/int4_pack.py``. The class-1 verdict of
``diff_encode`` (``max|Δ| <= LOW_BIT_MAX``) guarantees every element of a
low tile fits a signed 4-bit lane, and the storage word holds TWO
adjacent-K lanes per int8 byte:

    word = (d[2c+1] << 4) | (d[2c] & 0xF)          (two's-complement nibbles)

the EVEN K lane in bits 0-3, the ODD K lane in bits 4-7. Unpacking is bit
arithmetic — ``((w & 0xF) ^ 8) - 8`` sign-extends the low lane, an
arithmetic right shift the high one — and is exact for every lane value
in [-8, 7], so ``unpack_int4(pack_int4(d)) == d`` on every low tile.

These are the plain versions. The kernels use the ``__device__``
counterparts in ``csrc/int4_pack.cuh`` (the ``low_bits=4`` branch of
``ditto_diff_matmul`` and the Δ-cache of ``kernels.fused_step``). The
H100 has no int4 x int8 tensor-core product (its ``mma`` takes int4 only
against int4), so on the card, as on the reference's v5e, the packed word
is a half-width storage format and is unpacked to int8 lanes before the
product: it halves the bytes a low tile moves, not the multiplies.
"""
from __future__ import annotations

import torch

from .common import LOW_BIT_MAX

__all__ = ["LOW_BIT_MAX", "pack_int4", "unpack_int4", "unpack_int4_lanes"]


def pack_int4(d: torch.Tensor) -> torch.Tensor:
    """(..., K) integer Δ with K even -> (..., K/2) int8, two int4 lanes a
    byte. Lossless iff every element is in [-8, 7]; otherwise each lane
    keeps its low nibble, as the reference's int8 cast does."""
    k = d.shape[-1]
    if k % 2:
        raise ValueError(f"pack_int4: K must be even to pair int4 lanes, got {k}")
    pairs = d.to(torch.int32).reshape(d.shape[:-1] + (k // 2, 2))
    word = ((pairs[..., 1] & 0xF) << 4) | (pairs[..., 0] & 0xF)  # 0..255, unsigned
    return (word - ((word >> 7) << 8)).to(torch.int8)  # as a signed byte


def unpack_int4_lanes(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K/2) int8 packed words -> (even, odd) int32 lane planes, each
    (..., K/2)."""
    p32 = p.to(torch.int32)
    return ((p32 & 0xF) ^ 8) - 8, p32 >> 4


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """(..., K/2) int8 packed words -> (..., K) int32 lanes (exact inverse
    of :func:`pack_int4` for lane values in [-8, 7])."""
    lo, hi = unpack_int4_lanes(p)
    return torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (p.shape[-1] * 2,))
