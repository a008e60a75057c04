"""Plain PyTorch versions of the main-path kernels.

They run on the CPU (the wrappers take them only for CPU tensors) and on
the card (``chip_smoke.py`` holds each kernel against them there). PyTorch
has no integer matmul on CUDA, so the products run in float64 and are cast
back to int32. That is exact here: |Δ| <= 254, |w| <= 127 and K <= 4608 on
every main-path layer, so every partial sum is an integer below 1.5e8,
far under 2**53.

Each function takes an optional leading batch dim (``(..., M, K)``
operands), as the batched kernels do.

The packed-int4 paths (the ``low_bits=4`` branch of the diff matmul and
the fused flow's Δ-cache) go through ``int4_pack`` and dot the even and
odd K lanes against the even and odd weight rows, as the reference's
kernels do: they are the packed function, not an int8 product renamed.
"""
from __future__ import annotations

import torch

from .common import LOW_BIT_MAX, validate_low_bits
from .int4_pack import pack_int4, unpack_int4_lanes


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer a @ b with int32 result, through exact float64 products."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, *,
                    w_transposed: bool = False) -> torch.Tensor:
    """(..., M, K) int8 @ (..., K, N) int8 — or (..., N, K) with
    ``w_transposed`` — -> (..., M, N) int32."""
    return exact_matmul(x_q, w_q.transpose(-1, -2) if w_transposed else w_q)


def quantize_rows_ref(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 divide, round half to even, clip to ±127, int8: the chain of
    ``core/ditto/quant.py:quantize`` (the eager engine keeps its own copy)."""
    q = torch.round(x.to(torch.float32) / scale)
    return q.clamp(-127, 127).to(torch.int8)


def dequantize_rows_ref(y: torch.Tensor, s_row: torch.Tensor, s_col: torch.Tensor,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """int32 -> fp32 as the engine scales a product back:
    ``y.to(float32) * s_row * s_col (+ bias)``, each step rounded to fp32."""
    out = y.to(torch.float32) * s_row * s_col
    return out if bias is None else out + bias


def diff_encode_ref(x_t: torch.Tensor, x_prev: torch.Tensor,
                    tile: tuple[int, int]) -> torch.Tensor:
    """Per-tile class of Δ = x_t - x_prev: 0 zero / 1 low (<= LOW_BIT_MAX) /
    2 full. x_*: (..., M, K) int8 -> (..., M/tm, K/tk) int32."""
    tm, tk = tile
    m, k = x_t.shape[-2:]
    lead = x_t.shape[:-2]
    d = (x_t.to(torch.int32) - x_prev.to(torch.int32)).abs()
    amax = d.reshape(lead + (m // tm, tm, k // tk, tk)).amax(dim=(-3, -1))
    return torch.where(amax == 0, 0, torch.where(amax <= LOW_BIT_MAX, 1, 2)).to(torch.int32)


def tile_mask(classes: torch.Tensor, tile: tuple[int, int], pred) -> torch.Tensor:
    """``pred(classes)`` spread from one entry per tile to every element."""
    tm, tk = tile
    return pred(classes).repeat_interleave(tm, dim=-2).repeat_interleave(tk, dim=-1)


def _w_lane_pair(w_q: torch.Tensor, w_transposed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(even, odd) K-lane halves of W in (K/2, N) form, matching the int4
    lane planes."""
    w = w_q.transpose(-1, -2) if w_transposed else w_q
    return w[..., 0::2, :], w[..., 1::2, :]


def _lane_dot(even: torch.Tensor, odd: torch.Tensor, w_q: torch.Tensor,
              w_transposed: bool) -> torch.Tensor:
    """even @ W[even K rows] + odd @ W[odd K rows], exact int32."""
    w_even, w_odd = _w_lane_pair(w_q, w_transposed)
    return exact_matmul(even, w_even) + exact_matmul(odd, w_odd)


def ditto_diff_matmul_ref(x_t: torch.Tensor, x_prev: torch.Tensor, w_q: torch.Tensor,
                          y_prev: torch.Tensor | None = None,
                          classes: torch.Tensor | None = None,
                          tile: tuple[int, int] = (128, 128), *,
                          w_transposed: bool = False, low_bits: int = 8) -> torch.Tensor:
    """y = y_prev + (x_t - x_prev) @ W, exact int32.

    With ``classes`` (the diff_encode map over ``tile``), Δ of every
    class-0 tile is dropped exactly as the kernel skips it; for a map that
    diff_encode produced this changes nothing (those Δ are all zero). With
    ``low_bits=4`` the class-1 tiles go through the packed-int4 word:
    ``pack_int4`` -> ``unpack_int4_lanes`` -> even/odd lane products.
    """
    validate_low_bits(low_bits)
    d = x_t.to(torch.int32) - x_prev.to(torch.int32)
    if classes is not None:
        d = d * tile_mask(classes, tile, lambda c: c != 0)
    if low_bits == 4 and classes is not None:
        low = tile_mask(classes, tile, lambda c: c == 1)
        lo, hi = unpack_int4_lanes(pack_int4(d * low))
        y = (exact_matmul(d * ~low, w_q.transpose(-1, -2) if w_transposed else w_q)
             + _lane_dot(lo, hi, w_q, w_transposed))
    else:
        y = exact_matmul(d, w_q.transpose(-1, -2) if w_transposed else w_q)
    return y if y_prev is None else y_prev + y


def diff_encode_fused_ref(x_t: torch.Tensor, x_prev: torch.Tensor, tile: tuple[int, int]
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_* (..., M, K) int8 -> (classes (..., M/tm, K/tk) int32,
    dc (..., M, K/2) int8 — Δ's low nibbles, two int4 K lanes a byte,
    dh (..., M, K) int8 — (Δ - lo) >> 4, so that Δ = lo + (dh << 4)).

    The kernel writes ``dc`` only on class >= 1 tiles and ``dh`` only on
    class-2 tiles; this version writes both planes everywhere, which on
    the ungated tiles is 0 (Δ = 0 on class 0, |Δ| <= 7 on class 1). Only
    the gated tiles carry the function's result."""
    d = x_t.to(torch.int32) - x_prev.to(torch.int32)
    lo = ((d & 0xF) ^ 8) - 8  # sign-extended low nibble (= unpack(pack))
    return diff_encode_ref(x_t, x_prev, tile), pack_int4(d), ((d - lo) >> 4).to(torch.int8)


def ditto_fused_matmul_ref(w_q: torch.Tensor, dc: torch.Tensor, dh: torch.Tensor,
                           classes: torch.Tensor, tile: tuple[int, int] = (128, 128), *,
                           w_transposed: bool = False) -> torch.Tensor:
    """(x_t - x_prev) @ W from the Δ-cache of :func:`diff_encode_fused_ref`,
    the bare (..., M, N) int32 contribution. Class-gated as the kernel is:
    class 0 reads nothing, class 1 reads ``dc`` alone (its nibbles are Δ),
    class 2 rebuilds Δ = lo + (dh << 4) lane by lane. y_prev is the
    caller's epilogue, as in the reference."""
    tm, tk = tile
    lo, hi = unpack_int4_lanes(dc)  # even / odd K lanes, (..., M, K/2)
    half = (tm, tk // 2)
    live = tile_mask(classes, half, lambda c: c >= 1)
    full = tile_mask(classes, half, lambda c: c == 2)
    dh32 = dh.to(torch.int32)
    d_even = torch.where(full, lo + (dh32[..., 0::2] << 4), lo)
    d_odd = torch.where(full, hi + (dh32[..., 1::2] << 4), hi)
    zero = torch.zeros((), dtype=torch.int32, device=dc.device)
    return _lane_dot(torch.where(live, d_even, zero), torch.where(live, d_odd, zero),
                     w_q, w_transposed)
