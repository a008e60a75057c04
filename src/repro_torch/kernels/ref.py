"""Plain PyTorch versions of the three main-path kernels.

They run on the CPU (the wrappers take them only for CPU tensors) and on
the card (``chip_smoke.py`` holds each kernel against them there). PyTorch
has no integer matmul on CUDA, so the products run in float64 and are cast
back to int32. That is exact here: |Δ| <= 254, |w| <= 127 and K <= 4608 on
every main-path layer, so every partial sum is an integer below 1.5e8,
far under 2**53.

Each function takes an optional leading batch dim (``(..., M, K)``
operands), as the batched kernels do.
"""
from __future__ import annotations

import torch

from .common import LOW_BIT_MAX


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer a @ b with int32 result, through exact float64 products."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, *,
                    w_transposed: bool = False) -> torch.Tensor:
    """(..., M, K) int8 @ (..., K, N) int8 — or (..., N, K) with
    ``w_transposed`` — -> (..., M, N) int32."""
    return exact_matmul(x_q, w_q.transpose(-1, -2) if w_transposed else w_q)


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


def ditto_diff_matmul_ref(x_t: torch.Tensor, x_prev: torch.Tensor, w_q: torch.Tensor,
                          y_prev: torch.Tensor | None = None,
                          classes: torch.Tensor | None = None,
                          tile: tuple[int, int] = (128, 128), *,
                          w_transposed: bool = False) -> torch.Tensor:
    """y = y_prev + (x_t - x_prev) @ W, exact int32.

    With ``classes`` (the diff_encode map over ``tile``), Δ of every
    class-0 tile is dropped exactly as the kernel skips it; for a map that
    diff_encode produced this changes nothing (those Δ are all zero).
    """
    d = x_t.to(torch.int32) - x_prev.to(torch.int32)
    if classes is not None:
        tm, tk = tile
        keep = (classes != 0).repeat_interleave(tm, dim=-2).repeat_interleave(tk, dim=-1)
        d = d * keep
    y = exact_matmul(d, w_q.transpose(-1, -2) if w_transposed else w_q)
    return y if y_prev is None else y_prev + y
