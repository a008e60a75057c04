"""Batch-dimension padding buckets for the serving path.

Mirror of ``src/repro/serve/bucketing.py``. Ragged request batches are
padded up to a power-of-two batch size, so that an arbitrary request
stream meets at most ``log2(max_batch) + 1`` runners (one captured CUDA
graph each on the card) per layer-mode signature and plan, instead of one
per distinct batch size.

Padding replicates existing rows (a cyclic ``arange(bucket) % n`` gather)
rather than appending zeros. Activation calibration is per sample
(``quant.sample_scale``), so extra rows of any content cannot change a
real row's scale; the rest of the DiT forward never mixes batch rows
(attention within a sample, LayerNorm per token, DDIM per element). The
padded sample sliced back to the true batch is the unbucketed result.
"""
from __future__ import annotations

import torch

from ..core.ditto.plan import DEFAULT_MAX_BATCH  # single-sourced with DittoPlan


def bucket_for(n: int, *, max_batch: int = DEFAULT_MAX_BATCH) -> int:
    """Smallest power of two >= n, capped at ``max_batch``.

    Batches larger than ``max_batch`` are the caller's to split
    (``ServeSession`` chunks requests first), so n must be <= max_batch.
    """
    if n < 1:
        raise ValueError(f"batch must be >= 1, got {n}")
    if max_batch < 1 or max_batch & (max_batch - 1):
        raise ValueError(f"max_batch must be a power of two, got {max_batch}")
    if n > max_batch:
        raise ValueError(f"batch {n} exceeds max_batch {max_batch}; chunk the request first")
    b = 1
    while b < n:
        b *= 2
    return b


def pad_batch(x: torch.Tensor, labels: torch.Tensor | None, bucket: int
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Pad ``x`` (and ``labels``) along dim 0 to ``bucket`` rows by cyclically
    replicating the real rows."""
    n = x.shape[0]
    if n == bucket:
        return x, labels
    if n > bucket:
        raise ValueError(f"batch {n} larger than bucket {bucket}")
    idx = torch.arange(bucket, device=x.device) % n
    xp = x.index_select(0, idx)
    lp = None if labels is None else labels.index_select(0, idx.to(labels.device))
    return xp, lp
