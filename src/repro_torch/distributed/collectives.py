"""Distributed-optimization collectives.

Mirror of ``src/repro/distributed/collectives.py``.
``compressed_psum_grads``: an int8-quantized gradient all-reduce with error
feedback. Each participant quantizes (grad + residual) to int8 with a
per-leaf float32 scale, sums the payload over the group, dequantizes, and
carries the quantization error into the next step's residual. With error
feedback the *accumulated* update converges to the exact all-reduce.

The sum is a ``torch.distributed.all_reduce`` of the float32 dequantized
payload, ``sum_i s_i * q_i``, which is numerically the sum of the int8
payloads each with its scale (a deployment would put int8 plus one scale
a leaf on the wire); the reference lowers its ``psum`` the same way. A
group of one rank, the card's, is the reference's ``axis_names=()``: the
all-reduce returns its input.

Kept bit for bit from the reference: ``amax / 127`` is a true division
(``nn/core.py:divide``; CUDA's division by a Python scalar multiplies by
the reciprocal), ``round`` is half to even, and the mean is cast to the
gradient's dtype.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import tree as tr
from ..nn.core import divide


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 0-d): ``q = clip(round(x / scale), -127, 127)``
    with ``scale = max|x| / 127`` (1 for an all-zero ``x``)."""
    amax = x.abs().max().to(torch.float32)
    scale = torch.where(amax > 0, divide(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _compressed_psum_leaf(g: torch.Tensor, resid: torch.Tensor, group=None):
    """One leaf: error-feedback int8 compress -> all-reduce -> mean over the
    ranks of ``group`` (None: the default group). Returns (mean in ``g``'s
    dtype, the new float32 residual)."""
    compensated = g.to(torch.float32) + resid
    q, scale = quantize_int8(compensated)
    total = dequantize_int8(q, scale)
    new_resid = compensated - total  # error feedback carries the loss
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return divide(total, float(dist.get_world_size(group))).to(g.dtype), new_resid


def compressed_psum_grads(grads, residuals, group=None):
    """All-reduce-mean a gradient tree with int8 error-feedback compression
    over ``group``. Returns (mean_grads, new_residuals)."""
    outs = [_compressed_psum_leaf(g, r, group)
            for g, r in zip(tr.leaves(grads), tr.leaves(residuals))]
    return (tr.unflatten_like(grads, [o[0] for o in outs]),
            tr.unflatten_like(residuals, [o[1] for o in outs]))


def make_compressed_allreduce(group=None):
    """``fn(grads, residuals) -> (mean_grads, new_residuals)`` over ``group``:
    each rank passes its own gradients."""

    def fn(grads, residuals):
        return compressed_psum_grads(grads, residuals, group)

    return fn


def zeros_residuals(params):
    return tr.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
