"""Encoding-Unit kernel: temporal-difference class per tile, for Hopper.

Replaces ``src/repro/kernels/diff_encode.py: diff_encode`` (Pallas body
``_kernel``): one int32 class per (128, 128) tile of Δ = x_t - x_prev —
0 if max|Δ| == 0, 1 if max|Δ| <= LOW_BIT_MAX (7), else 2 — shape
(M/128, K/128), the map ``ditto_diff_matmul`` consumes to skip class-0
tiles.

Kernel (``csrc/diff_encode.cu`` over ``csrc/encode_sm90.cuh``): each
tile is split over a thread-block cluster of C blocks (1, 2, 4 or 8);
block r loads rows [r·128/C, (r+1)·128/C) of both operands in 16-byte
vectors, reduces max|Δ| by warp shuffle, and the cluster reduces the
blocks' maxima through distributed shared memory; block 0 writes the
int32 class. A leading batch dim runs as the grid's z axis (all heads of
an attention layer in one launch).

What bounds it on the H100: it reads 2 bytes and does a few integer
operations per element, so its bound is bytes (2·M·K over 3.35 TB/s).
At the main path's shapes the inputs are small (0.6-2.4 MB) and a launch
has 9-144 tiles against 132 SMs, so the latency of one block's load
round trip and reduction decides its time. The cluster spreads a tile
over C SMs, so each block waits on 1/C of the bytes:
:func:`repro_torch.kernels.common.encode_cluster` takes the largest C
whose grid gives no SM a second block. The measured time sits in PERF.md
beside its bound.

Dims must be multiples of 128 (:func:`repro_torch.kernels.ops.encode_classes`
zero-pads both operands identically, so padding is class 0). On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. Only 128 x 128 tiles exist on the card. Off the
CPU it reports each launch (its bytes, 0 operations, its operands' shapes
and dtypes) to ``common.record_work``; on a fake or meta tensor (the
runner-key audit, ``repro_torch/analysis/trace_audit.py``) it reports the
same and returns an empty int32 class map of the output's shape,
launching nothing.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import common
from .ref import diff_encode_ref

#: Kernel launches so far (chip_smoke.py zeroes it and reads it around a run).
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def diff_encode(x_t: torch.Tensor, x_prev: torch.Tensor, *, bm: int = 128,
                bk: int = 128) -> torch.Tensor:
    """x_*: (..., M, K) int8 -> tile classes (..., M/bm, K/bk) int32."""
    global launches
    m, k = x_t.shape[-2:]
    if x_prev.shape != x_t.shape or m % bm or k % bk:
        raise ValueError(f"diff_encode: shapes {tuple(x_t.shape)}, {tuple(x_prev.shape)} "
                         f"do not tile by ({bm}, {bk})")
    if x_t.device.type == "cpu":
        return diff_encode_ref(x_t, x_prev, (bm, bk))
    if (bm, bk) != (128, 128):
        raise ValueError(f"diff_encode: the CUDA kernel tiles by 128, got ({bm}, {bk})")
    tiles = math.prod(x_t.shape[:-2]) * (m // 128) * (k // 128)
    common.record_work("diff_encode", flops=0.0, nbytes=float(2 * x_t.numel() + 4 * tiles),
                       dtype=torch.int8, static=dict(operands=common.operands(x_t, x_prev)))
    if common.is_fake(x_t):
        return _empty_classes(x_t)
    common.check_cuda_operand("diff_encode x_t", x_t, torch.int8)
    common.check_cuda_operand("diff_encode x_prev", x_prev, torch.int8)
    out = launch(x_t, x_prev)
    launches += 1
    return out


def launch(x_t: torch.Tensor, x_prev: torch.Tensor, cluster: int = 0) -> torch.Tensor:
    """One launch of the C entry on checked operands; no count. ``cluster``
    0 takes :func:`repro_torch.kernels.common.encode_cluster`'s size; 1, 2,
    4 or 8 forces it (the parity of every size in chip_smoke.py, the sweep
    of benchmarks/torch_encode_sweep.py)."""
    (m, k), lead = x_t.shape[-2:], x_t.shape[:-2]
    batch, gm, gk = math.prod(lead), m // 128, k // 128
    out = _empty_classes(x_t)
    cluster = cluster or common.encode_cluster(batch * gm * gk, common.sm_count(x_t.device))
    common.call("diff_encode", "ditto_diff_encode", _ARGTYPES, x_t.device, x_t.data_ptr(),
                x_prev.data_ptr(), out.data_ptr(), batch, m, k, m * k, gm * gk,
                common.LOW_BIT_MAX, cluster)
    return out


def _empty_classes(x_t: torch.Tensor) -> torch.Tensor:
    """The launch's result, unwritten: (..., M/128, K/128) int32."""
    (m, k), lead = x_t.shape[-2:], x_t.shape[:-2]
    return torch.empty(lead + (m // 128, k // 128), dtype=torch.int32, device=x_t.device)
