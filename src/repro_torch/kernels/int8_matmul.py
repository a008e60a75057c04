"""Tiled int8 GEMM (the ITC-baseline compute path), hand-written for Hopper.

Replaces ``src/repro/kernels/int8_matmul.py: int8_matmul`` (Pallas body
``_kernel``): (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

Kernel (``csrc/int8_matmul.cu`` over ``csrc/tile_mma.cuh``): one 256-thread
block per 128 x 128 output tile, K staged through shared memory in 64-byte
chunks, products on the int8 tensor cores with ``mma.sync.m16n8k32``
(s8 x s8 -> s32). The weight may arrive (K, N) — transposed into the
tensor-core "col" layout while it is staged — or (N, K) with
``w_transposed`` (the attention act path contracts Q against K rows with
no transposed copy). A leading batch dim runs as the grid's z axis, one
launch for all (batch x heads) elements of an attention layer.

What bounds it on the H100: at the main path's DiT-XL/2 shapes at B = 2
(512 token rows, K and N of 1152..6912) a GEMM does 170-360 int8
operations per byte it must move (int8 weights in, int32 results out),
below the card's balance point of 1979e12 / 3.35e12 = 590, so its bound
is bytes, and the int32 output is the largest stream. This first version
is simple rather than fast: synchronous staging (no cp.async or TMA
pipeline), ``mma.sync`` rather than ``wgmma``, and one block per output
tile, which leaves most of the 132 SMs idle at 36 tiles; the measured
time sits in PERF.md beside its bound.

Dims must be multiples of 128 (:func:`repro_torch.kernels.ops.int8_act_matmul`
zero-pads, exactly as the reference's ops wrapper does). On a CPU tensor
the wrapper runs the plain version (``kernels.ref``); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import common
from .ref import int8_matmul_ref

#: Kernel launches so far (chip_smoke.py zeroes it and reads it around a run).
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 7 + [ctypes.c_int, ctypes.c_void_p]


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, *, bm: int = 128, bn: int = 128,
                bk: int = 128, w_transposed: bool = False) -> torch.Tensor:
    """x_q (..., M, K) int8; w_q (..., K, N) int8, or (..., N, K) with
    ``w_transposed``. Returns (..., M, N) int32."""
    global launches
    m, k = x_q.shape[-2:]
    n, k2 = w_q.shape[-2:] if w_transposed else w_q.shape[-2:][::-1]
    if k != k2 or m % bm or n % bn or k % bk:
        raise ValueError(f"int8_matmul: shapes {tuple(x_q.shape)} @ {tuple(w_q.shape)} "
                         f"(w_transposed={w_transposed}) do not tile by ({bm}, {bn}, {bk})")
    if x_q.device.type == "cpu":
        return int8_matmul_ref(x_q, w_q, w_transposed=w_transposed)
    if (bm, bn, bk) != (128, 128, 128):
        raise ValueError(f"int8_matmul: the CUDA kernel tiles by 128, got ({bm}, {bn}, {bk})")
    lead = x_q.shape[:-2]
    if w_q.shape[:-2] != lead:
        raise ValueError(f"int8_matmul: batch dims differ: {tuple(x_q.shape)} vs {tuple(w_q.shape)}")
    common.check_cuda_operand("int8_matmul x_q", x_q, torch.int8)
    common.check_cuda_operand("int8_matmul w_q", w_q, torch.int8)
    out = torch.empty(lead + (m, n), dtype=torch.int32, device=x_q.device)
    fn = common.cuda_fn("ditto_int8_matmul", _ARGTYPES)
    rc = fn(x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), math.prod(lead), m, n, k,
            m * k, n * k, m * n, int(w_transposed), common.stream_ptr(x_q))
    common.launch_check("int8_matmul", rc)
    launches += 1
    return out
