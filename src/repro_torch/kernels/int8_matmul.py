"""Tiled int8 GEMM (the ITC-baseline compute path), hand-written for Hopper.

Replaces ``src/repro/kernels/int8_matmul.py: int8_matmul`` (Pallas body
``_kernel``): (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

Kernel (``csrc/int8_matmul.cu`` over ``csrc/diff_gemm_sm90.cuh``, the
mainloop of the two difference GEMMs): one 128-thread block (one
warpgroup) per 64 x 128 output tile and K split, three blocks an SM. The
x and W chunks (64 K bytes a row) stream through a 3-stage ring of
64-byte-swizzled rows filled by ``cp.async`` 16-byte copies, two chunks
ahead of the product, and ``wgmma.m64n128k32`` s8 x s8 -> s32 reads both
operands from there: x as it is (a -128 lane is exact; A from shared
memory was 1-8 % faster than fragments built in registers) and W
K-major, as int8 ``wgmma`` requires. The kernel takes W as (N, K)
(``w_transposed``, as the compiled pass keeps its linear weights and as
attention passes its K rows); the wrapper lays a (K, N) weight out so
before the launch. Where a launch would leave SMs idle or walk a long K,
the kernel splits K across the blocks of a thread-block cluster (its own
choice, ``choose_splits``) and sums the partial tiles through distributed
shared memory, bit-identically. Every block stages its output tile
through shared memory and stores it in 16-byte vectors, a warp a whole
row. A leading batch dim runs as the grid's z axis, one launch for all
(batch x heads) elements of an attention layer.

What bounds it on the H100: at the main path's DiT-XL/2 shapes at B = 2
(512 token rows, K and N of 1152..6912) a GEMM does 170-360 int8
operations per byte it must move (int8 operands in, int32 results out),
below the card's balance point of 1979e12 / 3.35e12 = 590, so its bound
is bytes, and the int32 output is the largest stream; at 36-288 output
tiles the launch and the pipeline's fill weigh as much. The 64-row tiles
give the grid enough blocks, the ring keeps loads in flight behind the
tensor cores, and the split shortens a long K walk. Its measured time
sits in PERF.md beside its bound.

Dims must be multiples of 128 (:func:`repro_torch.kernels.ops.int8_act_matmul`
zero-pads, exactly as the reference's ops wrapper does). On a CPU tensor
the wrapper runs the plain version (``kernels.ref``); on a CUDA tensor it
launches the kernel or raises. On the card it reports each launch's work
(``2 batch M N K`` int8 operations, the operands' and the int32 result's
bytes) and its static arguments to ``common.record_work``. On a fake or
meta tensor (the step analyzer's dry run, ``repro_torch/launch/op_analysis.py``;
the runner-key audit, ``repro_torch/analysis/trace_audit.py``) it reports the
same and returns an empty int32 result of the output's shape: it carries
no data and launches nothing.
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
    if w_q.shape[:-2] != x_q.shape[:-2]:
        raise ValueError(f"int8_matmul: batch dims differ: {tuple(x_q.shape)} vs {tuple(w_q.shape)}")
    if not w_transposed:  # the kernel reads W K-major, as int8 wgmma does
        w_q = w_q.transpose(-1, -2).contiguous()
    lead = x_q.shape[:-2]
    common.record_work("int8_matmul", flops=2.0 * math.prod(lead) * m * n * k,
                       nbytes=float(x_q.numel() + w_q.numel() + 4 * math.prod(lead) * m * n),
                       dtype=torch.int8,
                       static=dict(operands=common.operands(x_q, w_q), w_transposed=w_transposed))
    if common.is_fake(x_q):
        return torch.empty(lead + (m, n), dtype=torch.int32, device=x_q.device)
    common.check_cuda_operand("int8_matmul x_q", x_q, torch.int8)
    common.check_cuda_operand("int8_matmul w_q", w_q, torch.int8)
    out = launch(x_q, w_q)
    launches += 1
    return out


def launch(x, w_nk, splits=0) -> torch.Tensor:
    """One launch of the C entry on checked operands, W (..., N, K); no
    count. ``splits`` 0 is the kernel's own K split, a positive count forces
    it (the parity of every split count in chip_smoke.py, the split sweep
    of benchmarks/torch_diff_gemm_sweep.py)."""
    (m, k), n = x.shape[-2:], w_nk.shape[-2]
    lead = x.shape[:-2]
    out = torch.empty(lead + (m, n), dtype=torch.int32, device=x.device)
    common.call("int8_matmul", "ditto_int8_matmul", _ARGTYPES, x.device, x.data_ptr(),
                w_nk.data_ptr(), out.data_ptr(), math.prod(lead), m, n, k, m * k, n * k,
                m * n, splits)
    return out
