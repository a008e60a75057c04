"""Ditto Compute-Unit kernel: tile-skipping temporal-difference GEMM, for Hopper.

    y_t = y_prev + (x_t - x_prev) @ W        (all-int32 exact)

Replaces ``src/repro/kernels/ditto_diff_matmul.py: ditto_diff_matmul``
(Pallas body ``_kernel`` with ``_dot_w`` and, for ``low_bits=4``,
``_w_lane_pair`` over the ``int4_pack`` helpers), with and without
``y_prev`` and with W as (K, N) or, ``w_transposed``, as (N, K).

Kernel (``csrc/ditto_diff_matmul.cu`` over ``csrc/tile_mma.cuh``): one
256-thread block per 128 x 128 output tile, K staged through shared memory
in 64-byte chunks, products on the int8 tensor cores with
``mma.sync.m16n8k32``. Δ is recomputed from the int8 operands while a
chunk is staged, so no Δ tensor lands in device memory. Δ lies in
[-254, 254] and does not fit an int8 operand, so it is split exactly into
lo = clamp(Δ, -127, 127) and hi = Δ - lo, both int8, and both products
go into the same int32 accumulator; the block votes whether any hi is
non-zero and skips the second product when none is (always for class-1
tiles). A class-0 tile issues no load and no product. A leading batch dim
runs as the grid's z axis: the two attention sub-operations of all
(batch x heads) elements are one launch each.

``low_bits=4``: a class-1 chunk is staged as packed int4 x 2 words
(``csrc/int4_pack.cuh``), 32 bytes a row instead of 64, and unpacked into
the ``mma.sync`` operand as its fragments load; class-2 chunks keep the
lo/hi split. The H100 has no int4 x int8 tensor-core product, so, as on
the reference's v5e, the packed word is a storage format: it halves the
shared-memory bytes of a low chunk, not its multiplies. The class-1
verdict keeps every lane in the exact [-8, 7] range, so both branches give
the same int32 result. These launches count in :data:`launches_int4`.

What bounds it on the H100: as for int8_matmul, bytes at the B = 2 shapes
(the int32 y_prev read and y write dominate), and it does less work the
more class-0 tiles the data has. This first version stages synchronously
and uses ``mma.sync``; the measured time sits in PERF.md beside its bound.

Dims must be multiples of 128 (:func:`repro_torch.kernels.ops.ditto_linear_step`
zero-pads). On a CPU tensor the wrapper runs the plain version, which
drops class-0 tiles exactly as the kernel skips it (and packs class-1
tiles for ``low_bits=4``); on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import common
from .ref import ditto_diff_matmul_ref

#: Kernel launches so far, ``low_bits=8`` and ``low_bits=4`` apart
#: (chip_smoke.py zeroes them and reads them around a run).
launches = 0
launches_int4 = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def ditto_diff_matmul(x_t: torch.Tensor, x_prev: torch.Tensor, w_q: torch.Tensor,
                      y_prev: torch.Tensor | None, classes: torch.Tensor, *,
                      bm: int = 128, bn: int = 128, bk: int = 128,
                      low_bits: int = common.DEFAULT_LOW_BITS,
                      w_transposed: bool = False) -> torch.Tensor:
    """x_*: (..., M, K) int8; w_q: (..., K, N) int8 — or (..., N, K) with
    ``w_transposed``; y_prev: (..., M, N) int32 or None (the bare diff
    contribution); classes: (..., M/bm, K/bk) int32 from diff_encode.
    Returns y_t (..., M, N) int32."""
    global launches, launches_int4
    common.validate_low_bits(low_bits)
    m, k = x_t.shape[-2:]
    n, k2 = w_q.shape[-2:] if w_transposed else w_q.shape[-2:][::-1]
    lead = x_t.shape[:-2]
    if (x_prev.shape != x_t.shape or k != k2 or m % bm or n % bn or k % bk
            or tuple(classes.shape) != lead + (m // bm, k // bk)
            or (y_prev is not None and tuple(y_prev.shape) != lead + (m, n))):
        raise ValueError(
            f"ditto_diff_matmul: inconsistent shapes x_t {tuple(x_t.shape)}, w_q "
            f"{tuple(w_q.shape)} (w_transposed={w_transposed}), classes "
            f"{tuple(classes.shape)}, y_prev "
            f"{None if y_prev is None else tuple(y_prev.shape)} for tiles ({bm}, {bn}, {bk})")
    if low_bits == 4 and bk % 2:
        raise ValueError(f"ditto_diff_matmul: low_bits=4 pairs K lanes, so bk must be even, "
                         f"got {bk}")
    if x_t.device.type == "cpu":
        return ditto_diff_matmul_ref(x_t, x_prev, w_q, y_prev, classes, (bm, bk),
                                     w_transposed=w_transposed, low_bits=low_bits)
    if (bm, bn, bk) != (128, 128, 128):
        raise ValueError(f"ditto_diff_matmul: the CUDA kernel tiles by 128, got ({bm}, {bn}, {bk})")
    if w_q.shape[:-2] != lead:
        raise ValueError(f"ditto_diff_matmul: batch dims differ: {tuple(x_t.shape)} vs "
                         f"{tuple(w_q.shape)}")
    common.check_cuda_operand("ditto_diff_matmul x_t", x_t, torch.int8)
    common.check_cuda_operand("ditto_diff_matmul x_prev", x_prev, torch.int8)
    common.check_cuda_operand("ditto_diff_matmul w_q", w_q, torch.int8)
    common.check_cuda_operand("ditto_diff_matmul classes", classes, torch.int32)
    if y_prev is not None:
        common.check_cuda_operand("ditto_diff_matmul y_prev", y_prev, torch.int32)
    out = torch.empty(lead + (m, n), dtype=torch.int32, device=x_t.device)
    fn = common.cuda_fn("ditto_diff_matmul", _ARGTYPES)
    rc = fn(x_t.data_ptr(), x_prev.data_ptr(), w_q.data_ptr(),
            None if y_prev is None else y_prev.data_ptr(), classes.data_ptr(),
            out.data_ptr(), math.prod(lead), m, n, k, m * k, n * k, m * n,
            (m // bm) * (k // bk), int(w_transposed), low_bits, common.stream_ptr(x_t))
    common.launch_check("ditto_diff_matmul", rc)
    if low_bits == 4:
        launches_int4 += 1
    else:
        launches += 1
    return out
