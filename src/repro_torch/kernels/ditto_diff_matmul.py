"""Ditto Compute-Unit kernel: tile-skipping temporal-difference GEMM, for Hopper.

    y_t = y_prev + (x_t - x_prev) @ W        (all-int32 exact)

Replaces ``src/repro/kernels/ditto_diff_matmul.py: ditto_diff_matmul``
(Pallas body ``_kernel`` with ``_dot_w`` and, for ``low_bits=4``,
``_w_lane_pair`` over the ``int4_pack`` helpers), with and without
``y_prev`` and with W as (K, N) or, ``w_transposed``, as (N, K).

Kernel (``csrc/ditto_diff_matmul.cu`` over ``csrc/diff_gemm_sm90.cuh``):
one 128-thread block (one warpgroup) per 64 x 128 output tile and K
split, three blocks an SM. The block reads its row of tile classes once, compacts
the live (class != 0) 128-K tiles into a list, and walks only their 64-K
chunks through a 3-stage ring of raw x_t, x_prev and W bytes filled by
``cp.async`` 16-byte copies, two chunks ahead of the product. Each thread
builds its ``wgmma`` A fragments in registers from the staged bytes:
Δ = x_t - x_prev lies in [-254, 254] and does not fit an int8 operand,
so a fragment word with a lane outside [-127, 127] is split exactly into
lo = clamp(Δ, -127, 127) and hi = Δ - lo, both int8, into the same int32
accumulator; the warpgroup votes whether any hi lane is non-zero and
skips the second product when none is. The products are
``wgmma.m64n128k32`` s8 x s8 -> s32, A from registers and W from shared
memory K-major, as int8 ``wgmma`` requires: the kernel takes W as (N, K)
(``w_transposed``, as the compiled pass keeps its linear weights); the
wrapper lays a (K, N) weight out so before the launch. Where a launch
would leave SMs idle or walk a long K, the kernel splits K across the
blocks of a thread-block cluster at 128-K tile boundaries (its choice,
from the shape and the card's SM count, is
:func:`repro_torch.kernels.common.diff_gemm_splits`); the blocks sum their
partial tiles through distributed shared memory. Every block stages its
output tile through shared memory and adds y_prev as it stores 16-byte
vectors, a warp a whole row. Integer addition is associative, so the
result is the same int32 bits for any split. A leading batch dim runs as
the grid's z axis: the two attention sub-operations of all (batch x
heads) elements are one launch each.

``low_bits=4``: a class-1 chunk's lanes go through the int4 lane format
(the pack -> unpack round trip of ``int4_pack``, in registers) and skip
the split and the vote; class-2 chunks keep the lo/hi split. The H100 has
no int4 x int8 tensor-core product, so, as on the reference's v5e, the
packed word is a format, not fewer multiplies. The class-1 verdict keeps
every lane in the exact [-8, 7] range, so both branches give the same
int32 result. These launches count in :data:`launches_int4`.

What bounds it on the H100: bytes at the B = 2 shapes (the int32 y_prev
read and y write dominate), and it does less work the more class-0 tiles
the data has. Its measured time sits in PERF.md beside its bound.

Dims must be multiples of 128 (:func:`repro_torch.kernels.ops.ditto_linear_step`
zero-pads). On a CPU tensor the wrapper runs the plain version, which
drops class-0 tiles exactly as the kernel skips it (and packs class-1
tiles for ``low_bits=4``); on a CUDA tensor it launches the kernel or
raises. Off the CPU it reports each launch to ``common.record_work``: its
static arguments (the operands' shapes and dtypes, ``low_bits``,
``w_transposed``, whether ``y_prev`` is given) and its work. The work
depends on the classes, which a fake tensor does not hold, so it reports
the dense count: ``2 batch M N K`` operations and every operand's bytes,
as if every class tile were live. On a fake or meta tensor (the runner-key
audit, ``repro_torch/analysis/trace_audit.py``) it reports the same and
returns an empty int32 result of the output's shape, launching nothing.
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
    common.refuse_dtensor("ditto_diff_matmul", x_t, x_prev, w_q, y_prev, classes)
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
    if not w_transposed:  # the kernel reads W K-major, as int8 wgmma does
        w_q = w_q.transpose(-1, -2).contiguous()
    rows = math.prod(lead) * m
    common.record_work(
        "ditto_diff_matmul", flops=2.0 * rows * n * k,
        nbytes=float(2 * x_t.numel() + w_q.numel() + 4 * classes.numel()
                     + 4 * rows * n * (1 if y_prev is None else 2)),
        dtype=torch.int8,
        static=dict(operands=common.operands(x_t, x_prev, w_q, y_prev, classes),
                    low_bits=low_bits, w_transposed=w_transposed, y_prev=y_prev is not None))
    if common.is_fake(x_t):
        return _empty_out(x_t, w_q)
    common.check_cuda_operand("ditto_diff_matmul x_t", x_t, torch.int8)
    common.check_cuda_operand("ditto_diff_matmul x_prev", x_prev, torch.int8)
    common.check_cuda_operand("ditto_diff_matmul w_q", w_q, torch.int8)
    common.check_cuda_operand("ditto_diff_matmul classes", classes, torch.int32)
    if y_prev is not None:
        common.check_cuda_operand("ditto_diff_matmul y_prev", y_prev, torch.int32)
    out = launch(x_t, x_prev, w_q, y_prev, classes, low_bits)
    if low_bits == 4:
        launches_int4 += 1
    else:
        launches += 1
    return out


def launch(x_t, x_prev, w_nk, y_prev, classes, low_bits, splits=0) -> torch.Tensor:
    """One launch of the C entry on checked operands, W (..., N, K); no
    count. ``splits`` 0 is the kernel's own K split, a positive count forces
    it (the parity of every split count in chip_smoke.py, the split sweep
    of benchmarks/torch_diff_gemm_sweep.py)."""
    common.validate_low_bits(low_bits)
    (m, k), n = x_t.shape[-2:], w_nk.shape[-2]
    lead = x_t.shape[:-2]
    out = _empty_out(x_t, w_nk)
    common.call("ditto_diff_matmul", "ditto_diff_matmul", _ARGTYPES, x_t.device,
                x_t.data_ptr(), x_prev.data_ptr(), w_nk.data_ptr(),
                None if y_prev is None else y_prev.data_ptr(), classes.data_ptr(),
                out.data_ptr(), math.prod(lead), m, n, k, m * k, n * k, m * n,
                (m // 128) * (k // 128), low_bits, splits)
    return out


def _empty_out(x_t: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """The launch's result, unwritten: (..., M, N) int32 for W (..., N, K)."""
    return torch.empty(x_t.shape[:-1] + (w_nk.shape[-2],), dtype=torch.int32,
                       device=x_t.device)
