"""The compiled step's int8 boundary, one pass each way, for Hopper.

Replaces no TPU kernel: the reference's compiled pass leaves the
quantise and dequantise chains around each int8 product to XLA, which
fuses each into one loop. PyTorch runs them as chains of launches; these
two kernels (``csrc/quant_rows.cu``) take their place in
``core/ditto/compiled.py``:

* :func:`quantize_rows` — fp32 -> int8, ``clamp(rint(x / scale), ±127)``
  with IEEE division and round half to even, the bits of
  ``core/ditto/quant.py:quantize``. ``scale`` holds one value per group of
  consecutive rows: a row each for a linear layer's ``(T, 1)`` scale, M
  (or N) rows each for an attention operand's per-(sample, head)
  ``(B, 1, 1)`` scale. 4 bytes in and 1 out an element. ``x`` is read in
  place where it is contiguous or the transpose of a contiguous tensor
  (attention's ``V^T``); any other layout is copied first, and the copy's
  8 bytes an element are counted with the launch's.
* :func:`dequantize_rows` — int32 -> fp32,
  ``((float)y * s_row) * s_col (+ bias)`` rounded step by step as the
  chain ``y.to(float32) * s_row * s_col + bias`` is. ``s_row`` is grouped
  by rows as ``scale`` above; ``s_col`` is a column vector (a linear
  layer's ``w_scale[None, :]``) or grouped by rows (attention's
  ``b_scale``); ``bias`` is a column vector or ``None``. ``y`` may be a
  row and column slice of a padded GEMM result (strided rows,
  :func:`~repro_torch.kernels.common.row_strides`): the kernel reads it in
  place. 4 bytes in and 4 out an element.

What bounds both on the H100: bytes (5 and 8 an element over 3.35
TB/s), with a few operations an element. The chains they replace moved
about 29 and 32 bytes an element over four and three or four launches.
Their measured times sit in PERF.md beside their bounds.

On a CPU tensor each wrapper runs its plain version (``kernels.ref``); on
a CUDA tensor it launches the kernel or raises. Off the CPU it reports
each launch (its bytes, no int8 operations, its operands' shapes and
dtypes) to ``common.record_work``; on a fake or meta tensor (the
runner-key audit, ``repro_torch/analysis/trace_audit.py``) it reports the
same and returns an empty result of the output's shape and dtype,
launching nothing.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import common
from .ref import dequantize_rows_ref, quantize_rows_ref

__all__ = ["quantize_rows", "dequantize_rows", "quantize_launches", "dequantize_launches"]

#: Kernel launches so far, per kernel (the runner cache counts them per capture).
quantize_launches = 0
dequantize_launches = 0

_QUANTIZE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
_DEQUANTIZE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]


def _rows_each(s: torch.Tensor, x: torch.Tensor, name: str) -> int:
    """The consecutive rows of ``x`` (its leading dims and rows flattened)
    that each value of ``s`` covers: ``s`` has ``x``'s dims, matches its
    leading dims up to some point and is 1 after it."""
    rows = math.prod(x.shape[:-1])
    j = s.dim()
    while j and s.shape[j - 1] == 1:
        j -= 1
    if s.dim() != x.dim() or j == x.dim() or tuple(s.shape[:j]) != tuple(x.shape[:j]):
        raise ValueError(f"{name}: shape {tuple(s.shape)} does not group the rows of "
                         f"{tuple(x.shape)} (x's leading dims, then ones)")
    return rows // max(s.numel(), 1)


def quantize_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., R, W) float32, scale grouping its rows -> int8 of x's shape."""
    global quantize_launches
    common.refuse_dtensor("quantize_rows", x, scale)
    rows_each = _rows_each(scale, x, "quantize_rows scale")
    if x.device.type == "cpu":
        return quantize_rows_ref(x, scale)
    copied = 0
    if x.is_contiguous():
        read, t_rows, t_width = x, 0, 0
    elif x.dim() >= 2 and x.mT.is_contiguous():  # read transposed, in place
        read, (t_rows, t_width) = x.mT, x.shape[-2:]
    else:
        read, t_rows, t_width, copied = x.contiguous(), 0, 0, 8 * x.numel()
    common.record_work("quantize_rows", flops=0.0,
                       nbytes=float(5 * x.numel() + 4 * scale.numel() + copied),
                       dtype=torch.float32, static=dict(operands=common.operands(x, scale)))
    if common.is_fake(x):
        return _empty_like(x, torch.int8)
    common.check_cuda_operand("quantize_rows x", read, torch.float32, align=4)
    common.check_cuda_operand("quantize_rows scale", scale, torch.float32, align=4)
    q = _empty_like(x, torch.int8)
    common.call("quantize_rows", "ditto_quantize_rows", _QUANTIZE_ARGTYPES, x.device,
                read.data_ptr(), scale.data_ptr(), q.data_ptr(), x.numel(),
                rows_each * x.shape[-1], t_rows, t_width)
    quantize_launches += 1
    return q


def dequantize_rows(y: torch.Tensor, s_row: torch.Tensor, s_col: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """y (..., R, W) int32 -> float32 of y's shape, contiguous."""
    global dequantize_launches
    common.refuse_dtensor("dequantize_rows", y, s_row, s_col, bias)
    row_group = _rows_each(s_row, y, "dequantize_rows s_row")
    width = y.shape[-1]
    per_column = s_col.shape[-1] == width and s_col.numel() == width
    col_group = 0 if per_column else _rows_each(s_col, y, "dequantize_rows s_col")
    if bias is not None and bias.numel() != width:
        raise ValueError(f"dequantize_rows: bias of shape {tuple(bias.shape)} against "
                         f"{width} columns")
    if y.device.type == "cpu":
        return dequantize_rows_ref(y, s_row, s_col, bias)
    small = s_row.numel() + s_col.numel() + (0 if bias is None else width)
    common.record_work("dequantize_rows", flops=0.0, nbytes=float(8 * y.numel() + 4 * small),
                       dtype=torch.float32,
                       static=dict(operands=common.operands(y, s_row, s_col, bias)))
    if common.is_fake(y):
        return _empty_like(y, torch.float32)
    common.check_cuda_operand("dequantize_rows y", y, torch.int32, rows=True)
    common.check_cuda_operand("dequantize_rows s_row", s_row, torch.float32, align=4)
    common.check_cuda_operand("dequantize_rows s_col", s_col, torch.float32, align=4)
    if bias is not None:
        common.check_cuda_operand("dequantize_rows bias", bias, torch.float32, align=4)
    out = _empty_like(y, torch.float32)
    common.call("dequantize_rows", "ditto_dequantize_rows", _DEQUANTIZE_ARGTYPES, y.device,
                y.data_ptr(), out.data_ptr(), s_row.data_ptr(), s_col.data_ptr(),
                None if bias is None else bias.data_ptr(), math.prod(y.shape[:-1]), width,
                *common.row_strides(y), row_group, col_group)
    dequantize_launches += 1
    return out


def _empty_like(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The launch's result, unwritten: contiguous, of ``t``'s shape."""
    return torch.empty(t.shape, dtype=dtype, device=t.device)
