"""Symmetric INT8 quantization for the Ditto pipeline.

Mirror of ``src/repro/core/ditto/quant.py``, bit-exact: activation scales
are calibrated per sample on the first denoising step and held afterwards
(temporal differences are exact under a shared scale); weights are
quantized per output channel once.

Two details keep it bit-exact with the reference on the card as well as on
the CPU: every division divides by a tensor on the operand's device
(PyTorch's CUDA division by a Python scalar multiplies by the reciprocal,
which can differ in the last bit), and :func:`int_matmul` runs its products
in float64, which is exact for these integer ranges (PyTorch has no
integer matmul on CUDA). ``int_matmul`` stays outside any kernel, as in
the reference, so the eager pass is an independent oracle for the kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from ...kernels.ref import exact_matmul
from ...nn.core import divide


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor  # int8
    scale: torch.Tensor  # (N,) per output channel


def compute_scale(x: torch.Tensor, *, axis=None) -> torch.Tensor:
    a = x.to(torch.float32).abs()
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    return torch.where(amax > 0, divide(amax, 127.0), torch.ones_like(amax))


def sample_scale(x: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Per-sample max-abs activation scale, broadcastable against ``x``.

    ``x`` has ``n_samples`` equal row groups along dim 0; each sample's
    scale reduces over its own elements only (batch-composition
    invariance), returned with shape ``(rows, 1, ..., 1)``.
    """
    t = x.shape[0]
    if n_samples < 1 or t % n_samples:
        raise ValueError(f"cannot group {t} rows into {n_samples} samples")
    s = compute_scale(x.reshape(n_samples, -1), axis=1)  # (n_samples, 1)
    s = s.repeat_interleave(t // n_samples, dim=0)
    return s.reshape((t,) + (1,) * (x.dim() - 1))


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 divide, round half to even, clip to ±127."""
    q = torch.round(x.to(torch.float32) / scale)
    return q.clamp(-127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8. w: (K, N) -> scale (N,)."""
    s = compute_scale(w, axis=0)  # (1, N)
    return QTensor(quantize(w, s), s.reshape(-1))


def int_matmul(a_int: torch.Tensor, b_int: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul with int32 result (contracts a's last dim with
    b's first)."""
    return exact_matmul(a_int, b_int)
