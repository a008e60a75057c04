"""Public wrappers over the main-path kernels.

Mirror of ``src/repro/kernels/ops.py``. Every wrapper zero-pads its
operands' last two dims up to the 128-tile grid and slices the result back,
exactly as the reference does: padding contributes 0 to every int32 sum
and classifies as a zero tile, so the sliced result is bit-identical to
the unpadded computation. Operands may carry a leading batch dim, which
the kernels run in one launch (the reference scanned over it).

:func:`ditto_linear_step` runs the two-pass flow (``diff_encode`` ->
``ditto_diff_matmul``, whose ``low_bits=4`` branch runs class-1 tiles
through the packed-int4 word) or, with ``fused=True``, the fused flow
(``diff_encode_fused`` -> ``ditto_fused_matmul``, which reads the Δ-cache
instead of the raw activations). All of them give the same int32 result.

Every wrapper accepts ``plan=`` (anything with ``block`` / ``low_bits`` /
``fused`` attributes); a plan overrides the per-knob keywords. ``low_bits``
is validated here (ValueError on anything but 4 or 8).
"""
from __future__ import annotations

import torch

from .common import DEFAULT_LOW_BITS, pad2, validate_low_bits
from .diff_encode import diff_encode
from .ditto_diff_matmul import ditto_diff_matmul
from .fused_step import diff_encode_fused, ditto_fused_matmul
from .int8_matmul import int8_matmul


def _plan_knobs(plan, bm, bn, bk, low_bits, fused):
    """Resolve (plan | per-knob kwargs) to one kernel config; plan wins."""
    if plan is None:
        return bm, bn, bk, low_bits, fused
    b = plan.block
    return b, b, b, plan.low_bits, plan.fused


def int8_act_matmul(x_q, w_q, *, plan=None, bm=128, bn=128, bk=128,
                    low_bits=DEFAULT_LOW_BITS, fused=False, w_transposed=False):
    """(..., M, K) int8 @ (..., K, N) int8 — or (..., N, K) with
    ``w_transposed`` — -> (..., M, N) int32, exact (act-mode ITC path).

    ``low_bits`` and ``fused`` are validated, then ignored, as in the
    reference: the act GEMM has no Δ operand to narrow or skip.
    """
    bm, bn, bk, low_bits, fused = _plan_knobs(plan, bm, bn, bk, low_bits, fused)
    validate_low_bits(low_bits)
    m, k = x_q.shape[-2:]
    n = w_q.shape[-2] if w_transposed else w_q.shape[-1]
    xp = pad2(x_q, bm, bk)
    wp = pad2(w_q, bn, bk) if w_transposed else pad2(w_q, bk, bn)
    y = int8_matmul(xp.contiguous(), wp.contiguous(), bm=bm, bn=bn, bk=bk,
                    w_transposed=w_transposed)
    return y[..., :m, :n]


def quantized_matmul(x_q, w_q, x_scale, w_scale, *, bm=128, bn=128, bk=128):
    """int8 x int8 -> fp32 with scales (baseline act-mode path)."""
    y = int8_act_matmul(x_q, w_q, bm=bm, bn=bn, bk=bk)
    return y.to(torch.float32) * x_scale * w_scale[None, :]


def encode_classes(x_t_q, x_prev_q, *, bm=128, bk=128):
    """Tile classes of the zero-padded Δ, (..., ceil(M/bm), ceil(K/bk))."""
    xt = pad2(x_t_q, bm, bk)
    xp = pad2(x_prev_q, bm, bk)
    return diff_encode(xt.contiguous(), xp.contiguous(), bm=bm, bk=bk)


def ditto_linear_step(x_t_q, x_prev_q, w_q, y_prev_i32=None, *, plan=None, bm=128,
                      bn=128, bk=128, low_bits=DEFAULT_LOW_BITS, fused=False,
                      w_transposed=False):
    """One temporal-difference linear step, tile-skipped.

    Returns (y_t_i32 (..., M, N), classes (..., M/bm, K/bk)), exact int32,
    equal to y_prev + (x_t - x_prev) @ W however many tiles were skipped.
    ``y_prev_i32=None`` returns the bare diff contribution; ``w_transposed``
    takes W as (..., N, K) and the kernel reads it so, with no copy.

    ``low_bits=4`` runs class-1 tiles of the two-pass flow through the
    packed-int4 branch. ``fused=True`` runs the fused flow, whose Δ-cache
    is always the int4 format, so it ignores ``low_bits`` (as the
    reference does); its GEMM adds y_prev as it stores the output, where
    the reference adds it after the kernel, with the same int32 result.
    """
    bm, bn, bk, low_bits, fused = _plan_knobs(plan, bm, bn, bk, low_bits, fused)
    validate_low_bits(low_bits)
    m, k = x_t_q.shape[-2:]
    n = w_q.shape[-2] if w_transposed else w_q.shape[-1]
    xt = pad2(x_t_q, bm, bk).contiguous()
    xp = pad2(x_prev_q, bm, bk).contiguous()
    wp = (pad2(w_q, bn, bk) if w_transposed else pad2(w_q, bk, bn)).contiguous()
    yp = None if y_prev_i32 is None else pad2(y_prev_i32, bm, bn).contiguous()
    if fused:
        classes, dc, dh = diff_encode_fused(xt, xp, bm=bm, bk=bk)
        y = ditto_fused_matmul(wp, dc, dh, classes, yp, bm=bm, bn=bn, bk=bk,
                               w_transposed=w_transposed)
    else:
        classes = diff_encode(xt, xp, bm=bm, bk=bk)
        y = ditto_diff_matmul(xt, xp, wp, yp, classes, bm=bm, bn=bn, bk=bk,
                              low_bits=low_bits, w_transposed=w_transposed)
    return y[..., :m, :n], classes


def attention_delta(q_t, q_prev, k_t, k_prev, s_prev_i32, *, plan=None, **blk):
    """Paper §IV-A attention identity via two diff matmuls:

        S_t = S_prev + Q_t ΔK^T + ΔQ K_prev^T

    q_*: (..., M, D) int8; k_*: (..., N, D) int8; s_prev: (..., M, N) int32.
    Exact. Returns (S_t, (cls_dk, cls_dq)), the tile-class maps of both
    sub-operations. The stationary activation (Q_t, K_prev) feeds the
    kernel in its natural (rows, D) layout through ``w_transposed``, and
    neither sub-op takes a y_prev: S_prev joins in the sum below. ``plan``
    (or ``low_bits`` / ``fused`` in ``blk``) selects the flow of both
    sub-ops, as for :func:`ditto_linear_step`.
    """
    if plan is not None:
        blk = {}
    #   Q_t ΔK^T  = ((k_t - k_prev) @ Q_t^T)^T   — x = K rows, W = Q_t (N,K) layout
    #   ΔQ K_prev^T = (q_t - q_prev) @ K_prev^T  — W = K_prev in (N,K) layout
    y1, cls_dk = ditto_linear_step(k_t, k_prev, q_t, None, plan=plan, w_transposed=True, **blk)
    y2, cls_dq = ditto_linear_step(q_t, q_prev, k_prev, None, plan=plan, w_transposed=True,
                                   **blk)
    return s_prev_i32 + y1.transpose(-1, -2) + y2, (cls_dk, cls_dq)
