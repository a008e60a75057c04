"""Compiled execution pass of the DittoEngine (paper §IV-C deployment).

Mirror of ``src/repro/core/ditto/compiled.py``. The eager
:class:`~repro_torch.core.ditto.engine.DittoEngine` is the calibration
pass; once its scales and per-layer modes are fixed, the remaining steps
run through the kernels:

  act   layers (and spatial ones, whose eager branch computes the direct
        GEMM) launch ``int8_matmul``;
  diff  layers launch ``diff_encode`` then ``ditto_diff_matmul``, so zero
        tiles are skipped on the card (with ``plan.low_bits=4``, class-1
        tiles run through its packed-int4 branch); with ``plan.fused`` they
        launch ``diff_encode_fused`` then ``ditto_fused_matmul``, which
        reads the Δ-cache instead of the raw activations. Every flow gives
        the same int32 result and the same class map, and the measured
        per-step tile-class histogram (``tile_hist``) feeds the pricing.

Every operand crosses into int8 through ``quantize_rows`` and every
int32 result back through ``dequantize_rows``
(``repro_torch/kernels/quant_rows.py``), one launch each way, with the
bits of the eager engine's chains (``quant.py``).

Weights. The int8 tensor cores read B only K-major, so the pass keeps
each linear layer's int8 weight as (N, K), ``w_qk`` (the reference's
``w_q`` transposed, made once when the pass is built) and calls every
kernel with ``w_transposed=True``; every wrapper still takes a (K, N)
weight from other callers (the difference GEMMs lay it out K-major for
their kernel first).

Nothing is traced: PyTorch runs eagerly, and "compiled" names the pass
that launches the hand-written kernels. Where the reference scanned the
attention identity over the (batch x heads) dim, each sub-operation here
is one batched launch, bit-identical to the per-element loop. Token and
feature dims are zero-padded to the 128-tile grid inside the ops wrappers,
so the pass is bit-identical to the eager engine in the int32 domain.

With ``collect_stats`` the step also reduces zero/low/full class counts
on the card and returns them as (3,) tensors in an aux dict; the engine
turns them into the eager pass's float32 fractions and cost-model records
(``record_compiled_step``).
"""
from __future__ import annotations

import torch

from ...kernels import ops
from ...kernels.common import LOW_BIT_MAX
from ...kernels.quant_rows import dequantize_rows, quantize_rows
from . import classify
from .engine import DittoEngine
from .plan import DittoPlan


def _class_counts(d: torch.Tensor) -> torch.Tensor:
    """(zero, low, full) element counts of an int-domain tensor, (3,) int64.
    Counts, not fractions: the row groups of a split dispatch add up to the
    whole batch's exactly; the engine forms the fractions on the host
    (``engine.class_fractions``), as ``classify`` does."""
    a = d.to(torch.int32).abs()
    return torch.stack([(a == 0).sum(), ((a > 0) & (a <= LOW_BIT_MAX)).sum(),
                        (a > LOW_BIT_MAX).sum()])


def _tile_hist(classes: torch.Tensor) -> torch.Tensor:
    """(n_zero, n_low, n_full) histogram of a diff_encode class map — the
    tiles the kernel actually skipped / would narrow / ran at int8. (Not
    ``torch.bincount``: on CUDA it reads the maximum back to the host.)"""
    return torch.stack([(classes == c).sum() for c in range(3)])


def linear_apply(p: dict, mode: str, x: torch.Tensor, st: dict, *,
                 plan: DittoPlan) -> tuple[torch.Tensor, dict, dict]:
    """Compiled linear op: params in, state in -> (y fp32, state, aux).
    Bit-identical int32 y_prev to the eager path for every mode."""
    x2 = x.reshape(-1, x.shape[-1])
    n = p["w_qk"].shape[0]
    q_t = quantize_rows(x2, p["x_scale"])

    aux: dict = {}
    if mode == "diff":
        y_i32, classes = ops.ditto_linear_step(q_t, st["x_prev"], p["w_qk"], st["y_prev"],
                                               plan=plan, w_transposed=True)
        if plan.collect_stats:
            aux["tile_hist"] = _tile_hist(classes)
    else:  # act, and spatial (whose eager branch computes the direct GEMM)
        y_i32 = ops.int8_act_matmul(q_t, p["w_qk"], plan=plan, w_transposed=True)
    if plan.collect_stats:
        if mode == "spatial":
            aux["cls_diff"] = _class_counts(classify.spatial_diff(q_t, axis=0)[1:])
        else:
            aux["cls_diff"] = _class_counts(q_t.to(torch.int16) - st["x_prev"].to(torch.int16))
        if q_t.shape[0] > 1:
            aux["cls_spatial"] = _class_counts(classify.spatial_diff(q_t, axis=0)[1:])
        aux["cls_act"] = _class_counts(q_t)

    new_st = dict(x_prev=q_t, y_prev=y_i32)
    y = dequantize_rows(y_i32, p["x_scale"], p["w_scale"][None, :], p["bias"])
    return y.reshape(x.shape[:-1] + (n,)), new_st, aux


def attention_apply(p: dict, mode: str, a: torch.Tensor, b: torch.Tensor, st: dict, *,
                    plan: DittoPlan) -> tuple[torch.Tensor, dict, dict]:
    """Compiled attention matmul (a @ b^T per leading-dim element): diff
    mode composes the two-sub-op identity (ops.attention_delta), act mode
    runs int8_matmul against b's rows; one launch per kernel for all
    (batch x heads) elements."""
    lead = a.shape[:-2]
    m, d_ = a.shape[-2:]
    n = b.shape[-2]
    a2 = a.reshape(-1, m, d_)
    b2 = b.reshape(-1, n, d_)
    qa = quantize_rows(a2, p["a_scale"])
    qb = quantize_rows(b2, p["b_scale"])

    aux: dict = {}
    if mode == "diff":
        y_i32, (cls_dk, cls_dq) = ops.attention_delta(qa, st["a_prev"], qb, st["b_prev"],
                                                      st["y_prev"], plan=plan)
        if plan.collect_stats:  # both sub-ops, all (batch x heads) elements
            aux["tile_hist"] = _tile_hist(cls_dk) + _tile_hist(cls_dq)
    else:
        y_i32 = ops.int8_act_matmul(qa, qb, plan=plan, w_transposed=True)
    if plan.collect_stats:
        da = qa.to(torch.int16) - st["a_prev"].to(torch.int16)
        db = qb.to(torch.int16) - st["b_prev"].to(torch.int16)
        aux["cls_diff"] = _class_counts(torch.cat([da.reshape(-1), db.reshape(-1)]))
        aux["cls_act"] = _class_counts(torch.cat([qa.reshape(-1), qb.reshape(-1)]))

    new_st = dict(a_prev=qa, b_prev=qb, y_prev=y_i32)
    y = dequantize_rows(y_i32, p["a_scale"], p["b_scale"])
    return y.reshape(lead + (m, n)), new_st, aux


class CompiledDittoEngine:
    """Per-layer compiled ops with static modes, built from a calibrated
    eager engine. All methods are pure (state in, state out). ``weights``
    (per linear layer ``w_qk`` / ``w_scale`` / ``bias``, as a runner cache
    keeps them for its params) replaces the K-major weights this engine
    would otherwise make from the eager engine's."""

    def __init__(self, engine: DittoEngine, *, plan: DittoPlan | None = None,
                 weights: dict | None = None):
        if not engine.ready_for_compiled():
            raise ValueError(
                "engine not calibrated: run >= 1 eager step (>= 2 for defo policies, "
                "whose mode decision lands after the step-2 diff probe) before "
                f"compiling (step_idx={engine.step_idx}, decided={engine._decided})")
        self.plan = DittoPlan() if plan is None else plan
        self.engine = engine
        self.modes = engine.compiled_modes()
        self.meta = engine.meta
        self.params: dict[str, dict] = {}
        for name, st in engine.layers.items():
            if st.w is not None:
                w = (dict(w_qk=st.w.q.t().contiguous(), w_scale=st.w.scale, bias=st.bias)
                     if weights is None else weights[name])
                self.params[name] = dict(w, x_scale=st.x_scale)
            else:
                self.params[name] = dict(a_scale=st.a_scale, b_scale=st.b_scale)

    def init_state(self) -> dict:
        """Initial temporal state = the eager engine's state after its last
        calibration step (int8 x_prev / int32 y_prev per layer)."""
        state: dict[str, dict] = {}
        for name, st in self.engine.layers.items():
            if st.w is not None:
                state[name] = dict(x_prev=st.x_prev, y_prev=st.y_prev)
            else:
                state[name] = dict(a_prev=st.a_prev, b_prev=st.b_prev, y_prev=st.y_prev)
        return state

    def linear(self, name: str, x: torch.Tensor, st: dict) -> tuple[torch.Tensor, dict, dict]:
        """Mirror of DittoEngine.linear with the mode fixed; delegates to
        :func:`linear_apply`."""
        return linear_apply(self.params[name], self.modes[name], x, st, plan=self.plan)

    def attention_matmul(self, name: str, a: torch.Tensor, b: torch.Tensor,
                         st: dict) -> tuple[torch.Tensor, dict, dict]:
        """Mirror of DittoEngine.attention_matmul with the mode fixed;
        delegates to :func:`attention_apply`."""
        return attention_apply(self.params[name], self.modes[name], a, b, st, plan=self.plan)
