"""The Ditto temporal-difference processing engine (paper §IV).

Mirror of ``src/repro/core/ditto/engine.py``. The engine intercepts every
linear operation of a denoiser during the reverse-diffusion loop and runs
it in one of three modes:

  act     : direct quantized GEMM  y = W_q · q_t                (step 1, and
            layers Defo decides to keep)
  diff    : temporal differences   y_t = y_{t+1} + W_q · Δq     (steps >= 2)
  spatial : Diffy-style row deltas (Defo+ for act-mode layers)

All difference math is exact in the integer domain, so ``diff`` is
bit-identical to ``act`` under a shared scale. Per layer and per step the
engine records zero/low/full fractions, BOPs, simulated memory traffic and
cycle estimates; Defo uses the step-1 (act) and step-2 (diff) cycles to
fix each layer's mode for the remaining steps (§IV-B).

This eager pass calls no kernel: its products go through
``quant.int_matmul`` (exact float64 products), so it is an independent
oracle for the compiled pass that runs the CUDA kernels.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any

import torch

from ...kernels.common import resolve_device
from ...kernels.ref import exact_matmul
from . import bops as bops_mod
from . import classify, quant
from .hwmodel import DEFAULT_HW, HwModel


@dataclasses.dataclass
class LayerMeta:
    name: str
    kind: str = "dense"  # dense | attn_qk | attn_pv
    boundary_in: bool = True  # input produced by a non-linear op
    boundary_out: bool = True  # output consumed by a non-linear op


@dataclasses.dataclass
class _LayerState:
    w: quant.QTensor | None = None
    bias: torch.Tensor | None = None
    x_scale: torch.Tensor | None = None
    x_prev: torch.Tensor | None = None  # int8 of previous step
    y_prev: torch.Tensor | None = None  # int32 accumulation of previous step
    mode: str = "act"
    # attention state
    a_prev: torch.Tensor | None = None  # lhs int8 of previous step
    b_prev: torch.Tensor | None = None  # rhs int8 of previous step
    a_scale: torch.Tensor | None = None
    b_scale: torch.Tensor | None = None


def class_fractions(counts) -> torch.Tensor:
    """Float32 fractions of (zero, low, full) class counts, (3,) or (R, 3):
    each ``float32(count) / float32(n)`` as :mod:`classify` forms them (n =
    the counts' sum, the elements classified; exact in float64)."""
    c = torch.tensor(counts, dtype=torch.float64)
    return c.to(torch.float32) / c.sum(-1, keepdim=True).to(torch.float32)


def _compiled_classes(host: dict, t_of: dict) -> dict:
    """``{layer: (cls_act, cls_diff, cls_spatial)}`` from one compiled step's
    host counts, in the float32 arithmetic of the reference's compiled step
    (all layers in a few tensor ops): cls_act is (zero, 0, low + full);
    cls_spatial weights the row deltas by 1 - 1/t and folds the
    full-precision first of the layer's ``t_of`` rows in at 1/t."""
    rows = [(n, k) for n, a in host.items() for k in a if k != "tile_hist"]
    frac = class_fractions([host[n][k] for n, k in rows])
    sp = [i for i, (_, k) in enumerate(rows) if k == "cls_spatial"]
    if sp:
        w0 = [1.0 / t_of[rows[i][0]] for i in sp]
        s = frac[sp] * torch.tensor([1 - w for w in w0], dtype=torch.float32)[:, None]
        s[:, 2] = s[:, 2] + torch.tensor(w0, dtype=torch.float32)
        frac[sp] = s
    act = torch.stack([frac[:, 0], torch.zeros_like(frac[:, 0]), frac[:, 1] + frac[:, 2]], 1)
    out: dict = {n: [None, None, None] for n in host}
    for (n, k), f, a in zip(rows, frac.tolist(), act.tolist()):
        if k == "cls_act":
            out[n][0] = tuple(a)
        else:
            out[n][1 if k == "cls_diff" else 2] = tuple(f)
    return out


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact batched a @ b^T over int operands: (B,M,D) x (B,N,D) -> (B,M,N)."""
    return exact_matmul(a, b.transpose(-1, -2))


class DittoEngine:
    """policy: 'act' | 'diff' | 'spatial' | 'defo' | 'defo+'.

    ``device`` (default: the card) is where registered weights and all
    per-layer state live."""

    def __init__(self, policy: str = "defo", hw: HwModel = DEFAULT_HW,
                 collect_oracle: bool = False, *, device=None):
        if policy not in ("act", "diff", "spatial", "defo", "defo+"):
            raise ValueError(f"unknown policy {policy!r}")
        self.policy = policy
        self.hw = hw
        self.collect_oracle = collect_oracle
        self.device = resolve_device(device)
        self.layers: dict[str, _LayerState] = {}
        self.meta: dict[str, LayerMeta] = {}
        self.step_idx = 0
        self.records: list[dict] = []  # one per (layer, step)
        self.watchdog_events: list[dict] = []  # re-anchor events (serve watchdog)
        self._decided = False
        self._compiled_base = None  # cached (modes, first-record-per-layer)

    # ------------------------------------------------------------- weights
    def register_linear(self, meta: LayerMeta, w: torch.Tensor,
                        bias: torch.Tensor | None = None):
        w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        if bias is not None:
            bias = torch.as_tensor(bias, dtype=torch.float32, device=self.device)
        self.layers[meta.name] = _LayerState(w=quant.quantize_weight(w), bias=bias)
        self.meta[meta.name] = meta

    def register_attention(self, meta: LayerMeta):
        self.layers[meta.name] = _LayerState()
        self.meta[meta.name] = meta

    # --------------------------------------------------------------- steps
    def begin_sample(self):
        self.step_idx = 0
        self._decided = False
        self._compiled_base = None
        self.records = []
        self.watchdog_events = []
        for st in self.layers.values():
            st.x_prev = st.y_prev = None
            st.a_prev = st.b_prev = None
            st.x_scale = st.a_scale = st.b_scale = None
            st.mode = "act"

    def end_step(self):
        self.step_idx += 1
        if self.step_idx == 2 and self.policy in ("defo", "defo+") and not self._decided:
            self._defo_decide()
            self._decided = True

    def _defo_decide(self):
        """Fix per-layer modes from step-1 (act) vs step-2 (diff) cycles."""
        by_layer: dict[str, dict[int, dict]] = {}
        for r in self.records:
            by_layer.setdefault(r["layer"], {})[r["step"]] = r
        for name, steps in by_layer.items():
            if 0 not in steps or 1 not in steps:
                continue
            c_act = steps[0]["cycles"]
            c_diff = steps[1]["cycles"]
            st = self.layers[name]
            if self.policy == "defo+":
                c_spatial = steps[0].get("cycles_spatial", math.inf)
                best = min((c_diff, "diff"), (c_act, "act"), (c_spatial, "spatial"))
                st.mode = best[1]
            else:
                st.mode = "diff" if c_diff < c_act else "act"

    # -------------------------------------------------------------- linear
    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """x: (..., K) fp32 -> (..., N) fp32 through the quantized path."""
        st = self.layers[name]
        meta = self.meta[name]
        x2 = x.reshape(-1, x.shape[-1])
        t, k = x2.shape
        n = st.w.q.shape[1]

        if st.x_scale is None:  # first-step calibration, held afterwards
            st.x_scale = quant.sample_scale(x2, x.shape[0] if x.dim() > 1 else 1)
        q_t = quant.quantize(x2, st.x_scale)

        mode = self._mode_for_step(st)
        rec: dict[str, Any] = {"layer": name, "step": self.step_idx, "mode": mode,
                               "kind": meta.kind, "macs": t * k * n}

        if mode == "act" or st.x_prev is None:
            y_i32 = quant.int_matmul(q_t, st.w.q)
            d_for_stats = None
            mode = "act"
            rec["mode"] = mode  # fallback executed act: keep accounting honest
        elif mode == "spatial":
            d_sp = classify.spatial_diff(q_t, axis=0)  # exact reconstructable
            # y rows are prefix sums of W·d, numerically identical to act
            y_i32 = quant.int_matmul(q_t, st.w.q)
            d_for_stats = d_sp[1:]  # first row stays full-precision
        else:  # temporal diff
            d = q_t.to(torch.int16) - st.x_prev.to(torch.int16)
            y_i32 = st.y_prev + quant.int_matmul(d, st.w.q)
            d_for_stats = d

        self._account(rec, t, k, n, q_t, d_for_stats, meta)
        self.records.append(rec)

        st.x_prev = q_t
        st.y_prev = y_i32
        y = y_i32.to(torch.float32) * st.x_scale * st.w.scale[None, :]
        if st.bias is not None:
            y = y + st.bias
        return y.reshape(x.shape[:-1] + (n,))

    # ----------------------------------------------------------- attention
    def attention_matmul(self, name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Two-operand matmul a @ b^T where BOTH change across steps
        (Q·K^T and P·V). Paper identity:
            A_t B_t^T = A_{t+1}B_{t+1}^T + A_t ΔB^T + ΔA B_{t+1}^T
        a: (..., M, D), b: (..., N, D) -> (..., M, N)."""
        st = self.layers[name]
        meta = self.meta[name]
        lead = a.shape[:-2]
        m, d_ = a.shape[-2:]
        n = b.shape[-2]
        a2 = a.reshape(-1, m, d_)
        b2 = b.reshape(-1, n, d_)

        if st.a_scale is None:  # per-(sample, head) scales
            st.a_scale = quant.sample_scale(a2, a2.shape[0])
            st.b_scale = quant.sample_scale(b2, b2.shape[0])
        qa = quant.quantize(a2, st.a_scale)
        qb = quant.quantize(b2, st.b_scale)

        mode = self._mode_for_step(st)
        rec: dict[str, Any] = {"layer": name, "step": self.step_idx, "mode": mode,
                               "kind": meta.kind, "macs": a2.shape[0] * m * n * d_}

        if mode in ("act", "spatial") or st.a_prev is None:
            y_i32 = _bmm(qa, qb)
            d_for_stats = None
            mode = "act"
            rec["mode"] = mode  # fallback executed act: keep accounting honest
        else:
            da = qa.to(torch.int16) - st.a_prev.to(torch.int16)
            db = qb.to(torch.int16) - st.b_prev.to(torch.int16)
            #   A_t ΔB^T + ΔA B_{t+1}^T  (A_t treated as weight, B_prev as weight)
            y_i32 = st.y_prev + _bmm(qa, db) + _bmm(da, st.b_prev)
            d_for_stats = torch.cat([da.reshape(-1), db.reshape(-1)])

        self._account(rec, a2.shape[0] * m, d_, n, torch.cat([qa.reshape(-1), qb.reshape(-1)]),
                      d_for_stats, meta, attention=True)
        self.records.append(rec)

        st.a_prev, st.b_prev, st.y_prev = qa, qb, y_i32
        y = y_i32.to(torch.float32) * st.a_scale * st.b_scale
        return y.reshape(lead + (m, n))

    # ------------------------------------------------------------ internals
    def _mode_for_step(self, st: _LayerState) -> str:
        if self.step_idx == 0:
            return "spatial" if self.policy in ("spatial", "defo+") else "act"
        if self.policy in ("act", "diff", "spatial"):
            return self.policy
        if self.step_idx == 1:  # defo probes diff on step 2
            return "diff"
        return st.mode

    def _account(self, rec, t, k, n, q_t, d, meta, *, attention=False):
        # class fractions, per candidate mode
        q_cls = classify.element_classes(q_t)
        cls_act = (float(q_cls["zero"]), 0.0, float(q_cls["low"] + q_cls["full"]))
        cls_diff = None
        if d is not None:
            cls = classify.element_classes(d)
            cls_diff = (float(cls["zero"]), float(cls["low"]), float(cls["full"]))
        self._account_classes(rec, t, k, n, cls_act, cls_diff, meta, attention=attention)
        hw = self.hw
        macs = rec["macs"]
        mem_cycles = rec["mem_cycles"]
        # spatial-mode counterfactual for Defo+ / the simulator
        if (self.step_idx == 0 and self.policy == "defo+") or self.collect_oracle:
            if not attention and t > 1:
                ds = classify.spatial_diff(q_t.reshape(t, k), axis=0)[1:]
                cs = classify.element_classes(ds)
                z2, l2, f2 = float(cs["zero"]), float(cs["low"]), float(cs["full"])
                w0 = 1.0 / t  # the first row stays full precision
                rec["cls_spatial"] = (z2 * (1 - w0), l2 * (1 - w0), f2 * (1 - w0) + w0)
                eff2 = macs * ((1 - w0) * hw.lanes_mixed(z2, l2, f2) + w0 * hw.lanes_full)
                cc2 = eff2 / (hw.n_pe * hw.mults_per_pe)
                rec["cycles_spatial"] = max(cc2, mem_cycles) + min(cc2, mem_cycles) * hw.overlap_slack
                rec["bops_spatial"] = bops_mod.bops_mixed(macs, *rec["cls_spatial"])

    def _account_classes(self, rec, t, k, n, cls_act, cls_diff, meta, *, attention=False,
                         cls_spatial=None):
        """Price one record from precomputed class fractions (the eager path
        measures them from the Δ tensors, the compiled path reduces them in
        its step; both produce the same record schema)."""
        hw = self.hw
        macs = rec["macs"]
        rec.update(t=t, k=k, n=n, attention=attention,
                   boundary_in=meta.boundary_in, boundary_out=meta.boundary_out)
        rec["cls_act"] = cls_act
        if cls_diff is not None:
            rec["cls_diff"] = cls_diff
        if cls_spatial is not None:
            rec["cls_spatial"] = cls_spatial
        executed_diff = cls_diff is not None and rec["mode"] in ("diff", "spatial")
        zero, low, full = cls_diff if executed_diff else cls_act
        rec.update(zero=zero, low=low, full=full)
        # --- BOPs ---
        rec["bops_act"] = bops_mod.bops_act(macs)
        rec["bops"] = bops_mod.bops_mixed(macs, zero, low, full) if executed_diff else rec["bops_act"]
        # --- memory traffic (bytes) ---
        w_bytes = k * n if not attention else 0  # weights stream once
        act_bytes = t * k + t * n  # read x, write y (int8)
        mem = w_bytes + act_bytes
        if rec["mode"] == "diff":
            extra = 4 * t * n  # y_prev read + y_t write (16-bit store)
            if meta.boundary_in:
                extra += 2 * t * k  # x_prev read + x_t write
            mem += extra
        rec["mem_bytes"] = mem
        # --- cycles (Ditto hardware: adder-tree PEs, 4-bit multipliers) ---
        eff_macs = macs * (hw.lanes_mixed(zero, low, full) if executed_diff
                           else hw.lanes_full)
        compute_cycles = eff_macs / (hw.n_pe * hw.mults_per_pe)
        mem_cycles = mem / hw.bytes_per_cycle
        rec["cycles"] = max(compute_cycles, mem_cycles) + min(compute_cycles, mem_cycles) * hw.overlap_slack
        rec["compute_cycles"] = compute_cycles
        rec["mem_cycles"] = mem_cycles

    # ------------------------------------------------- compiled execution
    def ready_for_compiled(self) -> bool:
        """True once everything the compiled pass bakes in is fixed: scales
        and prev-step state exist (>= 1 eager step) and, for Defo policies,
        the per-layer mode decision has been made (after step 2)."""
        if self.step_idx < 1:
            return False
        if self.policy in ("defo", "defo+") and not self._decided:
            return False
        return True

    def compiled_modes(self) -> dict[str, str]:
        """Static per-layer execution modes for the compiled pass. Attention
        layers have no spatial path, so 'spatial' maps to 'act' for them."""
        modes: dict[str, str] = {}
        for name, st in self.layers.items():
            m = self.policy if self.policy in ("act", "diff", "spatial") else st.mode
            if m == "spatial" and self.meta[name].kind in ("attn_qk", "attn_pv"):
                m = "act"
            modes[name] = m
        return modes

    def record_compiled_step(self, aux: dict[str, dict], *,
                             modes: dict[str, str] | None = None,
                             reanchor: bool = False) -> None:
        """Append records for one compiled step.

        ``aux`` maps each layer to (3,) tensors of counts reduced in the
        step (or merged from a split step's, ``dit_runner.merge_row_aux``):
        the (zero, low, full) element counts 'cls_act' always, 'cls_diff' /
        'cls_spatial' where the layer has the state to measure them, and
        'tile_hist' — the measured (n_zero, n_low, n_full) tile-class
        histogram from diff_encode — for diff-mode layers. They
        come to the host in one copy, where the counts become the float32
        fractions of the reference's step (:func:`_compiled_classes`). Layer
        dimensions are reused from that layer's calibration-step record.
        ``modes`` overrides the frozen modes the step ran under (the
        watchdog's all-act re-anchor step); ``reanchor`` marks its records.
        """
        if self._compiled_base is None:
            base_by_layer: dict[str, dict] = {}
            for r in self.records:
                base_by_layer.setdefault(r["layer"], r)
            self._compiled_base = (self.compiled_modes(), base_by_layer)
        base_modes, base_by_layer = self._compiled_base
        if modes is None:
            modes = base_modes
        keys = [(name, key) for name, a in aux.items() for key in a]
        if not keys:
            return
        flat = torch.cat([aux[name][key].to(torch.float64).reshape(3) for name, key in keys])
        vals = flat.tolist()
        host: dict[str, dict] = collections.defaultdict(dict)
        for i, (name, key) in enumerate(keys):
            host[name][key] = tuple(vals[3 * i:3 * i + 3])
        classes = _compiled_classes(host, {name: base_by_layer[name]["t"] for name in host})
        for name, a in host.items():
            base = base_by_layer[name]
            meta = self.meta[name]
            rec: dict[str, Any] = {"layer": name, "step": self.step_idx, "mode": modes[name],
                                   "kind": meta.kind, "macs": base["macs"], "compiled": True}
            if reanchor:
                rec["reanchor"] = True
            cls_act, cls_diff, cls_spatial = classes[name]
            self._account_classes(rec, base["t"], base["k"], base["n"], cls_act, cls_diff, meta,
                                  attention=base["attention"], cls_spatial=cls_spatial)
            if "tile_hist" in a:
                hist = tuple(int(v) for v in a["tile_hist"])
                rec["tile_hist"] = hist
                rec["tile_fracs"] = bops_mod.tile_fractions(hist)
                rec["bops_tile"] = bops_mod.bops_tile_mix(rec["macs"], hist)
            self.records.append(rec)

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        total = collections.defaultdict(float)
        for r in self.records:
            total["macs"] += r["macs"]
            total["bops"] += r["bops"]
            total["bops_act"] += r["bops_act"]
            total["mem_bytes"] += r["mem_bytes"]
            total["cycles"] += r["cycles"]
        steps = max((r["step"] for r in self.records), default=0) + 1
        modes = {name: st.mode for name, st in self.layers.items()}
        return {"steps": steps, **dict(total), "modes": modes}
