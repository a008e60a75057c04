"""DiT denoiser executed through the DittoEngine (quantized serving path).

Mirror of ``src/repro/core/ditto/dit_runner.py``. ``_dit_forward`` is the
single source of truth for the block structure; it takes the two engine
ops as callables, so the eager calibration pass (:class:`DittoDiT`) and
the kernel pass (:class:`CompiledDittoDiT`) share the exact same forward
and the same fp32 glue.

``make_denoise_fn(..., plan)`` with ``plan.compiled=True`` runs eager
steps until the engine is calibrated (>= 1 step; for Defo policies, until
the step-2 decision), then hands the remaining steps to the compiled step,
in which each layer's mode is fixed: act layers launch ``int8_matmul``,
diff layers ``diff_encode`` -> ``ditto_diff_matmul`` (or, with
``plan.fused``, ``diff_encode_fused`` -> ``ditto_fused_matmul``). With a
runner cache (``serve/cache.py``) the compiled step is the cache's runner
of its key, one captured CUDA graph on the card; a ``PlanSchedule`` swaps
runners at segment boundaries and carries the temporal state across; the
watchdog (``plan.watchdog``) re-anchors a step that saturates or goes
non-finite.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...kernels.common import DEFAULT_LOW_BITS, resolve_device
from ...nn import core as nncore
from ...nn import dit as dit_mod
from . import compiled as compiled_mod
from . import defo
from .compiled import CompiledDittoEngine
from .engine import DittoEngine
from .plan import (EAGER_PLAN, DittoPlan, PlanSchedule, check_device_block,
                   segment_resolved)


def _dit_forward(params, cfg: dit_mod.DiTCfg, linear, attention, latents, t, labels):
    """One DiT forward with every quantized op injected.

    ``linear(name, x)`` and ``attention(name, a, b)`` are the engine ops —
    eager (stateful) or compiled (closures threading a state dict). Patch
    embed / conditioning / norms / softmax stay fp32.
    """
    b, hh, ww, ch = latents.shape
    pp = cfg.patch
    x = latents.reshape(b, hh // pp, pp, ww // pp, pp, ch)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.n_tokens, cfg.patch_dim)
    x = nncore.dense(params["patch_embed"], x) + nncore.val(params["pos_embed"])[None]
    c = dit_mod.timestep_embedding(t, 256)
    c = nncore.dense(params["t_mlp2"], F.silu(nncore.dense(params["t_mlp1"], c)))
    if labels is not None and "label_embed" in params:
        c = c + nncore.val(params["label_embed"])[labels]
    c_act = F.silu(c)

    nh = cfg.n_heads
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    for i in range(cfg.n_layers):
        bk = f"blk{i}"
        mod = linear(f"{bk}.mod", c_act)
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mod, 6, dim=-1)
        h = dit_mod._modulate(dit_mod._ln(x), sh_a, sc_a)
        q = linear(f"{bk}.wq", h).reshape(b, cfg.n_tokens, nh, hd)
        k = linear(f"{bk}.wk", h).reshape(b, cfg.n_tokens, nh, hd)
        v = linear(f"{bk}.wv", h).reshape(b, cfg.n_tokens, nh, hd)
        qf = q.permute(0, 2, 1, 3).reshape(b * nh, cfg.n_tokens, hd)
        kf = k.permute(0, 2, 1, 3).reshape(b * nh, cfg.n_tokens, hd)
        vf = v.permute(0, 2, 1, 3).reshape(b * nh, cfg.n_tokens, hd)
        scores = attention(f"{bk}.qk", qf, kf) * scale
        probs = torch.softmax(scores, dim=-1)
        av = attention(f"{bk}.pv", probs, vf.transpose(-1, -2))
        av = av.reshape(b, nh, cfg.n_tokens, hd).permute(0, 2, 1, 3).reshape(b, cfg.n_tokens, nh * hd)
        a = linear(f"{bk}.wo", av)
        x = x + g_a[:, None, :] * a
        h = dit_mod._modulate(dit_mod._ln(x), sh_m, sc_m)
        hmid = F.gelu(linear(f"{bk}.wi", h), approximate="tanh")
        x = x + g_m[:, None, :] * linear(f"{bk}.wd", hmid)

    modf = nncore.dense(params["final_mod"], c_act)
    shift, scl = torch.chunk(modf, 2, dim=-1)
    x = dit_mod._modulate(dit_mod._ln(x), shift, scl)
    x = linear("final.out", x)
    x = x.reshape(b, hh // pp, ww // pp, pp, pp, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh, ww, ch)


class DittoDiT:
    """Eager calibration pass (per-layer Python loop — each layer's mode may
    differ per step, which is the point of Defo). Weights are registered
    once, onto the engine's device."""

    def __init__(self, params, cfg: dit_mod.DiTCfg, engine: DittoEngine):
        self.cfg = cfg
        self.engine = engine
        self.params = params
        metas = defo.analyze(defo.dit_graph(cfg.n_layers))
        blocks = params["blocks"]

        def blk(i, *path):
            cur = blocks
            for p in path:
                cur = cur[p]
            return nncore.val(cur)[i]

        for i in range(cfg.n_layers):
            b = f"blk{i}"
            engine.register_linear(metas[f"{b}.mod"], blk(i, "mod", "w"), blk(i, "mod", "b"))
            for nm in ("wq", "wk", "wv", "wo"):
                engine.register_linear(metas[f"{b}.{nm}"], blk(i, "attn", nm, "w"),
                                       blk(i, "attn", nm, "b"))
            engine.register_attention(metas[f"{b}.qk"])
            engine.register_attention(metas[f"{b}.pv"])
            engine.register_linear(metas[f"{b}.wi"], blk(i, "mlp", "wi", "w"), blk(i, "mlp", "wi", "b"))
            engine.register_linear(metas[f"{b}.wd"], blk(i, "mlp", "wo", "w"), blk(i, "mlp", "wo", "b"))
        fo = params["final_out"]
        engine.register_linear(metas["final.out"], nncore.val(fo["w"]), nncore.val(fo["b"]))

    def __call__(self, latents, t, labels=None):
        eng = self.engine
        return _dit_forward(self.params, self.cfg, eng.linear, eng.attention_matmul,
                            latents, t, labels)


def make_step_fn(cfg: dit_mod.DiTCfg, modes: dict[str, str], plan: DittoPlan | None = None,
                 *, inplace: bool = False):
    """Build the per-step function of the compiled pass.

    Returns ``step(ditto_params, model_params, state, latents, t, labels)
    -> (eps_hat, new_state, aux)``. Everything data-dependent is an
    argument; ``cfg``, the frozen per-layer ``modes`` and the plan (one
    segment's: a multi-segment ``PlanSchedule`` is rejected, a constant
    one collapses to its plan) are fixed when the step is built.
    ``inplace`` copies each layer's new state over ``state``'s tensors
    right after the layer and returns ``state`` itself: the form a
    captured CUDA graph needs (``serve/cache.py``).
    """
    plan = segment_resolved(DittoPlan() if plan is None else plan)
    modes = dict(modes)

    def step(dparams, mparams, state, latents, t, labels):
        new_state: dict = state if inplace else {}
        aux: dict = {}

        def keep(name, st2, a):
            if inplace:
                for k, v in st2.items():
                    state[name][k].copy_(v)
            else:
                new_state[name] = st2
            aux[name] = a

        def lin(name, x):
            y, st2, a = compiled_mod.linear_apply(dparams[name], modes[name], x,
                                                  state[name], plan=plan)
            keep(name, st2, a)
            return y

        def attn(name, a_, b_):
            y, st2, a = compiled_mod.attention_apply(dparams[name], modes[name], a_, b_,
                                                     state[name], plan=plan)
            keep(name, st2, a)
            return y

        out = _dit_forward(mparams, cfg, lin, attn, latents, t, labels)
        return out, new_state, aux

    return step


class CompiledDittoDiT:
    """Kernel pass: one step function over the whole denoiser, built from a
    calibrated engine. Per-layer temporal state is threaded functionally;
    modes are fixed at construction. With ``collect_stats`` the class
    fractions come back as an aux dict and the engine turns them into
    cost-model records for the step.

    With ``cache`` (a ``serve.CompiledRunnerCache``) the step is the
    cache's runner of (cfg, modes, ``plan.cache_sig()``, ``bucket``) — a
    captured CUDA graph on the card — and the K-major weights are the
    cache's, built once for its params."""

    def __init__(self, params, cfg: dit_mod.DiTCfg, engine: DittoEngine,
                 plan: DittoPlan | None = None, *, cache=None, bucket: int | None = None):
        self.cfg = cfg
        self.engine = engine
        self.params = params
        self.plan = segment_resolved(DittoPlan() if plan is None else plan)
        weights = None if cache is None else cache.weights_for(params, engine)
        self.ceng = CompiledDittoEngine(engine, plan=self.plan, weights=weights)
        self.state = self.ceng.init_state()
        if cache is not None:
            self._step = cache.step_for(cfg, self.ceng.modes, self.plan, bucket=bucket)
        else:
            self._step = make_step_fn(cfg, self.ceng.modes, self.plan)

    def __call__(self, latents, t, labels=None):
        out, self.state, aux = self._step(self.ceng.params, self.params, self.state,
                                          latents, t, labels)
        if self.plan.collect_stats:
            self.engine.record_compiled_step(aux)
        return out


def make_denoise_fn(params, cfg: dit_mod.DiTCfg, engine: DittoEngine,
                    plan: DittoPlan | PlanSchedule | None = None, *, runner_cache=None,
                    bucket: int | None = None, device=None):
    """denoise_fn(x, t, labels) for ``core.diffusion`` samplers; calls
    engine.end_step() after each sampler step.

    With no ``plan`` this is the bare eager path (:data:`EAGER_PLAN`).
    ``plan.compiled=True``: once the engine is calibrated, the remaining
    steps run through the kernels, seeded with the eager pass's temporal
    state; a new compiled runner is built per sample (begin_sample resets
    state and Defo may re-decide modes). ``device`` (default: the card)
    must be the engine's device. On the card a plan whose ``block`` is not
    128 raises ``ValueError`` here, before any eager step
    (:func:`~repro_torch.core.ditto.plan.check_device_block`).

    ``runner_cache`` (a ``serve.CompiledRunnerCache``) shares the step
    across samples and batches whose (cfg, modes, ``plan.cache_sig()``,
    ``bucket``) agree: one captured CUDA graph per key on the card.

    ``plan`` may be a :class:`PlanSchedule`: at a segment boundary the
    runner is swapped for one built from the new segment's plan (same
    runner cache) and the temporal state is carried across, so outputs stay
    bit-identical to the matching constant plan. Eager calibration steps
    ignore segment kernel knobs.

    ``plan.watchdog=True`` guards every compiled step: a non-finite output
    rolls the step back (state and records) and re-runs it as a re-anchor;
    with ``plan.reanchor_full_frac`` a step whose measured full-tile
    fraction reaches it schedules a re-anchor of the next step. A
    re-anchor runs the step with every layer in act mode under the
    canonical plan (``fused=False``, default ``low_bits``), refreshing
    x_prev / y_prev. Events land on ``engine.watchdog_events``; output that
    is still non-finite raises ``serve.faults.NumericalFault``.
    """
    plan = EAGER_PLAN if plan is None else plan
    if not isinstance(plan, (DittoPlan, PlanSchedule)):
        raise TypeError(
            f"make_denoise_fn takes a DittoPlan or a PlanSchedule, got {type(plan).__name__}")
    dev = resolve_device(device)
    check_device_block(plan, dev)
    if engine.device != dev:
        raise ValueError(f"engine lives on {engine.device}, denoise_fn asked for {dev}")
    schedule = plan.normalized() if isinstance(plan, PlanSchedule) else None
    watchdog = plan.watchdog
    reanchor_frac = plan.reanchor_full_frac
    if watchdog:
        # the typed error and the fault probe live with the serving layer;
        # imported here so core.ditto does not depend on serve
        from ...serve import faults as faults_mod
    runner = DittoDiT(params, cfg, engine)
    box: dict = {}

    def reanchor_step(x, t, labels, trigger: str, extra: dict):
        """Run this step with every layer in act mode under the canonical
        re-anchor plan, refreshing the temporal anchors."""
        cur = box["runner"]
        rplan = cur.plan.replace(fused=False, low_bits=DEFAULT_LOW_BITS)
        act_modes = {name: "act" for name in cur.ceng.modes}
        rsig = rplan.cache_sig()
        if box.get("reanchor_sig") != rsig:
            if runner_cache is not None:
                box["reanchor_fn"] = runner_cache.step_for(cfg, act_modes, rplan, bucket=bucket)
            else:
                box["reanchor_fn"] = make_step_fn(cfg, act_modes, rplan)
            box["reanchor_sig"] = rsig
        out, cur.state, aux = box["reanchor_fn"](cur.ceng.params, params, cur.state,
                                                 x, t, labels)
        if rplan.collect_stats:
            engine.record_compiled_step(aux, modes=act_modes, reanchor=True)
        engine.watchdog_events.append({"step": engine.step_idx, "trigger": trigger, **extra})
        return out

    def guarded_step(x, t, labels):
        """One compiled step under the watchdog: the finite guard, and the
        saturation tracking that schedules a re-anchor of the next step."""
        fault = faults_mod.fire("denoise.step")
        x_in = x
        if fault is not None and fault.kind == "drift":
            x_in = faults_mod.corrupt(fault, x)  # saturate the temporal Δs
        due = box.pop("reanchor_due", None)
        if due is not None:
            return reanchor_step(x_in, t, labels, "saturation", {"full_frac": due})
        cur = box["runner"]
        # a runner cache's graphs update their state in place: keep a copy
        snapshot = getattr(cur.state, "snapshot", None)
        pre_state = cur.state if snapshot is None else snapshot()
        n0 = len(engine.records)
        out = cur(x_in, t, labels)
        if fault is not None and fault.kind in ("poison_nan", "poison_inf"):
            # poison the step OUTPUT: quantization launders input NaNs
            out = faults_mod.corrupt(fault, out)
        if not bool(torch.isfinite(out).all()):
            # roll back the poisoned step (state and records) and re-run it
            # re-anchored from the pre-step state, with the clean input
            cur.state = pre_state
            del engine.records[n0:]
            return reanchor_step(x, t, labels, "nonfinite", {})
        if reanchor_frac is not None:
            hists = [r["tile_hist"] for r in engine.records[n0:] if "tile_hist" in r]
            total = sum(sum(h) for h in hists)
            full = sum(h[2] for h in hists)
            if total and full >= reanchor_frac * total:
                box["reanchor_due"] = full / total
        return out

    def fn(x, t, labels):
        if plan.compiled and engine.ready_for_compiled():
            # engine.step_idx is the current sampler step
            seg_plan = schedule.plan_for(engine.step_idx) if schedule is not None else plan
            sig = seg_plan.cache_sig()
            if box.get("built_for") is not engine.records:  # rebuilt per begin_sample
                box["runner"] = CompiledDittoDiT(params, cfg, engine, seg_plan,
                                                 cache=runner_cache, bucket=bucket)
                box["built_for"] = engine.records
                box["sig"] = sig
                box.pop("reanchor_due", None)  # saturation never crosses samples
            elif box["sig"] != sig:  # segment boundary: swap the step, carry the state
                prev = box["runner"]
                box["runner"] = CompiledDittoDiT(params, cfg, engine, seg_plan,
                                                 cache=runner_cache, bucket=bucket)
                box["runner"].state = prev.state
                box["sig"] = sig
            if watchdog:
                out = guarded_step(x, t, labels)
                if not bool(torch.isfinite(out).all()):
                    raise faults_mod.NumericalFault(engine.step_idx)
            else:
                out = box["runner"](x, t, labels)
        else:
            out = runner(x, t, labels)
        engine.end_step()
        return out

    return fn
