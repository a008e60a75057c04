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

A split dispatch (``make_denoise_fn(mesh=...)``, the port's counterpart of
the reference's batch-axis ``sharding_constraint``) runs the eager
calibration steps over the whole batch on the first device, so Defo's
decision is the unsharded one, and then the compiled steps by row groups,
one per device (:class:`RowGroup`), each with its own runner cache and
arena; the records of a step are merged from the groups' class counts.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ...distributed.sharding import batch_sharding
from ...kernels.diff_encode import diff_encode
from ...kernels.common import DEFAULT_LOW_BITS, LOW_BIT_MAX, pad2, resolve_device
from ...nn import core as nncore
from ...nn import dit as dit_mod
from . import compiled as compiled_mod
from . import defo
from .compiled import CompiledDittoEngine
from .engine import DittoEngine
from .plan import (EAGER_PLAN, DittoPlan, PlanSchedule, check_device_block,
                   segment_resolved)
from .quant import QTensor


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
        self.cache, self.bucket = cache, bucket
        self._step = self.step_for(self.ceng.modes, self.plan)

    def step_for(self, modes: dict[str, str], plan: DittoPlan):
        """The step of (``modes``, ``plan``) over this runner's rows: its
        cache's runner of that key, or an uncached step."""
        if self.cache is not None:
            return self.cache.step_for(self.cfg, modes, plan, bucket=self.bucket)
        return make_step_fn(self.cfg, modes, plan)

    def snapshot(self):
        """The state as it is now (a copy where a cache's arena holds it):
        the watchdog's rollback point."""
        snap = getattr(self.state, "snapshot", None)
        return self.state if snap is None else snap()

    def run(self, latents, t, labels=None, step=None) -> tuple[torch.Tensor, dict]:
        """One step: ``(eps, aux)``, the state carried, nothing recorded.
        ``step`` (from :meth:`step_for`) runs in place of the runner's own."""
        out, self.state, aux = (step or self._step)(self.ceng.params, self.params, self.state,
                                                    latents, t, labels)
        return out, aux

    def __call__(self, latents, t, labels=None):
        out, aux = self.run(latents, t, labels)
        if self.plan.collect_stats:
            self.engine.record_compiled_step(aux)
        return out


class RowGroup(NamedTuple):
    """One device of a split dispatch: the device, the params tree on it and
    its runner cache (``None``: uncached)."""
    device: torch.device
    params: Any
    cache: Any = None


def _row_view(engine: DittoEngine, lo: int, hi: int, batch: int, device,
              move_weights: bool) -> DittoEngine:
    """A calibrated engine holding rows ``[lo, hi)`` of ``engine``'s batch on
    ``device``: each per-row tensor (scales, temporal state) is sliced in
    proportion to the batch along dim 0 and moved; modes and step count are
    the engine's. ``move_weights`` moves the int8 weights too (an uncached
    group builds its K-major copies from them)."""
    def rows(a):
        if a is None:
            return None
        per = a.shape[0] // batch
        return a[lo * per:hi * per].to(device)

    def on(a):
        return None if a is None or not move_weights else a.to(device)

    view = copy.copy(engine)
    view.device = torch.device(device)
    view.records, view.watchdog_events = [], []
    view.layers = {
        name: dataclasses.replace(
            st, x_scale=rows(st.x_scale), x_prev=rows(st.x_prev), y_prev=rows(st.y_prev),
            a_prev=rows(st.a_prev), b_prev=rows(st.b_prev), a_scale=rows(st.a_scale),
            b_scale=rows(st.b_scale),
            w=st.w if st.w is None or not move_weights else QTensor(on(st.w.q), on(st.w.scale)),
            bias=st.bias if not move_weights else on(st.bias))
        for name, st in engine.layers.items()}
    return view


def _host_counts(parts_aux: list[dict]) -> list[dict]:
    """Each group's aux as host ``{layer: {key: [3 counts]}}``, one copy a group."""
    out = []
    for aux in parts_aux:
        keys = [(name, key) for name, a in aux.items() for key in a]
        if not keys:
            out.append({})
            continue
        flat = torch.cat([aux[n][k].to(torch.float64).reshape(3) for n, k in keys]).cpu().tolist()
        host: dict = {}
        for i, (n, k) in enumerate(keys):
            host.setdefault(n, {})[k] = flat[3 * i:3 * i + 3]
        out.append(host)
    return out


def _boundary_counts(states: list[dict], names: list[str]) -> dict[str, list]:
    """(zero, low, full) counts of the row deltas that cross the groups'
    boundaries, per linear layer: row 0 of group g + 1 against the last row
    of group g of the step's quantized input (the state's ``x_prev``), read
    to the host in one copy a group."""
    widths = [states[0][n]["x_prev"].shape[-1] for n in names]
    total = sum(widths)
    edges = [torch.cat([st[n]["x_prev"][0] for n in names]
                       + [st[n]["x_prev"][-1] for n in names]).cpu().numpy().astype(np.int16)
             for st in states]
    out = {n: [0, 0, 0] for n in names}
    for g in range(len(states) - 1):
        off = 0
        for n, k in zip(names, widths):
            a = np.abs(edges[g + 1][off:off + k] - edges[g][total + off:total + off + k])
            c = out[n]
            c[0] += int((a == 0).sum())
            c[1] += int(((a > 0) & (a <= LOW_BIT_MAX)).sum())
            c[2] += int((a > LOW_BIT_MAX).sum())
            off += k
    return out


def _straddling(states: list[dict], modes: dict[str, str], block: int) -> list[str]:
    """The diff-mode linear layers whose rows on one device are not whole
    class tiles (the conditioning ``mod`` layer, M = the batch): there the
    devices' tiles are not the unsplit step's."""
    return [n for n, m in modes.items() if m == "diff" and "x_prev" in states[0][n]
            and states[0][n]["x_prev"].shape[0] % block]


def _whole_batch_tile_hists(prev: dict, states: list[dict], block: int, device) -> dict:
    """The unsplit step's tile histogram of each layer of ``prev``: the
    class tiles of the whole batch's Δ (the groups' ``x_prev`` after the
    step against ``prev``, theirs before it, rows concatenated), classified
    by the ``diff_encode`` kernel (its plain version on the CPU); one host
    copy for all layers."""
    hists = []
    for n, old in prev.items():
        x_t = torch.cat([st[n]["x_prev"].to(device) for st in states])
        x_prev = torch.cat(old)
        classes = diff_encode(pad2(x_t, block, block), pad2(x_prev, block, block),
                              bm=block, bk=block)
        hists.append(torch.stack([(classes == c).sum() for c in range(3)]))
    flat = torch.stack(hists).to(torch.float64).cpu()
    return dict(zip(prev, flat))


def merge_row_aux(parts_aux: list[dict], states: list[dict], modes: dict[str, str], *,
                  prev: dict | None = None, block: int = 128, device=None) -> dict:
    """The aux of one compiled step over the whole batch from its row
    groups' (``parts_aux`` and the groups' states after the step, in row
    order): element counts add up, and the row deltas of the spatial
    statistics (``cls_spatial``, and ``cls_diff`` of spatial-mode layers)
    gain the deltas across each group boundary, so every count equals the
    unsplit step's. ``tile_hist`` sums the groups' measured tiles where a
    layer's rows on one device are whole ``block``-row tiles; the layers of
    ``prev`` (:func:`_straddling`, each with its groups' ``x_prev`` from
    before the step, on ``device``, default the card) are classified again
    over the whole batch (:func:`_whole_batch_tile_hists`). Values are (3,)
    float64 count tensors on the host."""
    host = _host_counts(parts_aux)
    names: list[str] = []
    for h in host:
        names += [n for n in h if n not in names]
    if not names:
        return {}
    linear = [n for n in names if "x_prev" in states[0][n]]
    boundary = _boundary_counts(states, linear)
    merged: dict = {}
    for n in names:
        # a one-row group has no row delta, hence no cls_spatial of its own
        keys = dict.fromkeys([k for h in host for k in h.get(n, {})]
                             + (["cls_spatial"] if n in boundary else []))
        m = merged[n] = {}
        for k in keys:
            c = [sum(h.get(n, {}).get(k, (0, 0, 0))[i] for h in host) for i in range(3)]
            if k == "cls_spatial" or (k == "cls_diff" and modes[n] == "spatial"):
                c = [a + b for a, b in zip(c, boundary[n])]
            m[k] = torch.tensor(c, dtype=torch.float64)
    if prev:
        hists = _whole_batch_tile_hists(prev, states, block, resolve_device(device))
        for n, hist in hists.items():
            merged[n]["tile_hist"] = hist
    return merged


class SplitDittoDiT:
    """The compiled pass of a split dispatch: one :class:`CompiledDittoDiT`
    a :class:`RowGroup`, each on its device's rows of a ``batch``-row batch
    (``batch_sharding``), seeded from its rows of the calibrated engine's
    state, through its own cache at ``bucket`` = its rows. Called like
    :class:`CompiledDittoDiT`: it places each group's rows on its device
    (``serve.mesh.place_dispatch``), records the merged counts of the step
    on ``engine`` (:func:`merge_row_aux`) and returns the eps rows
    concatenated on the engine's device. ``prev`` (the split runner of the
    previous segment) hands its groups' row views on."""

    def __init__(self, groups, cfg: dit_mod.DiTCfg, engine: DittoEngine, plan: DittoPlan,
                 batch: int, *, prev: "SplitDittoDiT | None" = None):
        self.engine = engine
        self.plan = segment_resolved(plan)
        ranges = batch_sharding(self.plan.mesh_sig(), batch)
        if ranges[0] == (0, batch):
            raise ValueError(f"a batch of {batch} rows does not split over {len(groups)} "
                             f"devices")
        self.devices = tuple(g.device for g in groups)
        self.parts = [
            CompiledDittoDiT(g.params, cfg,
                             _row_view(engine, lo, hi, batch, g.device, g.cache is None)
                             if prev is None else prev.parts[i].engine,
                             self.plan, cache=g.cache, bucket=hi - lo)
            for i, (g, (lo, hi)) in enumerate(zip(groups, ranges))]

    @property
    def state(self) -> list:
        return [p.state for p in self.parts]

    @state.setter
    def state(self, states: list) -> None:
        for p, st in zip(self.parts, states):
            p.state = st

    def step_for(self, modes: dict[str, str], plan: DittoPlan) -> list:
        """One step of (``modes``, ``plan``) a row group, each through its
        group's cache at its group's rows."""
        return [p.step_for(modes, plan) for p in self.parts]

    def snapshot(self) -> list:
        return [p.snapshot() for p in self.parts]

    def run(self, latents, t, labels=None, step=None, modes=None) -> tuple[torch.Tensor, dict]:
        """One step over the row groups: ``(eps, aux)``, the eps rows
        concatenated on the engine's device and the groups' counts merged
        (:func:`merge_row_aux`, under ``modes``, default the frozen ones);
        ``step`` (from :meth:`step_for`) runs in place of the groups' own."""
        from ...serve.mesh import place_dispatch  # core.ditto does not import serve

        axis = self.plan.mesh_axis
        xs, ls = place_dispatch(latents, labels, self.devices, axis)
        ts, _ = place_dispatch(t, None, self.devices, axis)
        steps = step or [None] * len(self.parts)
        modes = modes or self.parts[0].ceng.modes
        block, dev = self.plan.block, self.engine.device
        prev = {}
        if self.plan.collect_stats:  # a copy: a cache's arena is updated in place
            prev = {n: [st[n]["x_prev"].to(dev, copy=True) for st in self.state]
                    for n in _straddling(self.state, modes, block)}
        outs, auxes = [], []
        for part, st, xg, tg, lg in zip(self.parts, steps, xs, ts, ls):
            out, aux = part.run(xg, tg, lg, st)
            outs.append(out)
            auxes.append(aux)
        aux = (merge_row_aux(auxes, self.state, modes, prev=prev, block=block, device=dev)
               if self.plan.collect_stats else {})
        return torch.cat([o.to(dev) for o in outs]), aux

    def __call__(self, latents, t, labels=None):
        out, aux = self.run(latents, t, labels)
        if self.plan.collect_stats:
            self.engine.record_compiled_step(aux)
        return out


def make_denoise_fn(params, cfg: dit_mod.DiTCfg, engine: DittoEngine,
                    plan: DittoPlan | PlanSchedule | None = None, *, runner_cache=None,
                    bucket: int | None = None, device=None, mesh=None):
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

    ``mesh`` (a tuple of :class:`RowGroup`, one per device of a shard, the
    first on ``device``; the plan's ``mesh_devices`` of them) splits the
    compiled steps (:class:`SplitDittoDiT`): every batch the denoiser sees
    must divide into ``len(mesh)`` equal row groups (``serve_records`` runs
    a batch that does not unsplit). The eager calibration steps run over
    the whole batch on ``device``. Under the watchdog a trigger on any
    group's rows (a non-finite output; a full-tile fraction of the step's
    merged counts, which are the unsplit step's, at or above
    ``reanchor_full_frac``) is one for the whole dispatch: every group
    rolls back and re-anchors at the same step, so the samples and
    ``watchdog_events`` equal the unsplit dispatch's.
    """
    plan = EAGER_PLAN if plan is None else plan
    if not isinstance(plan, (DittoPlan, PlanSchedule)):
        raise TypeError(
            f"make_denoise_fn takes a DittoPlan or a PlanSchedule, got {type(plan).__name__}")
    dev = resolve_device(device)
    check_device_block(plan, dev)
    if engine.device != dev:
        raise ValueError(f"engine lives on {engine.device}, denoise_fn asked for {dev}")
    groups = tuple(mesh) if mesh is not None and len(mesh) > 1 else None
    if groups is not None:
        if plan.mesh_sig() is None or plan.mesh_sig()[0] != len(groups):
            raise ValueError(f"a split over {len(groups)} devices needs a plan with "
                             f"mesh_devices={len(groups)}, got {plan.mesh_sig()}")
        if torch.device(groups[0].device) != dev:
            raise ValueError(f"the first row group lives on {groups[0].device}, the "
                             f"engine on {dev}")
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
        parts = cur.parts if groups is not None else [cur]
        act_modes = {name: "act" for name in parts[0].ceng.modes}
        rsig = (rplan.cache_sig(), tuple(p.bucket for p in parts))
        if box.get("reanchor_sig") != rsig:
            box["reanchor_fn"] = cur.step_for(act_modes, rplan)
            box["reanchor_sig"] = rsig
        if groups is None:
            out, aux = cur.run(x, t, labels, box["reanchor_fn"])
        else:
            out, aux = cur.run(x, t, labels, box["reanchor_fn"], act_modes)
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
        pre_state = cur.snapshot()
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

    def compiled_runner(seg_plan, batch: int, prev=None):
        if groups is None:
            return CompiledDittoDiT(params, cfg, engine, seg_plan, cache=runner_cache,
                                    bucket=bucket)
        return SplitDittoDiT(groups, cfg, engine, seg_plan, batch, prev=prev)

    def fn(x, t, labels):
        if plan.compiled and engine.ready_for_compiled():
            # engine.step_idx is the current sampler step
            seg_plan = schedule.plan_for(engine.step_idx) if schedule is not None else plan
            sig = seg_plan.cache_sig()
            if box.get("built_for") is not engine.records:  # rebuilt per begin_sample
                box["runner"] = compiled_runner(seg_plan, x.shape[0])
                box["built_for"] = engine.records
                box["sig"] = sig
                box.pop("reanchor_due", None)  # saturation never crosses samples
            elif box["sig"] != sig:  # segment boundary: swap the step, carry the state
                prev = box["runner"]
                box["runner"] = compiled_runner(seg_plan, x.shape[0], prev)
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
