"""The serving pass and the design-point pass over the Ditto engine.

Mirror of ``src/repro/sim/harness.py``: ``serve_records`` is the
deployment pass; ``collect_records`` runs one exact eager pass whose
per-mode statistics ``run_designs`` prices on each design point of the
paper's Fig. 13 (GPU as an analytic A100, ITC, Diffy, Cambricon-D, Ditto,
Ditto+), through ``sim/cycles.py``.
"""
from __future__ import annotations

import torch

from ..core import diffusion
from ..core.ditto.dit_runner import make_denoise_fn
from ..core.ditto.engine import DittoEngine
from ..core.ditto.hwmodel import CAMBRICON_D, DIFFY, DITTO_HW, ITC
from ..core.ditto.plan import DittoPlan, PlanSchedule, check_device_block
from ..kernels.common import resolve_device
from ..nn import dit as dit_mod
from ..tree import map_tree
from . import cycles

DESIGN_HW = {
    "itc": ITC,
    "diffy": DIFFY,
    "cambricon-d": CAMBRICON_D,
    "ditto": DITTO_HW,
    "ditto+": DITTO_HW,
}

# The reference's analytic A100 baseline, as it is (model inputs, not
# measurements): 624 TOPS int8 peak at low single-digit sustained
# utilization for small-batch diffusion inference (the paper's GPU bars
# sit below the 27-TOPS ITC), 1.555 TB/s.
GPU_TOPS = 624e12 * 0.03
GPU_BW = 1.555e12


def _on(device, params, sched, x_T, labels):
    """Move the inputs of a pass onto ``device`` (a no-op where they are)."""
    params = map_tree(lambda a: a.to(device), params)
    labels = None if labels is None else torch.as_tensor(labels, device=device)
    return params, sched.to(device), torch.as_tensor(x_T, device=device), labels


def serve_records(params, cfg: dit_mod.DiTCfg, sched, x_T, labels=None,
                  plan: DittoPlan | PlanSchedule | None = None, *, runner_cache=None,
                  bucket: int | None = None, device=None, mesh=None):
    """The deployment pass: eager calibration (+ the Defo mode decision
    after step 2), then the remaining steps through the kernels — act
    layers on int8_matmul, diff layers on diff_encode -> ditto_diff_matmul
    (``plan.low_bits=4``: its packed-int4 branch) or, with ``plan.fused``,
    diff_encode_fused -> ditto_fused_matmul, with tile skipping on the
    card. Records cover every step (compiled steps build theirs from class
    fractions reduced on the card unless ``plan.collect_stats=False``).

    ``plan`` is the whole configuration; omitting it means ``DittoPlan()``
    (20-step DDIM, Defo, compiled). It may be a ``PlanSchedule``: the loop
    fields come off its base and the compiled steps are partitioned by
    segment. ``device`` defaults to the card; the inputs are moved there
    (a no-op for tensors already on it, so a session's params keep their
    addresses). On the card a plan whose ``block`` is not 128 raises
    ``ValueError`` before any step runs.

    ``runner_cache`` (a ``serve.CompiledRunnerCache``) shares the compiled
    step across calls: one captured CUDA graph per (cfg, modes,
    ``plan.cache_sig()``, bucket) on the card. ``bucket`` pads the batch up
    to that size by row replication before the pass and slices the sample
    back afterwards (``serve/bucketing.py``); records are collected at
    bucket scale. Returns (records, sample, engine).

    ``mesh`` (a tuple of ``dit_runner.RowGroup``, one per device of a shard;
    the port's counterpart of the reference's shard submesh) splits the
    dispatch when the plan's ``mesh_devices`` (> 1) divides the padded
    batch: the eager calibration steps run over the whole batch on the
    first group's device, so Defo decides as unsplit, and the compiled
    steps by row groups, one per device, each through its own runner cache
    (``dit_runner.make_denoise_fn(mesh=)``); the records are merged by
    (layer, step). A batch that ``mesh_devices`` does not divide is
    replicated, as the reference lays it out: it runs whole on the first
    device. With ``mesh``, ``device`` and ``runner_cache`` are the first
    group's.
    """
    plan = DittoPlan() if plan is None else plan
    if mesh is not None:
        device, runner_cache = mesh[0].device, mesh[0].cache
    dev = resolve_device(device)
    check_device_block(plan, dev)
    params, sched, x_T, labels = _on(dev, params, sched, x_T, labels)
    true_b = x_T.shape[0]
    if bucket is not None and bucket != true_b:
        from ..serve import bucketing  # function-level: repro_torch.serve imports this module

        x_T, labels = bucketing.pad_batch(x_T, labels, bucket)
    if mesh is not None and (len(mesh) < 2 or x_T.shape[0] % len(mesh)):
        mesh = None  # one device, or a replicated batch: the whole batch on the first
    eng = DittoEngine(policy=plan.policy, collect_oracle=plan.collect_stats, device=dev)
    fn = make_denoise_fn(params, cfg, eng, plan, runner_cache=runner_cache,
                         bucket=x_T.shape[0], device=dev, mesh=mesh)
    eng.begin_sample()
    sample = diffusion.SAMPLERS[plan.sampler](sched, fn, x_T, steps=plan.steps, labels=labels)
    return eng.records, sample[:true_b], eng


def collect_records(params, cfg: dit_mod.DiTCfg, sched, x_T, labels, *, steps: int,
                    sampler: str = "ddim", device=None):
    """One exact eager engine pass collecting act/diff/spatial stats per
    record. Returns (records, sample, engine)."""
    dev = resolve_device(device)
    params, sched, x_T, labels = _on(dev, params, sched, x_T, labels)
    eng = DittoEngine(policy="diff", collect_oracle=True, device=dev)
    fn = make_denoise_fn(params, cfg, eng, device=dev)
    eng.begin_sample()
    sample = diffusion.SAMPLERS[sampler](sched, fn, x_T, steps=steps, labels=labels)
    return eng.records, sample, eng


def run_designs(records, *, t_mult: float = 1.0, d_mult: float = 1.0,
                seq_mult: float | None = None, designs=tuple(DESIGN_HW), **mode_kw) -> dict:
    """Price one record set on each design point (and the analytic GPU)."""
    recs = cycles.scale_records(records, t_mult=t_mult, d_mult=d_mult, seq_mult=seq_mult)
    out = {}
    for name in designs:
        hw = DESIGN_HW[name]
        fn = cycles.mode_fn_for(name, recs, hw, **mode_kw)
        out[name] = cycles.simulate(recs, hw, fn)
    out["gpu-a100"] = gpu_baseline(recs)
    return out


def gpu_baseline(records) -> dict:
    """The reference's analytic A100: max(compute, memory) at GPU_TOPS / GPU_BW."""
    total_macs = sum(r["macs"] for r in records)
    total_bytes = sum(cycles._mem_bytes(r, "act") for r in records)
    t = max(2 * total_macs / GPU_TOPS, total_bytes / GPU_BW)
    return {"hw": "gpu-a100", "time_s": t, "energy_j": t * 300.0, "cycles": t * 1.41e9}


def run_all(params, cfg: dit_mod.DiTCfg, sched, x_T, labels, *, steps: int,
            sampler: str = "ddim", t_mult: float = 1.0, d_mult: float = 1.0,
            seq_mult: float | None = None, device=None):
    """collect_records then run_designs; every design's result carries the
    sample, and the records and engine ride along."""
    records, sample, eng = collect_records(params, cfg, sched, x_T, labels, steps=steps,
                                           sampler=sampler, device=device)
    out = run_designs(records, t_mult=t_mult, d_mult=d_mult, seq_mult=seq_mult)
    for r in out.values():
        r["sample"] = sample
    out["records"] = records
    out["engine"] = eng
    return out
