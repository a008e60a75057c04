"""The serving pass over the Ditto engine.

Mirror of ``serve_records`` of ``src/repro/sim/harness.py``; the
design-point pass (``collect_records``, ``run_designs``) waits for
``sim/cycles.py`` (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch

from ..core import diffusion
from ..core.ditto.dit_runner import make_denoise_fn
from ..core.ditto.engine import DittoEngine
from ..core.ditto.plan import DittoPlan
from ..kernels.common import resolve_device
from ..nn import dit as dit_mod
from ..nn.core import map_tree


def _on(device, params, sched, x_T, labels):
    """Move the inputs of a pass onto ``device`` (a no-op where they are)."""
    params = map_tree(lambda a: a.to(device), params)
    labels = None if labels is None else torch.as_tensor(labels, device=device)
    return params, sched.to(device), torch.as_tensor(x_T, device=device), labels


def serve_records(params, cfg: dit_mod.DiTCfg, sched, x_T, labels=None,
                  plan: DittoPlan | None = None, *, device=None):
    """The deployment pass: eager calibration (+ the Defo mode decision
    after step 2), then the remaining steps through the kernels — act
    layers on int8_matmul, diff layers on diff_encode -> ditto_diff_matmul
    with tile skipping on the card. Records cover every step (compiled
    steps build theirs from class fractions reduced on the card unless
    ``plan.collect_stats=False``).

    ``plan`` is the whole configuration; omitting it means ``DittoPlan()``
    (20-step DDIM, Defo, compiled). ``device`` defaults to the card; the
    inputs are moved there. Returns (records, sample, engine).
    """
    plan = DittoPlan() if plan is None else plan
    dev = resolve_device(device)
    params, sched, x_T, labels = _on(dev, params, sched, x_T, labels)
    eng = DittoEngine(policy=plan.policy, collect_oracle=plan.collect_stats, device=dev)
    fn = make_denoise_fn(params, cfg, eng, plan, device=dev)
    eng.begin_sample()
    sample = diffusion.SAMPLERS[plan.sampler](sched, fn, x_T, steps=plan.steps, labels=labels)
    return eng.records, sample, eng
