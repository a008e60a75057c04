"""Pipeline parallelism over a stage axis of devices (GPipe schedule).

Mirror of ``src/repro/distributed/pipeline.py``. Layers are split into S
contiguous stages, stage ``i`` holding its ``L / S`` layer slice on
``stages[i]``; microbatches stream through, an activation moving from
stage to stage with ``.to(stages[i + 1])``, the counterpart of the
reference's ``ppermute``. The stage axis is a tuple of devices and may
name one device more than once (as ``serve/mesh.py:ServeMesh(devices=...)``
does), so the schedule runs on one card too; there it measures only the
schedule's own cost.

Schedule: GPipe (fill, steady state, drain), S + M - 1 ticks for M
microbatches over S stages; bubble fraction (S - 1) / (S + M - 1). In a
tick, each stage that holds a microbatch runs its layers on it. A bubble
computes nothing here (the reference's SPMD computes throw-away values
there), so the outputs are the same either way: each microbatch goes
through the L layers in order, as the sequential stack runs it.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree as tr


def pipeline_apply(layer_fn: Callable, stacked_params, x: torch.Tensor, *, stages: tuple,
                   n_microbatches: int | None = None) -> torch.Tensor:
    """Run ``layer_fn(params_slice, x) -> x`` through the pipeline stages.

    stacked_params: a tree with leading dim L (layers); L must divide into
    S = ``len(stages)`` stages of L / S layers. x: (B, ...) with B divisible
    by the microbatch count M (default: S); microbatch j is rows
    [j B / M, (j + 1) B / M). Returns the value of running the L layers in
    order, on ``x``'s device."""
    s = len(stages)
    m = n_microbatches or s
    b = x.shape[0]
    n_layers = tr.leaves(stacked_params)[0].shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not divide into {m} microbatches")
    if n_layers % s:
        raise ValueError(f"{n_layers} layers do not divide into {s} stages")
    per_stage = n_layers // s

    # stage i's layers, one tree a layer, on stages[i]
    def stage_layers(i):
        held = tr.map_tree(lambda p: p[i * per_stage:(i + 1) * per_stage].to(stages[i]),
                           stacked_params)
        rows = tr.map_tree(lambda p: p.unbind(0), held)
        return [tr.map_tree(lambda r, j=j: r[j], rows) for j in range(per_stage)]

    layers = [stage_layers(i) for i in range(s)]
    mbs = x.reshape((m, b // m) + x.shape[1:]).unbind(0)
    out: list = [None] * m
    inbox: list = [None] * s  # the activation arriving at each stage
    for t in range(m + s - 1):
        nxt: list = [None] * s
        for i in range(s):
            j = t - i  # the microbatch at stage i in tick t
            if not 0 <= j < m:
                continue  # a bubble
            h = mbs[j].to(stages[0]) if i == 0 else inbox[i]
            for p in layers[i]:
                h = layer_fn(p, h)
            if i == s - 1:
                out[j] = h.to(x.device)
            else:
                nxt[i + 1] = h.to(stages[i + 1])
        inbox = nxt
    return torch.cat(out)
