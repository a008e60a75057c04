"""ServeSession: the stateful front end of the serving runtime.

Mirror of ``src/repro/serve/session.py``. One session owns the model
(params on its device, config, noise schedule), a
:class:`~repro_torch.serve.cache.CompiledRunnerCache` and a default
:class:`~repro_torch.core.ditto.DittoPlan`. Each ``serve(x, labels)`` call
is one request batch; the session

  1. chunks oversized requests to ``plan.max_batch``,
  2. pads each chunk up to its power-of-two batch bucket
     (``serve/bucketing.py`` — replication padding, bit-exact),
  3. runs the two-phase Ditto pass (eager calibration + Defo decision,
     then the compiled steps) through ``sim.harness.serve_records`` with
     the shared runner cache — on the card one captured CUDA graph per
     (modes, ``plan.cache_sig()``, bucket), replayed every step — and
  4. slices the sample back to the true batch.

The params move to the session's device once, at construction: the
captured graphs read them by address. ``serve(..., plan=...)`` overrides
the session plan for one request and shares the session's cache.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import torch

from ..core.ditto.plan import DittoPlan, PlanSchedule, check_device_block
from ..kernels.common import resolve_device
from ..tree import map_tree
from ..sim import harness
from . import faults
from .bucketing import bucket_for
from .cache import CompiledRunnerCache


@dataclasses.dataclass
class ChunkResult:
    """One served chunk (<= max_batch requests, one bucket)."""
    sample: torch.Tensor  # (true chunk batch, ...)
    records: list
    engine: Any
    batch: int
    bucket: int | None  # padded dispatch size; None = eager (unbucketed) chunk
    wall_s: float
    captures_delta: int  # new captures this chunk caused (0 = every runner cached)

    @property
    def pad_rows(self) -> int:
        """Wasted (replicated) batch rows this chunk computed."""
        return 0 if self.bucket is None else self.bucket - self.batch


@dataclasses.dataclass
class ServeResult:
    sample: torch.Tensor  # (true request batch, ...) — chunks re-concatenated
    chunks: list[ChunkResult]

    @property
    def records(self) -> list:
        return [r for c in self.chunks for r in c.records]

    @property
    def wall_s(self) -> float:
        return sum(c.wall_s for c in self.chunks)

    @property
    def captures_delta(self) -> int:
        return sum(c.captures_delta for c in self.chunks)

    @property
    def pad_rows(self) -> int:
        return sum(c.pad_rows for c in self.chunks)


class ServeSession:
    """Serving runtime for one model.

    ``plan`` is the session's default :class:`DittoPlan` (or
    ``PlanSchedule``); omitting it means ``DittoPlan()``. ``cache`` may be
    shared between sessions serving the same params (the key includes the
    model-config signature; a cache binds to one params tree). ``device``
    defaults to the card. Thread-safe: counters update under a lock, and
    samples run one at a time on the cache's ``sample_lock`` (a bucket's
    state arena holds one sample).
    """

    def __init__(self, params, cfg, sched, plan: DittoPlan | PlanSchedule | None = None, *,
                 cache: CompiledRunnerCache | None = None, device=None):
        self.device = resolve_device(device)
        self.params = map_tree(lambda a: a.to(self.device), params)
        self.cfg = cfg
        self.sched = sched.to(self.device)
        self.plan = DittoPlan() if plan is None else plan
        self.cache = cache if cache is not None else CompiledRunnerCache()
        self.batches_served = 0
        self.requests_served = 0
        self.watchdog_events = 0  # re-anchor steps across all served chunks
        self._stats_lock = threading.Lock()

    # ------------------------------------------------------------------ api
    def serve(self, x: torch.Tensor, labels=None, *,
              plan: DittoPlan | PlanSchedule | None = None) -> ServeResult:
        """Serve one request batch; returns the sample at the true batch size
        plus per-chunk records and engines for the design-point simulator.
        ``plan`` overrides the session default for this request only."""
        fault = faults.fire("session.serve")
        if fault is not None:
            faults.perform(fault)
        plan = self.plan if plan is None else plan
        check_device_block(plan, self.device)
        n = x.shape[0]
        chunks: list[ChunkResult] = []
        for lo in range(0, n, plan.max_batch):
            hi = min(lo + plan.max_batch, n)
            lc = None if labels is None else labels[lo:hi]
            chunks.append(self._serve_chunk(x[lo:hi], lc, plan))
        events = sum(len(c.engine.watchdog_events) for c in chunks)
        with self._stats_lock:
            self.batches_served += 1
            self.requests_served += n
            self.watchdog_events += events
        samples = [c.sample for c in chunks]
        sample = samples[0] if len(samples) == 1 else torch.cat(samples, dim=0)
        return ServeResult(sample=sample, chunks=chunks)

    def _serve_chunk(self, x, labels, plan: DittoPlan | PlanSchedule) -> ChunkResult:
        b = x.shape[0]
        # eager chunks run unbucketed (no runner to share)
        bucket = bucket_for(b, max_batch=plan.max_batch) if plan.compiled else None
        with self.cache.sample_lock, self.cache.attribution() as att:
            t0 = time.perf_counter()
            records, sample, eng = harness.serve_records(
                self.params, self.cfg, self.sched, x, labels, plan,
                runner_cache=self.cache, bucket=bucket, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t0
        return ChunkResult(sample=sample, records=records, engine=eng, batch=b,
                           bucket=bucket, wall_s=wall, captures_delta=att.count)

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._stats_lock:
            own = {"batches": self.batches_served, "requests": self.requests_served,
                   "watchdog_events": self.watchdog_events}
        return {**own, **self.cache.stats()}
