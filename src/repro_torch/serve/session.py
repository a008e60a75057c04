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

A chunk is a ``session.chunk`` span (:mod:`repro_torch.spans`), and the
wait for its streams at its end a ``session.sync`` span inside it.

The params move to the session's device once, at construction: the
captured graphs read them by address. ``serve(..., plan=...)`` overrides
the session plan for one request and shares the session's cache.

On the card a session serves on CUDA streams of its own, one a device,
and a chunk waits for its own streams only, never for the whole card: two
sessions (two shards of a ``ServeMesh``) on one card overlap. The streams
first wait for the caller's current streams, so inputs made there are
ready; the samples handed back are marked in use on the caller's streams.

``mesh`` (a tuple of devices: one shard of a ``ServeMesh``) serves on
those devices: ``mesh[0]`` is the session's device, each device gets the
params once and a runner cache of its own, and a mesh-signed plan whose
``mesh_devices`` (the tuple's length) divides a chunk's bucket splits
the chunk's compiled steps over them (``sim.harness.serve_records(mesh=)``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any

import torch

from .. import spans
from ..core.ditto.dit_runner import RowGroup
from ..core.ditto.plan import DittoPlan, PlanSchedule, check_device_block
from ..kernels.common import resolve_device
from ..tree import map_tree
from ..sim import harness
from . import faults
from .bucketing import bucket_for
from .cache import CompiledRunnerCache


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current card's index, so the session's devices equal
    the ``.device`` of the tensors it places there."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
    shared between sessions serving the same params on one device (the key
    includes the model-config signature; a cache binds to one params tree
    and one device). ``device`` defaults to the card; ``mesh`` (a tuple of
    devices, see the module docstring) replaces it, and ``cache`` is then
    the first device's. Thread-safe: counters update under a lock, and
    samples run one at a time on the caches' ``sample_lock`` (a bucket's
    state arena holds one sample).
    """

    def __init__(self, params, cfg, sched, plan: DittoPlan | PlanSchedule | None = None, *,
                 cache: CompiledRunnerCache | None = None, device=None, mesh=None):
        devices = tuple(_indexed(resolve_device(d)) for d in (mesh or (device,)))
        if mesh and device is not None and _indexed(resolve_device(device)) != devices[0]:
            raise ValueError(f"device={device} is not the mesh's first device {devices[0]}")
        self.device = devices[0]
        self.devices = devices
        placed: dict = {}
        for d in devices:
            if d not in placed:
                placed[d] = map_tree(lambda a, d=d: a.to(d), params)
        self.params = placed[self.device]
        self.cfg = cfg
        self.sched = sched.to(self.device)
        self.plan = DittoPlan() if plan is None else plan
        self.cache = cache if cache is not None else CompiledRunnerCache()
        # one runner cache a device of the mesh (a device named twice gets two)
        self.caches = (self.cache,) + tuple(CompiledRunnerCache() for _ in devices[1:])
        self._groups = (tuple(RowGroup(d, placed[d], c) for d, c in zip(devices, self.caches))
                        if len(devices) > 1 else None)
        self._streams = ({d: torch.cuda.Stream(device=d) for d in placed}
                         if self.device.type == "cuda" else {})
        self.batches_served = 0
        self.requests_served = 0
        self.watchdog_events = 0  # re-anchor steps across all served chunks
        self._stats_lock = threading.Lock()

    def stream(self, device) -> torch.cuda.Stream | None:
        """The session's stream on ``device`` (``None`` off the card)."""
        return self._streams.get(torch.device(device))

    @contextlib.contextmanager
    def _on_streams(self):
        """Serve on the session's streams, after the caller's current ones."""
        with contextlib.ExitStack() as stack:
            for d, s in self._streams.items():
                s.wait_stream(torch.cuda.current_stream(d))
                stack.enter_context(torch.cuda.stream(s))
            if self._streams:
                stack.enter_context(torch.cuda.device(self.device))
            yield

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
        if self._groups is not None and plan.mesh_devices != len(self.devices):
            raise ValueError(f"this session splits over {len(self.devices)} devices; its plans "
                             f"need mesh_devices={len(self.devices)} (ServeMesh.plan_for), "
                             f"got {plan.mesh_sig()}")
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
        callers = {d: torch.cuda.current_stream(d) for d in self._streams}
        with contextlib.ExitStack() as stack:
            stack.enter_context(spans.span("session.chunk", bucket=bucket, rows=b))
            for c in self.caches:
                stack.enter_context(c.sample_lock)
            frames = [stack.enter_context(c.attribution()) for c in self.caches]
            t0 = time.perf_counter()
            with self._on_streams():
                records, sample, eng = harness.serve_records(
                    self.params, self.cfg, self.sched, x, labels, plan,
                    runner_cache=self.cache, bucket=bucket, device=self.device,
                    mesh=self._groups)
            with spans.span("session.sync"):
                for s in self._streams.values():  # this chunk's work, not the card's
                    s.synchronize()
            wall = time.perf_counter() - t0
        if self._streams:
            sample.record_stream(callers[sample.device])  # the caller reads it there
        return ChunkResult(sample=sample, records=records, engine=eng, batch=b,
                           bucket=bucket, wall_s=wall,
                           captures_delta=sum(f.count for f in frames))

    def warmup(self, modes: dict, plans, buckets, *, labels: bool) -> int:
        """Capture the runners of ``plans`` under ``modes`` at each bucket of
        ``buckets`` in this session's caches (``CompiledRunnerCache.warmup``):
        a bucket its devices split warms each device's cache at the rows
        of its group, any other warms the first device's at the whole
        bucket. Returns the captures made."""
        n = 0
        with self._on_streams():
            for b in buckets:
                split = self._groups is not None and b % len(self._groups) == 0
                for g in (self._groups if split else [RowGroup(self.device, self.params,
                                                               self.cache)]):
                    r = g.cache.warmup(self.cfg, modes, plans,
                                       [b // len(self._groups) if split else b],
                                       labels=labels, params=g.params)
                    n += r["captures"]
        for s in self._streams.values():
            s.synchronize()
        return n

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The session's counters and its caches' (summed over a mesh's)."""
        with self._stats_lock:
            own = {"batches": self.batches_served, "requests": self.requests_served,
                   "watchdog_events": self.watchdog_events}
        return {**own, **CompiledRunnerCache.stats_of(self.caches)}

    @property
    def n_captures(self) -> int:
        """Captures made in the session's caches."""
        return sum(c.n_captures for c in self.caches)
