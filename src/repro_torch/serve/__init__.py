"""The serving runtime of the port: runner cache, batch buckets, faults
and the session front end.

Mirror of the parts of ``src/repro/serve/`` ported so far:

  :class:`CompiledRunnerCache` — one runner per ``RunnerKey = (model-cfg
      signature, layer-mode signature, plan.cache_sig(), batch bucket)``:
      one captured CUDA graph on the card, replayed every step;
  :mod:`bucketing` — ragged batches padded to power-of-two buckets by row
      replication (bit-exact against the unbucketed path);
  :class:`ServeSession` — the request front end over
      ``sim.harness.serve_records``;
  :mod:`faults` — seeded fault injection driving the recovery paths (the
      scheduler's retry/fallback ladder and the re-anchor watchdog);
  :class:`ServeScheduler` — continuous batching across submissions (sync
      coalescing, an async dispatch thread with deadlines and shedding,
      the degradation ladder, graph warmup); one :class:`Ticket` a request.

The mesh comes with a later slice (ROADMAP.md, queue 1).
"""
from ..core.ditto.plan import DittoPlan, PlanSchedule
from . import faults
from .bucketing import DEFAULT_MAX_BATCH, bucket_for, pad_batch
from .cache import CompiledRunnerCache, RunnerKey, cfg_signature
from .faults import (Fault, FaultInjector, InjectedFault, NumericalFault,
                     ResourceExhausted, chaos_schedule, inject)
from .scheduler import DispatchFailed, RequestShed, SchedulerDied, ServeScheduler, Ticket
from .session import ChunkResult, ServeResult, ServeSession

__all__ = [
    "DEFAULT_MAX_BATCH",
    "bucket_for",
    "pad_batch",
    "CompiledRunnerCache",
    "RunnerKey",
    "cfg_signature",
    "ChunkResult",
    "ServeResult",
    "ServeSession",
    "ServeScheduler",
    "Ticket",
    "SchedulerDied",
    "DispatchFailed",
    "RequestShed",
    "DittoPlan",
    "PlanSchedule",
    "faults",
    "Fault",
    "FaultInjector",
    "InjectedFault",
    "ResourceExhausted",
    "NumericalFault",
    "chaos_schedule",
    "inject",
]
