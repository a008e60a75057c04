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
      re-anchor watchdog on the session path).

The scheduler and the mesh come with later slices (ROADMAP.md, queue 1).
"""
from ..core.ditto.plan import DittoPlan, PlanSchedule
from . import faults
from .bucketing import DEFAULT_MAX_BATCH, bucket_for, pad_batch
from .cache import CompiledRunnerCache, RunnerKey, cfg_signature
from .faults import (Fault, FaultInjector, InjectedFault, NumericalFault,
                     ResourceExhausted, chaos_schedule, inject)
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
