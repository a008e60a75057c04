"""DittoPlan: the one execution-configuration object of the port.

Mirror of ``src/repro/core/ditto/plan.py`` for the fields the main path
reads, in three groups:

  kernel   : ``block``, ``low_bits``, ``fused`` — what the compiled step
             launches (validated once, at construction);
  sampling : ``steps``, ``sampler``, ``policy`` — the denoising loop and
             the engine's mode policy;
  serve    : ``compiled``, ``collect_stats``, ``max_batch``.

The reference's ``interpret`` has no counterpart: the device of the
tensors decides between kernel and plain version. The mesh, recovery and
deadline fields and ``PlanSchedule`` come with later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

from ...kernels.common import DEFAULT_LOW_BITS, validate_low_bits

DEFAULT_MAX_BATCH = 64

_SAMPLERS = ("ddim", "plms")
_POLICIES = ("act", "diff", "spatial", "defo", "defo+")


@dataclasses.dataclass(frozen=True)
class DittoPlan:
    """Frozen, hashable execution plan for one request (or one session)."""

    # --- kernel config ------------------------------------------------------
    block: int = 128
    low_bits: int = DEFAULT_LOW_BITS  # 4 = packed-int4 low-tile branch
    fused: bool = False  # single-pass fused diff-step kernel
    # --- sampling config: the denoising loop --------------------------------
    steps: int = 20
    sampler: str = "ddim"
    policy: str = "defo"
    # --- serve config: runtime behavior --------------------------------------
    compiled: bool = True
    collect_stats: bool = True
    max_batch: int = DEFAULT_MAX_BATCH

    def __post_init__(self):
        validate_low_bits(self.low_bits)
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_batch & (self.max_batch - 1):
            raise ValueError(
                f"max_batch must be a power of two (the canonical bucket "
                f"ladder), got {self.max_batch}")
        if self.sampler not in _SAMPLERS:
            raise ValueError(f"sampler must be one of {_SAMPLERS}, got {self.sampler!r}")
        if self.policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {self.policy!r}")

    def replace(self, **kw) -> "DittoPlan":
        """A copy with fields overridden (re-validated)."""
        return dataclasses.replace(self, **kw)

    def cache_sig(self) -> tuple:
        """Ordered identity of the compiled step: the plan fields that select
        what it launches. The loop and serve fields are absent: plans
        differing only there run the same step."""
        return (self.block, self.collect_stats, self.low_bits, self.fused)


#: Default plan for the bare eager engine path (``make_denoise_fn`` with no
#: plan): calibration/analysis runs, not the compiled serving path.
EAGER_PLAN = DittoPlan(compiled=False)
