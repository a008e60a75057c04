"""DittoPlan: the one execution-configuration object of the port.

Mirror of ``src/repro/core/ditto/plan.py``. A :class:`DittoPlan` is a
frozen, hashable dataclass in four groups:

  kernel   : ``block``, ``low_bits``, ``fused`` — what the compiled step
             launches (validated once, at construction);
  mesh     : ``mesh_devices``, ``mesh_axis`` — the data-parallel width a
             dispatch's rows are split over (``serve/mesh.py``);
  sampling : ``steps``, ``sampler``, ``policy`` — the denoising loop and
             the engine's mode policy;
  serve    : ``compiled``, ``collect_stats``, ``max_batch``,
             ``deadline_ms`` — runtime behavior of the serving layer;
  recovery : ``max_retries``, ``retry_backoff_ms``, ``fallbacks`` (the
             scheduler's degradation ladder), ``watchdog``,
             ``reanchor_full_frac`` — never part of
             :meth:`DittoPlan.cache_sig`.

A plan is a runner identity: :meth:`DittoPlan.cache_sig` is the ordered
tuple of the fields that select what the compiled step launches, and
``serve.cache.RunnerKey`` embeds it. :class:`PlanSchedule` maps timestep
ranges to deltas over :data:`SEGMENT_FIELDS` and builds one runner per
distinct segment.

The reference's ``interpret`` has no counterpart: the device of the
tensors decides between kernel and plain version. On the card every
kernel tiles by 128, so :func:`check_device_block` rejects any other
``block`` there before a step runs; the plain versions on the CPU take any
block. Of the deprecated per-knob keyword shims only the :data:`UNSET` sentinel
is here, which ``ServeScheduler.submit(deadline_ms=)`` needs
(``plan_from_kwargs`` has no caller in the port).
"""
from __future__ import annotations

import dataclasses

import torch

from ...kernels.common import DEFAULT_LOW_BITS, validate_low_bits

DEFAULT_MAX_BATCH = 64  # mirrored by repro_torch.serve.bucketing

#: The tile edge every CUDA kernel of the port takes (``csrc/*.cu``).
CARD_BLOCK = 128

_SAMPLERS = ("ddim", "plms")
_POLICIES = ("act", "diff", "spatial", "defo", "defo+")

#: Plan fields a schedule segment may override: exactly the fields of
#: :meth:`DittoPlan.cache_sig`. Loop-level fields (``steps``, ``sampler``,
#: ``policy``, ``compiled``, ``max_batch``) stay constant across a schedule.
SEGMENT_FIELDS = ("block", "collect_stats", "low_bits", "fused")

#: Mesh fields: how a dispatch's batch rows are split over the devices of
#: one shard (``(mesh_axis: mesh_devices)``). They are runner identity —
#: :meth:`DittoPlan.cache_sig` ends with :meth:`DittoPlan.mesh_sig` — so a
#: sharded and an unsharded runner never share a CUDA graph. They are
#: neither segment-schedulable (a mid-loop change would move the carried
#: state) nor fallback-overridable (a degraded rung stays on its shard).
#: The steal and queue policy lives on ``serve.mesh.ServeMesh`` and stays
#: out of the sig.
MESH_SIG_FIELDS = ("mesh_devices", "mesh_axis")

#: Plan fields a degradation-ladder fallback delta may override: the
#: segment fields plus ``compiled``, so the last rung can drop to the eager
#: engine. Loop and queueing fields stay fixed: a fallback redispatch covers
#: the same tickets with the same loop shape.
FALLBACK_FIELDS = SEGMENT_FIELDS + ("compiled",)

#: Recovery-policy fields. None of them changes what a step launches, so
#: none may appear in :meth:`DittoPlan.cache_sig`: two plans differing only
#: in how they recover share every runner.
ROBUSTNESS_FIELDS = (
    "max_retries", "retry_backoff_ms", "fallbacks", "watchdog",
    "reanchor_full_frac",
)


def _canon_delta(delta) -> tuple:
    """Delta -> canonical sorted ``((field, value), ...)`` tuple."""
    if delta is None:
        return ()
    items = delta.items() if isinstance(delta, dict) else delta
    try:
        pairs = [(k, v) for k, v in items]
    except (TypeError, ValueError):
        raise ValueError(
            f"segment delta must be a dict or (field, value) pairs, got {delta!r}")
    return tuple(sorted(pairs))


@dataclasses.dataclass(frozen=True)
class DittoPlan:
    """Frozen, hashable execution plan for one request (or one session)."""

    # --- kernel config ------------------------------------------------------
    block: int = CARD_BLOCK
    low_bits: int = DEFAULT_LOW_BITS  # 4 = packed-int4 low-tile branch
    fused: bool = False  # single-pass fused diff-step kernel
    # --- mesh config: data-parallel layout of one dispatch --------------------
    mesh_devices: int | None = None  # devices a dispatch's rows split over; None = unsharded
    mesh_axis: str = "data"  # mesh axis name the batch dim splits over
    # --- sampling config: the denoising loop --------------------------------
    steps: int = 20
    sampler: str = "ddim"
    policy: str = "defo"
    # --- serve config: runtime behavior --------------------------------------
    compiled: bool = True
    collect_stats: bool = True
    max_batch: int = DEFAULT_MAX_BATCH
    deadline_ms: float | None = None  # per-request latency budget (SLO); None = no budget
    # --- recovery config: never part of cache_sig() --------------------------
    max_retries: int = 0  # extra dispatch attempts after the first fails
    retry_backoff_ms: float = 0.0  # base backoff, doubled per retry (capped)
    fallbacks: tuple = ()  # degradation ladder: plan deltas over FALLBACK_FIELDS
    watchdog: bool = False  # per-step finite guard + re-anchor on the compiled path
    reanchor_full_frac: float | None = None  # Δ-saturation threshold; None = off

    def __post_init__(self):
        validate_low_bits(self.low_bits)
        self._validate_recovery()
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
        if self.deadline_ms is not None and not self.deadline_ms > 0:
            raise ValueError(
                f"deadline_ms must be > 0 (or None for no budget), got {self.deadline_ms}")
        if self.sampler not in _SAMPLERS:
            raise ValueError(f"sampler must be one of {_SAMPLERS}, got {self.sampler!r}")
        if self.policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {self.policy!r}")
        if self.mesh_devices is not None and (
                self.mesh_devices < 1 or self.mesh_devices & (self.mesh_devices - 1)):
            # buckets are powers of two, so a power-of-two width divides every
            # bucket at least as large (smaller ones are replicated)
            raise ValueError(
                f"mesh_devices must be a power of two >= 1 (or None for unsharded), "
                f"got {self.mesh_devices}")
        if not (isinstance(self.mesh_axis, str) and self.mesh_axis.isidentifier()):
            raise ValueError(f"mesh_axis must be an identifier string, got {self.mesh_axis!r}")

    def _validate_recovery(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff_ms < 0:
            raise ValueError(f"retry_backoff_ms must be >= 0, got {self.retry_backoff_ms}")
        canon = tuple(_canon_delta(d) for d in tuple(self.fallbacks))
        object.__setattr__(self, "fallbacks", canon)
        for delta in canon:
            bad = sorted(k for k, _ in delta if k not in FALLBACK_FIELDS)
            if bad:
                raise ValueError(
                    f"fallback delta overrides non-fallback fields {bad}; "
                    f"allowed fields are {FALLBACK_FIELDS}")
            self.replace(**dict(delta), fallbacks=())  # each rung must be a valid plan
        if self.reanchor_full_frac is not None:
            if not 0.0 < self.reanchor_full_frac <= 1.0:
                raise ValueError(
                    f"reanchor_full_frac must be in (0, 1], got {self.reanchor_full_frac}")
            if not self.watchdog:
                raise ValueError(
                    "reanchor_full_frac requires watchdog=True (the saturation "
                    "metric is read by the watchdog)")
            if not self.collect_stats:
                raise ValueError(
                    "reanchor_full_frac requires collect_stats=True (the saturation "
                    "metric is derived from the recorded tile-class histograms)")

    def replace(self, **kw) -> "DittoPlan":
        """A copy with fields overridden (re-validated)."""
        return dataclasses.replace(self, **kw)

    def normalized(self) -> "DittoPlan":
        """The canonical form. The reference resolves ``interpret`` here; the
        port has nothing to resolve, so a plan is its own normal form."""
        return self

    def cache_sig(self) -> tuple:
        """Ordered identity of the compiled step: the plan fields that select
        what it launches, in :data:`SEGMENT_FIELDS` order, then
        :meth:`mesh_sig` as the final slot (``RunnerKey``'s accessors rely on
        the order; the reference's tuple has ``interpret`` in slot 1 besides,
        which the port has not, so its mesh slot is 5 and the port's 4). The
        loop, serve and recovery fields are absent: plans differing only
        there run the same step."""
        return (self.block, self.collect_stats, self.low_bits, self.fused, self.mesh_sig())

    def mesh_sig(self) -> tuple | None:
        """``(mesh_devices, mesh_axis)`` for a sharded plan, else ``None``:
        the whole mesh identity a runner sees. Which devices a shard owns is
        placement (``serve.mesh``), never part of a key."""
        if self.mesh_devices is None:
            return None
        return (self.mesh_devices, self.mesh_axis)

    def fallback_plans(self) -> tuple:
        """The resolved degradation ladder: one :class:`DittoPlan` per
        ``fallbacks`` delta, in order. Rungs carry no recovery policy of
        their own (``max_retries=0``, no further fallbacks): the scheduler
        walks the ladder, one rung per retry, and it must not recurse.
        ``watchdog`` / ``reanchor_full_frac`` are inherited."""
        return tuple(
            self.replace(**dict(delta), max_retries=0, retry_backoff_ms=0.0, fallbacks=())
            for delta in self.fallbacks)


#: Default plan for the bare eager engine path (``make_denoise_fn`` with no
#: plan): calibration/analysis runs, not the compiled serving path.
EAGER_PLAN = DittoPlan(compiled=False)


# ----------------------------------------------------------- plan schedules
@dataclasses.dataclass(frozen=True)
class PlanSchedule:
    """Frozen, hashable mapping of timestep ranges -> plan deltas.

    ``segments`` is a tuple of ``(start, stop, delta)`` half-open ranges
    over ``[0, base.steps)``; each delta overrides a subset of
    :data:`SEGMENT_FIELDS` on ``base``. Construction validates the
    partition (full cover, no gaps, no overlaps, no empty ranges) and that
    every delta yields a valid plan. ``make_denoise_fn`` builds one runner
    per distinct segment ``cache_sig()`` and carries the temporal state
    across a boundary; a constant schedule is its one plan.

        sched = PlanSchedule(DittoPlan(steps=12), [
            (0, 4, {}),                              # int8 two-pass early
            (4, 12, dict(low_bits=4, fused=True)),   # packed-int4 fused late
        ])
    """

    base: DittoPlan
    segments: tuple = ()

    def __post_init__(self):
        if not isinstance(self.base, DittoPlan):
            raise TypeError(
                f"PlanSchedule.base must be a DittoPlan, got {type(self.base).__name__}")
        canon = []
        for seg in tuple(self.segments):
            try:
                start, stop, delta = seg
            except (TypeError, ValueError):
                raise ValueError(f"segment must be (start, stop, delta), got {seg!r}")
            canon.append((int(start), int(stop), _canon_delta(delta)))
        canon.sort(key=lambda s: (s[0], s[1]))
        object.__setattr__(self, "segments", tuple(canon))
        self._validate()

    def _validate(self) -> None:
        steps = self.base.steps
        if not self.segments:
            raise ValueError(f"schedule has no segments; must cover [0, {steps})")
        cursor = 0
        for start, stop, delta in self.segments:
            if stop <= start:
                raise ValueError(f"empty segment [{start}, {stop})")
            if start < cursor:
                raise ValueError(
                    f"segments overlap: [{start}, {stop}) begins before step {cursor}")
            if start > cursor:
                raise ValueError(f"gap: steps [{cursor}, {start}) are uncovered")
            if stop > steps:
                raise ValueError(f"segment [{start}, {stop}) exceeds steps={steps}")
            bad = sorted(k for k, _ in delta if k not in SEGMENT_FIELDS)
            if bad:
                raise ValueError(
                    f"segment [{start}, {stop}) overrides non-segment fields {bad}; "
                    f"schedulable fields are {SEGMENT_FIELDS}")
            self.base.replace(**dict(delta))  # each delta must yield a valid plan
            cursor = stop
        if cursor != steps:
            raise ValueError(f"gap: steps [{cursor}, {steps}) are uncovered")

    # ----------------------------------------------- loop-level delegation
    # Constant across the schedule by construction: callers that only care
    # about the loop shape read these off a schedule as off a bare plan.
    @property
    def steps(self) -> int:
        return self.base.steps

    @property
    def sampler(self) -> str:
        return self.base.sampler

    @property
    def policy(self) -> str:
        return self.base.policy

    @property
    def compiled(self) -> bool:
        return self.base.compiled

    @property
    def max_batch(self) -> int:
        return self.base.max_batch

    @property
    def collect_stats(self) -> bool:
        # the eager engine's oracle stats follow the base; each compiled
        # segment reads its own plan's
        return self.base.collect_stats

    @property
    def deadline_ms(self) -> float | None:
        return self.base.deadline_ms

    # The mesh layout is loop-level: a segment may not move the carried state
    # to another split, so every segment plan inherits the base's.
    @property
    def mesh_devices(self) -> int | None:
        return self.base.mesh_devices

    @property
    def mesh_axis(self) -> str:
        return self.base.mesh_axis

    def mesh_sig(self) -> tuple | None:
        return self.base.mesh_sig()

    # The recovery policy governs the whole dispatch, so it delegates too.
    @property
    def max_retries(self) -> int:
        return self.base.max_retries

    @property
    def retry_backoff_ms(self) -> float:
        return self.base.retry_backoff_ms

    @property
    def fallbacks(self) -> tuple:
        return self.base.fallbacks

    @property
    def watchdog(self) -> bool:
        return self.base.watchdog

    @property
    def reanchor_full_frac(self) -> float | None:
        return self.base.reanchor_full_frac

    def fallback_plans(self) -> tuple:
        """The ladder of a scheduled dispatch: its rungs are constant plans
        (a dispatch that already failed drops the per-segment variation)."""
        return self.base.fallback_plans()

    # ------------------------------------------------------------------ api
    def plan_for(self, step: int) -> DittoPlan:
        """The fully resolved plan of sampler step ``step``."""
        for start, stop, delta in self.segments:
            if start <= step < stop:
                return self.base.replace(**dict(delta))
        raise ValueError(f"step {step} outside the schedule's [0, {self.base.steps}) range")

    def segment_plans(self) -> tuple:
        """``((start, stop, DittoPlan), ...)``, the resolved partition."""
        return tuple((start, stop, self.base.replace(**dict(delta)))
                     for start, stop, delta in self.segments)

    def replace(self, **kw) -> "PlanSchedule":
        """A copy with ``base`` / ``segments`` overridden (re-validated)."""
        return dataclasses.replace(self, **kw)

    def normalized(self) -> "PlanSchedule":
        """Canonical form: adjacent segments that resolve to the same plan
        merged, each delta reduced to the fields that differ from the base,
        so two spellings of the same per-step behavior compare equal."""
        base = self.base.normalized()
        merged: list = []
        for start, stop, plan in self.segment_plans():
            plan = plan.normalized()
            if merged and merged[-1][2] == plan:
                prev_start, _, prev_plan = merged.pop()
                merged.append((prev_start, stop, prev_plan))
            else:
                merged.append((start, stop, plan))
        segments = tuple(
            (start, stop, tuple(sorted(
                (f, getattr(plan, f)) for f in SEGMENT_FIELDS
                if getattr(plan, f) != getattr(base, f))))
            for start, stop, plan in merged)
        return dataclasses.replace(self, base=base, segments=segments)

    def cache_sigs(self) -> tuple:
        """Distinct segment ``cache_sig()`` tuples in first-use order: one
        runner per entry, per bucket."""
        sigs: list = []
        for _, _, plan in self.segment_plans():
            sig = plan.cache_sig()
            if sig not in sigs:
                sigs.append(sig)
        return tuple(sigs)

    def is_constant(self) -> bool:
        """True when every step resolves to one plan."""
        return self.constant_plan() is not None

    def constant_plan(self) -> DittoPlan | None:
        """The one per-step plan of a constant schedule, else ``None``."""
        plans = {plan for _, _, plan in self.normalized().segment_plans()}
        return plans.pop() if len(plans) == 1 else None


def segment_resolved(plan):
    """Collapse ``plan`` to the one :class:`DittoPlan` a runner needs: a bare
    plan passes through, a constant schedule resolves to its plan, and a
    multi-segment schedule raises (``make_denoise_fn`` and the serve layers
    take the schedule itself and resolve it per segment)."""
    if isinstance(plan, PlanSchedule):
        const = plan.constant_plan()
        if const is None:
            raise TypeError(
                "a multi-segment PlanSchedule resolves per step; pass one segment's "
                "plan (PlanSchedule.plan_for / segment_plans) — make_denoise_fn and "
                "the serve layers accept the schedule itself")
        return const
    return plan


def segment_view(plan):
    """``((start, stop, DittoPlan), ...)`` for a plan or a schedule,
    normalized; a bare plan is one whole-loop segment."""
    if isinstance(plan, PlanSchedule):
        return plan.normalized().segment_plans()
    plan = plan.normalized()
    return ((0, plan.steps, plan),)


class _Unset:
    """Sentinel telling "keyword not passed" from any real value."""

    def __repr__(self):
        return "<unset>"


UNSET = _Unset()


def is_unset(v) -> bool:
    """True when ``v`` is the :data:`UNSET` sentinel (keyword not passed)."""
    return isinstance(v, _Unset)


def check_device_block(plan, device) -> None:
    """Raise ``ValueError`` when ``plan`` (or any segment of a schedule) asks
    for a tile other than :data:`CARD_BLOCK` on a CUDA device: the kernels
    ``int8_matmul``, ``diff_encode``, ``ditto_diff_matmul``,
    ``diff_encode_fused`` and ``ditto_fused_matmul`` tile by 128 only. The
    plain versions on the CPU take any block, and an eager-only plan
    (``compiled=False``) launches no kernel."""
    if torch.device(device).type != "cuda" or not plan.compiled:
        return
    blocks = sorted({p.block for _, _, p in segment_view(plan)} - {CARD_BLOCK})
    if blocks:
        raise ValueError(
            f"block={blocks[0]} cannot run on the card: its kernels (int8_matmul, "
            f"diff_encode, ditto_diff_matmul, diff_encode_fused, ditto_fused_matmul) "
            f"tile by {CARD_BLOCK} only; use block={CARD_BLOCK} or device='cpu'")
