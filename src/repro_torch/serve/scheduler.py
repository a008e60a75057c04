"""ServeScheduler: continuous batching across request submissions.

Mirror of ``src/repro/serve/scheduler.py``: solo mode (one
:class:`ServeSession`) and mesh mode (one session a shard of a
:class:`~repro_torch.serve.mesh.ServeMesh`, below).

``ServeSession.serve`` batches WITHIN one call: each call chunks to
``max_batch`` and pads its own remainder chunk up to a power-of-two
bucket, so a stream of small requests wastes pad rows on every call. The
scheduler coalesces ACROSS submissions:

  * ``submit(x, labels, plan=None, deadline_ms=...) -> Ticket`` queues a
    request (an optional per-request plan and latency budget) and returns
    at once. Whenever a plan group's queue holds ``max_batch`` rows, a
    full bucket dispatches.
  * ``flush()`` dispatches everything still queued (the ragged tail pays
    the only padding of the stream) and resolves every ticket.
  * ``Ticket.result()`` returns this request's rows of the sample.

Requests are grouped by behavior: the group key is the loop-level fields,
the normalized ``(start, stop, cache_sig())`` segment partition, the
recovery policy and whether labels came with it, so sig-equal plans and
schedules built separately (a constant schedule and its bare plan, a
duck-typed plan) coalesce, and requests that differ in any step's
lowering never share a dispatch. ``deadline_ms`` stays out of the key (and
out of ``cache_sig()``): it changes when a request dispatches, never what
it computes.

A dispatch may split a request across two batches or pack several into
one. Both are invisible in the rows: activation calibration is per sample
(``quant.sample_scale``), the compiled products are exact integers and the
fp32 glue never mixes rows and runs its one-row-a-sample products at one
shape whatever the batch (``nn.core.dense``), so each ticket's rows equal
a per-request ``serve()`` bit for bit (tests/test_torch_scheduler.py;
``chip_smoke.py`` and ``benchmarks/torch_row_invariance.py`` on the card).

``async_mode=True`` starts a dispatch thread and makes the policy
time-based: a group dispatches when it holds a full bucket or when its
oldest budget is within one ``dispatch_interval`` of expiring (a partial
bucket, on purpose). ``poll()`` runs the same policy one step on the
calling thread; with an injected ``clock`` it makes the time-based
behavior deterministic under test.

Fault tolerance: a failed serve walks the plan's degradation ladder
(``max_retries`` re-dispatches, capped exponential backoff, down
``fallbacks``; on the card only after an injected or numerical fault);
batch assembly is transactional (``_take_locked``); a dead dispatch
thread fails every pending and later call with :class:`SchedulerDied`; ``shed_expired=True`` rejects expired queued
requests with :class:`RequestShed`. The ``scheduler.policy``,
``scheduler.take`` and ``scheduler.dispatch`` fault sites of
:mod:`~repro_torch.serve.faults` fire where the reference fires them.

On the card, the first request of a runner key captures its CUDA graph on
the dispatching thread (the dispatch thread in async mode) while clients
keep submitting and allocating on theirs. The runner cache captures with
``capture_error_mode="thread_local"``, so only the capturing thread is
barred from synchronizing calls during a capture; the session waits for
its own streams after each chunk, and a ticket's rows are assembled (each
piece after a wait on the stream that produced it, moved to the device of
the ticket's first rows) and their stream synchronized before
``result()`` hands them to another thread.

Mesh mode
---------

``mesh`` (a :class:`~repro_torch.serve.mesh.ServeMesh`) puts the scheduler
on several devices: one :class:`ServeSession` a shard, every submitted plan
stamped with the mesh signature (``mesh_devices`` / ``mesh_axis`` end
``cache_sig()``, so mesh groups never coalesce with unsharded ones), and
per-shard dispatch: each group is routed to the shard with the fewest
queued rows when it is created (round-robin on a tie), and in async mode
each shard runs its own dispatch thread (``ditto-serve-shard{k}``) over its
own groups. A shard with no due work of its own STEALS due work (a full
bucket, a nearing deadline, a demanded or drained tail) from a sibling
that is mid-dispatch, gated by ``mesh.steal`` / ``mesh.steal_min_rows``,
and serves it on its own session, bit-identically (per-sample calibration
makes the serving device invisible in the rows); a steal counts as
trigger ``"steal"``. Deadlines, shedding and the ladder stay per dispatch,
so a fault on one shard walks that dispatch's ladder and no sibling's.
Port divergence, on purpose: each shard's session has runner caches of its
own (the reference shares one: a CUDA graph and its arena are bound to one
device and one sample at a time, so a shared cache would run the shards
one after another).

Completed tickets RETIRE to counters; ``retain=True`` keeps the full
``tickets`` / ``dispatches`` / ``Ticket.results`` record (every
ServeResult stays live for the scheduler's lifetime).

Spans (:mod:`repro_torch.spans`, on ``time.monotonic()``, never on
``clock``): ``sched.wait`` around a dispatch thread's wait for work,
``sched.dispatch`` over each dispatch, ``sched.deliver`` over its
delivery, and one ``ticket.queue`` a ticket, from its submit to the take
of its first rows, carrying the id of the dispatch that took them.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Callable

import torch

from .. import spans
from ..core import diffusion
from ..core.ditto import DittoEngine, make_denoise_fn
from ..core.ditto.plan import UNSET, DittoPlan, PlanSchedule, is_unset, segment_view
from . import faults
from .bucketing import bucket_for
from .cache import CompiledRunnerCache
from .session import ServeResult, ServeSession

#: Per-retry exponential backoff is capped here so a deep ladder cannot
#: sleep a dispatch past any plausible SLO.
BACKOFF_CAP_MS = 2000.0


class SchedulerDied(RuntimeError):
    """The background dispatch thread died; the scheduler cannot serve.

    Every pending ``Ticket.result()`` raises this (the original thread
    exception is the ``__cause__``), as does any later ``submit()``."""


class DispatchFailed(RuntimeError):
    """A dispatch failed after exhausting its retry/fallback ladder."""

    def __init__(self, attempts: int, cause: BaseException):
        super().__init__(f"dispatch failed after {attempts} attempt(s): {cause!r}")
        self.attempts = attempts
        self.__cause__ = cause


class RequestShed(RuntimeError):
    """Deadline-aware load shedding rejected this request: its latency
    budget expired before any dispatch covered it (``shed_expired=True``)."""


class _TakeFailed(RuntimeError):
    """Internal: batch assembly failed; covered tickets are already failed
    and the queue repaired — the dispatch loop just moves on."""


class Ticket:
    """Handle for one submitted request; resolves to its own sample rows."""

    def __init__(self, scheduler: "ServeScheduler", index: int, batch: int,
                 plan: DittoPlan | PlanSchedule, deadline_ms: float | None, submit_t: float):
        self._scheduler = scheduler
        self.index = index  # submission order, scheduler-wide
        self.batch = batch  # rows in this request
        self.plan = plan  # normalized plan/schedule this request runs under
        self.deadline_ms = deadline_ms  # latency budget; None = no SLO
        self.submit_t = submit_t  # scheduler-clock time of submit()
        # the spans' clock: submit() and the first take (a ticket.queue span)
        self._submit_mono = time.monotonic()
        self._taken_mono: float | None = None
        self.done_t: float | None = None  # scheduler-clock time of completion
        # absolute budget expiry on the scheduler clock
        self._deadline_t = None if deadline_ms is None else submit_t + deadline_ms / 1e3
        self.served_with = None  # plan of the successful dispatch (ladder rung)
        self._pieces: list[tuple[int, torch.Tensor]] = []  # (row offset, rows)
        self._filled = 0
        self._sample: torch.Tensor | None = None
        self._error: BaseException | None = None
        self._event = threading.Event()
        self.results: list[ServeResult] = []  # populated only under retain=True

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> torch.Tensor:
        """This request's sample at its true batch size (rows in submission
        order). Blocks until served; in sync mode a still-queued request
        triggers ``flush()``, in async mode it marks the request demanded so
        the dispatch thread drains its group next."""
        if not self._event.is_set():
            self._scheduler._demand(self)
            if not self._event.wait(timeout):
                raise TimeoutError(f"request {self.index} not served within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._sample

    # ------------------------------------------------------------- internal
    # all mutation happens under the scheduler's condition lock
    def _deliver(self, dst: int, rows: torch.Tensor, result: ServeResult | None,
                 stream=None) -> None:
        # dst = this piece's row offset within the request, fixed at take
        # time: split pieces may be served on different shard threads and
        # complete out of order; stream = the CUDA stream that produced rows
        self._pieces.append((dst, rows, stream))
        self._filled += rows.shape[0]
        if result is not None:
            self.results.append(result)

    def _finish(self, now: float) -> None:
        pieces = sorted(self._pieces, key=lambda p: p[0])
        dev = pieces[0][1].device  # the ticket's device: where its first rows were served
        rows = []
        for _, piece, stream in pieces:
            if stream is not None:  # made on another shard's stream (or card)
                torch.cuda.current_stream(piece.device).wait_stream(stream)
            rows.append(piece.to(dev))
        # a fresh tensor even for one piece: the ticket must not pin the
        # dispatch's padded sample, of which each piece is a view
        sample = torch.cat(rows, dim=0)
        if sample.is_cuda:
            # assembled on the dispatching thread's stream; the client reads
            # it on its own
            torch.cuda.current_stream(sample.device).synchronize()
        self._sample = sample
        self._pieces = []
        self.done_t = now
        self._event.set()

    def _fail(self, exc: BaseException, now: float) -> None:
        self._error = exc
        self._pieces = []
        self.done_t = now
        self._event.set()


@dataclasses.dataclass
class _Pending:
    ticket: Ticket
    x: torch.Tensor
    labels: torch.Tensor | None
    used: int = 0  # rows already dispatched

    @property
    def remaining(self) -> int:
        return self.x.shape[0] - self.used


class _Group:
    """FIFO queue of pending requests sharing one behavioral group key.
    ``plan`` is the first-seen normalized plan/schedule of the group; every
    member behaves identically to it, so dispatching all members under it
    is exact. ``shard`` is the mesh shard whose queue owns the group (0,
    the only session, in solo mode); a sibling may still steal its due
    work."""

    def __init__(self, plan: DittoPlan | PlanSchedule, shard: int = 0):
        self.plan = plan
        self.shard = shard
        self.pending: deque[_Pending] = deque()

    @property
    def queued_rows(self) -> int:
        return sum(p.remaining for p in self.pending)


def _naive_pad(batch: int, max_batch: int) -> int:
    """Pad rows ``batch`` would waste as an independent serve() call."""
    total, b = 0, batch
    while b > 0:
        c = min(b, max_batch)
        total += bucket_for(c, max_batch=max_batch) - c
        b -= c
    return total


def _bucket_ladder(max_batch: int) -> list[int]:
    out, b = [], 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return out


class ServeScheduler:
    """Continuous-batching front end over one :class:`ServeSession` (or one
    a shard of ``mesh``).

    ``plan`` is the default for submissions that carry none; the session
    and its runner ``cache`` belong to the scheduler; ``device`` is the
    session's (default: the card). ``mesh`` (a :class:`ServeMesh`) serves
    on its shards instead (``device`` is then unused; ``cache`` is shard
    0's first device's). ``eager=False`` queues everything until
    ``flush()``.

    ``async_mode=True`` starts the background dispatch thread (a daemon):
    submissions return at once, the full-bucket / deadline policy drives
    dispatch, ``Ticket.result()`` blocks on completion.
    ``dispatch_interval_ms`` is the policy's time granularity: a budget
    counts as nearing within one interval of expiry. ``clock`` (a ``() ->
    float`` seconds callable, monotonic) injects a fake clock for tests.
    ``collect_done=True`` exposes completed tickets on the ``done`` queue.
    ``retain=True`` keeps full per-dispatch records.
    """

    def __init__(self, params, cfg, sched, plan: DittoPlan | PlanSchedule | None = None, *,
                 cache: CompiledRunnerCache | None = None, device=None, mesh=None,
                 eager: bool = True, async_mode: bool = False,
                 dispatch_interval_ms: float = 10.0, retain: bool = False,
                 collect_done: bool = False, shed_expired: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        plan = plan if plan is not None else DittoPlan()
        sessions = None
        if mesh is not None:
            # one session a shard, each with runner caches of its own
            plan = mesh.plan_for(plan)
            sessions = [ServeSession(params, cfg, sched, plan, cache=cache if k == 0 else None,
                                     mesh=mesh.shard_devices(k))
                        for k in range(mesh.n_shards)]
            session = sessions[0]
        else:
            session = ServeSession(params, cfg, sched, plan, cache=cache, device=device)
        self._init_runtime(session, mesh=mesh, sessions=sessions, eager=eager,
                           async_mode=async_mode, dispatch_interval_ms=dispatch_interval_ms,
                           retain=retain, collect_done=collect_done, shed_expired=shed_expired,
                           clock=clock)

    @classmethod
    def from_session(cls, session, *, eager: bool = True, async_mode: bool = False,
                     dispatch_interval_ms: float = 10.0, retain: bool = False,
                     collect_done: bool = False, shed_expired: bool = False,
                     clock: Callable[[], float] = time.monotonic) -> "ServeScheduler":
        """Wrap an existing session-like object (anything with ``.plan``,
        ``.serve(x, labels, plan=)`` and ``.stats()``): the hook tests use
        to drive the dispatch policy without a model."""
        s = cls.__new__(cls)
        s._init_runtime(session, eager=eager, async_mode=async_mode,
                        dispatch_interval_ms=dispatch_interval_ms, retain=retain,
                        collect_done=collect_done, shed_expired=shed_expired, clock=clock)
        return s

    def _init_runtime(self, session, *, eager, async_mode, dispatch_interval_ms, retain,
                      collect_done, shed_expired, clock, mesh=None, sessions=None):
        self.session = session
        self.mesh = mesh
        # per-shard sessions (mesh mode); solo mode serves everything on
        # self.session, which is also sessions[0] in mesh mode
        self._sessions = sessions if sessions is not None else [session]
        self._n_shards = mesh.n_shards if mesh is not None else 1
        self.eager = eager
        self.async_mode = async_mode
        self.retain = retain
        self.shed_expired = shed_expired  # reject expired queued requests
        self.dispatch_interval = dispatch_interval_ms / 1e3
        self._clock = clock
        self._cv = threading.Condition()  # guards everything below
        self._groups: dict[tuple, _Group] = {}
        self._live: dict[int, Ticket] = {}  # unresolved tickets only
        self._urgent: set[int] = set()  # ticket indices demanded via result()
        self._draining = False
        self._inflight = 0
        self._closed = False
        self._n_submitted = 0
        self._rows_submitted = 0
        self._n_dispatches = 0
        self._dispatched_rows = 0
        self._pad_rows = 0
        self._naive_pad_rows = 0
        self._completed = 0
        self._failed = 0
        self._deadline_misses = 0
        self._retries = 0
        self._fallbacks = 0
        self._shed = 0
        self._died: BaseException | None = None
        # "steal" is the mesh's trigger; solo mode keeps it at 0
        self._triggers = {"full": 0, "deadline": 0, "demand": 0, "drain": 0, "steal": 0}
        # mesh accounting: dispatches / rows per serving shard, steal events
        self._shard_dispatches = [0] * self._n_shards
        self._shard_rows = [0] * self._n_shards
        self._shard_inflight = [0] * self._n_shards  # steal gate: owner busy?
        self._steals = 0
        self._stolen_rows = 0
        self._rr = 0  # round-robin tiebreak of group routing
        # each shard's captures when warmup ended
        self._warm_captures: list[int] | None = None
        self.tickets: list[Ticket] = []
        self.dispatches: list[ServeResult] = []
        self.done: queue.SimpleQueue | None = queue.SimpleQueue() if collect_done else None
        self._threads: list[threading.Thread] = []
        if async_mode:
            # one dispatch thread a shard (solo: one, shard 0), each running
            # the policy over its own groups and, in mesh mode, stealing
            for k in range(self._n_shards):
                name = ("ditto-serve-dispatch" if self._n_shards == 1
                        else f"ditto-serve-shard{k}")
                t = threading.Thread(target=self._dispatch_loop, args=(k,), name=name,
                                     daemon=True)
                self._threads.append(t)
                t.start()

    # ------------------------------------------------------------------ api
    @staticmethod
    def _group_key(plan: DittoPlan | PlanSchedule) -> tuple:
        """Behavioral coalescing key of a normalized plan or schedule: the
        loop-level fields plus the ``(start, stop, cache_sig())`` segment
        partition, so sig-equal plans and schedules built separately share a
        group and anything that changes the served rows does not.
        ``deadline_ms`` is absent (urgency is per-request metadata). The
        recovery policy is present: it never changes a runner, but a
        dispatch recovers all its tickets under the group plan's policy."""
        segments = tuple((start, stop, p.cache_sig()) for start, stop, p in segment_view(plan))
        recovery = (getattr(plan, "max_retries", 0),
                    getattr(plan, "retry_backoff_ms", 0.0),
                    tuple(getattr(plan, "fallbacks", ()) or ()),
                    bool(getattr(plan, "watchdog", False)),
                    getattr(plan, "reanchor_full_frac", None))
        return (plan.steps, plan.sampler, plan.policy, plan.compiled, plan.max_batch,
                segments, recovery)

    def submit(self, x: torch.Tensor, labels=None,
               plan: DittoPlan | PlanSchedule | None = None, *,
               deadline_ms: float | None = UNSET) -> Ticket:
        """Queue one request; returns its :class:`Ticket` at once.

        ``plan`` overrides the scheduler default for this request;
        ``deadline_ms`` overrides the plan's latency budget (``None`` = no
        budget). Full ``max_batch`` buckets dispatch as soon as they fill
        (unless ``eager=False``)."""
        if x.shape[0] < 1:
            raise ValueError("empty request")
        plan = plan if plan is not None else self.session.plan
        if self.mesh is not None:
            # every dispatched plan carries the mesh signature: an unstamped
            # override would land in a separate (unsharded) group and key
            plan = self.mesh.plan_for(plan)
        plan = plan.normalized()
        if is_unset(deadline_ms):
            deadline_ms = plan.deadline_ms
        elif deadline_ms is not None and not deadline_ms > 0:
            raise ValueError(f"deadline_ms must be > 0 (or None), got {deadline_ms}")
        now = self._clock()
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._died is not None:
                raise SchedulerDied("scheduler dispatch thread has died; no further "
                                    "requests can be served") from self._died
            key = (self._group_key(plan), labels is not None)
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = _Group(plan, shard=self._route_locked())
            ticket = Ticket(self, self._n_submitted, x.shape[0], plan, deadline_ms, now)
            self._n_submitted += 1
            self._rows_submitted += ticket.batch
            self._naive_pad_rows += _naive_pad(ticket.batch, plan.max_batch)
            self._live[ticket.index] = ticket
            if self.retain:
                self.tickets.append(ticket)
            group.pending.append(_Pending(ticket, x, labels))
            if self.async_mode:
                self._cv.notify_all()  # wake the dispatch thread
            elif self.eager:
                while group.queued_rows >= plan.max_batch:
                    self._dispatch_locked(group, plan.max_batch, "full")
        return ticket

    def flush(self) -> list[Ticket]:
        """Dispatch every queued row (full buckets first; the ragged tail is
        the only padded dispatch) and return the tickets this call resolved.
        In async mode this blocks until the dispatch thread has drained
        every group and nothing is in flight."""
        with self._cv:
            snapshot = list(self._live.values())
            if self.async_mode:
                self._draining = True
                self._cv.notify_all()
                while (not self._closed and self._died is None and (
                        self._inflight or any(g.queued_rows for g in self._groups.values()))):
                    self._cv.wait()
                self._draining = False
            else:
                for group in self._groups.values():
                    while group.queued_rows:
                        self._dispatch_locked(
                            group, min(group.queued_rows, group.plan.max_batch), "drain")
            return [t for t in snapshot if t.done]

    def poll(self, shard: int | None = None) -> int:
        """Run at most one due dispatch on the calling thread and return the
        rows it dispatched (0 = nothing due): the dispatch threads' policy
        (``_next_job_locked``), for fake-clock tests and thread-free use.
        ``shard`` polls as that shard's dispatch thread would: its own
        groups first, then the steal scan, serving on its own session;
        ``None`` scans every group with no stealing."""
        with self._cv:
            job = self._next_job_locked(shard)
            if job is None:
                return 0
            group, rows, trigger = job
            try:
                batch = self._take_locked(group, rows)
            except _TakeFailed:
                return rows  # covered tickets failed; the queue is repaired
            serve_shard = shard if shard is not None else group.shard
            self._inflight += 1
            self._shard_inflight[serve_shard] += 1
        try:
            self._serve_and_deliver(group, batch, trigger, shard=serve_shard)
        finally:
            with self._cv:
                self._inflight -= 1
                self._shard_inflight[serve_shard] -= 1
                self._cv.notify_all()
        return rows

    def close(self, *, drain: bool = True, join_timeout_s: float = 5.0) -> None:
        """Stop the dispatch thread; ``drain=True`` (default) flushes the
        queues first so no ticket is left unresolved. A dispatch thread that
        fails to join within ``join_timeout_s`` raises (the scheduler still
        counts as closed)."""
        if self._closed:
            return
        if drain:
            self.flush()
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        threads, self._threads = self._threads, []
        for thread in threads:
            thread.join(timeout=join_timeout_s)
            if thread.is_alive():
                raise RuntimeError(
                    f"dispatch thread {thread.name} failed to join within "
                    f"{join_timeout_s}s (stalled dispatch?); the scheduler "
                    f"is closed but the thread may still hold the device")

    def __enter__(self) -> "ServeScheduler":
        return self

    def __exit__(self, *exc) -> None:
        # a failing with-body shouldn't hang on a drain of queued work
        self.close(drain=exc[0] is None)

    # --------------------------------------------------------------- warmup
    def warmup(self, *, plans=None, buckets=None, labels: bool = True,
               probe_seed: int = 0) -> dict:
        """Capture the bucket ladder's CUDA graphs before the first request.

        One batch-1 eager calibration probe per distinct (policy, steps) —
        seeded noise, the prefix up to the Defo decision, which both
        samplers share — gives the frozen per-layer modes; then
        :meth:`CompiledRunnerCache.warmup` captures one graph per (segment
        plan, bucket) under them (on the CPU: runs each step once). First
        requests then neither warm a step nor capture. A request whose Defo
        modes differ from the probe's lands on another key and captures
        then: ``stats()["captures_after_warmup"]`` counts those.

        The reference compiles ahead of time: its ``aot_compiled`` is the
        port's ``captures`` (a capture is where the port builds the step it
        replays), and its ``traces`` has no counterpart (nothing is traced).
        In mesh mode every sibling shard captures the same ladder in its own
        caches (a graph is bound to one device's addresses), and ``primed``
        counts those captures (0 in solo mode; ``captures`` is shard 0's).
        ``plans`` defaults to the
        session plan, ``buckets`` to each plan's power-of-two ladder (keep
        ``max_batch`` <= 16 at DiT-XL/2: a bucket's state arena is 0.58 GB
        a sample, per ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700
        W), ``labels`` to requests with class labels. Returns
        ``{"captures", "primed", "wall_s"}``."""
        t0 = time.monotonic()
        plans = [p.normalized() for p in
                 (plans if plans is not None else [self.session.plan])]
        by_probe: dict[tuple, list] = {}
        for p in plans:
            by_probe.setdefault((p.policy, p.steps), []).append(p)
        out = {"captures": 0, "primed": 0}
        for group_plans in by_probe.values():
            modes = self._probe_modes(group_plans[0], labels=labels, probe_seed=probe_seed)
            for p in group_plans:
                if self.mesh is not None:
                    p = self.mesh.plan_for(p).normalized()
                ladder = _bucket_ladder(p.max_batch) if buckets is None else buckets
                for k, sess in enumerate(self._sessions):
                    out["primed" if k else "captures"] += sess.warmup(modes, [p], ladder,
                                                                      labels=labels)
        with self._cv:
            self._warm_captures = [sess.n_captures for sess in self._sessions]
        out["wall_s"] = time.monotonic() - t0
        return out

    def _probe_modes(self, plan, *, labels: bool, probe_seed: int) -> dict:
        """Frozen per-layer modes from an eager calibration prefix: batch-1
        seeded-noise forwards until the engine is ready for the compiled
        pass (scales calibrated; Defo decided after step 2)."""
        sess = self.session
        cfg, dev = sess.cfg, sess.device
        eng = DittoEngine(policy=plan.policy, collect_oracle=False, device=dev)
        fn = make_denoise_fn(sess.params, cfg, eng, device=dev)
        g = torch.Generator(device=dev).manual_seed(probe_seed)
        x = torch.randn((1, cfg.input_size, cfg.input_size, cfg.in_channels), generator=g,
                        device=dev)
        lab = torch.zeros((1,), dtype=torch.int64, device=dev) if labels else None
        ts = diffusion.ddim_timesteps(sess.sched.T, plan.steps)
        eng.begin_sample()
        for i in range(len(ts)):
            if eng.ready_for_compiled():
                break
            t = ts[i]
            t_prev = ts[i + 1] if i + 1 < len(ts) else -1
            eps = fn(x, torch.full((1,), t, dtype=torch.int32, device=dev), lab)
            x = diffusion.ddim_step(sess.sched, x, eps, t, t_prev)
        return eng.compiled_modes()

    # ------------------------------------------------------------ internals
    def _demand(self, ticket: Ticket) -> None:
        """A client is blocked in ``result()`` on a still-queued ticket."""
        if not self.async_mode:
            self.flush()
            return
        with self._cv:
            if ticket.index in self._live:
                self._urgent.add(ticket.index)
                self._cv.notify_all()

    def _route_locked(self) -> int:
        """Shard of a newly created group: the fewest queued rows over its
        current groups, round-robin on a tie (an idle mesh spreads new
        groups instead of piling them on shard 0)."""
        if self._n_shards == 1:
            return 0
        load = [0] * self._n_shards
        for g in self._groups.values():
            load[g.shard] += g.queued_rows
        order = [(self._rr + k) % self._n_shards for k in range(self._n_shards)]
        shard = min(order, key=lambda k: load[k])
        self._rr = (shard + 1) % self._n_shards
        return shard

    def _next_job_locked(self, shard: int | None = None) -> tuple[_Group, int, str] | None:
        """The dispatch policy: the next (group, rows, trigger) to serve, or
        None if nothing is due. Deadline-due partials preempt full buckets (a
        full bucket loses no budget by waiting one policy round; an expiring
        request does). With ``shed_expired=True``, requests whose budget
        already expired undispatched are rejected first.

        ``shard`` scopes the scan to that shard's own groups (the per-shard
        dispatch threads); ``None`` scans everything. A shard with no due
        work of its own STEALS: it runs the same scan over sibling groups
        whose owner is mid-dispatch and that hold at least
        ``mesh.steal_min_rows`` — due work the owner is too busy to take,
        never a partial bucket an idle owner is still coalescing."""
        f = faults.fire("scheduler.policy")
        if f is not None:
            faults.perform(f)
        now = self._clock()
        if self.shed_expired:
            self._shed_locked(now)
        groups = (list(self._groups.values()) if shard is None else
                  [g for g in self._groups.values() if g.shard == shard])
        job = self._policy_scan_locked(groups, now)
        if job is not None or shard is None:
            return job
        if self.mesh is not None and self.mesh.steal:
            victims = [g for g in self._groups.values()
                       if g.shard != shard and self._shard_inflight[g.shard]
                       and g.queued_rows >= self.mesh.steal_min_rows]
            job = self._policy_scan_locked(victims, now)
            if job is not None:
                group, rows, _ = job
                return group, rows, "steal"
        return None

    def _policy_scan_locked(self, groups, now: float) -> tuple[_Group, int, str] | None:
        """One pass of the deadline -> full -> demand -> drain policy."""
        for group in groups:
            if any(p.ticket._deadline_t is not None
                   and p.ticket._deadline_t - now <= self.dispatch_interval
                   for p in group.pending):
                return group, min(group.queued_rows, group.plan.max_batch), "deadline"
        if self.eager or self._draining:
            for group in groups:
                if group.queued_rows >= group.plan.max_batch:
                    return group, group.plan.max_batch, "full"
        if self._urgent:
            for group in groups:
                if any(p.ticket.index in self._urgent for p in group.pending):
                    return group, min(group.queued_rows, group.plan.max_batch), "demand"
        if self._draining:
            for group in groups:
                q = group.queued_rows
                if q:
                    return group, min(q, group.plan.max_batch), "drain"
        return None

    def _next_wakeup_locked(self) -> float | None:
        """Seconds until the earliest queued budget becomes due, or None to
        sleep until notified."""
        now = self._clock()
        waits = [p.ticket._deadline_t - self.dispatch_interval - now
                 for g in self._groups.values() for p in g.pending
                 if p.ticket._deadline_t is not None]
        if not waits:
            return None
        return max(min(waits), 1e-4)  # floor avoids a zero-length spin

    def _shed_locked(self, now: float) -> None:
        """Reject every queued request whose budget has already expired with
        none of its rows dispatched (a split request in flight is served)."""
        any_shed = False
        for group in self._groups.values():
            for p in [p for p in group.pending
                      if p.used == 0 and p.ticket._deadline_t is not None
                      and now > p.ticket._deadline_t]:
                group.pending.remove(p)
                self._shed += 1
                self._failed += 1
                p.ticket._fail(RequestShed(
                    f"request {p.ticket.index} shed: deadline_ms="
                    f"{p.ticket.deadline_ms} expired before dispatch"), now)
                self._retire_locked(p.ticket)
                any_shed = True
        if any_shed:
            self._cv.notify_all()

    def _dispatch_loop(self, shard: int = 0) -> None:
        # any escape from the loop body lands in _on_died, so a dead thread
        # fails fast instead of stranding result() callers; a death on any
        # shard fails the whole scheduler (serve faults recover through the
        # per-dispatch ladder, not thread death)
        try:
            self._dispatch_loop_inner(shard)
        except BaseException as exc:  # noqa: BLE001 — death must be typed
            self._on_died(exc)

    def _dispatch_loop_inner(self, shard: int) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed:
                        return
                    job = self._next_job_locked(shard)
                    if job is not None:
                        break
                    with spans.span("sched.wait", shard=shard):
                        self._cv.wait(self._next_wakeup_locked())
                group, rows, trigger = job
                try:
                    batch = self._take_locked(group, rows)
                except _TakeFailed:
                    continue  # tickets failed, queue repaired — move on
                self._inflight += 1
                self._shard_inflight[shard] += 1
            try:
                fault = faults.fire("scheduler.dispatch")
                if fault is not None:
                    faults.perform(fault)
                self._serve_and_deliver(group, batch, trigger, shard=shard)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._shard_inflight[shard] -= 1
                    self._cv.notify_all()

    def _on_died(self, exc: BaseException) -> None:
        """The dispatch thread is dead: fail every live ticket with a typed
        :class:`SchedulerDied` (original exception chained) and clear the
        queues so ``flush()`` waiters wake."""
        now = self._clock()
        with self._cv:
            self._died = exc
            err = SchedulerDied(f"dispatch thread died: {exc!r}; all pending requests failed")
            err.__cause__ = exc
            for ticket in list(self._live.values()):
                self._failed += 1
                ticket._fail(err, now)
                self._retire_locked(ticket)
            self._groups.clear()
            self._cv.notify_all()

    def _take_locked(self, group: _Group, rows: int):
        """Pop exactly ``rows`` queued rows of ``group`` (FIFO, splitting a
        request across dispatches when needed). Transactional: rows are
        planned with index math first and the pendings are consumed only
        after slicing and concatenation succeed; on failure the covered
        tickets fail with the error, leave the queue, and
        :class:`_TakeFailed` tells the caller to go on."""
        plan_items: list[tuple[_Pending, int]] = []
        take, i = rows, 0
        while take:
            p = group.pending[i]
            c = min(p.remaining, take)
            plan_items.append((p, c))
            take -= c
            i += 1
        try:
            fault = faults.fire("scheduler.take")
            if fault is not None:
                faults.perform(fault)
            xs, ls = [], []
            for p, c in plan_items:
                xs.append(p.x[p.used:p.used + c])
                if p.labels is not None:
                    ls.append(p.labels[p.used:p.used + c])
            x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=0)
            labels = None if not ls else ls[0] if len(ls) == 1 else torch.cat(ls, dim=0)
        except BaseException as exc:
            now = self._clock()
            for p, _ in plan_items:
                self._failed += 1
                p.ticket._fail(exc, now)
                self._retire_locked(p.ticket)
                group.pending.remove(p)
            self._cv.notify_all()
            raise _TakeFailed(str(exc)) from exc
        segments = []
        taken = time.monotonic()
        for p, c in plan_items:
            if p.used == 0:
                p.ticket._taken_mono = taken
            segments.append((p.ticket, p.used, c))
            p.used += c
        while group.pending and not group.pending[0].remaining:
            group.pending.popleft()
        return x, labels, segments

    def _serve_and_deliver(self, group: _Group, batch, trigger: str,
                           shard: int | None = None) -> ServeResult | None:
        """One dispatch: a ``sched.dispatch`` span over :meth:`_serve_batch`,
        and a ``ticket.queue`` span, from its submit to this take, of each
        ticket whose first rows the batch took, naming the dispatch."""
        x, _, segments = batch
        shard = group.shard if shard is None else shard
        with spans.span("sched.dispatch", trigger=trigger, rows=x.shape[0], shard=shard,
                        tickets=[t.index for t, _, _ in segments]) as sp:
            for ticket, dst, _ in segments:
                if dst == 0:
                    spans.record("ticket.queue", ticket._submit_mono, ticket._taken_mono,
                                 ticket=ticket.index, dispatch=sp.id)
            return self._serve_batch(group, batch, trigger, shard)

    def _serve_batch(self, group: _Group, batch, trigger: str,
                     shard: int) -> ServeResult | None:
        """Serve one taken batch (outside the lock: submissions go on while
        the card runs) and deliver each covered ticket its rows. ``shard``
        is the SERVING shard: the thief's own on a stolen job, the group's
        otherwise.

        A failed serve walks the plan's degradation ladder: up to
        ``max_retries`` re-dispatches with capped exponential backoff, each
        on the next ``fallback_plans()`` rung (the last rung repeats once
        the ladder is shorter than the retry budget). The kernel-family rungs
        (fused -> two-pass -> ``low_bits=8`` -> eager) are bit-identical by
        the port's exact-integer identities, so a recovered ticket's rows
        equal the fault-free ones. Exhausting the ladder fails the covered
        tickets with :class:`DispatchFailed`; a single attempt fails them
        with the original error. On the card only the serving faults the
        stack types walk the ladder (:meth:`_may_retry`); a kernel, build,
        capture or replay error fails the tickets at once. Nothing serves
        elsewhere quietly."""
        x, labels, segments = batch
        session = self._sessions[shard] if shard < len(self._sessions) else self.session
        plan = group.plan
        ladder = (plan,) + tuple(plan.fallback_plans() if hasattr(plan, "fallback_plans")
                                 else ())
        attempts = 1 + getattr(plan, "max_retries", 0)
        backoff_ms = getattr(plan, "retry_backoff_ms", 0.0)
        result = None
        used_plan = plan
        last_exc: BaseException | None = None
        ran = 0
        for attempt in range(attempts):
            used_plan = ladder[min(attempt, len(ladder) - 1)]
            if attempt:
                with self._cv:
                    self._retries += 1
                    if used_plan is not plan:
                        self._fallbacks += 1
                if backoff_ms:
                    time.sleep(min(backoff_ms * 2 ** (attempt - 1), BACKOFF_CAP_MS) / 1e3)
            ran = attempt + 1
            try:
                result = session.serve(x, labels, plan=used_plan)
                break
            except Exception as exc:
                last_exc = exc
                if not self._may_retry(exc):
                    break
            except BaseException as exc:
                last_exc = exc  # never retry KeyboardInterrupt/SystemExit
                break
        if result is None:
            exc = last_exc if ran <= 1 else DispatchFailed(ran, last_exc)
            now = self._clock()
            with self._cv:
                self._failed += len(segments)
                for ticket, _, _ in segments:
                    ticket._fail(exc, now)
                    self._retire_locked(ticket)
                self._cv.notify_all()
            if not self.async_mode:
                raise exc  # sync callers get the error on their own stack
            return None
        stream_of = getattr(session, "stream", None)
        stream = (stream_of(result.sample.device)
                  if stream_of is not None and result.sample.is_cuda else None)
        now = self._clock()
        with spans.span("sched.deliver"), self._cv:
            self._n_dispatches += 1
            self._dispatched_rows += x.shape[0]
            self._pad_rows += result.pad_rows
            self._triggers[trigger] += 1
            self._shard_dispatches[shard] += 1
            self._shard_rows[shard] += x.shape[0]
            if trigger == "steal":
                self._steals += 1
                self._stolen_rows += x.shape[0]
            if self.retain:
                self.dispatches.append(result)
            off = 0
            for ticket, dst, c in segments:
                ticket.served_with = used_plan
                ticket._deliver(dst, result.sample[off:off + c],
                                result if self.retain else None, stream)
                off += c
                if ticket._filled == ticket.batch:
                    ticket._finish(now)
                    self._completed += 1
                    if ticket._deadline_t is not None and now > ticket._deadline_t:
                        self._deadline_misses += 1
                    self._retire_locked(ticket)
            self._cv.notify_all()
        return result

    def _may_retry(self, exc: Exception) -> bool:
        """Whether a failed serve may walk the ladder. On a CUDA session only
        an injected fault (resource exhaustion included) or a
        :class:`~.faults.NumericalFault` does: any other error there is the
        kernels' or the runner cache's, and a lower rung (another kernel, or
        the eager pass) would hide it. Elsewhere, as in the reference, every
        ``Exception`` retries."""
        device = getattr(self.session, "device", None)
        return (getattr(device, "type", None) != "cuda"
                or isinstance(exc, (faults.InjectedFault, faults.NumericalFault)))

    def _retire_locked(self, ticket: Ticket) -> None:
        self._live.pop(ticket.index, None)
        self._urgent.discard(ticket.index)
        if self.done is not None:
            self.done.put(ticket)

    def _dispatch_locked(self, group: _Group, rows: int, trigger: str) -> ServeResult | None:
        """Sync-mode dispatch: take + serve + deliver on the calling thread
        (the condition's lock is re-entrant)."""
        batch = self._take_locked(group, rows)
        return self._serve_and_deliver(group, batch, trigger)

    # ---------------------------------------------------------------- stats
    @property
    def pad_rows(self) -> int:
        """Replicated (wasted) rows across all dispatches so far."""
        return self._pad_rows

    def naive_pad_rows(self) -> int:
        """Pad rows the same submissions would have wasted as independent
        per-request ``serve()`` calls: the baseline coalescing beats."""
        return self._naive_pad_rows

    def stats(self) -> dict[str, Any]:
        """The scheduler's counters (the reference's keys), then the
        session's (its requests and the runner caches' captures, replays;
        in mesh mode summed over the shards), then, after :meth:`warmup`,
        ``captures_after_warmup``. Mesh mode adds the reference's ``mesh``
        block, with each shard's captures and captures after warmup."""
        with self._cv:
            out = {"submitted": self._n_submitted,
                   "submitted_rows": self._rows_submitted,
                   "queued_rows": sum(g.queued_rows for g in self._groups.values()),
                   "inflight": self._inflight,
                   "live_tickets": len(self._live),
                   "completed": self._completed,
                   "failed": self._failed,
                   "dispatches": self._n_dispatches,
                   "dispatched_rows": self._dispatched_rows,
                   "pad_rows": self._pad_rows,
                   "plan_groups": len(self._groups),
                   "triggers": dict(self._triggers),
                   "deadline_misses": self._deadline_misses,
                   "retries": self._retries,
                   "fallback_dispatches": self._fallbacks,
                   "shed": self._shed,
                   "died": self._died is not None}
            warm = self._warm_captures
            mesh = None if self.mesh is None else {
                "n_devices": self.mesh.n_devices, "dp": self.mesh.dp,
                "n_shards": self._n_shards,
                "shard_dispatches": list(self._shard_dispatches),
                "shard_rows": list(self._shard_rows),
                "steals": self._steals, "stolen_rows": self._stolen_rows}
        if mesh is None:
            out.update(self.session.stats())
        else:
            for sess in self._sessions:
                with sess._stats_lock:
                    out["batches"] = out.get("batches", 0) + sess.batches_served
                    out["requests"] = out.get("requests", 0) + sess.requests_served
                    out["watchdog_events"] = (out.get("watchdog_events", 0)
                                              + sess.watchdog_events)
            shard_caches = [getattr(sess, "caches", ()) for sess in self._sessions]
            out.update(CompiledRunnerCache.stats_of(c for caches in shard_caches for c in caches))
            mesh["shard_captures"] = [sum(c.n_captures for c in caches)
                                      for caches in shard_caches]
            out["mesh"] = mesh
        if warm is not None:
            after = [sess.n_captures - w for sess, w in zip(self._sessions, warm)]
            out["captures_after_warmup"] = sum(after)
            if mesh is not None:
                mesh["captures_after_warmup"] = after
        return out
