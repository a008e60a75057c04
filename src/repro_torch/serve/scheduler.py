"""ServeScheduler: continuous batching across request submissions.

Mirror of ``src/repro/serve/scheduler.py`` in solo mode (one
:class:`ServeSession`; the mesh mode comes with ``serve/mesh.py``).

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
barred from synchronizing calls during a capture; the session synchronizes
the card after each chunk, and a ticket's rows are assembled and their
stream synchronized before ``result()`` hands them to another thread.

Completed tickets RETIRE to counters; ``retain=True`` keeps the full
``tickets`` / ``dispatches`` / ``Ticket.results`` record (every
ServeResult stays live for the scheduler's lifetime).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Callable

import torch

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
    def _deliver(self, dst: int, rows: torch.Tensor, result: ServeResult | None) -> None:
        # dst = this piece's row offset within the request, fixed at take time
        self._pieces.append((dst, rows))
        self._filled += rows.shape[0]
        if result is not None:
            self.results.append(result)

    def _finish(self, now: float) -> None:
        pieces = [rows for _, rows in sorted(self._pieces, key=lambda p: p[0])]
        # a fresh tensor even for one piece: the ticket must not pin the
        # dispatch's padded sample, of which each piece is a view
        sample = torch.cat(pieces, dim=0)
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
    is exact."""

    def __init__(self, plan: DittoPlan | PlanSchedule):
        self.plan = plan
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
    """Continuous-batching front end over one :class:`ServeSession`.

    ``plan`` is the default for submissions that carry none; the session
    and its runner ``cache`` belong to the scheduler; ``device`` is the
    session's (default: the card). ``eager=False`` queues everything until
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
                 cache: CompiledRunnerCache | None = None, device=None,
                 eager: bool = True, async_mode: bool = False,
                 dispatch_interval_ms: float = 10.0, retain: bool = False,
                 collect_done: bool = False, shed_expired: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        plan = plan if plan is not None else DittoPlan()
        session = ServeSession(params, cfg, sched, plan, cache=cache, device=device)
        self._init_runtime(session, eager=eager, async_mode=async_mode,
                           dispatch_interval_ms=dispatch_interval_ms, retain=retain,
                           collect_done=collect_done, shed_expired=shed_expired, clock=clock)

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
                      collect_done, shed_expired, clock):
        self.session = session
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
        self._warm_captures: int | None = None  # the cache's captures when warmup ended
        self.tickets: list[Ticket] = []
        self.dispatches: list[ServeResult] = []
        self.done: queue.SimpleQueue | None = queue.SimpleQueue() if collect_done else None
        self._threads: list[threading.Thread] = []
        if async_mode:
            t = threading.Thread(target=self._dispatch_loop, name="ditto-serve-dispatch",
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
                group = self._groups[key] = _Group(plan)
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

    def poll(self) -> int:
        """Run at most one due dispatch on the calling thread and return the
        rows it dispatched (0 = nothing due): the dispatch thread's policy
        (``_next_job_locked``), for fake-clock tests and thread-free use."""
        with self._cv:
            job = self._next_job_locked()
            if job is None:
                return 0
            group, rows, trigger = job
            try:
                batch = self._take_locked(group, rows)
            except _TakeFailed:
                return rows  # covered tickets failed; the queue is repaired
            self._inflight += 1
        try:
            self._serve_and_deliver(group, batch, trigger)
        finally:
            with self._cv:
                self._inflight -= 1
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
        replays), its ``traces`` has no counterpart (nothing is traced),
        and ``primed`` is the mesh's and stays 0. ``plans`` defaults to the
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
        cache = self.session.cache
        for group_plans in by_probe.values():
            modes = self._probe_modes(group_plans[0], labels=labels, probe_seed=probe_seed)
            for p in group_plans:
                ladder = _bucket_ladder(p.max_batch) if buckets is None else buckets
                r = cache.warmup(self.session.cfg, modes, [p], ladder, labels=labels,
                                 params=self.session.params)
                out["captures"] += r["captures"]
        if self.session.device.type == "cuda":
            torch.cuda.synchronize(self.session.device)
        with self._cv:
            self._warm_captures = cache.n_captures
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

    def _next_job_locked(self) -> tuple[_Group, int, str] | None:
        """The dispatch policy: the next (group, rows, trigger) to serve, or
        None if nothing is due. Deadline-due partials preempt full buckets (a
        full bucket loses no budget by waiting one policy round; an expiring
        request does). With ``shed_expired=True``, requests whose budget
        already expired undispatched are rejected first."""
        f = faults.fire("scheduler.policy")
        if f is not None:
            faults.perform(f)
        now = self._clock()
        if self.shed_expired:
            self._shed_locked(now)
        return self._policy_scan_locked(list(self._groups.values()), now)

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

    def _dispatch_loop(self) -> None:
        # any escape from the loop body lands in _on_died, so a dead thread
        # fails fast instead of stranding result() callers
        try:
            self._dispatch_loop_inner()
        except BaseException as exc:  # noqa: BLE001 — death must be typed
            self._on_died(exc)

    def _dispatch_loop_inner(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._closed:
                        return
                    job = self._next_job_locked()
                    if job is not None:
                        break
                    self._cv.wait(self._next_wakeup_locked())
                group, rows, trigger = job
                try:
                    batch = self._take_locked(group, rows)
                except _TakeFailed:
                    continue  # tickets failed, queue repaired — move on
                self._inflight += 1
            try:
                fault = faults.fire("scheduler.dispatch")
                if fault is not None:
                    faults.perform(fault)
                self._serve_and_deliver(group, batch, trigger)
            finally:
                with self._cv:
                    self._inflight -= 1
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
        for p, c in plan_items:
            segments.append((p.ticket, p.used, c))
            p.used += c
        while group.pending and not group.pending[0].remaining:
            group.pending.popleft()
        return x, labels, segments

    def _serve_and_deliver(self, group: _Group, batch, trigger: str) -> ServeResult | None:
        """Serve one taken batch (outside the lock: submissions go on while
        the card runs) and deliver each covered ticket its rows.

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
                result = self.session.serve(x, labels, plan=used_plan)
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
        now = self._clock()
        with self._cv:
            self._n_dispatches += 1
            self._dispatched_rows += x.shape[0]
            self._pad_rows += result.pad_rows
            self._triggers[trigger] += 1
            if self.retain:
                self.dispatches.append(result)
            off = 0
            for ticket, dst, c in segments:
                ticket.served_with = used_plan
                ticket._deliver(dst, result.sample[off:off + c],
                                result if self.retain else None)
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
        """The scheduler's counters (the reference's solo keys), then the
        session's (its requests and the runner cache's captures, replays),
        then, after :meth:`warmup`, ``captures_after_warmup``."""
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
        out.update(self.session.stats())
        if warm is not None:
            out["captures_after_warmup"] = self.session.cache.n_captures - warm
        return out
