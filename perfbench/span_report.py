#!/usr/bin/env python3
"""The program's spans in a traced run: what the span readers take from
them, the device's idle time by the span open on a dispatch thread, and a
command that runs one cell and prints all of it.

The program records its spans (``repro_torch.spans``) while a
``torch.profiler`` records, so a traced run (``--trace 1``) has them
without a call of its own; they and the device events are both on
``time.monotonic()``. The first reader to ask drains the recorder into
``run.trace.spans``; a program without the recorder gives none, and every
reader then returns None.

    python3 perfbench/span_report.py --workload <name> --seed <n> --seconds <s> \\
        [--trace 0|1] [--spans 0|1]
    python3 perfbench/span_report.py --workload <name> --seed <n> --counts

The first form runs the cell as ``run.py`` does and prints its result line,
then one line ``{"span_report": ...}``: the spans recorded a dispatch and,
traced, the device's idle seconds by span, how the chunks' ``session.sync``
spans end against the device's last activity, and the span metrics.
``--spans 1`` turns the recorder on from the start (``--trace 0``: with the
profiler off, to measure the recorder's cost). ``--counts`` serves a few
dispatches of the cell's model with the recorder on and compares the span
counts with the scheduler's and the runner cache's counters.
"""
from __future__ import annotations

import math
import os
import sys
import time

T_START = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # a script: the checkout's root and the port's sources
    sys.path[:1] = [ROOT, os.path.join(ROOT, "src")]

from perfbench.stats import delta, percentile  # noqa: E402

#: Recorded after the fact for a request: not code running on a thread.
REQUEST_SPANS = ("ticket.queue",)

#: A chunk's sync "agrees" when it ends at most this long after the device's
#: last activity of the chunk.
SYNC_SLACK_S = 1e-3


# -------------------------------------------------------------- intervals
def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(lo, hi)`` intervals, sorted and disjoint."""
    out: list[tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def gaps(intervals: list, t0: float, t1: float) -> list[tuple[float, float]]:
    """[t0, t1] less the merged ``intervals``."""
    out, cur = [], t0
    for lo, hi in intervals:
        if hi <= cur:
            continue
        if lo >= t1:
            break
        if lo > cur:
            out.append((cur, lo))
        cur = hi
    if cur < t1:
        out.append((cur, t1))
    return out


def overlap_by(pieces: list, intervals: list) -> dict[str, float]:
    """Seconds of the merged ``intervals`` under each label of ``pieces``
    (sorted, disjoint ``(lo, hi, label)``)."""
    by: dict[str, float] = {}
    i = 0
    for lo, hi, label in pieces:
        while i < len(intervals) and intervals[i][1] <= lo:
            i += 1
        j = i
        while j < len(intervals) and intervals[j][0] < hi:
            s = min(hi, intervals[j][1]) - max(lo, intervals[j][0])
            if s > 0:
                by[label] = by.get(label, 0.0) + s
            j += 1
    return by


def length(intervals) -> float:
    return sum(hi - lo for lo, hi in intervals)


def overlap(a: list, b: list) -> list[tuple[float, float]]:
    """The intersection of two merged lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(a: list, b: list) -> list[tuple[float, float]]:
    """Merged ``a`` less merged ``b``."""
    return overlap(a, gaps(b, a[0][0], a[-1][1])) if a else []


# ----------------------------------------------------------------- spans
def spans_of(run) -> list | None:
    """The program's spans of a traced run, drained from the recorder by
    the first caller and kept on ``run.trace``; None without a trace, for a
    program without the recorder, or when the recorder dropped any."""
    trace = run.trace
    if trace is None:
        return None
    got = getattr(trace, "spans", None)
    if got is None:
        try:
            from repro_torch import spans as recorder
        except ImportError:  # a program without the recorder
            return None
        lost = recorder.dropped()
        got = recorder.drain()
        trace.spans = [] if lost else got
    return trace.spans or None


def dispatch_threads(spans: list) -> list[str]:
    """The threads that ran a dispatch, by name."""
    return sorted({s.thread for s in spans if s.name == "sched.dispatch"})


def innermost(thread_spans: list) -> list[tuple[float, float, str]]:
    """One thread's time as sorted, disjoint ``(lo, hi, name)`` pieces, each
    named by the innermost span open then (a thread's spans nest)."""
    out: list[tuple[float, float, str]] = []
    stack: list = []
    cur = -math.inf

    def close_until(t: float) -> None:
        nonlocal cur
        while stack and stack[-1].end <= t:
            top = stack.pop()
            if top.end > cur:
                out.append((cur, top.end, top.name))
                cur = top.end

    for s in sorted(thread_spans, key=lambda s: (s.start, -s.end)):
        close_until(s.start)
        if stack and s.start > cur:
            out.append((cur, s.start, stack[-1].name))
        cur = max(cur, s.start)
        stack.append(s)
    close_until(math.inf)
    return out


def device_idle(trace, t0: float, t1: float) -> list[tuple[float, float]]:
    """The device's idle intervals in [t0, t1]."""
    return gaps(merged((lo, hi) for _, lo, hi in trace.device_in(t0, t1)), t0, t1)


def idle_by_span(spans: list, trace, t0: float, t1: float) -> dict[str, float]:
    """The device's idle seconds in [t0, t1] by the innermost span open on a
    dispatch thread then ("no span" where none was); with several dispatch
    threads, the first by name with a span open. The values sum to the
    window's idle seconds."""
    left = device_idle(trace, t0, t1)
    by: dict[str, float] = {}
    for th in dispatch_threads(spans):
        pieces = innermost([s for s in spans
                            if s.thread == th and s.name not in REQUEST_SPANS])
        for k, v in overlap_by(pieces, left).items():
            by[k] = by.get(k, 0.0) + v
        left = minus(left, merged((lo, hi) for lo, hi, _ in pieces))
    by["no span"] = length(left)
    return by


def clipped_s(spans: list, name: str, t0: float, t1: float) -> float:
    return sum(max(min(s.end, t1) - max(s.start, t0), 0.0) for s in spans if s.name == name)


# -------------------------------------------------------- span metrics
def eager_s_per_dispatch(run) -> float | None:
    """Seconds of ``ditto.eager_step`` spans in the window over its
    dispatches."""
    spans, n = spans_of(run), delta(run, "dispatches")
    if not spans or not n or not any(s.name == "ditto.eager_step" for s in spans):
        return None
    return clipped_s(spans, "ditto.eager_step", run.t_open, run.t_close) / n


def queue_waits(run) -> list[float] | None:
    """The ``ticket.queue`` seconds of each ticket submitted in the window
    and taken by its close: the window's requests the trace saw taken (a
    ticket taken before the recorder came on has no span) and the few later
    arrivals taken before it closes. None when a window request was never
    served, or no such span."""
    spans = spans_of(run)
    if not spans or any(r.sample is None for r in run.measured):
        return None
    waits = [s.end - s.start for s in spans if s.name == "ticket.queue"
             and s.start >= run.t_open and s.end <= run.t_close]
    return waits or None


def queue_wait_p50_s(run) -> float | None:
    waits = queue_waits(run)
    return None if waits is None else percentile(waits, 50)


def host_bound_idle_frac(run) -> float | None:
    """The share of the window's wall in which the device ran nothing while
    a dispatch thread was inside ``sched.dispatch`` and outside
    ``session.sync`` (the host's own work, not its wait on the device)."""
    spans = spans_of(run)
    if not spans:
        return None
    host = []
    for th in dispatch_threads(spans):
        mine = [s for s in spans if s.thread == th]
        host += minus(merged((s.start, s.end) for s in mine if s.name == "sched.dispatch"),
                      merged((s.start, s.end) for s in mine if s.name == "session.sync"))
    idle = device_idle(run.trace, run.t_open, run.t_close)
    return length(overlap(idle, merged(host))) / run.window_s


# ---------------------------------------------------------------- report
def sync_agreement(spans: list, trace, t0: float, t1: float) -> dict:
    """For each chunk in [t0, t1]: its ``session.sync`` end less the end of
    the last device activity that began inside the chunk, and the start of
    the first such activity less the chunk's start; the share of end lags
    within [0, SYNC_SLACK_S], and each chunk's (seconds from t0, end lag,
    start lag, the last activity's name). Where the trace keeps each
    activity's stream (``trace.streams``), the end lag also against the
    chunk's own stream alone (the one most of its activities ran on): the
    sync waits for that stream, not for the benchmark's own requests made
    meanwhile on another."""
    import bisect
    import collections

    streams = getattr(trace, "streams", None) or [None] * len(trace.device)
    events = sorted((lo, hi, name, st) for (name, lo, hi), st in zip(trace.device, streams))
    starts = [e[0] for e in events]
    sync_of = {s.parent: s for s in spans if s.name == "session.sync"}
    rows = []
    for c in sorted(spans, key=lambda s: s.start):
        if c.name != "session.chunk" or c.start < t0 or c.end > t1 or c.id not in sync_of:
            continue
        inside = events[bisect.bisect_left(starts, c.start):bisect.bisect_right(starts, c.end)]
        if not inside:
            continue
        own = collections.Counter(e[3] for e in inside).most_common(1)[0][0]
        end = sync_of[c.id].end
        last = max(inside, key=lambda e: e[1])
        last_own = max((e for e in inside if e[3] == own), key=lambda e: e[1])
        rows.append([c.start - t0, end - last[1], end - last_own[1], inside[0][0] - c.start,
                     last[2][:60]])
    if not rows:
        return {"chunks": 0}
    out = {"chunks": len(rows)}
    for key, col in (("", 1), ("own_stream_", 2)):
        lags = [r[col] for r in rows]
        out.update({key + "agree_share": sum(0.0 <= g <= SYNC_SLACK_S for g in lags) / len(lags),
                    key + "lag_s_min": min(lags), key + "lag_s_p50": percentile(lags, 50),
                    key + "lag_s_max": max(lags)})
    out["each"] = rows
    return out


def report(run, spans: list) -> dict:
    """What the spans say of one run."""
    t0, t1 = run.t_open, run.t_close
    n = delta(run, "dispatches")
    counts: dict[str, int] = {}
    for s in spans:
        counts[s.name] = counts.get(s.name, 0) + 1
    in_window = sum(t0 <= s.start < t1 for s in spans)
    out = {"spans": counts, "dispatches": n,
           "spans_per_dispatch": in_window / n if n else None,
           "wait_share": clipped_s(spans, "sched.wait", t0, t1) / run.window_s}
    if run.trace is None:
        return out
    by = idle_by_span(spans, run.trace, t0, t1)
    idle = run.window_s - run.trace.busy_s(t0, t1)
    out.update(idle_s=idle, idle_by_span_sum_s=sum(by.values()),
               idle_by_span=[[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]],
               sync=sync_agreement(spans, run.trace, t0, t1),
               eager_s_per_dispatch=eager_s_per_dispatch(run),
               host_bound_idle_frac=host_bound_idle_frac(run))
    waits = queue_waits(run)
    if waits is not None:
        out["queue_wait_s"] = {f"p{q}": percentile(waits, q) for q in (10, 50, 90)}
    return out


def counts_check(cell, seed: int, device="cuda") -> dict:
    """Serve a few dispatches of the cell's model and plan (full and partial
    buckets) with the recorder on; the span counts beside the counters."""
    from perfbench.harness import Program
    from repro_torch import spans as recorder

    model = cell.config["model"]
    prog = Program(cell, cell.family.make_weights(model, seed, device), device)
    mb = prog.plan.max_batch
    sizes = [min(4, mb)] * (2 * mb // min(4, mb)) + [1, 2, 1]
    before = prog.sched.stats()
    recorder.enable()
    try:
        tickets = []
        for i, n in enumerate(sizes):
            x, cond = cell.family.make_request(model, seed, i, n, device)
            tickets.append(prog.submit(x, cond, deadline_ms=500.0))
        for t in tickets:
            t.result(timeout=600.0)
        prog.sched.flush()
        after = prog.sched.stats()
    finally:
        recorder.disable()
        prog.close()
    got = recorder.drain()
    n = {name: sum(s.name == name for s in got)
         for name in ("sched.dispatch", "session.chunk", "ditto.eager_step", "ditto.replay",
                      "ditto.capture", "ticket.queue", "session.sync", "sched.deliver")}
    d = {k: after[k] - before[k] for k in ("dispatches", "replays", "captures", "submitted")}
    checks = {"dispatch = dispatches": n["sched.dispatch"] == d["dispatches"],
              "eager_step = 2 x chunks": n["ditto.eager_step"] == 2 * n["session.chunk"],
              "replay = replays": n["ditto.replay"] == d["replays"],
              "capture = captures": n["ditto.capture"] == d["captures"],
              "ticket.queue = tickets taken": n["ticket.queue"] == d["submitted"]}
    return {"spans": n, "counters": d, "checks": checks, "ok": all(checks.values()),
            "spans_per_dispatch": len(got) / d["dispatches"] if d["dispatches"] else None}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=0)
    ap.add_argument("--counts", action="store_true")
    args = ap.parse_args(argv)
    # every build and kernel cache at run.py's place in the checkout
    cache = os.path.join(ROOT, "perfbench", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    import torch

    from perfbench import harness, tracing
    from repro_torch import spans as recorder

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    if args.counts:
        out = counts_check(cell, args.seed)
        print(json.dumps({"span_counts": out}), flush=True)
        return 0 if out["ok"] else 1
    runs = []
    load_reader = harness.load_reader

    def keeping(name):  # every reader of the run also hands it here
        read = load_reader(name)
        return lambda run: (runs.append(run), read(run))[1]

    harness.load_reader = keeping
    if args.trace:
        tracing_stop = tracing.Tracer.stop

        def stop_keeping_streams(self):  # each device activity's stream, for the clock check
            from torch.autograd import DeviceType

            data = tracing_stop(self)
            data.streams = [e.device_resource_id()
                            for e in self._prof.profiler.kineto_results.events()
                            if e.device_type() == DeviceType.CUDA]
            return data

        tracing.Tracer.stop = stop_keeping_streams
    if args.spans:
        recorder.enable()
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    recorder.disable()
    run = runs[-1]
    spans = (spans_of(run) or []) if run.trace is not None else recorder.drain()
    print(json.dumps(out), flush=True)
    print(json.dumps({"span_report": report(run, spans)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
