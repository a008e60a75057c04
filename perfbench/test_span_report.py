"""CPU tests of the span readers (``span_report.py`` and the
``metrics/*`` files that read the program's spans): the interval
arithmetic, each reader and the idle time by span on synthetic traces
whose answers are known, the readers' silence for a program without the
recorder, the per-layer sources BENCHMARK.json may name, and a traced tiny
run whose result line carries the span metrics."""
from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest

from perfbench import harness, span_report, tracing
from perfbench.test_perfbench import SEED, tiny_cell
from repro_torch.spans import Span

BENCH = json.loads((Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())
SPAN_METRICS = ["eager_s_per_dispatch.offline", "eager_s_per_dispatch.online",
                "queue_wait_p50_s.online", "host_bound_idle_frac.offline",
                "host_bound_idle_frac.online"]


def _span(name, lo, hi, sid, parent=None, thread="ditto-serve-dispatch", **attrs):
    return Span(name, lo, hi, sid, parent, thread, attrs)


def _run(device, spans, t_open=0.0, t_close=10.0, dispatches=2, measured=()):
    trace = tracing.TraceData(device=device)
    if spans is not None:
        trace.spans = spans
    return types.SimpleNamespace(
        trace=trace, t_open=t_open, t_close=t_close, window_s=t_close - t_open,
        measured=list(measured), open_snap={"stats": {"dispatches": 5}},
        close_snap={"stats": {"dispatches": 5 + dispatches}})


#: Two dispatches in [0, 10]: each a chunk with two eager steps and a sync.
SPANS = [
    _span("sched.wait", -1.0, 0.5, 1),
    _span("sched.dispatch", 0.5, 5.0, 2),
    _span("session.chunk", 0.6, 4.8, 3, 2),
    _span("ditto.eager_step", 0.7, 1.2, 4, 3),
    _span("ditto.eager_step", 1.2, 1.7, 5, 3),
    _span("session.sync", 4.0, 4.8, 6, 3),
    _span("sched.dispatch", 5.5, 12.0, 7),
    _span("session.chunk", 5.6, 11.8, 8, 7),
    _span("ditto.eager_step", 5.7, 6.2, 9, 8),
    _span("ditto.eager_step", 9.8, 10.4, 10, 8),
    _span("ticket.queue", -0.5, 0.5, 11, 2, ticket=0, dispatch=2),
    _span("ticket.queue", 0.2, 5.5, 12, 7, ticket=1, dispatch=7),
    _span("ticket.queue", 3.0, 5.5, 13, 7, ticket=2, dispatch=7),
]
#: The device: busy [0.7, 1.0], [2, 4.2] and [6.5, 9.5]; idle 10 - 5.5 = 4.5 s.
DEVICE = [("k", 0.7, 1.0), ("k", 2.0, 3.0), ("m", 2.5, 4.2), ("k", 6.5, 9.5)]


# ------------------------------------------------------------- intervals
def test_interval_arithmetic():
    a = span_report.merged([(3, 4), (0, 1), (0.5, 2), (5, 5)])
    assert a == [(0, 2), (3, 4)]
    assert span_report.gaps(a, -1, 5) == [(-1, 0), (2, 3), (4, 5)]
    assert span_report.overlap(a, [(1, 3.5)]) == [(1, 2), (3, 3.5)]
    assert span_report.minus(a, [(1, 3.5)]) == [(0, 1), (3.5, 4)]
    assert span_report.length(a) == 3
    assert span_report.overlap_by([(0, 1, "x"), (1, 4, "y")], [(0.5, 1.5), (3, 5)]) == {
        "x": 0.5, "y": 1.5}


def test_innermost_names_each_moment_by_the_innermost_open_span():
    pieces = span_report.innermost([s for s in SPANS[:6]])
    assert [p[2] for p in pieces] == ["sched.wait", "sched.dispatch", "session.chunk",
                                      "ditto.eager_step", "ditto.eager_step", "session.chunk",
                                      "session.sync", "sched.dispatch"]
    assert [p[:2] for p in pieces] == [(-1.0, 0.5), (0.5, 0.6), (0.6, 0.7), (0.7, 1.2),
                                       (1.2, 1.7), (1.7, 4.0), (4.0, 4.8), (4.8, 5.0)]


# ---------------------------------------------------------------- readers
def test_eager_seconds_per_dispatch_clip_to_the_window():
    run = _run(DEVICE, SPANS)
    # 0.5 + 0.5 + 0.5 + (10 - 9.8) over the window's two dispatches
    assert span_report.eager_s_per_dispatch(run) == pytest.approx(1.7 / 2)
    assert span_report.eager_s_per_dispatch(_run(DEVICE, SPANS, dispatches=0)) is None


def test_host_bound_idle_leaves_out_the_sync_and_the_wait():
    run = _run(DEVICE, SPANS)
    # idle: [0, 0.7], [1, 2], [4.2, 6.5], [9.5, 10]; inside a dispatch and
    # outside its sync: [0.5, 4] and [4.8, 5] and [5.5, 10]
    want = 0.2 + 1.0 + 0.2 + 1.0 + 0.5
    assert span_report.host_bound_idle_frac(run) == pytest.approx(want / 10)


def test_idle_by_span_sums_to_the_idle_time():
    run = _run(DEVICE, SPANS)
    by = span_report.idle_by_span(SPANS, run.trace, 0.0, 10.0)
    assert sum(by.values()) == pytest.approx(10.0 - run.trace.busy_s(0.0, 10.0))
    # idle [0, 0.7], [1, 2], [4.2, 6.5], [9.5, 10], piece by piece
    assert by == pytest.approx({"sched.wait": 0.5, "sched.dispatch": 0.1 + 0.2 + 0.1,
                                "session.chunk": 0.1 + 0.3 + 0.1 + 0.6,
                                "ditto.eager_step": 0.2 + 0.5 + 0.5 + 0.2,
                                "session.sync": 0.6, "no span": 0.5})


def test_queue_wait_takes_the_tickets_submitted_and_taken_in_the_window():
    served = [types.SimpleNamespace(sample=1)] * 2
    run = _run(DEVICE, SPANS, measured=served)
    # ticket 0 was submitted before the window opened
    assert span_report.queue_waits(run) == pytest.approx([5.3, 2.5])
    assert span_report.queue_wait_p50_s(run) == pytest.approx(3.9)
    early = _run(DEVICE, SPANS, t_close=5.0, measured=served)
    assert span_report.queue_waits(early) is None  # none taken by the close
    lost = [types.SimpleNamespace(sample=1), types.SimpleNamespace(sample=None)]
    assert span_report.queue_wait_p50_s(_run(DEVICE, SPANS, measured=lost)) is None


def test_sync_agreement_against_the_chunks_last_device_activity():
    trace = tracing.TraceData(DEVICE)
    got = span_report.sync_agreement(SPANS, trace, 0.0, 10.0)
    assert got["chunks"] == 1 and got["lag_s_p50"] == pytest.approx(4.8 - 4.2)
    assert got["agree_share"] == 0.0 and got["own_stream_lag_s_p50"] == got["lag_s_p50"]
    assert got["each"] == [[pytest.approx(0.6), pytest.approx(0.6), pytest.approx(0.6),
                            pytest.approx(0.1), "m"]]
    # another stream's activity ending last: the chunk's own stream ends at 3.0
    trace.streams = [7, 7, 9, 7]
    got = span_report.sync_agreement(SPANS, trace, 0.0, 10.0)
    assert got["own_stream_lag_s_p50"] == pytest.approx(4.8 - 3.0)
    assert got["lag_s_p50"] == pytest.approx(4.8 - 4.2)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_recorder_reads_nothing(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)  # import fails
    run = _run(DEVICE, None, measured=[types.SimpleNamespace(sample=1)])
    assert harness.load_reader(name)(run) is None
    assert harness.load_reader(name)(_run(DEVICE, [], measured=run.measured)) is None


# ------------------------------------------------------------- contract
def test_per_layer_sources_and_the_span_metrics_entries():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("host_clock", "device_trace", "program_counter", "program_span")
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"]
        assert all(w.endswith(name.rsplit(".", 1)[1]) for w in m["workloads"])
    assert list(entries)[-len(SPAN_METRICS):] == SPAN_METRICS


# ------------------------------------------------------------------ a run
@pytest.mark.parametrize("workload", ["dit-xl2-256.offline", "dit-xl2-256.online"])
def test_a_traced_run_prints_the_span_metrics(workload, monkeypatch):
    """A traced tiny run on the CPU (the profiler records the CPU's
    activity here: the card's tracer has none to record): the program's
    spans follow the profiler, so each span metric of the cell reads."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans

    def on_the_cpu(self):
        self._prof = profile(activities=[ProfilerActivity.CPU])
        self._clock = None

    monkeypatch.setattr(tracing.Tracer, "__init__", on_the_cpu)
    spans.drain()
    out = harness.run_cell(tiny_cell(workload), SEED, 0.8, True, device="cpu")
    assert out["correct"] is True
    want = [m for m in SPAN_METRICS if workload in next(
        e["workloads"] for e in BENCH["per_layer"] if e["name"] == m)]
    assert want and set(want) <= set(out["metrics"])
    assert all(out["metrics"][m]["value"] > 0 for m in want)
    assert not spans.enabled()
