"""The port's span recorder (``repro_torch/spans.py``) and the spans of its
serving path.

The recorder: off, ``span()`` hands back one shared no-op and reads no
clock; nesting sets parents from a thread-local stack, so two threads keep
apart; the cap counts what it drops; ``drain()`` empties it; a running
``torch.profiler`` turns it on. The serving path: a tiny async
``ServeScheduler`` on the CPU (a two-block, 64-wide DiT under Defo) with
the recorder on gives each dispatch one ``sched.dispatch`` span with a
``session.chunk`` under it, each chunk two ``ditto.eager_step`` spans, as
many ``ditto.replay`` spans as the runner cache counts replays, and each
ticket one ``ticket.queue`` span that ends before its dispatch starts and
names it.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoPlan  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve import ServeScheduler  # noqa: E402

CFG = dit.DiTCfg(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
                 n_classes=4)
PLAN = DittoPlan(steps=4, policy="defo", max_batch=4, collect_stats=False)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


# ------------------------------------------------------------ the recorder
def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the recorder read the clock while off")

    monkeypatch.setattr(spans, "_clock", no_clock)
    assert not spans.enabled()
    a, b = spans.span("a", k=1), spans.span("b")
    assert a is b and a.id is None
    with a as sp:
        assert sp is a
        spans.record("c", 0.0, 1.0)
    assert spans.drain() == [] and spans.dropped() == 0


def test_nesting_sets_parents_and_record_takes_the_open_span():
    spans.enable()
    with spans.span("outer", k=1) as outer:
        with spans.span("inner") as inner:
            pass
        spans.record("after", 1.0, 2.0, why="test")
    got = {s.name: s for s in spans.drain()}
    assert [got[n].parent for n in ("outer", "inner", "after")] == [None, outer.id, outer.id]
    assert got["inner"].id == inner.id and got["outer"].attrs == {"k": 1}
    assert got["after"].start == 1.0 and got["after"].end == 2.0
    assert got["outer"].start <= got["inner"].start <= got["inner"].end <= got["outer"].end
    assert got["outer"].thread == threading.current_thread().name


def test_two_threads_keep_separate_stacks():
    spans.enable()
    opened, release = threading.Event(), threading.Event()

    def other():
        with spans.span("other.outer"):
            opened.set()
            release.wait(10.0)
            with spans.span("other.inner"):
                pass

    th = threading.Thread(target=other, name="span-test-other")
    th.start()
    assert opened.wait(10.0)
    with spans.span("main.outer") as main_outer:
        release.set()
        th.join(10.0)
        with spans.span("main.inner"):
            pass
    assert not th.is_alive()
    got = {s.name: s for s in spans.drain()}
    assert got["other.inner"].parent == got["other.outer"].id
    assert got["other.outer"].parent is None
    assert got["main.inner"].parent == main_outer.id
    assert {got[n].thread for n in ("other.outer", "other.inner")} == {"span-test-other"}


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    spans.enable()
    for i in range(5):
        spans.record("r", float(i), float(i) + 0.5, i=i)
    assert spans.dropped() == 2
    assert [s.attrs["i"] for s in spans.drain()] == [0, 1, 2]
    assert spans.dropped() == 0


def test_drain_empties_the_recorder():
    spans.enable()
    with spans.span("a"):
        pass
    assert [s.name for s in spans.drain()] == ["a"]
    assert spans.drain() == []
    spans.disable()
    with spans.span("b"):
        pass
    assert spans.drain() == []


def test_a_running_profiler_turns_the_recorder_on():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.enabled()
        with spans.span("profiled"):
            pass
    assert not spans.enabled()
    with spans.span("after"):
        pass
    assert [s.name for s in spans.drain()] == ["profiled"]


# -------------------------------------------------------- the serving path
@pytest.fixture(scope="module")
def model():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    params = dit.init(g, CFG, device="cpu")
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=g)
    yield params, diffusion.cosine_schedule(100)
    torch.set_num_threads(n)


def test_a_served_stream_gives_the_span_tree(model):
    params, sched = model
    rng = np.random.default_rng(3)
    sizes = [2, 2, 1, 3, 4, 1]
    reqs = [(torch.from_numpy(rng.standard_normal((n, 8, 8, 4)).astype(np.float32)),
             torch.from_numpy((np.arange(n) + i) % 4)) for i, n in enumerate(sizes)]
    s = ServeScheduler(params, CFG, sched, PLAN, device="cpu", async_mode=True,
                       dispatch_interval_ms=10.0)
    try:
        s.warmup()
        before = s.stats()
        spans.enable()
        tickets = [s.submit(x, lab, deadline_ms=150.0) for x, lab in reqs]
        for t in tickets:
            t.result(timeout=120.0)
        s.flush()
        after = s.stats()
    finally:
        s.close(join_timeout_s=30.0)
    spans.disable()
    got = spans.drain()
    by_id = {sp.id: sp for sp in got}

    def named(name):
        return [sp for sp in got if sp.name == name]

    def children(parent, name):
        return [sp for sp in got if sp.parent == parent.id and sp.name == name]

    dispatches = named("sched.dispatch")
    assert len(dispatches) == after["dispatches"] - before["dispatches"] > 1
    assert sum(d.attrs["rows"] for d in dispatches) == sum(sizes)
    assert {d.thread for d in dispatches} == {"ditto-serve-dispatch"}
    for d in dispatches:
        (chunk,) = children(d, "session.chunk")
        assert len(children(chunk, "ditto.eager_step")) == 2
        assert len(children(chunk, "session.sync")) == 1
        assert len(children(d, "sched.deliver")) == 1
        assert d.start <= chunk.start <= chunk.end <= d.end
    assert len(named("ditto.eager_step")) == 2 * len(named("session.chunk"))
    assert len(named("ditto.replay")) == after["replays"] - before["replays"]
    assert named("ditto.capture") == []  # warmed up
    queued = named("ticket.queue")
    assert sorted(q.attrs["ticket"] for q in queued) == [t.index for t in tickets]
    for q in queued:
        d = by_id[q.attrs["dispatch"]]
        assert d.name == "sched.dispatch" and q.attrs["ticket"] in d.attrs["tickets"]
        assert q.start <= q.end <= d.start
    waits = named("sched.wait")
    assert waits and all(w.attrs["shard"] == 0 for w in waits)
    assert all(w.parent is None for w in waits + dispatches)
