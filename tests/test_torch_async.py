"""The port's ServeScheduler in async mode, its warmup, and its fault paths.

Fake-session tests (x -> 2x, tests/_torch_sched.py) hold the dispatch
thread's behavior as the reference's tests hold it
(tests/test_async_serving.py, tests/test_faults.py): full buckets dispatch
without a poll, ``result()`` demands a ragged tail, ``flush()`` drains,
timeouts and failed dispatches surface, a ``scheduler.take`` fault fails
exactly its tickets and the thread survives, a ``scheduler.policy`` fault
kills the thread with a typed ``SchedulerDied``, a stalled dispatch makes
``close()`` raise the reference's message, and seeded chaos schedules
leave no ticket unresolved. The real stack (a 2-block, 64-wide DiT on the
CPU): four client threads with mixed plans and no warmup get rows equal to
their solo serves bit for bit with one capture per key; after ``warmup``
the first request captures nothing. Every wait carries a timeout; the
dispatch threads are daemons.
"""
import sys
import threading
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_sched import PORT, REF, FakeClock, fake_scheduler  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoPlan, PlanSchedule  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve import (CompiledRunnerCache, DispatchFailed, Fault,  # noqa: E402
                               FaultInjector, InjectedFault, NumericalFault, ResourceExhausted,
                               SchedulerDied, ServeScheduler, ServeSession, chaos_schedule,
                               inject)
from repro_torch.serve.scheduler import BACKOFF_CAP_MS  # noqa: E402

CFG = dit.DiTCfg(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
                 n_classes=4)
PLAN = DittoPlan(steps=3, policy="diff", max_batch=4, collect_stats=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ones(rows, fill=1.0):
    return torch.full((rows, 8, 8, 4), fill)


# ------------------------------------------------------------ async plumbing
def test_async_full_bucket_dispatches_without_poll():
    s = fake_scheduler(PORT, async_mode=True)
    try:
        tickets = [s.submit(_ones(2, float(i))) for i in range(2)]
        for i, t in enumerate(tickets):
            assert torch.equal(t.result(timeout=5.0), _ones(2, 2.0 * i))
        assert s.stats()["triggers"]["full"] == 1 and s.pad_rows == 0
    finally:
        s.close()


def test_async_result_demands_ragged_tail():
    s = fake_scheduler(PORT, async_mode=True)
    try:
        assert s.submit(_ones(3)).result(timeout=5.0).shape[0] == 3
        assert s.stats()["triggers"]["demand"] == 1
    finally:
        s.close()


def test_async_flush_blocks_until_drained():
    s = fake_scheduler(PORT, async_mode=True, wall_s=0.02)
    try:
        tickets = [s.submit(_ones(1)) for _ in range(5)]
        resolved = s.flush()
        assert all(t.done for t in tickets)
        assert {t.index for t in resolved} == {t.index for t in tickets}
        st = s.stats()
        assert st["queued_rows"] == 0 and st["inflight"] == 0
    finally:
        s.close()


def test_async_result_timeout():
    s = fake_scheduler(PORT, async_mode=True, wall_s=0.3)
    try:
        t = s.submit(_ones(4))  # a full bucket: dispatches, slowly
        with pytest.raises(TimeoutError):
            t.result(timeout=0.02)
        assert t.result(timeout=5.0).shape[0] == 4  # and still completes
    finally:
        s.close()


def test_failed_dispatch_resolves_tickets_with_error():
    s = fake_scheduler(PORT, async_mode=True, fail=True)
    try:
        t = s.submit(_ones(4))
        with pytest.raises(RuntimeError, match="injected"):
            t.result(timeout=5.0)
        st = s.stats()
        assert st["failed"] == 1 and st["live_tickets"] == 0
    finally:
        s.close(drain=False)


def test_close_rejects_new_submissions_and_context_manager_drains():
    s = fake_scheduler(PORT, async_mode=True)
    s.submit(_ones(4))
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(_ones(1))
    with fake_scheduler(PORT, async_mode=True) as s:
        t = s.submit(_ones(1))
    assert t.done and s._closed and not any(th.is_alive() for th in s._threads)


def test_completed_tickets_retire_and_do_not_pin_dispatches():
    """Completed tickets retire to counters; a ticket's rows are its own
    tensor, so a dispatch's sample is freed once the ticket alone is held;
    ``collect_done`` hands every ticket over once; ``result()`` repeats."""
    s = fake_scheduler(PORT, collect_done=True)
    seen = []
    real_serve = s.session.serve

    def serve(x, labels, plan=None):
        res = real_serve(x, labels, plan=plan)
        seen.append(weakref.ref(res.sample))
        return res

    s.session.serve = serve
    tickets = [s.submit(_ones(1 + i % 3, float(i))) for i in range(12)]
    s.flush()
    st = s.stats()
    assert st["live_tickets"] == 0 and st["completed"] == 12 and s.tickets == []
    assert all(r() is None for r in seen)  # no dispatch sample outlives its deliveries
    assert sorted(s.done.get_nowait().index for _ in range(12)) == list(range(12))
    a = tickets[5].result()
    assert a is tickets[5].result() and torch.equal(a, _ones(3, 10.0))


def test_async_concurrent_submitters_fake():
    """8 threads x 10 ragged, partly budgeted requests against one async
    scheduler, under a short switch interval: every ticket resolves to its
    own rows and the counters add up."""
    s = fake_scheduler(PORT, async_mode=True, dispatch_interval_ms=5.0)
    errors = []

    def client(i):
        try:
            for j in range(10):
                b = 1 + (i + j) % 3
                fill = float(i * 100 + j)
                t = s.submit(_ones(b, fill), deadline_ms=50.0 if j % 2 else None)
                assert torch.equal(t.result(timeout=30.0), _ones(b, 2.0 * fill))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
        s.close(join_timeout_s=30.0)
    assert not any(t.is_alive() for t in threads) and errors == []
    st = s.stats()
    assert st["completed"] == 80 and st["live_tickets"] == 0
    assert st["dispatched_rows"] == st["submitted_rows"] == sum(
        1 + (i + j) % 3 for i in range(8) for j in range(10))


def test_no_deadline_missed_by_more_than_one_interval():
    """A Poisson-like arrival replay on the fake clock, polled every
    interval: every budgeted ticket completes by its deadline plus one
    interval, and partials really happened."""
    clock = FakeClock()
    interval = 0.010
    s = fake_scheduler(PORT, clock=clock, dispatch_interval_ms=interval * 1e3)
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(0.02, size=30))
    budgets = rng.choice([60.0, 120.0, 250.0], size=30)
    tickets, nxt = [], 0
    while clock() < arrivals[-1] + 0.5:
        while nxt < len(arrivals) and arrivals[nxt] <= clock():
            tickets.append(s.submit(_ones(1 + nxt % 3, float(nxt)),
                                    deadline_ms=float(budgets[nxt])))
            nxt += 1
        while s.poll():
            pass
        clock.advance(interval)
    s.flush()
    assert all(t.done and t.done_t <= t._deadline_t + interval + 1e-9 for t in tickets)
    st = s.stats()
    assert st["triggers"]["deadline"] > 0 and st["dispatched_rows"] == st["submitted_rows"]


# --------------------------------------------------------- fault paths
def test_take_fault_fails_covered_tickets_thread_survives():
    s = fake_scheduler(PORT, async_mode=True, dispatch_interval_ms=5.0)
    with inject(FaultInjector([Fault("scheduler.take", 0, "error")])):
        t1 = s.submit(_ones(4))
        with pytest.raises(InjectedFault):
            t1.result(timeout=30.0)
    t2 = s.submit(_ones(4, 3.0))  # the queue is repaired and the thread alive
    assert torch.equal(t2.result(timeout=30.0), _ones(4, 6.0))
    st = s.stats()
    assert st["failed"] == 1 and st["completed"] == 1 and not st["died"]
    s.close()


def test_policy_fault_is_typed_scheduler_death():
    s = fake_scheduler(PORT, async_mode=True, dispatch_interval_ms=5.0)
    with inject(FaultInjector([Fault("scheduler.policy", 0, "error")])):
        # the policy may fire on a wakeup before or after this submit lands
        with pytest.raises(SchedulerDied) as err:
            s.submit(_ones(4)).result(timeout=30.0)
        assert isinstance(err.value.__cause__, InjectedFault)
        with pytest.raises(SchedulerDied):
            s.submit(_ones(2))
    st = s.stats()
    assert st["died"] and st["live_tickets"] == 0
    s.close(join_timeout_s=5.0)  # a dead scheduler still closes


def test_stalled_dispatch_makes_close_raise_like_reference():
    """A ``scheduler.dispatch`` stall holds the thread: ``close`` with a
    short join raises the reference's error, word for word."""
    messages = []
    for pkg in (REF, PORT):
        s = fake_scheduler(pkg, async_mode=True, dispatch_interval_ms=5.0)
        inj = pkg.faults.FaultInjector([pkg.faults.Fault("scheduler.dispatch", 0, "stall",
                                                         value=0.3)])
        with pkg.faults.inject(inj):
            t = s.submit(pkg.full((4, 8, 8, 4), 1.0))
            deadline = time.monotonic() + 5.0
            while not s.stats()["inflight"] and time.monotonic() < deadline:
                time.sleep(0.005)
            with pytest.raises(RuntimeError, match="failed to join") as err:
                s.close(drain=False, join_timeout_s=0.05)
            messages.append(str(err.value))
            t.result(timeout=10.0)  # the stalled dispatch still serves
    assert messages[0] == messages[1]


def test_backoff_is_bounded_and_counted():
    plan = PLAN.replace(max_retries=3, retry_backoff_ms=1.0)
    s = fake_scheduler(PORT, plan)
    t0 = time.monotonic()
    with inject(FaultInjector([Fault("session.serve", i, "error") for i in range(3)])):
        t = s.submit(_ones(4))
    assert time.monotonic() - t0 < 3 * BACKOFF_CAP_MS / 1e3  # 1 + 2 + 4 ms, not caps
    assert t.result().shape[0] == 4
    st = s.stats()
    assert st["retries"] == 3 and st["fallback_dispatches"] == 0 and st["completed"] == 1


@pytest.mark.parametrize("device,error,walks", [
    ("cpu", RuntimeError("kernel launch failed"), True),
    ("cuda", RuntimeError("kernel launch failed"), False),
    ("cuda", NumericalFault(3), True),
    ("cuda", ResourceExhausted(Fault("session.serve", 0, "resource_exhausted")), True),
], ids=["cpu-untyped", "cuda-untyped", "cuda-numerical", "cuda-resource-exhausted"])
def test_card_ladder_walks_only_for_typed_faults(device, error, walks):
    """On a CUDA session only an injected or numerical fault walks the
    ladder down to the eager rung; any other error (a kernel's, a build's, a
    capture's) fails its ticket with itself at once, with no retry and no
    fallback dispatch. On the CPU every error retries, as in the reference."""
    plan = PLAN.replace(max_retries=2, fallbacks=({"compiled": False},))
    s = fake_scheduler(PORT, plan)
    s.session.device = torch.device(device)
    serve, plans = s.session.serve, []

    def serve_failing_first(x, labels, plan=None):
        plans.append(plan)
        if len(plans) == 1:
            raise error
        return serve(x, labels, plan=plan)

    s.session.serve = serve_failing_first
    t = s.submit(_ones(2))
    st_want = dict(retries=1, fallback_dispatches=1, failed=0) if walks else \
        dict(retries=0, fallback_dispatches=0, failed=1)
    if walks:
        assert torch.equal(t.result(timeout=5.0), _ones(2) * 2.0)
        assert t.served_with.compiled is False and len(plans) == 2
    else:
        with pytest.raises(RuntimeError) as err:
            t.result(timeout=5.0)
        assert err.value is error and len(plans) == 1
    st = s.stats()
    assert {k: st[k] for k in st_want} == st_want


@pytest.mark.parametrize("seed", range(6))
def test_chaos_every_ticket_terminates(seed):
    """Seeded fault schedules over the scheduler and session sites: every
    ticket ends with its rows or a typed error within its timeout, and
    ``close(drain=True)`` returns."""
    sites = ("session.serve", "scheduler.policy", "scheduler.take", "scheduler.dispatch")
    plan = PLAN.replace(max_retries=2, retry_backoff_ms=1.0, fallbacks=(dict(fused=False),))
    s = fake_scheduler(PORT, plan, async_mode=True, dispatch_interval_ms=5.0)
    outcomes, tickets = [], []
    with inject(chaos_schedule(seed, 4, sites=sites, max_at=4)):
        for i, b in enumerate([3, 4, 2, 4, 1]):
            try:
                tickets.append((b, float(i), s.submit(_ones(b, float(i)))))
            except SchedulerDied as e:
                outcomes.append(e)
        for b, fill, t in tickets:
            try:
                out = t.result(timeout=60.0)
                assert torch.equal(out, _ones(b, 2.0 * fill))
                outcomes.append(out)
            except (InjectedFault, DispatchFailed, SchedulerDied) as e:
                outcomes.append(e)
    assert len(outcomes) == 5  # nothing hung, nothing vanished
    try:
        s.close(drain=True, join_timeout_s=30.0)
    except SchedulerDied:
        pass  # a policy fault may have killed the thread; close still returns
    st = s.stats()
    assert st["live_tickets"] == 0 and st["queued_rows"] == 0
    assert not any(th.is_alive() for th in s._threads)


# ---------------------------------------------------- capture from a thread
def test_capture_runs_thread_local(monkeypatch):
    """The runner cache captures with ``capture_error_mode="thread_local"``:
    under the default global mode another thread's allocation or
    synchronize (a client submitting while the dispatch thread captures a
    new key) would fail or break the capture. The capture runs on the
    cache's own capture stream, on the cache's device. The CUDA calls of
    ``_capture`` are recorded here; the card runs them in chip_smoke.py."""
    seen = {}

    class Nothing:
        def __init__(self, *args, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Graph(Nothing):
        def __init__(self, graph, **kw):
            seen["graph_kw"] = kw

    class Stream:
        def __init__(self, device=None):
            seen.setdefault("stream_devices", []).append(device)

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream(("current", device)))
    monkeypatch.setattr(torch.cuda, "stream", Nothing)
    monkeypatch.setattr(torch.cuda, "device", Nothing)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Nothing)
    monkeypatch.setattr(torch.cuda, "graph", Graph)
    g = torch.Generator().manual_seed(0)
    params = dit.init(g, CFG, device="cpu")
    sess = ServeSession(params, CFG, diffusion.cosine_schedule(100), PLAN, device="cpu")
    res = sess.serve(torch.randn((2, 8, 8, 4), generator=g), torch.arange(2))
    cache = sess.cache
    (key,) = cache.capture_counts
    runner, arena = cache._steps[key], cache._arenas[(key.cfg_sig, 2)]
    cache._capture(runner, arena, sess.params, True)
    # on its own capture stream, made (as the side stream) on the cache's device
    assert seen["graph_kw"] == {"pool": "pool", "stream": cache._capture_stream,
                                "capture_error_mode": "thread_local"}
    assert seen["stream_devices"] == [("current", cache.device)] + [cache.device] * 2
    assert res.sample.shape == (2, 8, 8, 4)


# ------------------------------------------------------- the real stack
@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(0)
    params = dit.init(g, CFG, device="cpu")
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=g)
    rng = np.random.default_rng(1)
    reqs = {(n, i): (torch.from_numpy(rng.standard_normal((n, 8, 8, 4)).astype(np.float32)),
                     torch.from_numpy((np.arange(n) + i) % 4))
            for i in range(8) for n in (1, 2, 3)}
    return params, diffusion.cosine_schedule(100), reqs


CLIENT_PLANS = [PLAN, PLAN.replace(fused=True),
                PlanSchedule(PLAN, [(0, 2, {}), (2, 3, dict(low_bits=4))]),
                PLAN.replace(policy="act")]


def test_async_concurrent_clients_mixed_plans_no_warmup(model):
    """Four client threads (diff, fused, a two-segment schedule, act), two
    requests each with budgets, against one async scheduler and one cold
    cache: every ticket equals its solo serve bit for bit (1-row requests
    coalesced into larger buckets included) and each key captures once."""
    params, sched, reqs = model
    sizes = {(c, j): 1 + (c + 2 * j) % 3 for c in range(4) for j in range(2)}
    sess = ServeSession(params, CFG, sched, PLAN, device="cpu")
    solo = {k: sess.serve(*reqs[(n, 2 * k[0] + k[1])], plan=CLIENT_PLANS[k[0]]).sample
            for k, n in sizes.items()}
    cache = CompiledRunnerCache()
    s = ServeScheduler(params, CFG, sched, PLAN, cache=cache, device="cpu", async_mode=True,
                       dispatch_interval_ms=25.0)
    got, errors = {}, []

    def client(c):
        try:
            tickets = [(j, s.submit(*reqs[(sizes[(c, j)], 2 * c + j)], plan=CLIENT_PLANS[c],
                                    deadline_ms=200.0 if j else None)) for j in range(2)]
            for j, t in tickets:
                got[(c, j)] = t.result(timeout=120.0)
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180.0)
    s.close(join_timeout_s=30.0)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert sorted(got) == sorted(sizes)
    for k, want in solo.items():
        assert torch.equal(got[k], want), k
    assert cache.capture_counts and all(c == 1 for c in cache.capture_counts.values())
    assert {(k.low_bits, k.fused) for k in cache.capture_counts} == {(8, False), (8, True),
                                                                     (4, False)}
    st = s.stats()
    assert st["completed"] == 8 and st["plan_groups"] == 4 and st["captures"] == len(cache)


def test_warmup_then_first_requests_capture_nothing(model):
    """``warmup`` probes the modes and captures the ladder 1, 2, 4; the
    first requests then capture nothing and equal their solo serves; a
    bucket left out of the warmup shows in ``captures_after_warmup``."""
    params, sched, reqs = model
    s = ServeScheduler(params, CFG, sched, PLAN, device="cpu", async_mode=True,
                       dispatch_interval_ms=25.0)
    try:
        w = s.warmup()
        assert w["captures"] == 3 and w["primed"] == 0 and w["wall_s"] > 0
        assert s.stats()["captures_after_warmup"] == 0
        sess = ServeSession(params, CFG, sched, PLAN, device="cpu")
        for n in (3, 1, 2):
            t = s.submit(*reqs[(n, 0)], deadline_ms=100.0)
            assert torch.equal(t.result(timeout=60.0), sess.serve(*reqs[(n, 0)]).sample)
        st = s.stats()
        assert st["captures"] == 3 and st["captures_after_warmup"] == 0
    finally:
        s.close(join_timeout_s=30.0)
    s = ServeScheduler(params, CFG, sched, PLAN, device="cpu")
    assert s.warmup(buckets=[1, 2])["captures"] == 2
    s.submit(*reqs[(3, 1)]).result()
    assert s.stats()["captures_after_warmup"] == 1
    # the probe's frozen modes: every layer diff under the diff policy
    assert set(s._probe_modes(PLAN, labels=True, probe_seed=0).values()) == {"diff"}


def test_lone_deadline_request_dispatches_as_a_partial(model):
    """A 1-row request with a budget and no company dispatches as a
    "deadline" partial (bucket 1) within its budget, equal to its solo
    serve."""
    params, sched, reqs = model
    s = ServeScheduler(params, CFG, sched, PLAN, device="cpu", async_mode=True,
                       dispatch_interval_ms=25.0)
    try:
        t = s.submit(*reqs[(1, 3)], deadline_ms=60.0)
        deadline = time.monotonic() + 60.0
        while not t.done and time.monotonic() < deadline:
            time.sleep(0.005)
        out = t.result(timeout=1.0)
        st = s.stats()
        assert st["triggers"]["deadline"] == 1 and st["triggers"]["demand"] == 0
    finally:
        s.close(join_timeout_s=30.0)
    sess = ServeSession(params, CFG, sched, PLAN, device="cpu")
    assert torch.equal(out, sess.serve(*reqs[(1, 3)]).sample)
