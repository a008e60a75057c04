"""The port's ServeScheduler and the plan's scheduler fields against the
reference.

Plan parity: the new fields' validation messages equal the reference's
(up to the list of allowed fallback fields: the port has no
``interpret``), ``fallback_plans()`` equals the reference's field by
field, and no recovery or deadline field reaches ``cache_sig()`` or a
``RunnerKey``. Grouping parity: ``_group_key`` splits a set of plans and
schedules into the reference's equivalence classes. Policy parity: one
scripted stream (request sizes, budgets, plans, labels and clock advances
from a numpy seed, with ``session.serve``, ``scheduler.take`` and
``scheduler.policy`` faults) drives the reference's and the port's
``ServeScheduler.from_session`` through matching fakes (x -> 2x, the real
bucket accounting) and matching fake clocks, sync and ``poll()``-driven;
every call's return or error, every dispatch's size and rung, every
``stats()`` and every ticket's rows, rung, completion time and error are
compared exactly.

The real stack (a 2-block, 64-wide DiT on the CPU, 3 DDIM steps): the
coalesced 3 + 3 + 2 stream and a split request equal per-request port
``serve()`` bit for bit and the reference scheduler's tickets to 1e-5 of
their scale (the fp32 glue's order, see tests/test_torch_slice.py), but
for a row where that order flips an int8 rounding (one of the 16 rows
here): that row must equal, in each package, the eager pass of the row
alone bit for bit, so the difference arises before the scheduler and the
kernels; mixed
plans never share a RunnerKey; a ladder recovery equals the fault-free
rows bit for bit; the entry point's ``--deadline-ms`` and ``--chaos``
resolve every request.
"""
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_sched import PKGS, PORT, REF, FakeClock, FakeSession, plan_summary  # noqa: E402
from repro.core import diffusion as rdiffusion  # noqa: E402
from repro.core.ditto import plan as rplan  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import dit as rdit  # noqa: E402
from repro.serve import ServeScheduler as RServeScheduler  # noqa: E402
from repro.sim import harness as rharness  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoPlan, PlanSchedule  # noqa: E402
from repro_torch.core.ditto import plan as pplan  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.sim import harness  # noqa: E402
from repro_torch.serve import (CompiledRunnerCache, DispatchFailed, Fault,  # noqa: E402
                               FaultInjector, InjectedFault, ServeScheduler, ServeSession,
                               inject)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG_KW = dict(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
              n_classes=4)
PLAN_KW = dict(steps=3, policy="diff", max_batch=4, collect_stats=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ plan parity
BAD_PLANS = [dict(max_retries=-1), dict(retry_backoff_ms=-1.0),
             dict(fallbacks=(dict(steps=5),)), dict(fallbacks=(dict(max_batch=8, fused=False),)),
             dict(fallbacks=(dict(low_bits=3),)), dict(fallbacks=(dict(block=0),)),
             dict(fallbacks=("not a delta",)), dict(deadline_ms=0.0), dict(deadline_ms=-5.0)]


@pytest.mark.parametrize("kw", BAD_PLANS,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_scheduler_field_validation_matches_reference(kw):
    with pytest.raises(ValueError) as err:
        REF.DittoPlan(**kw)
    with pytest.raises(ValueError) as perr:
        DittoPlan(**kw)
    # the same message, but for the list of allowed fields (no interpret)
    assert str(perr.value).split("; allowed")[0] == str(err.value).split("; allowed")[0]
    if "; allowed" in str(err.value):
        assert str(perr.value).endswith(f"allowed fields are {pplan.FALLBACK_FIELDS}")


def test_field_tuples_match_reference():
    assert pplan.FALLBACK_FIELDS == tuple(f for f in rplan.FALLBACK_FIELDS if f != "interpret")
    assert pplan.ROBUSTNESS_FIELDS == rplan.ROBUSTNESS_FIELDS
    assert pplan.is_unset(pplan.UNSET) and not pplan.is_unset(None)
    assert repr(pplan.UNSET) == repr(rplan.UNSET)


LADDERS = [(), (dict(fused=False),), (dict(fused=False), dict(compiled=False)),
           (dict(fused=False, low_bits=8), (("compiled", False),)), ({}, dict(collect_stats=True))]


def _fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(DittoPlan)}


@pytest.mark.parametrize("i", range(len(LADDERS)))
def test_fallback_plans_match_reference(i):
    kw = dict(PLAN_KW, fused=True, low_bits=4, max_retries=3, retry_backoff_ms=10.0,
              watchdog=True, deadline_ms=75.0, fallbacks=LADDERS[i])
    plan, rplan_ = DittoPlan(**kw), REF.DittoPlan(**kw)
    assert plan.fallbacks == rplan_.fallbacks  # canonicalised deltas
    rungs, rrungs = plan.fallback_plans(), rplan_.fallback_plans()
    assert len(rungs) == len(rrungs) == len(LADDERS[i])
    for rung, rrung in zip(rungs, rrungs):
        assert _fields(rung) == {f: getattr(rrung, f) for f in _fields(rung)}
        assert rung.max_retries == 0 and rung.fallbacks == () and rung.watchdog
    # a schedule's ladder is its base's
    sched = PlanSchedule(plan, [(0, 1, {}), (1, 3, dict(low_bits=8))])
    rsched = REF.PlanSchedule(rplan_, [(0, 1, {}), (1, 3, dict(low_bits=8))])
    assert sched.fallback_plans() == plan.fallback_plans()
    for f in ("deadline_ms", "max_retries", "retry_backoff_ms", "fallbacks", "watchdog",
              "reanchor_full_frac"):
        assert getattr(sched, f) == getattr(plan, f) == getattr(rsched, f), f


def test_scheduler_fields_are_not_runner_identity():
    """No deadline or recovery field enters cache_sig() or a RunnerKey, in
    either package."""
    cache = CompiledRunnerCache()
    cfg = dit.DiTCfg(**CFG_KW)
    modes = {"l1": "diff"}
    kws = [dict(deadline_ms=20.0), dict(max_retries=4), dict(retry_backoff_ms=3.0),
           dict(fallbacks=(dict(fused=False), dict(compiled=False)))]
    for kw in kws:
        for pkg in PKGS:
            base = pkg.DittoPlan(**PLAN_KW)
            assert base.replace(**kw).cache_sig() == base.cache_sig(), (pkg.name, kw)
        base = DittoPlan(**PLAN_KW)
        assert (cache.key_for(cfg, modes, base.replace(**kw), bucket=4)
                == cache.key_for(cfg, modes, base, bucket=4))


# -------------------------------------------------------- grouping parity
def _grouping_plans(pkg):
    base = pkg.DittoPlan(**PLAN_KW)

    @dataclasses.dataclass(frozen=True)
    class Tagged(pkg.DittoPlan):
        tag: str = "client-a"  # not a sig field: behaves as base

    S = pkg.PlanSchedule
    return [base, base.replace(deadline_ms=50.0), S(base, [(0, 1, {}), (1, 3, {})]),
            Tagged(**dataclasses.asdict(base)),
            S(base, [(0, 2, {}), (2, 3, dict(low_bits=4))]),
            S(base, [(0, 1, {}), (1, 2, {}), (2, 3, dict(low_bits=4))]),
            S(base, [(0, 1, {}), (1, 3, dict(low_bits=4))]),
            S(base.replace(deadline_ms=9.0), [(0, 1, {}), (1, 3, dict(low_bits=4))]),
            base.replace(low_bits=4), base.replace(fused=True), base.replace(collect_stats=True),
            base.replace(max_retries=1), base.replace(retry_backoff_ms=5.0),
            base.replace(fallbacks=(dict(fused=False),)), base.replace(watchdog=True),
            base.replace(steps=4), base.replace(sampler="plms"), base.replace(max_batch=8),
            base.replace(compiled=False), base.replace(policy="act")]


def test_group_keys_partition_like_reference():
    """Equal schedules, a constant schedule and its bare plan, a duck-typed
    plan and a different budget share a group; distinct schedules, loop
    fields, lowerings and recovery policies do not."""
    classes = []
    for pkg in PKGS:
        keys = [pkg.ServeScheduler._group_key(p.normalized()) for p in _grouping_plans(pkg)]
        classes.append([[keys[i] == keys[j] for j in range(len(keys))]
                        for i in range(len(keys))])
    assert classes[0] == classes[1]
    same = classes[1]
    assert same[0][1] and same[0][2] and same[0][3]  # budget, constant schedule, duck type
    assert same[4][5] and same[6][7]  # equal schedules; a schedule's budget
    assert not same[4][6] and not same[0][4]
    assert sum(same[0]) == 4 and all(sum(row) <= 4 for row in same)


# ---------------------------------------------------------- policy parity
def _script(seed: int, n: int = 20):
    """Seed -> ops: submits (rows 1-6, fill, plan, budget, labels), clock
    advances each followed by a poll, results and a final flush."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        ops.append(("submit", int(rng.integers(1, 7)), float(i), str(rng.choice(["a", "a", "b"])),
                    [None, "plan", 30.0, 80.0, 250.0][int(rng.integers(0, 5))],
                    bool(rng.random() < 0.3)))
        for _ in range(int(rng.integers(0, 3))):
            ops.append(("advance", float(rng.choice([0.005, 0.02, 0.06]))))
            ops.append(("poll",))
        if rng.random() < 0.15:
            ops.append(("result", int(rng.integers(0, 1000))))
    return ops + [("flush",)] * 3  # a flush stops at a dispatch that fails


SCRIPT_PLANS = {
    # a: fused with a two-rung ladder; b: int4, no retries (errors surface as they are)
    "a": dict(PLAN_KW, fused=True, deadline_ms=120.0, max_retries=2, retry_backoff_ms=0.5,
              fallbacks=(dict(fused=False), dict(compiled=False))),
    "b": dict(PLAN_KW, low_bits=4),
}
# session.serve: single faults the ladder absorbs and a run of three that
# exhausts it; one batch-assembly fault; two policy faults (raised by poll)
SCRIPT_FAULTS = [("session.serve", 1, "error"), ("session.serve", 4, "resource_exhausted"),
                 ("session.serve", 6, "error"), ("session.serve", 7, "error"),
                 ("session.serve", 8, "error"), ("scheduler.take", 3, "error"),
                 ("scheduler.policy", 5, "error"), ("scheduler.policy", 11, "error")]


def _run_script(pkg, ops, sched_kw):
    clock = FakeClock()
    plans = {k: pkg.DittoPlan(**kw) for k, kw in SCRIPT_PLANS.items()}
    fake = FakeSession(pkg, plans["a"])
    s = pkg.ServeScheduler.from_session(fake, clock=clock, **sched_kw)
    injector = pkg.faults.FaultInjector([pkg.faults.Fault(*f) for f in SCRIPT_FAULTS])
    log, tickets = [], []
    with pkg.faults.inject(injector):
        for op in ops:
            try:
                if op[0] == "submit":
                    _, rows, fill, name, ddl, lab = op
                    x = pkg.full((rows, 2, 2, 1), fill)
                    labels = pkg.full((rows,), fill) if lab else None
                    kw = {} if ddl == "plan" else {"deadline_ms": ddl}
                    tickets.append(s.submit(x, labels, plan=plans[name], **kw))
                    out = None
                elif op[0] == "advance":
                    out = clock.advance(op[1])
                elif op[0] == "poll":
                    out = s.poll()
                elif op[0] == "result":
                    out = pkg.numpy(tickets[op[1] % len(tickets)].result()).tolist()
                else:
                    out = len(s.flush())
            except Exception as exc:  # compared with the other package's
                out = (type(exc).__name__, str(exc))
            log.append((op, out, s.stats(), list(fake.calls)))
    ends = []
    for t in tickets:
        assert t.done, (pkg.name, t.index)
        if t._error is not None:
            ends.append((t.index, t.done_t, type(t._error).__name__, str(t._error)))
        else:
            ends.append((t.index, t.done_t, plan_summary(t.served_with),
                         pkg.numpy(t.result()).tolist()))
    return log, ends, [f.site for f in injector.fired]


@pytest.mark.parametrize("sched_kw", [dict(), dict(eager=False, shed_expired=True)],
                         ids=["eager", "lazy-shed"])
@pytest.mark.parametrize("seed", range(4))
def test_policy_matches_reference_on_a_scripted_stream(seed, sched_kw):
    """Same dispatches (sizes, triggers, rungs), pad rows, stats, errors and
    tickets, call by call."""
    ops = _script(seed)
    ref_log, ref_ends, ref_fired = _run_script(REF, ops, sched_kw)
    log, ends, fired = _run_script(PORT, ops, sched_kw)
    for (op, out, st, calls), (_, rout, rst, rcalls) in zip(log, ref_log):
        assert (out, st, calls) == (rout, rst, rcalls), op
    assert ends == ref_ends
    assert fired == ref_fired
    st = log[-1][2]
    assert st["live_tickets"] == 0 and st["queued_rows"] == 0
    # "failed" counts failed dispatch segments, as the reference does: a
    # request split over two failing dispatches counts twice
    assert st["completed"] + st["failed"] >= st["submitted"]


def test_scripted_streams_reach_every_path():
    """The scripts above exercise what they claim: retries, fallbacks, a
    ladder exhausted, shedding, deadline partials and a failed take."""
    seen = {"retries": 0, "fallback_dispatches": 0, "shed": 0, "deadline": 0, "errors": set()}
    for seed in range(4):
        for kw in (dict(), dict(eager=False, shed_expired=True)):
            log, ends, _ = _run_script(PORT, _script(seed), kw)
            st = log[-1][2]
            seen["retries"] += st["retries"]
            seen["fallback_dispatches"] += st["fallback_dispatches"]
            seen["shed"] += st["shed"]
            seen["deadline"] += st["triggers"]["deadline"]
            seen["errors"] |= {e[2] for e in ends if isinstance(e[2], str)}
            seen["errors"] |= {out[0] for _, out, _, _ in log if isinstance(out, tuple)}
    assert seen["retries"] and seen["fallback_dispatches"] and seen["shed"] and seen["deadline"]
    assert {"DispatchFailed", "InjectedFault", "RequestShed"} <= seen["errors"]


# ------------------------------------------------------- the real stack
@pytest.fixture(scope="module")
def model():
    """Reference init as numpy (adaLN ``mod`` weights refilled N(0, 0.02)),
    the port's params from it, and seeded requests of 1-6 rows."""
    cfg = rdit.DiTCfg(**CFG_KW)
    tree = jax.tree.map(lambda p: np.asarray(p.value), rdit.init(jax.random.PRNGKey(0), cfg),
                        is_leaf=rcore.is_param)
    rng = np.random.default_rng(0)
    w = tree["blocks"]["mod"]["w"]
    tree["blocks"]["mod"]["w"] = (rng.standard_normal(w.shape) * 0.02).astype(np.float32)
    reqs = [(rng.standard_normal((n, 8, 8, 4)).astype(np.float32), (np.arange(n) + i) % 4)
            for i, n in enumerate((3, 3, 2, 6, 2))]
    return tree, bridge.params_from_numpy(tree, device="cpu"), reqs


def _port_req(req):
    return torch.from_numpy(req[0]), torch.from_numpy(req[1])


def _session(params, plan=None, cache=None):
    return ServeSession(params, dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000),
                        plan if plan is not None else DittoPlan(**PLAN_KW), cache=cache,
                        device="cpu")


def _scheduler(params, plan=None, **kw):
    return ServeScheduler(params, dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000),
                          plan if plan is not None else DittoPlan(**PLAN_KW), device="cpu", **kw)


# (ticket, row) of the one row past the reference tolerance in
# test_coalesced_and_split_rows_equal_serve_and_reference, and the bound on
# its error as a fraction of the ticket's scale (ROADMAP queue 3).
KNOWN_FLIP_ROWS = {(3, 3)}  # the 6-row request's fourth row: 0.13 % of its scale
KNOWN_FLIP_FRAC = 2e-3


def test_coalesced_and_split_rows_equal_serve_and_reference(model):
    """3 + 3 + 2 dispatches as 4 + 4 with no pad row (2 one by one); then a
    6-row request splits 4 + 2 with a 2-row one after it. Every ticket
    equals the port's per-request serve() bit for bit, and the reference
    scheduler's ticket to 1e-5 of its scale, but for the one known row
    (``KNOWN_FLIP_ROWS``), held within ``KNOWN_FLIP_FRAC`` of the scale and
    to each package's own eager pass of it bit for bit."""
    tree, params, reqs = model
    sess = _session(params)
    solo = [sess.serve(*_port_req(r)).sample for r in reqs]
    s = _scheduler(params, retain=True)
    tickets = [s.submit(*_port_req(r)) for r in reqs[:3]]
    assert all(t.done for t in tickets)  # the second and third submit each fill a bucket
    st = s.stats()
    assert st["dispatches"] == 2 and st["triggers"]["full"] == 2
    assert s.pad_rows == 0 and s.naive_pad_rows() == 2
    t6 = s.submit(*_port_req(reqs[3]))  # rows 0..3 dispatch at once
    assert s.stats()["dispatches"] == 3 and not t6.done
    t2 = s.submit(*_port_req(reqs[4]))  # 2 left + 2 new: a full bucket
    assert t6.done and t2.done and s.pad_rows == 0 and len(t6.results) == 2
    tickets += [t6, t2]
    for t, want in zip(tickets, solo):
        assert torch.equal(t.result(), want), t.index
    rparams = jax.tree.map(jnp.asarray, tree)
    rs = RServeScheduler(rparams, rdit.DiTCfg(**CFG_KW), rdiffusion.linear_schedule(1000),
                         REF.DittoPlan(**PLAN_KW))
    rtickets = [rs.submit(jnp.asarray(x), jnp.asarray(lab)) for x, lab in reqs]
    rs.flush()
    assert rs.stats()["dispatches"] == s.stats()["dispatches"] == 4
    eager = dict(PLAN_KW, compiled=False)
    past = {}
    for i, (t, rt, (x, lab)) in enumerate(zip(tickets, rtickets, reqs)):
        got, want = t.result().numpy(), np.asarray(rt.result())
        scale = np.abs(want).max()
        err = np.abs(got - want).reshape(len(x), -1).max(axis=1)
        for r in np.nonzero(err > 1e-5 * scale)[0]:
            past[(i, int(r))] = err[r] / scale
            # The fp32 glue's order flipped an int8 rounding upstream of the
            # scheduler and the kernels: each package's ticket row equals its
            # own eager pass of that row alone, bit for bit.
            _, pe, _ = harness.serve_records(params, dit.DiTCfg(**CFG_KW),
                                             diffusion.linear_schedule(1000),
                                             torch.from_numpy(x[r:r + 1]),
                                             torch.from_numpy(lab[r:r + 1]),
                                             DittoPlan(**eager), device="cpu")
            _, re, _ = rharness.serve_records(rparams, rdit.DiTCfg(**CFG_KW),
                                              rdiffusion.linear_schedule(1000),
                                              jnp.asarray(x[r:r + 1]), jnp.asarray(lab[r:r + 1]),
                                              REF.DittoPlan(**eager))
            np.testing.assert_array_equal(got[r], pe[0].numpy())
            np.testing.assert_array_equal(want[r], np.asarray(re)[0])
    # Only the one known row of these requests (seed 0) may pass the
    # tolerance, and only by a flip's size: XLA and PyTorch sum blk0.wo's
    # fp32 input in other orders and one int8 rounding flips at step 0.
    assert set(past) == KNOWN_FLIP_ROWS, past
    assert all(frac < KNOWN_FLIP_FRAC for frac in past.values()), past


def test_mixed_plans_never_share_a_runner_key(model):
    """int8, int4 and fused submissions coexist in one scheduler and one
    cache, group apart, and each key's runner serves one lowering; same-plan
    submissions still coalesce and every ticket equals its solo serve."""
    _, params, reqs = model
    cache = CompiledRunnerCache()
    p8 = DittoPlan(**PLAN_KW)
    plans = [p8, p8.replace(low_bits=4), p8, p8.replace(fused=True)]
    s = _scheduler(params, p8, cache=cache)
    tickets = [s.submit(*_port_req(reqs[i]), plan=p) for i, p in zip((2, 4, 4, 2), plans)]
    assert s.stats()["plan_groups"] == 3 and s.stats()["dispatches"] == 1
    s.flush()
    keys = list(cache.capture_counts)
    assert len(cache) == 3 and len(set(keys)) == 3
    assert sorted((k.low_bits, k.fused) for k in keys) == [(4, False), (8, False), (8, True)]
    assert all(c == 1 for c in cache.capture_counts.values())
    sess = _session(params)
    for t, i, p in zip(tickets, (2, 4, 4, 2), plans):
        assert torch.equal(t.result(), sess.serve(*_port_req(reqs[i]), plan=p).sample)


@pytest.mark.parametrize("faults_at,rung", [((0,), (8, False, True)), ((0, 1), (8, True, False))],
                         ids=["two-pass-rung", "eager-rung"])
def test_ladder_recovery_is_bit_identical(model, faults_at, rung):
    """A serve error on the fused plan recovers on the two-pass rung, two on
    the eager rung (exact float64 products): the rows equal the fault-free
    ones bit for bit, and ``served_with`` is the rung taken."""
    _, params, reqs = model
    plan = DittoPlan(**PLAN_KW, fused=True, max_retries=2,
                     fallbacks=(dict(fused=False), dict(compiled=False)))
    cache = CompiledRunnerCache()
    x, lab = _port_req(reqs[0])
    want = _scheduler(params, plan, cache=cache).submit(x, lab).result()
    s = _scheduler(params, plan, cache=cache)
    with inject(FaultInjector([Fault("session.serve", a, "error") for a in faults_at])) as inj:
        t = s.submit(x, lab)
        got = t.result()
    assert len(inj.fired) == len(faults_at) and plan_summary(t.served_with) == rung
    st = s.stats()
    assert st["retries"] == st["fallback_dispatches"] == len(faults_at)
    assert torch.equal(got, want)


def test_exhausted_ladder_and_single_attempt_errors(model):
    """Three faults exhaust a two-retry ladder (DispatchFailed, the fault as
    its cause); with no retry budget the fault itself surfaces. Nothing is
    served elsewhere."""
    _, params, reqs = model
    x, lab = _port_req(reqs[2])
    plan = DittoPlan(**PLAN_KW, max_retries=2, fallbacks=(dict(compiled=False),))
    s = _scheduler(params, plan)
    with inject(FaultInjector([Fault("session.serve", i, "error") for i in range(3)])):
        t = s.submit(x, lab)
        with pytest.raises(DispatchFailed) as err:
            t.result()
    assert err.value.attempts == 3 and isinstance(err.value.__cause__, InjectedFault)
    s = _scheduler(params)
    with inject(FaultInjector([Fault("session.serve", 0, "error")])):
        t = s.submit(x, lab)
        with pytest.raises(InjectedFault):
            t.result()
    assert s.stats()["failed"] == 1 and s.stats()["batches"] == 0


# ------------------------------------------------------------ entry point
def _example():
    path = ROOT / "examples" / "serve_diffusion_torch.py"
    spec = importlib.util.spec_from_file_location("serve_diffusion_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


@pytest.mark.parametrize("extra", [["--deadline-ms", "400"], ["--deadline-ms", "400", "--warmup"],
                                   ["--chaos", "7"], ["--chaos", "3", "--fused"]],
                         ids=["deadline", "deadline-warmup", "chaos7", "chaos3-fused"])
def test_entry_point_scheduler_resolves_every_request(tmp_path, capsys, extra):
    """``--device cpu --small`` through the async scheduler: every request
    is served (the chaos plan's retry budget outlasts its one-shot faults)
    and logged with its latency."""
    log = tmp_path / "log.json"
    st = _example().main(["--device", "cpu", "--small", "--steps", "3", "--requests", "5",
                          "--batch", "2", "--log", str(log)] + extra)
    out = capsys.readouterr().out
    done = json.loads(log.read_text())
    assert sorted(done) == ["0", "1", "2", "3", "4"]
    assert all("error" not in v and v["wall_s"] > 0 for v in done.values()), done
    assert st["completed"] == 5 and st["failed"] == 0 and st["live_tickets"] == 0
    assert st["requests"] == 5 and st["dispatched_rows"] == 5
    if "--warmup" in extra:
        assert "warmup: 2 graph(s)" in out and st["captures_after_warmup"] == 0
    if "--chaos" in extra:
        assert "chaos:" in out and st["retries"] >= st["fallback_dispatches"]
