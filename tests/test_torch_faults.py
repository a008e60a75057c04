"""The port's fault injection and re-anchor watchdog against the reference.

Fault validation, the injector's one-shot arrivals, seeded chaos schedules,
``perform`` / ``corrupt`` and the plan's recovery fields are held to
``src/repro/serve/faults.py`` and ``src/repro/core/ditto/plan.py`` on the
same inputs (the reference's own cases, tests/test_faults.py). The
watchdog is held end to end: a ``poison_nan`` step and a ``drift`` step
served through both packages' ``ServeSession`` re-anchor at the same steps
for the same trigger, and the samples agree to 1e-5 of their scale (the
fp32 glue's order, see tests/test_torch_slice.py).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import diffusion as rdiffusion  # noqa: E402
from repro.core.ditto import DittoPlan as RDittoPlan  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import dit as rdit  # noqa: E402
from repro.serve import ServeSession as RServeSession  # noqa: E402
from repro.serve import faults as rfaults  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import (CompiledDittoDiT, DittoDiT, DittoEngine,  # noqa: E402
                                    DittoPlan)
from repro_torch.nn import dit  # noqa: E402
from repro_torch.sim import harness  # noqa: E402
from repro_torch.serve import (CompiledRunnerCache, Fault, FaultInjector,  # noqa: E402
                               InjectedFault, ResourceExhausted, ServeSession,
                               chaos_schedule, faults, inject)

CFG_KW = dict(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
              n_classes=4)
WATCH = dict(steps=4, policy="diff", max_batch=4, watchdog=True, reanchor_full_frac=0.9)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(f):
    return (f.site, f.at, f.kind, f.value)


# --------------------------------------------------------- injector basics
BAD_FAULTS = [("nope.site", 0, "error", 0.0), ("scheduler.take", 0, "stall", 0.0),
              ("session.serve", -1, "error", 0.0), ("scheduler.dispatch", 0, "stall", 0.0),
              ("denoise.step", 0, "drift", 0.0), ("denoise.step", 0, "error", 0.0)]


@pytest.mark.parametrize("args", BAD_FAULTS, ids=lambda a: f"{a[0]}-{a[2]}-{a[1]}")
def test_fault_validation_matches_reference(args):
    with pytest.raises(ValueError) as err:
        rfaults.Fault(*args)
    with pytest.raises(ValueError) as perr:
        Fault(*args)
    assert str(perr.value) == str(err.value)


def test_injector_validation_and_one_shot():
    assert faults.SITE_KINDS == rfaults.SITE_KINDS
    with pytest.raises(ValueError, match="duplicate fault"):
        FaultInjector([Fault("session.serve", 0, "error"),
                       Fault("session.serve", 0, "resource_exhausted")])
    with pytest.raises(TypeError):
        FaultInjector(["not a fault"])
    inj = FaultInjector([Fault("session.serve", 1, "error")])
    assert inj.check("session.serve") is None  # arrival 0
    f = inj.check("session.serve")  # arrival 1: fires
    assert f is not None and f.kind == "error"
    assert inj.check("session.serve") is None  # one-shot
    assert inj.fired == [f] and inj.arrivals("session.serve") == 3


@pytest.mark.parametrize("seed", range(6))
def test_chaos_schedule_matches_reference(seed):
    for kw in (dict(), dict(sites=("session.serve", "denoise.step"), max_at=6)):
        got = chaos_schedule(seed, 5, **kw).faults
        want = rfaults.chaos_schedule(seed, 5, **kw).faults
        assert [_fields(f) for f in got] == [_fields(f) for f in want]
    assert chaos_schedule(seed, 5).faults == chaos_schedule(seed, 5).faults


def test_inject_exclusive_and_scoped():
    inj = FaultInjector([Fault("session.serve", 0, "error")])
    assert faults.fire("session.serve") is None  # nothing installed
    with inject(inj):
        with pytest.raises(RuntimeError, match="already installed"):
            with inject(FaultInjector([])):
                pass
        assert faults.fire("session.serve") is inj.faults[0]
    assert faults.fire("session.serve") is None  # uninstalled on exit


def test_perform_and_corrupt_match_reference():
    with pytest.raises(InjectedFault):
        faults.perform(Fault("session.serve", 0, "error"))
    with pytest.raises(ResourceExhausted):
        faults.perform(Fault("session.serve", 0, "resource_exhausted"))
    t0 = time.monotonic()
    faults.perform(Fault("scheduler.dispatch", 0, "stall", value=0.01))
    assert time.monotonic() - t0 >= 0.01
    x = np.random.default_rng(0).standard_normal((2, 3, 4)).astype(np.float32)
    for kind, value in (("poison_nan", 0.0), ("poison_inf", 0.0), ("drift", 64.0)):
        got = faults.corrupt(Fault("denoise.step", 0, kind, value), torch.from_numpy(x))
        want = rfaults.corrupt(rfaults.Fault("denoise.step", 0, kind, value), jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        faults.perform(Fault("denoise.step", 0, "poison_nan"))
    with pytest.raises(ValueError):
        faults.corrupt(Fault("session.serve", 0, "error"), torch.from_numpy(x))


# ------------------------------------------------- plan recovery contract
BAD_RECOVERY = [dict(reanchor_full_frac=0.9, collect_stats=True),
                dict(reanchor_full_frac=0.9, watchdog=True, collect_stats=False),
                dict(reanchor_full_frac=1.5, watchdog=True, collect_stats=True),
                dict(reanchor_full_frac=0.0, watchdog=True, collect_stats=True),
                dict(reanchor_full_frac=-0.5, watchdog=True, collect_stats=True)]


@pytest.mark.parametrize("kw", BAD_RECOVERY,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_plan_recovery_validation_matches_reference(kw):
    with pytest.raises(ValueError) as err:
        RDittoPlan(**kw)
    with pytest.raises(ValueError) as perr:
        DittoPlan(**kw)
    assert str(perr.value) == str(err.value)


def test_recovery_knobs_are_not_runner_identity():
    kw = dict(watchdog=True, reanchor_full_frac=0.9)
    base, rbase = DittoPlan(), RDittoPlan()
    decked, rdecked = base.replace(**kw), rbase.replace(**kw)
    assert decked.cache_sig() == base.cache_sig()
    assert rdecked.cache_sig() == rbase.cache_sig()
    for f in kw:
        assert getattr(decked, f) == getattr(rdecked, f), f


# ------------------------------------------------------- the session path
@pytest.fixture(scope="module")
def model():
    cfg = rdit.DiTCfg(**CFG_KW)
    tree = jax.tree.map(lambda p: np.asarray(p.value), rdit.init(jax.random.PRNGKey(0), cfg),
                        is_leaf=rcore.is_param)
    rng = np.random.default_rng(1)
    w = tree["blocks"]["mod"]["w"]
    tree["blocks"]["mod"]["w"] = (rng.standard_normal(w.shape) * 0.02).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    return tree, bridge.params_from_numpy(tree, device="cpu"), x, np.array([1, 2], np.int32)


def test_session_serve_fault_site_raises_before_serving(model):
    _, params, x, lab = model
    sess = ServeSession(params, dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000),
                        DittoPlan(**WATCH), device="cpu")
    with inject(FaultInjector([Fault("session.serve", 0, "resource_exhausted")])) as inj:
        with pytest.raises(ResourceExhausted):
            sess.serve(torch.from_numpy(x), torch.from_numpy(lab))
    assert len(inj.fired) == 1 and len(sess.cache) == 0
    assert sess.stats()["requests"] == 0


@pytest.fixture(scope="module")
def reanchored(model):
    """Both packages' sessions serve the same request under a ``drift`` at
    the first compiled step and, separately, a ``poison_nan`` at the
    second."""
    tree, params, x, lab = model
    rsess = RServeSession(jax.tree.map(jnp.asarray, tree), rdit.DiTCfg(**CFG_KW),
                          rdiffusion.linear_schedule(1000), RDittoPlan(**WATCH))
    sess = ServeSession(params, dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000),
                        DittoPlan(**WATCH), device="cpu")
    out = {}
    # the poison run does without the saturation watch (its first compiled
    # step saturates at random weights), under the same runners
    for name, fault, kw in (("drift", ("denoise.step", 0, "drift", 64.0), {}),
                            ("poison_nan", ("denoise.step", 1, "poison_nan", 0.0),
                             dict(reanchor_full_frac=None))):
        with rfaults.inject(rfaults.FaultInjector([rfaults.Fault(*fault)])) as rinj:
            rres = rsess.serve(jnp.asarray(x), jnp.asarray(lab),
                               plan=RDittoPlan(**dict(WATCH, **kw)))
        with inject(FaultInjector([Fault(*fault)])) as inj:
            res = sess.serve(torch.from_numpy(x), torch.from_numpy(lab),
                             plan=DittoPlan(**dict(WATCH, **kw)))
        assert len(rinj.fired) == len(inj.fired) == 1
        out[name] = (rres, res)
    return rsess, sess, out


@pytest.mark.parametrize("name,trigger", [("drift", "saturation"),
                                          ("poison_nan", "nonfinite")])
def test_reanchor_matches_reference(reanchored, name, trigger):
    _, _, out = reanchored
    rres, res = out[name]
    events, revents = res.chunks[0].engine.watchdog_events, rres.chunks[0].engine.watchdog_events
    assert [(e["step"], e["trigger"]) for e in events] == [
        (e["step"], e["trigger"]) for e in revents]
    assert events and events[0]["trigger"] == trigger
    for e, re_ in zip(events, revents):
        if "full_frac" in e:
            assert e["full_frac"] == pytest.approx(re_["full_frac"], abs=1e-3)
    assert torch.isfinite(res.sample).all()
    want = np.asarray(rres.sample)
    np.testing.assert_allclose(res.sample.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    marked = {(r["layer"], r["step"]) for r in res.records if r.get("reanchor")}
    rmarked = {(r["layer"], r["step"]) for r in rres.records if r.get("reanchor")}
    assert marked == rmarked and marked
    # the re-anchor's class statistics read the state it starts from: the
    # pre-step state after a rollback (a step that was not rolled back
    # would leave Δ = 0 everywhere, all-zero-class fractions)
    rrecs = {(r["layer"], r["step"]): r for r in rres.records if r.get("reanchor")}
    for r in res.records:
        if r.get("reanchor") and "cls_diff" in r:
            want_cls = rrecs[(r["layer"], r["step"])]["cls_diff"]
            assert r["cls_diff"] == pytest.approx(want_cls, abs=1e-3), r["layer"]
    assert {r["mode"] for r in res.records if r.get("reanchor")} == {"act"}


def test_reanchor_counts_and_shares_one_canonical_runner(reanchored, model):
    """Both re-anchors ran on one act-mode runner (the canonical plan), as
    the reference's on one trace; the session counts every event."""
    rsess, sess, _ = reanchored
    st, rst = sess.stats(), rsess.stats()
    assert st["watchdog_events"] == rst["watchdog_events"] >= 2
    assert st["runners"] == rst["runners"] == 2 and st["captures"] == rst["traces"] == 2
    # a fused plan re-anchors through the same runner: no new one appears
    _, params, x, lab = model
    fused = ServeSession(params, dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000),
                         DittoPlan(**dict(WATCH, fused=True)), cache=sess.cache, device="cpu")
    with inject(FaultInjector([Fault("denoise.step", 1, "poison_inf")])):
        out = fused.serve(torch.from_numpy(x), torch.from_numpy(lab)).sample
    assert torch.isfinite(out).all() and fused.stats()["watchdog_events"] >= 1
    assert len(sess.cache) == 3  # the fused step only


def test_watchdog_rollback_restores_an_arena_snapshot(model):
    """The watchdog restores the state of a step it rolls back although a
    cache's runner updates its bucket's arena in place: the poisoned step's
    state is snapshotted before it runs and loaded back into the arena for
    the re-anchor, whose class statistics (Δ against ``x_prev``) read it.
    The cached session's sample and records equal the uncached run's bit
    for bit."""
    _, params, x, lab = model
    cfg, sched = dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000)
    plan = DittoPlan(**dict(WATCH, reanchor_full_frac=None))
    poison = lambda: inject(FaultInjector([Fault("denoise.step", 1, "poison_nan")]))
    sess = ServeSession(params, cfg, sched, plan, device="cpu")
    with poison():
        got = sess.serve(torch.from_numpy(x), torch.from_numpy(lab))
    with poison():
        records, sample, eng = harness.serve_records(
            params, cfg, sched, torch.from_numpy(x), torch.from_numpy(lab), plan,
            bucket=2, device="cpu")
    events = got.chunks[0].engine.watchdog_events
    assert [e["trigger"] for e in events] == ["nonfinite"]
    assert events == eng.watchdog_events
    assert torch.equal(got.sample, sample)
    assert got.records == records
    assert any(r.get("reanchor") and "cls_diff" in r for r in records)


def test_arena_replays_a_step_from_a_snapshot(model):
    """A state handed back to a runner (a snapshot, as the watchdog's
    rollback does) is copied into the arena over what the last step wrote,
    and the step gives the same output and state as from the original; a
    handle the arena has since been taken from raises."""
    _, params, x, lab = model
    cfg, sched = dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000)
    plan = DittoPlan(steps=4, policy="diff", collect_stats=False)
    cache = CompiledRunnerCache()
    eng = DittoEngine(policy="diff", device="cpu")
    xt, labels, t = torch.from_numpy(x), torch.from_numpy(lab), torch.full((2,), 500)
    eng.begin_sample()
    DittoDiT(params, cfg, eng)(xt, t, labels)
    eng.end_step()
    runner = CompiledDittoDiT(params, cfg, eng, plan, cache=cache, bucket=2)
    runner(xt, t, labels)
    held = runner.state
    snap = held.snapshot()
    first = runner(xt * 0.5, t, labels)
    after = held.snapshot()
    runner(xt, t, labels)  # the state moves on
    runner.state = snap
    again = runner(xt * 0.5, t, labels)
    assert torch.equal(first, again)
    for name, st in after.items():
        for k, v in st.items():
            assert torch.equal(runner.state[name][k], v), (name, k)
    assert runner.state is not held
    other = CompiledDittoDiT(params, cfg, eng, plan, cache=cache, bucket=2)
    other.state = held  # a handle of the sample the arena held before
    with pytest.raises(RuntimeError, match="overwritten by another sample"):
        other(xt, t, labels)
