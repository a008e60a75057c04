"""The port's mesh serving against the reference: ServeMesh, the plan's mesh
fields and the mesh-aware ServeScheduler, on the CPU.

Three layers:

* The reference's ten in-process tests of tests/test_mesh_serving.py, name
  for name: plan and ``ServeMesh`` validation, the mesh signature's slot in
  ``cache_sig()`` and the group key, and the routing / stealing policy
  driven through ``poll(shard=...)`` over duck-typed per-shard sessions.
  The white-box ones run the same script on both packages.
* The reference's three subprocess contracts (which fail before their
  8-device child prints ``MESH_OK``, ROADMAP queue 3), in process over four
  logical CPU devices (``devices=(cpu,) * 4``): per-ticket bit identity
  to solo serving (each ticket also within 1e-5 of its scale of the
  reference's solo ``ServeSession``), stealing under a skewed async
  stream, one-shard fault recovery down the ladder.
* The port's own: a dp=2 split dispatch equals the unsharded one (modes,
  sample bits, records by (layer, step): class counts, tile histograms
  and every float exactly), under the watchdog too; each kernel wrapper enters its operand's device (the CUDA calls
  faked); a ticket split over two shards assembles in row order; the mesh
  never invents devices.
"""
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_sched import PKGS, PORT, REF, FakeClock  # noqa: E402
from repro.core import diffusion as rdiffusion  # noqa: E402
from repro.core.ditto import DittoPlan as RDittoPlan  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import dit as rdit  # noqa: E402
from repro.serve import ServeMesh as RServeMesh  # noqa: E402
from repro.serve import ServeSession as RServeSession  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoPlan, PlanSchedule  # noqa: E402
from repro_torch.core.ditto.dit_runner import RowGroup  # noqa: E402
from repro_torch.core.ditto.plan import MESH_SIG_FIELDS  # noqa: E402
from repro_torch.distributed import batch_sharding, constrain_batch  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import diff_encode as k_encode  # noqa: E402
from repro_torch.kernels import ditto_diff_matmul as k_diff  # noqa: E402
from repro_torch.kernels import fused_step as k_fused  # noqa: E402
from repro_torch.kernels import int8_matmul as k_int8  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve import (CompiledRunnerCache, Fault, FaultInjector, ServeMesh,  # noqa: E402
                               ServeScheduler, ServeSession, inject)
from repro_torch.serve.mesh import MESH_POLICY_FIELDS, place_dispatch, resolve_mesh  # noqa: E402
from repro_torch.serve.scheduler import Ticket  # noqa: E402
from repro_torch.sim import harness  # noqa: E402

CFG_KW = dict(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
              n_classes=4)
CFG = dit.DiTCfg(**CFG_KW)
PLAN = DittoPlan(steps=3, policy="diff", max_batch=4, collect_stats=False)
CPU = torch.device("cpu")
CPU4 = (CPU,) * 4
WAIT_S = 120.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------- plan mesh fields
@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_plan_mesh_validation(pkg):
    assert pkg.DittoPlan().mesh_sig() is None
    p = pkg.DittoPlan(mesh_devices=4, mesh_axis="dp")
    assert p.mesh_sig() == (4, "dp")
    with pytest.raises(ValueError, match="mesh_devices"):
        pkg.DittoPlan(mesh_devices=3)
    with pytest.raises(ValueError, match="mesh_devices"):
        pkg.DittoPlan(mesh_devices=0)
    with pytest.raises(ValueError, match="mesh_axis"):
        pkg.DittoPlan(mesh_devices=2, mesh_axis="not an identifier")


def test_mesh_sig_is_trace_identity():
    """The mesh signature is the last slot of ``cache_sig()`` (the
    reference's slot 5; the port has no ``interpret`` slot, so its 4) and
    ``RunnerKey.mesh`` reads it."""
    base = DittoPlan(collect_stats=False)
    meshed = base.replace(mesh_devices=2)
    rbase = RDittoPlan(collect_stats=False)
    assert base.cache_sig() != meshed.cache_sig()
    assert base.cache_sig()[-1] is None and rbase.cache_sig()[5] is None
    assert meshed.cache_sig()[4] == rbase.replace(mesh_devices=2).cache_sig()[5] == (2, "data")
    assert meshed.cache_sig() != base.replace(mesh_devices=4).cache_sig()
    assert meshed.cache_sig() != base.replace(mesh_devices=2, mesh_axis="x").cache_sig()
    sched = PlanSchedule(meshed.replace(steps=12), [(0, 6, {}), (6, 12, dict(low_bits=4))])
    assert sched.mesh_sig() == (2, "data")
    for _, _, seg in sched.segment_plans():
        assert seg.cache_sig()[4] == (2, "data")
    key = CompiledRunnerCache().key_for(CFG, {"a": "diff"}, meshed, bucket=4)
    assert key.mesh == (2, "data") and key.fused is False


def test_mesh_field_tuples_disjoint():
    assert set(MESH_SIG_FIELDS) == {"mesh_devices", "mesh_axis"}
    assert not set(MESH_SIG_FIELDS) & set(MESH_POLICY_FIELDS)
    stamped = ServeMesh(1, devices=(CPU,)).plan_for(DittoPlan())
    for name in MESH_POLICY_FIELDS:
        assert not hasattr(stamped, name)


# ------------------------------------------------------------- ServeMesh
def test_serve_mesh_validation(monkeypatch):
    with pytest.raises(ValueError, match="power of two"):
        ServeMesh(3, dp=3, devices=(CPU,) * 3)
    with pytest.raises(ValueError, match="multiple"):
        ServeMesh(3, dp=2, devices=(CPU,) * 3)
    with pytest.raises(ValueError, match="identifier"):
        ServeMesh(1, axis="bad axis", devices=(CPU,))
    with pytest.raises(ValueError, match="steal_min_rows"):
        ServeMesh(1, steal_min_rows=0, devices=(CPU,))
    with pytest.raises(ValueError, match=r"devices=\("):
        ServeMesh(4096)  # more devices than any host exposes
    # one visible card: a 2-device mesh raises, naming devices=, never
    # repeating the card or dropping to the CPU on its own
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"devices=\(torch.device\('cuda:0'\),\) \* 2"):
        ServeMesh(2)
    with pytest.raises(ValueError, match="cuda:1"):
        ServeMesh(2, devices=("cuda:0", "cuda:1"))
    with pytest.raises(ValueError, match="2 devices"):
        ServeMesh(2, devices=(CPU,))
    assert ServeMesh(2, devices=("cuda:0",) * 2).devices == (torch.device("cuda", 0),) * 2
    assert ServeMesh(1).devices == (torch.device("cuda", 0),)


def test_serve_mesh_identity_and_stamping():
    m = ServeMesh(1, dp=1, axis="data", devices=(CPU,))
    rm = RServeMesh(1, dp=1, axis="data")
    assert m.n_shards == rm.n_shards == 1
    assert m.signature() == rm.signature() == (1, "data")
    stamped = m.plan_for(PLAN)
    assert stamped.mesh_sig() == (1, "data")
    assert stamped.cache_sig() != PLAN.cache_sig()
    sched = PlanSchedule(PLAN.replace(steps=12), [(0, 12, {})])
    assert m.plan_for(sched).mesh_sig() == (1, "data")
    # the shard's devices, and its row split (the reference's shard_mesh / sharding)
    assert m.shard_devices(0) == (CPU,)
    with pytest.raises(ValueError, match="shard"):
        m.shard_devices(1)
    m4 = ServeMesh(4, dp=2, devices=CPU4)
    assert m4.n_shards == 2 and m4.shard_devices(1) == (CPU, CPU)
    assert m4.row_split(4) == ((0, 2), (2, 4)) and m4.row_split(1) == ((0, 1), (0, 1))
    assert resolve_mesh(PLAN) is None
    assert resolve_mesh(m4.plan_for(PLAN), (CPU, CPU)) == (CPU, CPU)
    x = torch.arange(8.0).reshape(4, 2)
    xs, ls = place_dispatch(x, torch.arange(4), (CPU, CPU))
    assert [t.tolist() for t in xs] == [x[:2].tolist(), x[2:].tolist()]
    assert [t.tolist() for t in ls] == [[0, 1], [2, 3]]
    assert place_dispatch(x, None, None) == ((x,), (None,))
    assert batch_sharding((2, "data"), 3) == ((0, 3), (0, 3))  # replicated
    assert len(constrain_batch(x, None)) == 1


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_group_key_separates_mesh_plans(pkg):
    plan = pkg.DittoPlan(steps=3, policy="diff", max_batch=4, collect_stats=False)
    mesh = (RServeMesh(1) if pkg is REF else ServeMesh(1, devices=(CPU,)))
    plain = plan.normalized()
    stamped = mesh.plan_for(plan).normalized()
    assert pkg.ServeScheduler._group_key(plain) != pkg.ServeScheduler._group_key(stamped)


# ---------------------------------------- routing + stealing (white box)
class _ShardSession:
    """Duck-typed per-shard session (x -> 2x) of package ``pkg``: records
    which shard served each batch, and carries the counters mesh-mode
    ``stats()`` sums."""

    def __init__(self, pkg, plan, shard, wall_s=0.0):
        self.pkg = pkg
        self.plan = plan
        self.shard = shard
        self.wall_s = wall_s
        self.calls = []
        self.batches_served = 0
        self.requests_served = 0
        self.watchdog_events = 0
        self._stats_lock = threading.Lock()

    def serve(self, x, labels, plan=None):
        plan = self.plan if plan is None else plan
        if self.wall_s:
            time.sleep(self.wall_s)
        self.calls.append((x.shape[0], plan))
        self.batches_served += 1
        b = x.shape[0]
        return self.pkg.result(x * 2.0, b, self.pkg.bucket_for(b, max_batch=plan.max_batch),
                               0.0)

    def stats(self):
        return {}


def _mesh_fake_scheduler(pkg, n_shards=2, steal=True, steal_min_rows=1, **kw):
    """``pkg``'s scheduler rewired onto fake per-shard sessions, as the
    reference's test builds it: the full routing / steal policy, no
    devices, deterministic through ``poll()``."""
    plan = pkg.DittoPlan(steps=3, policy="diff", max_batch=4, collect_stats=False)
    sessions = [_ShardSession(pkg, plan, k) for k in range(n_shards)]
    s = pkg.ServeScheduler.from_session(sessions[0], **kw)
    s.mesh = types.SimpleNamespace(n_devices=n_shards, dp=1, axis="data", steal=steal,
                                   steal_min_rows=steal_min_rows, n_shards=n_shards,
                                   plan_for=lambda p: p)
    s._sessions = sessions
    s._n_shards = n_shards
    s._shard_dispatches = [0] * n_shards
    s._shard_rows = [0] * n_shards
    s._shard_inflight = [0] * n_shards
    return s, sessions, plan


def _req(pkg, b, seed=0):
    x = np.arange(b * 4, dtype=np.float32).reshape(b, 4) + 100 * seed
    return (jnp.asarray(x) if pkg is REF else torch.from_numpy(x)), None


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_new_groups_route_least_loaded(pkg):
    s, _, plan = _mesh_fake_scheduler(pkg, n_shards=2, eager=False)
    s.submit(*_req(pkg, 2), plan=plan)
    s.submit(*_req(pkg, 2), plan=plan.replace(steps=5))
    assert sorted(g.shard for g in s._groups.values()) == [0, 1]
    s.close(drain=False)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_steal_only_from_busy_owner(pkg):
    s, sessions, _ = _mesh_fake_scheduler(pkg, n_shards=2)
    s.submit(*_req(pkg, 3), deadline_ms=1.0)  # group owned by shard 0
    assert s.poll(shard=1) == 0  # owner idle: the sibling must not steal
    s._shard_inflight[0] = 1
    assert s.poll(shard=1) == 3  # owner mid-dispatch: stolen, served on shard 1
    s._shard_inflight[0] = 0
    st = s.stats()
    assert st["triggers"]["steal"] == 1
    assert st["mesh"]["steals"] == 1 and st["mesh"]["stolen_rows"] == 3
    assert st["mesh"]["shard_dispatches"] == [0, 1]
    assert sessions[1].calls and not sessions[0].calls
    s.close(drain=False)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_steal_respects_gates(pkg):
    s, _, _ = _mesh_fake_scheduler(pkg, n_shards=2, steal=False)
    s.submit(*_req(pkg, 3), deadline_ms=1.0)
    s._shard_inflight[0] = 1
    assert s.poll(shard=1) == 0
    s._shard_inflight[0] = 0
    s.close(drain=False)
    s, _, _ = _mesh_fake_scheduler(pkg, n_shards=2, steal_min_rows=8)
    s.submit(*_req(pkg, 3), deadline_ms=1.0)
    s._shard_inflight[0] = 1
    assert s.poll(shard=1) == 0
    s._shard_inflight[0] = 0
    assert s.poll(shard=0) == 3  # the owner still serves its due work
    assert s.stats()["triggers"]["deadline"] == 1
    s.close(drain=False)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_mesh_stats_shape(pkg):
    s, _, _ = _mesh_fake_scheduler(pkg, n_shards=2)
    s.submit(*_req(pkg, 4))  # a full bucket: the sync submit dispatches on shard 0
    st = s.stats()
    assert st["triggers"]["full"] == 1
    assert st["mesh"]["n_shards"] == 2 and st["mesh"]["dp"] == 1
    assert st["mesh"]["shard_dispatches"] == [1, 0]
    assert st["mesh"]["shard_rows"] == [4, 0]
    assert st["batches"] == 1  # summed over the per-shard sessions
    s.close(drain=False)


def test_mesh_concurrent_submitters_fake():
    """Eight client threads x 10 ragged, partly budgeted requests in three
    groups against an async four-shard mesh over fake sessions (each
    serve sleeps, so owners are busy and siblings steal), under a short
    switch interval: every ticket resolves to its own rows, and the
    per-shard counters add up to the scheduler's."""
    plan = DittoPlan(steps=3, policy="diff", max_batch=4, collect_stats=False)
    sessions = [_ShardSession(PORT, plan, k, wall_s=0.002) for k in range(4)]
    mesh = types.SimpleNamespace(n_devices=4, dp=1, axis="data", steal=True,
                                 steal_min_rows=1, n_shards=4, plan_for=lambda p: p)
    s = ServeScheduler.__new__(ServeScheduler)
    s._init_runtime(sessions[0], mesh=mesh, sessions=sessions, eager=True, async_mode=True,
                    dispatch_interval_ms=5.0, retain=False, collect_done=False,
                    shed_expired=False, clock=time.monotonic)
    assert [t.name for t in s._threads] == [f"ditto-serve-shard{k}" for k in range(4)]
    errors, rows = [], [0]
    lock = threading.Lock()

    def client(c):
        try:
            rng = np.random.default_rng(c)
            mine = []
            for j in range(10):
                n = int(rng.integers(1, 4))
                x = torch.full((n, 4), float(100 * c + j))
                p = plan.replace(steps=3 + (c + j) % 3)
                mine.append((x, s.submit(x, plan=p, deadline_ms=20.0 if j % 3 == 0 else None)))
                with lock:
                    rows[0] += n
            for x, t in mine:
                if not torch.equal(t.result(timeout=WAIT_S), x * 2.0):
                    raise AssertionError(f"client {c}: rows differ")
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(old)
        s.close(join_timeout_s=WAIT_S)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert not any(t.is_alive() for t in s._threads)
    st = s.stats()
    assert st["completed"] == 80 and st["failed"] == 0 and st["submitted_rows"] == rows[0]
    assert sum(st["mesh"]["shard_rows"]) == st["dispatched_rows"] == rows[0]
    assert sum(st["mesh"]["shard_dispatches"]) == st["dispatches"] == st["batches"]
    assert st["mesh"]["stolen_rows"] <= st["dispatched_rows"]


# ------------------------------------------- the three contracts, in process
@pytest.fixture(scope="module")
def model():
    """The reference's init as numpy (adaLN ``mod`` weights refilled
    N(0, 0.02), so the blocks are live), the port's params from it, the
    reference's params and a request maker."""
    cfg = rdit.DiTCfg(**CFG_KW)
    tree = jax.tree.map(lambda p: np.asarray(p.value), rdit.init(jax.random.PRNGKey(0), cfg),
                        is_leaf=rcore.is_param)
    rng = np.random.default_rng(7)
    w = tree["blocks"]["mod"]["w"]
    tree["blocks"]["mod"]["w"] = (rng.standard_normal(w.shape) * 0.02).astype(np.float32)
    params = bridge.params_from_numpy(tree, device="cpu")

    def req(b, seed):
        r = np.random.default_rng(100 + seed)
        return (torch.from_numpy(r.standard_normal((b, 8, 8, 4)).astype(np.float32)),
                torch.from_numpy((np.arange(b) + seed) % 4))

    rsolo = RServeSession(jax.tree.map(jnp.asarray, tree), rdit.DiTCfg(**CFG_KW),
                          rdiffusion.cosine_schedule(100),
                          RDittoPlan(steps=3, policy="diff", max_batch=4, collect_stats=False))
    return params, rsolo, diffusion.cosine_schedule(100), req


def _held_to_reference(rsolo, tickets, reqs):
    """Each ticket within 1e-5 of its scale of the reference's solo
    ``ServeSession`` serving the same rows (the tolerance of
    tests/test_torch_scheduler.py: the two frameworks sum the fp32 glue in
    other orders)."""
    for i, (t, (x, lab)) in enumerate(zip(tickets, reqs)):
        want = np.asarray(rsolo.serve(jnp.asarray(x.numpy()), jnp.asarray(lab.numpy())).sample)
        got = t.result().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"ticket {i}")


def test_mesh_bit_identity_in_process(model):
    """Four logical CPU devices: dp=4 (one shard whose every dispatch splits
    its rows four ways) and dp=1 (four one-device shards) serve every ticket
    bit for bit as solo serving; warmup captures the ladder on every shard
    once (``primed`` = the siblings' captures), serving then captures
    nothing and every key carries the mesh signature; an unsharded session
    on shard 0's cache lands on keys of its own."""
    params, rsolo, sched, req = model
    solo = ServeSession(params, CFG, sched, PLAN, device="cpu")
    # dp=4: a split dispatch
    s4 = ServeScheduler(params, CFG, sched, PLAN, mesh=ServeMesh(4, dp=4, devices=CPU4))
    reqs = [req(4, 1), req(4, 2)]
    tickets = [s4.submit(*r) for r in reqs]
    s4.flush()
    for t, r in zip(tickets, reqs):
        assert torch.equal(t.result(), solo.serve(*r).sample), "dp4 not bit-identical"
    keys4 = [k for c in s4.session.caches for k in c.capture_counts]
    assert keys4 and {k.mesh for k in keys4} == {(4, "data")} and {k.bucket for k in keys4} == {1}
    s4.close()
    # dp=1: four shards, each with its own caches
    cache = CompiledRunnerCache()
    s1 = ServeScheduler(params, CFG, sched, PLAN, cache=cache,
                        mesh=ServeMesh(4, dp=1, devices=CPU4))
    w1 = s1.warmup()
    assert w1["captures"] == 3 and w1["primed"] == 9
    assert s1.warmup()["captures"] == 0  # once per shard and key
    keys_warm = set(cache.capture_counts)
    assert {k.mesh for k in keys_warm} == {(1, "data")}
    reqs = [req(3, 3), req(4, 4), req(2, 5), req(4, 6)]
    tickets = [s1.submit(*r) for r in reqs]
    s1.flush()
    for t, r in zip(tickets, reqs):
        assert torch.equal(t.result(), solo.serve(*r).sample), "dp1 not bit-identical"
    st = s1.stats()
    assert sum(st["mesh"]["shard_dispatches"]) == st["dispatches"]
    assert st["captures_after_warmup"] == 0 and st["mesh"]["captures_after_warmup"] == [0] * 4
    assert st["mesh"]["shard_captures"] == [3] * 4 and st["captures"] == 12
    assert set(cache.capture_counts) == keys_warm
    s1.close()
    un = ServeSession(params, CFG, sched, PLAN, cache=cache, device="cpu")
    assert torch.equal(un.serve(*req(4, 7)).sample, solo.serve(*req(4, 7)).sample)
    new_keys = set(cache.capture_counts) - keys_warm
    assert new_keys and all(k.mesh is None for k in new_keys)
    _held_to_reference(rsolo, tickets[1::2], reqs[1::2])  # the 4-row ones: one bucket


def test_mesh_work_stealing_skewed_stream_in_process(model):
    """An async four-shard mesh under a skewed stream (every request in one
    group, so one owner shard): siblings steal the owner's due buckets while
    it is mid-dispatch, and every stolen row is still bit-identical to solo
    serving (and within tolerance of the reference's solo session)."""
    params, rsolo, sched, req = model
    solo = ServeSession(params, CFG, sched, PLAN, device="cpu")
    s = ServeScheduler(params, CFG, sched, PLAN, mesh=ServeMesh(4, dp=1, steal=True,
                                                                devices=CPU4),
                       async_mode=True, dispatch_interval_ms=5.0)
    reqs = [req(4, seed) for seed in range(8)]  # 8 full buckets, one group
    try:
        tickets = [s.submit(*r) for r in reqs]
        s.flush()
        for t, r in zip(tickets, reqs):
            assert torch.equal(t.result(timeout=WAIT_S), solo.serve(*r).sample), "stolen rows"
        st = s.stats()
        owner = next(iter(s._groups.values())).shard
    finally:
        s.close(join_timeout_s=WAIT_S)
    assert {t.name for t in s._threads} == set()  # joined
    assert st["completed"] == len(reqs) and st["failed"] == 0
    assert st["mesh"]["steals"] >= 1, st["mesh"]
    non_owner = sum(r for k, r in enumerate(st["mesh"]["shard_rows"]) if k != owner)
    assert st["mesh"]["stolen_rows"] == non_owner, st["mesh"]
    _held_to_reference(rsolo, tickets[:2], reqs[:2])


def test_mesh_dispatch_threads_are_named_per_shard(model):
    params, _, sched, _ = model
    s = ServeScheduler(params, CFG, sched, PLAN, mesh=ServeMesh(2, devices=(CPU, CPU)),
                       async_mode=True)
    try:
        assert [t.name for t in s._threads] == ["ditto-serve-shard0", "ditto-serve-shard1"]
    finally:
        s.close()


def test_mesh_fault_on_one_shard_recovers_via_ladder_in_process(model):
    """A fault on the second group's dispatch (its own shard) walks that
    dispatch's ladder to ``low_bits=4`` and recovers bit-identically; the
    siblings serve their plans untouched and the scheduler never dies."""
    params, rsolo, sched, req = model
    mk = lambda steps: PLAN.replace(steps=steps, max_retries=1,  # noqa: E731
                                    fallbacks=(dict(low_bits=4),))
    plans = [mk(3), mk(4), mk(5)]  # three groups -> three shards
    s = ServeScheduler(params, CFG, sched, PLAN, mesh=ServeMesh(4, dp=1, steal=False,
                                                                devices=CPU4))
    with inject(FaultInjector([Fault("session.serve", 1, "error")])) as inj:
        tickets = [s.submit(*req(4, seed), plan=p) for seed, p in enumerate(plans)]
        s.flush()
    assert len(inj.fired) == 1
    solo = ServeSession(params, CFG, sched, PLAN, device="cpu")
    for seed, (t, p) in enumerate(zip(tickets, plans)):
        assert torch.equal(t.result(), solo.serve(*req(4, seed), plan=p).sample), seed
    st = s.stats()
    assert st["completed"] == 3 and st["failed"] == 0 and not st["died"]
    assert st["retries"] == 1 and st["fallback_dispatches"] == 1
    assert tickets[1].served_with.low_bits == 4
    assert tickets[0].served_with.low_bits != 4 and tickets[2].served_with.low_bits != 4
    assert sorted(st["mesh"]["shard_dispatches"], reverse=True)[:3] == [1, 1, 1]
    s.close()


# ------------------------------------------------------ the dp split dispatch
SPLIT_KW = dict(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=32,
                n_classes=4)  # 256 tokens a sample: 128-row tiles per device


def _records_by_key(recs):
    return {(r["layer"], r["step"]): r for r in recs}


def _assert_records_equal(got, want):
    """By (layer, step): ints and class counts exactly, floats within 1e-12
    relative (they come out equal)."""
    g, w = _records_by_key(got), _records_by_key(want)
    assert g.keys() == w.keys()
    for key in w:
        assert g[key].keys() == w[key].keys(), key
        for f, v in w[key].items():
            u = g[key][f]
            if isinstance(v, float) or (isinstance(v, tuple) and v and isinstance(v[0], float)):
                np.testing.assert_allclose(u, v, rtol=1e-12, atol=0, err_msg=f"{key} {f}")
            else:
                assert u == v, (key, f, u, v)


@pytest.mark.parametrize("policy", ["defo", "diff"])
def test_dp2_split_dispatch_equals_unsharded(policy):
    """dp=2 over two logical devices: the eager calibration runs over the
    whole batch, so Defo's modes equal the unsharded dispatch's, and the
    split compiled steps give the same sample bits and the same records by
    (layer, step) — with statistics on, every class fraction and priced
    float equal to the unsharded record (the spatial deltas across the
    split counted in), and every tile histogram: the conditioning ``mod``
    layer (M = the batch), whose rows on one device are not whole 128-row
    tiles, is classified again over the whole batch's Δ, so its histogram
    is the unsplit one, not the two halves'."""
    cfg = dit.DiTCfg(**SPLIT_KW)
    g = torch.Generator().manual_seed(5)
    params = dit.init(g, cfg, device="cpu")
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=g)
    sched = diffusion.cosine_schedule(100)
    x = torch.randn((4, 32, 32, 4), generator=g)
    lab = torch.arange(4) % 4
    plan = DittoPlan(steps=4, policy=policy, max_batch=4, collect_stats=True)
    split = plan.replace(mesh_devices=2)
    groups = tuple(RowGroup(CPU, params, CompiledRunnerCache()) for _ in range(2))
    r2, s2, e2 = harness.serve_records(params, cfg, sched, x, lab, split, bucket=4, mesh=groups)
    r1, s1, e1 = harness.serve_records(params, cfg, sched, x, lab, plan, bucket=4,
                                       runner_cache=CompiledRunnerCache(), device="cpu")
    assert e2.compiled_modes() == e1.compiled_modes()
    assert torch.equal(s2, s1)
    assert {c.capture_counts and next(iter(c.capture_counts)).bucket for c in
            (groups[0].cache, groups[1].cache)} == {2}
    _assert_records_equal(r2, r1)
    g1 = _records_by_key(r1)
    hists = [k for k, r in g1.items() if r["layer"].endswith(".mod") and "tile_hist" in r]
    assert bool(hists) == (policy == "diff")
    if hists:  # the halves alone classify tiles of their own rows: not the unsplit counts
        halves = [_records_by_key(harness.serve_records(
            params, cfg, sched, x[lo:hi], lab[lo:hi], plan, device="cpu")[0])
            for lo, hi in ((0, 2), (2, 4))]
        assert any(g1[key]["tile_hist"] != tuple(
            a + b for a, b in zip(halves[0][key]["tile_hist"], halves[1][key]["tile_hist"]))
            for key in hists)
    # a schedule's segment swap hands each device's state on
    swap = PlanSchedule(plan, [(0, 3, {}), (3, 4, dict(low_bits=4, fused=True))])
    _, s4, _ = harness.serve_records(params, cfg, sched, x, lab,
                                     swap.replace(base=split), bucket=4, mesh=groups)
    assert torch.equal(s4, harness.serve_records(params, cfg, sched, x, lab, swap,
                                                 device="cpu")[1])
    # a batch dp does not divide runs whole on the first device (replicated)
    r3, s3, _ = harness.serve_records(params, cfg, sched, x[:1], lab[:1], split, bucket=1,
                                      mesh=groups)
    assert torch.equal(s3, harness.serve_records(params, cfg, sched, x[:1], lab[:1], plan,
                                                 device="cpu")[1])


def test_dp2_split_records_exact_when_no_layer_is_whole_tiles():
    """At 16 tokens a sample every linear layer's rows on one device (32)
    are less than a 128-row tile: each diff layer's histogram is classified
    again over the whole batch, and every record equals the unsplit one."""
    cfg = dit.DiTCfg(**dict(SPLIT_KW, input_size=8))
    g = torch.Generator().manual_seed(6)
    params = dit.init(g, cfg, device="cpu")
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=g)
    sched = diffusion.cosine_schedule(100)
    x, lab = torch.randn((4, 8, 8, 4), generator=g), torch.arange(4) % 4
    plan = DittoPlan(steps=4, policy="diff", max_batch=4, collect_stats=True)
    groups = tuple(RowGroup(CPU, params, None) for _ in range(2))
    r2, s2, _ = harness.serve_records(params, cfg, sched, x, lab, plan.replace(mesh_devices=2),
                                      bucket=4, mesh=groups)
    r1, s1, _ = harness.serve_records(params, cfg, sched, x, lab, plan, device="cpu")
    assert torch.equal(s2, s1)
    linear = [r for r in r1 if "tile_hist" in r and r["kind"] == "dense"]
    steps = {r["step"] for r in r1 if r.get("compiled")}
    assert len(linear) == len(steps) * (7 * cfg.n_layers + 1) > 0  # every layer is diff
    _assert_records_equal(r2, r1)


@pytest.mark.parametrize("fault,kw", [
    (("denoise.step", 0, "drift", 64.0), dict(reanchor_full_frac=0.9)),
    (("denoise.step", 1, "poison_nan", 0.0), dict(reanchor_full_frac=None))],
    ids=["drift", "poison_nan"])
def test_dp2_split_watchdog_equals_unsharded(fault, kw):
    """The watchdog on a dp=2 split: a drift at the first compiled step
    (every group saturates; the next step re-anchors) and a poisoned output
    at the second (non-finite: every group rolls back and re-anchors) give
    the unsplit dispatch's sample bits, ``watchdog_events`` (step, trigger,
    ``full_frac``) and records by (layer, step), exactly."""
    cfg = dit.DiTCfg(**SPLIT_KW)
    g = torch.Generator().manual_seed(5)
    params = dit.init(g, cfg, device="cpu")
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=g)
    sched = diffusion.cosine_schedule(100)
    x = torch.randn((4, 32, 32, 4), generator=g)
    lab = torch.arange(4) % 4
    plan = DittoPlan(steps=4, policy="diff", max_batch=4, collect_stats=True, watchdog=True,
                     **kw)
    groups = tuple(RowGroup(CPU, params, CompiledRunnerCache()) for _ in range(2))
    with inject(FaultInjector([Fault(*fault)])) as inj:
        r2, s2, e2 = harness.serve_records(params, cfg, sched, x, lab,
                                           plan.replace(mesh_devices=2), bucket=4, mesh=groups)
    assert len(inj.fired) == 1
    with inject(FaultInjector([Fault(*fault)])):
        r1, s1, e1 = harness.serve_records(params, cfg, sched, x, lab, plan, bucket=4,
                                           runner_cache=CompiledRunnerCache(), device="cpu")
    trigger = "saturation" if fault[2] == "drift" else "nonfinite"
    assert [e["trigger"] for e in e1.watchdog_events] == [trigger]
    assert e2.watchdog_events == e1.watchdog_events
    assert torch.isfinite(s1).all() and torch.equal(s2, s1)
    assert any(r.get("reanchor") for r in r1)
    _assert_records_equal(r2, r1)


def test_split_session_checks_its_plans(model):
    params, _, sched, req = model
    sess = ServeSession(params, CFG, sched, PLAN.replace(mesh_devices=2), mesh=(CPU, CPU))
    assert len(sess.caches) == 2 and sess.device == CPU
    with pytest.raises(ValueError, match="mesh_devices=2"):
        sess.serve(*req(2, 0), plan=PLAN)
    # the watchdog runs on a split dispatch: the same rows as the solo session
    watched = PLAN.replace(watchdog=True)
    got = sess.serve(*req(2, 0), plan=watched.replace(mesh_devices=2))
    want = ServeSession(params, CFG, sched, watched, device="cpu").serve(*req(2, 0))
    assert torch.equal(got.sample, want.sample)
    assert got.chunks[0].engine.watchdog_events == want.chunks[0].engine.watchdog_events


def test_cache_refuses_a_dispatch_on_another_device(model):
    """A runner cache is bound to its params' device: a dispatch whose
    latents live elsewhere raises before anything is captured or run."""
    params, _, sched, req = model
    sess = ServeSession(params, CFG, sched, PLAN, device="cpu")
    sess.serve(*req(2, 0))
    cache = sess.cache
    assert cache.device == CPU
    (key,) = cache.capture_counts
    before = cache.n_captures
    x = torch.empty((2, 8, 8, 4), device="meta")
    with pytest.raises(ValueError, match="bound to cpu"):
        cache._steps[key]({}, sess.params, {}, x, torch.zeros(2, dtype=torch.int32), None)
    assert cache.n_captures == before


# --------------------------------------------------- repair: the launch device
def test_each_wrapper_enters_its_operands_device(monkeypatch):
    """Every C entry runs with the operand's device current and on that
    device's stream (a shard's thread may have another device current).
    The CUDA calls are faked: the card runs them in chip_smoke.py."""
    entered, calls = [], []

    class Device:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            entered.append(self.d)

        def __exit__(self, *exc):
            entered.pop()

    def cuda_fn(name, argtypes):
        def fn(*args):
            calls.append((name, list(entered), args[-1]))
            return 0
        return fn

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=("stream", device)))
    monkeypatch.setattr(common, "cuda_fn", cuda_fn)
    monkeypatch.setattr(common, "sm_count", lambda device: 132)
    i8 = lambda *s: torch.zeros(s, dtype=torch.int8)  # noqa: E731
    cls = torch.zeros((1, 1), dtype=torch.int32)
    k_encode.launch(i8(128, 128), i8(128, 128))
    k_diff.launch(i8(128, 128), i8(128, 128), i8(128, 128), None, cls, 8)
    k_int8.launch(i8(128, 128), i8(128, 128))
    k_fused.launch_encode(i8(128, 128), i8(128, 128))
    k_fused.launch_matmul(i8(128, 128), i8(128, 64), i8(128, 128), cls, None)
    assert [c[0] for c in calls] == ["ditto_diff_encode", "ditto_diff_matmul",
                                     "ditto_int8_matmul", "ditto_diff_encode_fused",
                                     "ditto_fused_matmul"]
    for name, devs, stream in calls:
        assert devs == [CPU] and stream == ("stream", CPU), name


# ---------------------------------------------- repair: a ticket's assembly
def test_ticket_split_over_two_shards_assembles_in_row_order(monkeypatch):
    """A request split over two shards: its first rows are stolen by shard 1
    while shard 0 is busy, its last are served by shard 0; the ticket's rows
    come back in submission order, and each piece was waited for on the
    stream that produced it before the concatenation."""
    s, sessions, _ = _mesh_fake_scheduler(PORT, n_shards=2, clock=FakeClock(), eager=False)
    x = torch.arange(24.0).reshape(6, 4)
    t = s.submit(x, deadline_ms=1.0)  # 6 rows: a 4-row and a 2-row dispatch
    s._shard_inflight[0] = 1
    assert s.poll(shard=1) == 4  # rows 0..3 stolen on shard 1
    s._shard_inflight[0] = 0
    assert s.poll(shard=0) == 2  # rows 4..5 on the owner
    assert torch.equal(t.result(), x * 2.0)
    assert s.stats()["mesh"]["shard_rows"] == [2, 4]
    s.close(drain=False)
    # pieces delivered out of row order, each from its own stream
    waited = []

    class Cur:
        def wait_stream(self, stream):
            waited.append(stream)

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Cur())
    tk = Ticket(None, 0, 6, PLAN, None, 0.0)
    tk._deliver(4, x[4:], None, "stream of shard 0")
    tk._deliver(0, x[:4], None, "stream of shard 1")
    tk._finish(1.0)
    assert torch.equal(tk.result(), x)
    assert waited == ["stream of shard 1", "stream of shard 0"]  # in row order
