"""The port's serving layer against the reference: buckets, runner keys and
ServeSession.

Both packages serve the same bridged weights and the same requests (numpy,
seeded) through ``ServeSession`` at 5 DDIM steps. Samples agree to 1e-5 of
their scale (the fp32 glue accumulates in another order in XLA and in
PyTorch, see tests/test_torch_slice.py); each (layer, step)'s mode and
tile-class histogram, the chunks' batches and buckets and the cache's
runner counts are compared exactly. Inside the port, a bucketed sample
equals the unbucketed one and a cached sample the uncached one, bit for
bit. On the CPU a runner calls its step directly, and its first call
stands in for the CUDA graph capture it makes on the card.
"""
import importlib.util
import json
import pathlib
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import diffusion as rdiffusion  # noqa: E402
from repro.core.ditto import DittoPlan as RDittoPlan  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import dit as rdit  # noqa: E402
from repro.serve import CompiledRunnerCache as RCache  # noqa: E402
from repro.serve import ServeSession as RServeSession  # noqa: E402
from repro.serve import bucket_for as rbucket_for  # noqa: E402
from repro.serve import pad_batch as rpad_batch  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoEngine, DittoPlan, PlanSchedule, make_denoise_fn  # noqa: E402
from repro_torch.core.ditto.plan import check_device_block  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve import (CompiledRunnerCache, ServeSession, bucket_for,  # noqa: E402
                               pad_batch)
from repro_torch.sim import harness  # noqa: E402

CFG_KW = dict(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
              n_classes=4)
STEPS = 5
RAGGED = (1, 3, 2)  # buckets 1, 4, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """Reference init as numpy (adaLN ``mod`` weights refilled N(0, 0.02) so
    the blocks reach the sample), the port's params from it, and one seeded
    request per batch size."""
    cfg = rdit.DiTCfg(**CFG_KW)
    tree = jax.tree.map(lambda p: np.asarray(p.value), rdit.init(jax.random.PRNGKey(0), cfg),
                        is_leaf=rcore.is_param)
    rng = np.random.default_rng(0)
    w = tree["blocks"]["mod"]["w"]
    tree["blocks"]["mod"]["w"] = (rng.standard_normal(w.shape) * 0.02).astype(np.float32)
    reqs = {n: (rng.standard_normal((n, 8, 8, 4)).astype(np.float32),
                (np.arange(n) + n) % 4) for n in (1, 2, 3, 4)}
    return tree, bridge.params_from_numpy(tree, device="cpu"), reqs


def _port(reqs, n):
    x, lab = reqs[n]
    return torch.from_numpy(x), torch.from_numpy(lab)


def _int_records(records):
    return {(r["layer"], r["step"]): (r["mode"], r.get("tile_hist")) for r in records}


PLAN = dict(steps=STEPS, policy="diff", max_batch=4)


@pytest.fixture(scope="module")
def served(model):
    """One reference session and one port session serve the ragged batches,
    a 3-row request chunked by ``max_batch=2``, and a 2-row request under a
    per-request ``low_bits=4`` plan."""
    tree, params, reqs = model
    rsess = RServeSession(jax.tree.map(jnp.asarray, tree), rdit.DiTCfg(**CFG_KW),
                          rdiffusion.linear_schedule(1000), RDittoPlan(**PLAN))
    sess = ServeSession(params, dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000),
                        DittoPlan(**PLAN), device="cpu")
    calls = [(n, {}) for n in RAGGED] + [(3, dict(max_batch=2)), (2, dict(low_bits=4))]
    out = []
    for n, knobs in calls:
        x, lab = reqs[n]
        rplan = RDittoPlan(**dict(PLAN, **knobs)) if knobs else None
        plan = DittoPlan(**dict(PLAN, **knobs)) if knobs else None
        rres = rsess.serve(jnp.asarray(x), jnp.asarray(lab), plan=rplan)
        res = sess.serve(*_port(reqs, n), plan=plan)
        out.append((n, knobs, rres, res))
    return rsess, sess, out


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------- bucketing
def test_bucket_for_matches_reference():
    for max_batch in (1, 4, 16, 64):
        for n in range(1, max_batch + 1):
            assert bucket_for(n, max_batch=max_batch) == rbucket_for(n, max_batch=max_batch)
    for n, max_batch in ((0, 16), (17, 16), (5, 6), (1, 12)):
        for fn in (bucket_for, rbucket_for):
            with pytest.raises(ValueError):
                fn(n, max_batch=max_batch)


@pytest.mark.parametrize("n,bucket", [(1, 4), (3, 4), (3, 8), (4, 4)])
def test_pad_batch_matches_reference(n, bucket):
    rng = np.random.default_rng(n * 10 + bucket)
    x = rng.standard_normal((n, 8, 8, 4)).astype(np.float32)
    lab = np.arange(n, dtype=np.int32)
    rx, rl = rpad_batch(jnp.asarray(x), jnp.asarray(lab), bucket)
    px, pl = pad_batch(torch.from_numpy(x), torch.from_numpy(lab), bucket)
    np.testing.assert_array_equal(px.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    assert pad_batch(torch.from_numpy(x), None, bucket)[1] is None
    with pytest.raises(ValueError):
        pad_batch(torch.from_numpy(x), None, n - 1 if n > 1 else 0)


# -------------------------------------------------------------- runner keys
MODES = {"l1": "diff", "l2": "act"}
KEY_PLANS = [dict(), dict(low_bits=4), dict(fused=True), dict(collect_stats=False),
             dict(block=64), dict(block=64, low_bits=4, collect_stats=False),
             dict(steps=9), dict(sampler="plms"), dict(policy="diff"), dict(compiled=False),
             dict(max_batch=2), dict(watchdog=True),
             dict(watchdog=True, reanchor_full_frac=0.9)]


def test_runner_keys_match_reference():
    """Two (plan, bucket, modes) requests share a port key exactly when they
    share a reference key, ``block=64`` included (the CPU serves it)."""
    cache, rcache = CompiledRunnerCache(), RCache()
    cfg, rcfg = dit.DiTCfg(**CFG_KW), rdit.DiTCfg(**CFG_KW)
    combos = [(kw, b, m) for kw in KEY_PLANS for b in (2, 4)
              for m in (MODES, {"l1": "act", "l2": "act"})]
    keys = [cache.key_for(cfg, m, DittoPlan(**kw), bucket=b) for kw, b, m in combos]
    rkeys = [rcache.key_for(rcfg, m, RDittoPlan(**kw), bucket=b) for kw, b, m in combos]
    for i in range(len(combos)):
        for j in range(len(combos)):
            assert (keys[i] == keys[j]) == (rkeys[i] == rkeys[j]), (combos[i], combos[j])
    for key, rkey in zip(keys, rkeys):
        assert (key.block, key.collect_stats, key.low_bits, key.fused, key.bucket) == (
            rkey.block, rkey.collect_stats, rkey.low_bits, rkey.fused, rkey.bucket)


def test_cache_hit_miss_bookkeeping():
    """Same key -> one entry and a hit (mode order does not matter); a new
    bucket, lowering or mode set -> a new entry; ``clear`` resets."""
    cache = CompiledRunnerCache()
    cfg = dit.DiTCfg(**CFG_KW)
    plan = DittoPlan(steps=4)
    f1 = cache.step_for(cfg, MODES, plan, bucket=8)
    assert cache.step_for(cfg, dict(reversed(list(MODES.items()))), plan, bucket=8) is f1
    assert cache.step_for(cfg, MODES, plan.replace(steps=8), bucket=8) is f1
    assert cache.stats() == {"runners": 1, "captures": 0, "hits": 2, "misses": 1,
                             "replays": 0, "arena_bytes": {}}
    cache.step_for(cfg, MODES, plan, bucket=4)
    cache.step_for(cfg, MODES, plan.replace(low_bits=4), bucket=8)
    cache.step_for(cfg, {"l1": "act", "l2": "act"}, plan, bucket=8)
    assert len(cache) == 4 and cache.misses == 4
    const = PlanSchedule(plan, [(0, 2, {}), (2, 4, {})])  # a constant schedule is its plan
    assert cache.key_for(cfg, MODES, const, bucket=8) == cache.key_for(cfg, MODES, plan, bucket=8)
    with pytest.raises(TypeError):
        cache.key_for(cfg, MODES, PlanSchedule(plan, [(0, 2, {}), (2, 4, dict(low_bits=4))]))
    cache.clear()
    assert cache.stats() == {"runners": 0, "captures": 0, "hits": 0, "misses": 0,
                             "replays": 0, "arena_bytes": {}}


def test_warmup_builds_each_segment_and_bucket(model):
    """``warmup`` makes the runner of every distinct segment plan at every
    bucket asked for and captures it (on the CPU: counts it built), and a
    request then captures nothing."""
    _, params, reqs = model
    cfg = dit.DiTCfg(**CFG_KW)
    cache = CompiledRunnerCache()
    plan = DittoPlan(steps=4, policy="diff", max_batch=4, collect_stats=False)
    sched = PlanSchedule(plan, [(0, 2, {}), (2, 4, dict(low_bits=4))])
    sess = ServeSession(params, cfg, diffusion.linear_schedule(1000), sched, cache=cache,
                        device="cpu")
    res = sess.serve(*_port(reqs, 2))
    modes = res.chunks[0].engine.compiled_modes()
    cache.clear()
    assert cache.warmup(cfg, modes, [sched, plan], buckets=(1, 2),
                        params=sess.params) == {"captures": 4}
    assert len(cache) == 4 and cache.misses == 4 and cache.hits == 2
    assert cache.warmup(cfg, modes, [plan], buckets=(2,), params=sess.params)["captures"] == 0
    res = sess.serve(*_port(reqs, 2))
    assert len(cache) == 4 and cache.n_captures == 4 and res.captures_delta == 0


def test_same_bucket_batches_capture_once(model):
    """Four batches over two buckets: one capture (on the CPU: one first
    call) per key, the other batches pure hits; a cached sample equals a
    fresh uncached run bit for bit."""
    _, params, reqs = model
    cache = CompiledRunnerCache()
    plan = DittoPlan(steps=3, policy="diff", max_batch=4, collect_stats=False)
    sess = ServeSession(params, dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000), plan,
                        cache=cache, device="cpu")
    results = [sess.serve(*_port(reqs, n)) for n in (4, 3, 4, 2)]  # buckets 4, 4, 4, 2
    assert len(cache) == 2 and cache.n_captures == 2
    assert all(c == 1 for c in cache.capture_counts.values())
    assert cache.misses == 2 and cache.hits == 2
    assert [r.captures_delta for r in results] == [1, 0, 0, 1]
    _, fresh, _ = harness.serve_records(params, dit.DiTCfg(**CFG_KW),
                                        diffusion.linear_schedule(1000), *_port(reqs, 4), plan,
                                        device="cpu")
    assert torch.equal(results[2].sample, fresh)


def test_cache_binds_one_params_tree(model):
    """The cache's graphs read the weights and params it was bound to:
    another params tree, or one changed in place, raises."""
    _, params, reqs = model
    cfg, sched = dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000)
    plan = DittoPlan(steps=3, policy="diff", collect_stats=False)
    cache = CompiledRunnerCache()
    harness.serve_records(params, cfg, sched, *_port(reqs, 2), plan, runner_cache=cache,
                          device="cpu")
    other = {k: v for k, v in params.items()}
    other["pos_embed"] = params["pos_embed"].clone()
    with pytest.raises(ValueError, match="another params tree"):
        harness.serve_records(other, cfg, sched, *_port(reqs, 2), plan, runner_cache=cache,
                              device="cpu")
    cache.clear()
    harness.serve_records(other, cfg, sched, *_port(reqs, 2), plan, runner_cache=cache,
                          device="cpu")


# ------------------------------------------------------------- block != 128
def test_block_other_than_128_is_rejected_on_the_card_only(model, monkeypatch):
    """The card's kernels tile by 128: a compiled plan (or a schedule
    segment) with another block raises ValueError naming them before any
    step; the CPU and eager-only plans serve it."""
    cuda = torch.device("cuda")  # a device object needs no card
    for plan in (DittoPlan(block=64), PlanSchedule(DittoPlan(steps=4), [
            (0, 2, {}), (2, 4, dict(block=64))])):
        with pytest.raises(ValueError, match="int8_matmul.*tile by 128"):
            check_device_block(plan, cuda)
        check_device_block(plan, torch.device("cpu"))
    check_device_block(DittoPlan(), cuda)
    check_device_block(DittoPlan(block=64, compiled=False), cuda)
    # the entry points check before they move anything to the card
    _, params, reqs = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg, sched = dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000)
    with pytest.raises(ValueError, match="tile by 128"):
        harness.serve_records(params, cfg, sched, *_port(reqs, 2), DittoPlan(block=64),
                              device="cuda")
    with pytest.raises(ValueError, match="tile by 128"):
        make_denoise_fn(params, cfg, DittoEngine(device="cpu"), DittoPlan(block=64),
                        device="cuda")
    monkeypatch.undo()
    sess = ServeSession(params, cfg, sched, DittoPlan(steps=3, policy="diff", block=64),
                        device="cpu")
    out = sess.serve(*_port(reqs, 3)).sample
    assert out.shape == (3, 8, 8, 4) and torch.isfinite(out).all()


# ------------------------------------------------------------------ session
@pytest.mark.parametrize("i", range(len(RAGGED)), ids=[f"rows{n}" for n in RAGGED])
def test_session_ragged_batches_match_reference(served, i):
    _, _, out = served
    n, _, rres, res = out[i]
    assert [(c.batch, c.bucket) for c in res.chunks] == [(c.batch, c.bucket)
                                                         for c in rres.chunks]
    assert res.chunks[0].bucket == rbucket_for(n, max_batch=4)
    assert res.sample.shape == (n, 8, 8, 4)
    _close(res.sample, rres.sample)
    assert _int_records(res.records) == _int_records(rres.records)
    assert sum(1 for r in res.records if "tile_hist" in r) == 19 * (STEPS - 1)


def test_session_chunks_and_plan_override_match_reference(served):
    """A 3-row request under ``max_batch=2`` runs as chunks of 2 and 1 on the
    buckets already captured; a per-request ``low_bits=4`` plan adds one
    runner; the session's counters match the reference's."""
    rsess, sess, out = served
    (_, _, rchunked, chunked), (_, _, roverride, override) = out[3], out[4]
    assert [(c.batch, c.bucket) for c in chunked.chunks] == [(2, 2), (1, 1)] == [
        (c.batch, c.bucket) for c in rchunked.chunks]
    assert chunked.captures_delta == 0 == rchunked.traces_delta
    _close(chunked.sample, rchunked.sample)
    assert _int_records(chunked.records) == _int_records(rchunked.records)
    _close(override.sample, roverride.sample)
    assert override.captures_delta == 1 == roverride.traces_delta
    assert _int_records(override.records) == _int_records(roverride.records)
    st, rst = sess.stats(), rsess.stats()
    for key in ("batches", "requests", "watchdog_events", "runners", "hits", "misses"):
        assert st[key] == rst[key], key
    assert st["captures"] == rst["traces"] == 4


def test_session_bucketed_and_cached_equal_uncached(model, served):
    """Inside the port: each chunk a session served (bucketed, cached) equals
    the unbucketed uncached run of its rows, and the padded uncached run of
    the int8 plan, bit for bit (the low_bits=4 override included)."""
    _, params, reqs = model
    _, _, out = served
    cfg, sched = dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000)
    for n, knobs, _, res in out:
        x, lab = _port(reqs, n)
        lo = 0
        for c in res.chunks:
            rows = (x[lo:lo + c.batch], lab[lo:lo + c.batch])
            lo += c.batch
            _, plain, _ = harness.serve_records(params, cfg, sched, *rows,
                                                DittoPlan(**dict(PLAN, **knobs)), device="cpu")
            _, padded, _ = harness.serve_records(params, cfg, sched, *rows, DittoPlan(**PLAN),
                                                 bucket=c.bucket, device="cpu")
            assert torch.equal(c.sample, plain), (n, knobs)
            assert torch.equal(c.sample, padded), (n, knobs)


def test_session_shared_by_threads_counts_and_serves_exactly(model):
    """Eight threads share one session and one cache: every request is
    counted once and every sample equals the same request served alone
    (samples run one at a time on the cache's sample_lock; a bucket's
    arena holds one sample)."""
    _, params, reqs = model
    plan = DittoPlan(steps=3, policy="diff", max_batch=4, collect_stats=False)
    sess = ServeSession(params, dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000), plan,
                        device="cpu")
    want = {n: sess.serve(*_port(reqs, n)).sample for n in (1, 2, 3)}
    got, errors = [], []

    def worker(i):
        try:
            for n in (1 + i % 3, 1 + (i + 1) % 3):
                got.append((n, sess.serve(*_port(reqs, n)).sample))
        except Exception as err:  # surfaced by the assertion below
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(got) == 16 and all(torch.equal(x, want[n]) for n, x in got)
    st = sess.stats()
    assert st["batches"] == 19 and st["requests"] == 6 + sum(n for n, _ in got)
    assert st["captures"] == len(sess.cache) == 3


def test_eager_chunks_report_bucket_none(model):
    _, params, reqs = model
    sess = ServeSession(params, dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000),
                        DittoPlan(steps=3, policy="act", compiled=False, max_batch=4,
                                  collect_stats=False), device="cpu")
    res = sess.serve(*_port(reqs, 3))
    assert res.sample.shape[0] == 3 and [c.bucket for c in res.chunks] == [None]
    assert res.pad_rows == 0 and res.captures_delta == 0 and len(sess.cache) == 0


# -------------------------------------------------------------- entry point
def test_entry_point_serves_resumes_and_logs_atomically(tmp_path, capsys):
    """``examples/serve_diffusion_torch.py --device cpu --small``: ragged
    batches on buckets, a schedule, a resumed queue, and a log that stays
    valid JSON with no temporary file left behind."""
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "serve_diffusion_torch.py"
    spec = importlib.util.spec_from_file_location("serve_diffusion_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    log = tmp_path / "log.json"
    common = ["--device", "cpu", "--small", "--steps", "3", "--log", str(log)]
    st = example.main(common + ["--requests", "3", "--batch", "2", "--int4-from", "2"])
    assert st["requests"] == 3 and st["batches"] == 2 and st["captures"] == 2
    first = json.loads(log.read_text())
    assert sorted(first) == ["0", "1", "2"] and [first[k]["bucket"] for k in "012"] == [2, 2, 1]
    st = example.main(common + ["--requests", "5", "--batch", "2", "--chaos", "3"])
    assert st["requests"] == 2 and "resuming: 3 requests" in capsys.readouterr().out
    done = json.loads(log.read_text())
    assert sorted(done) == ["0", "1", "2", "3", "4"] and done["0"] == first["0"]
    assert not (tmp_path / "log.json.tmp").exists()
