"""The port's PlanSchedule against the reference, and its segment swap.

Construction errors, ``normalized``, ``cache_sigs``, ``constant_plan`` and
``segment_view`` are held to the reference's on the same inputs (the
reference's ``cache_sig`` carries ``interpret``, which the port has not:
sigs are compared on the shared fields). The
segment swap is held inside the port: a schedule that switches
``low_bits`` 8 -> 4 (or to the fused flow) at step 1, k or steps - 1 gives,
at every step, the outputs of the matching constant plan bit for bit,
with and without a runner cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.ditto import DittoPlan as RDittoPlan  # noqa: E402
from repro.core.ditto import PlanSchedule as RPlanSchedule  # noqa: E402
from repro.core.ditto.plan import segment_resolved as rsegment_resolved  # noqa: E402
from repro.core.ditto.plan import segment_view as rsegment_view  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoEngine, DittoPlan, PlanSchedule, dit_runner  # noqa: E402
from repro_torch.core.ditto.plan import SEGMENT_FIELDS, segment_resolved, segment_view  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve import CompiledRunnerCache  # noqa: E402

CFG = dit.DiTCfg(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
                 n_classes=4)
_DELTA_POOL = ({}, {"low_bits": 4}, {"fused": True}, {"low_bits": 4, "fused": True},
               {"collect_stats": True}, {"block": 64})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_partition(seed: int, max_steps: int = 24):
    """Seed -> a valid (steps, segments) partition of [0, steps)."""
    rng = np.random.RandomState(seed)
    steps = int(rng.randint(1, max_steps + 1))
    n_cuts = int(rng.randint(0, min(5, steps - 1) + 1)) if steps > 1 else 0
    cuts = sorted(int(c) for c in rng.choice(np.arange(1, steps), size=n_cuts, replace=False))
    bounds = [0] + cuts + [steps]
    return steps, [(bounds[i], bounds[i + 1], _DELTA_POOL[rng.randint(len(_DELTA_POOL))])
                   for i in range(len(bounds) - 1)]


def _both(steps, segments):
    base = dict(steps=steps, policy="diff", collect_stats=False)
    return PlanSchedule(DittoPlan(**base), segments), RPlanSchedule(RDittoPlan(**base), segments)


def _sig(rsig):
    """The reference's (block, interpret, collect_stats, low_bits, fused,
    mesh) on the port's fields."""
    return (rsig[0], rsig[2], rsig[3], rsig[4], rsig[5])


def _view(view):
    return tuple((a, b, tuple(getattr(p, f) for f in SEGMENT_FIELDS)) for a, b, p in view)


@pytest.mark.parametrize("segments", [
    [(0, 4, {}), (5, 12, {})],
    [(0, 6, {}), (4, 12, {})],
    [(0, 0, {}), (0, 12, {})],
    [(0, 4, {})],
    [(2, 12, {})],
    [(0, 14, {})],
    [],
    [(0, 12, {"steps": 4})],
    [(0, 12, {"low_bits": 5})],
    [(0, 12, {"block": 0})],
    [(0, 12, "not a delta")],
    [(0, 12)],
], ids=["gap", "overlap", "empty", "short", "late-start", "exceeds", "no-segments",
        "loop-field", "bad-low_bits", "bad-block", "bad-delta", "bad-segment"])
def test_invalid_partitions_raise_like_reference(segments):
    with pytest.raises(ValueError) as err:
        RPlanSchedule(RDittoPlan(steps=12), segments)
    with pytest.raises(ValueError) as perr:
        PlanSchedule(DittoPlan(steps=12), segments)
    # the same message, but for the list of schedulable fields (no interpret)
    assert str(perr.value).split("; schedulable")[0] == str(err.value).split("; schedulable")[0]


def test_base_must_be_a_plan():
    with pytest.raises(TypeError):
        PlanSchedule("not-a-plan", [(0, 12, {})])


@pytest.mark.parametrize("seed", range(12))
def test_normalized_and_cache_sigs_match_reference(seed):
    steps, segments = _random_partition(seed)
    sched, rsched = _both(steps, segments)
    norm, rnorm = sched.normalized(), rsched.normalized()
    assert norm.segments == rnorm.segments
    assert sched.cache_sigs() == tuple(_sig(s) for s in rsched.cache_sigs())
    assert norm.cache_sigs() == sched.cache_sigs()
    assert _view(segment_view(sched)) == _view(rsegment_view(rsched))
    assert sched.is_constant() == rsched.is_constant()
    for step in range(steps):
        assert _view([(0, 1, sched.plan_for(step))]) == _view([(0, 1, rsched.plan_for(step))])
    if sched.is_constant():
        assert _sig(rsegment_resolved(rsched).cache_sig()) == segment_resolved(sched).cache_sig()
    else:
        for fn, s in ((segment_resolved, sched), (rsegment_resolved, rsched)):
            with pytest.raises(TypeError):
                fn(s)
    # a re-split of the same per-step behavior normalizes to the same schedule
    resplit = [(s, s + 1, sched.plan_for(s).replace()) for s in range(steps)]
    again = PlanSchedule(sched.base, [
        (a, b, {f: getattr(p, f) for f in SEGMENT_FIELDS}) for a, b, p in resplit])
    assert again.normalized() == norm


def test_loop_and_recovery_fields_delegate_to_the_base():
    base = DittoPlan(steps=8, sampler="plms", policy="diff", max_batch=2, watchdog=True,
                     reanchor_full_frac=0.9)
    sched = PlanSchedule(base, [(0, 4, {}), (4, 8, dict(low_bits=4))])
    for f in ("steps", "sampler", "policy", "compiled", "max_batch", "collect_stats",
              "watchdog", "reanchor_full_frac"):
        assert getattr(sched, f) == getattr(base, f), f


# ---------------------------------------------------------- the segment swap
@pytest.fixture(scope="module")
def setup():
    g = torch.Generator().manual_seed(0)
    params = dit.init(g, CFG, device="cpu")
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=g)
    x = torch.randn((2, 8, 8, 4), generator=g)
    return params, diffusion.cosine_schedule(100), x


def _trajectory(params, noise, x, plan, cache):
    """Per-step denoise outputs and the final sample of one trajectory."""
    eng = DittoEngine(policy=plan.policy, device="cpu")
    fn = dit_runner.make_denoise_fn(params, CFG, eng, plan, runner_cache=cache,
                                    bucket=x.shape[0], device="cpu")
    outs = []

    def probe(z, t, labels):
        y = fn(z, t, labels)
        outs.append(y.clone())
        return y

    eng.begin_sample()
    sample = diffusion.SAMPLERS[plan.sampler](noise, probe, x, steps=plan.steps, labels=None)
    return outs, sample


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
@pytest.mark.parametrize("segments", [
    [(0, 1, {}), (1, 4, {"low_bits": 4})],
    [(0, 2, {}), (2, 4, {"low_bits": 4})],
    [(0, 3, {}), (3, 4, {"low_bits": 4, "fused": True})],
    [(0, 1, {}), (1, 2, {"low_bits": 4}), (2, 4, {})],
], ids=["k1", "k2", "k3", "one-step"])
def test_boundary_bit_identity_at_every_step(setup, segments, cached):
    """At every step, a schedule's outputs equal the matching constant
    plan's run from the same state (int8, packed-int4 and fused are
    mutually bit-exact); the cached run builds one runner per distinct
    segment sig."""
    params, noise, x = setup
    base = DittoPlan(steps=4, policy="diff", max_batch=4, collect_stats=False)
    cache = CompiledRunnerCache() if cached else None
    ref_outs, ref_sample = _trajectory(params, noise, x, base, cache)
    schedule = PlanSchedule(base, segments)
    outs, sample = _trajectory(params, noise, x, schedule, cache)
    assert len(outs) == len(ref_outs) == 4
    for step, (got, ref) in enumerate(zip(outs, ref_outs)):
        assert torch.equal(got, ref), f"step {step}"
    assert torch.equal(sample, ref_sample)
    if cached:
        assert len(cache) == len({base.cache_sig(), *schedule.cache_sigs()})
        assert all(c == 1 for c in cache.capture_counts.values())
