"""The port's design-point pass (``sim/harness.py:collect_records``,
``run_designs``, ``run_all`` over ``sim/cycles.py``) vs the reference.

Both packages run one exact eager pass over the same bridged weights and
x_T (numpy, seeded), then price its records on every design point. The
records' class fractions agree to 1e-3 (see ``test_torch_slice.py``: the
fp32 glue accumulates in another order, and one flipped int8 rounding moves
a fraction by 1/numel), and the prices are linear in them, so cycles, time,
energy and bytes are compared to a relative 1e-3; the modes each design
picks, and the record keys, exactly. ``cycles`` itself is fed the
reference's own records, where it must agree to float rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import diffusion as rdiffusion  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import dit as rdit  # noqa: E402
from repro.sim import cycles as rcycles  # noqa: E402
from repro.sim import harness as rharness  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.sim import cycles, harness  # noqa: E402

CFG_KW = dict(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
              n_classes=4)
STEPS = 4
SCALES = [dict(), dict(t_mult=2.0, d_mult=3.0, seq_mult=1.5)]
NUMBERS = ("cycles", "time_s", "energy_j", "mem_bytes", "compute_cycles", "mem_stall_cycles")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both_runs():
    """run_all of each package on the same inputs (adaLN ``mod`` weights
    refilled N(0, 0.02) so the blocks reach the sample)."""
    cfg = rdit.DiTCfg(**CFG_KW)
    tree = jax.tree.map(lambda p: np.asarray(p.value), rdit.init(jax.random.PRNGKey(1), cfg),
                        is_leaf=rcore.is_param)
    rng = np.random.default_rng(1)
    w = tree["blocks"]["mod"]["w"]
    tree["blocks"]["mod"]["w"] = (rng.standard_normal(w.shape) * 0.02).astype(np.float32)
    x_T = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    labels = np.array([1, 2], np.int32)
    want = rharness.run_all(jax.tree.map(jnp.asarray, tree), cfg, rdiffusion.linear_schedule(1000),
                            jnp.asarray(x_T), jnp.asarray(labels), steps=STEPS)
    got = harness.run_all(bridge.params_from_numpy(tree, device="cpu"), dit.DiTCfg(**CFG_KW),
                          diffusion.linear_schedule(1000), torch.from_numpy(x_T),
                          torch.from_numpy(labels), steps=STEPS, device="cpu")
    return got, want


def _close(a, b, rtol):
    np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=0)


@pytest.mark.parametrize("scale", range(len(SCALES)))
def test_run_designs_matches_reference(both_runs, scale):
    got_all, want_all = both_runs
    got = harness.run_designs(got_all["records"], **SCALES[scale])
    want = rharness.run_designs(want_all["records"], **SCALES[scale])
    assert got.keys() == want.keys() == set(harness.DESIGN_HW) | {"gpu-a100"}
    for name in harness.DESIGN_HW:
        assert got[name]["hw"] == want[name]["hw"]
        assert got[name]["modes"] == want[name]["modes"]
        for key in NUMBERS:
            _close(got[name][key], want[name][key], 1e-3)
    for key in ("time_s", "energy_j", "cycles"):
        _close(got["gpu-a100"][key], want["gpu-a100"][key], 1e-3)


def test_run_all_and_records_match_reference(both_runs):
    got, want = both_runs
    rsample = np.asarray(want["ditto"]["sample"])
    np.testing.assert_allclose(got["ditto"]["sample"].numpy(), rsample, rtol=0,
                               atol=1e-5 * np.abs(rsample).max())
    key = lambda r: (r["layer"], r["step"])  # noqa: E731
    assert sorted(map(key, got["records"])) == sorted(map(key, want["records"]))
    rby = {key(r): r for r in want["records"]}
    for r in got["records"]:
        assert r.keys() == rby[key(r)].keys()
    assert harness.GPU_TOPS == rharness.GPU_TOPS and harness.GPU_BW == rharness.GPU_BW


def test_cycles_prices_reference_records_identically(both_runs):
    """Fed the same records, the port's cost model is the reference's."""
    recs = rcycles.scale_records(both_runs[1]["records"], t_mult=2.0, d_mult=1.5)
    assert cycles.scale_records(both_runs[1]["records"], t_mult=2.0, d_mult=1.5) == recs
    for name, hw in harness.DESIGN_HW.items():
        fn, rfn = cycles.mode_fn_for(name, recs, hw), rcycles.mode_fn_for(name, recs, hw)
        got, want = cycles.simulate(recs, hw, fn), rcycles.simulate(recs, hw, rfn)
        assert got["modes"] == want["modes"]
        for k in NUMBERS:
            _close(got[k], want[k], 1e-12)
    assert cycles.oracle_modes(recs, harness.DESIGN_HW["ditto"], plus=True) == \
        rcycles.oracle_modes(recs, harness.DESIGN_HW["ditto"], plus=True)
