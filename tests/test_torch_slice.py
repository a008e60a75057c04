"""The port's main path end to end: serve_records vs the reference.

Both packages serve the same bridged weights and the same x_T (numpy,
seeded) through 5 DDIM steps. Samples agree to a tolerance: the fp32 glue
(matmuls, LayerNorm, softmax) accumulates in another order in XLA and in
PyTorch, and a one-ulp difference can flip an int8 rounding that then
propagates. Integer records — each (layer, step)'s mode and measured
tile-class histogram — are compared exactly. Inside the port, the kernel
pass must equal the eager-only pass bit for bit. Also here: the port
imports neither JAX nor the JAX package, and its entry points refuse to
fall back to the CPU when no card is present.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import diffusion as rdiffusion  # noqa: E402
from repro.core.ditto import DittoPlan as RDittoPlan  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import dit as rdit  # noqa: E402
from repro.sim import harness as rharness  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoEngine, DittoPlan, make_denoise_fn  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.sim import harness  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG_KW = dict(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
              n_classes=4)
STEPS = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    """Reference init as numpy (adaLN ``mod`` weights refilled with
    N(0, 0.02) so the blocks reach the sample), seeded x_T and labels."""
    cfg = rdit.DiTCfg(**CFG_KW)
    tree = jax.tree.map(lambda p: np.asarray(p.value), rdit.init(jax.random.PRNGKey(0), cfg),
                        is_leaf=rcore.is_param)
    rng = np.random.default_rng(0)
    w = tree["blocks"]["mod"]["w"]
    tree["blocks"]["mod"]["w"] = (rng.standard_normal(w.shape) * 0.02).astype(np.float32)
    x_T = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    labels = np.array([0, 3], np.int32)
    return tree, x_T, labels


def _serve_port(inputs, plan):
    tree, x_T, labels = inputs
    return harness.serve_records(bridge.params_from_numpy(tree, device="cpu"),
                                 dit.DiTCfg(**CFG_KW), diffusion.linear_schedule(1000),
                                 torch.from_numpy(x_T), torch.from_numpy(labels), plan,
                                 device="cpu")


def _int_records(records):
    return {(r["layer"], r["step"]): (r["mode"], r.get("tile_hist")) for r in records}


# (policy, kernel knobs): the two-pass flow, its packed-int4 branch and the
# fused flow
PLANS = [pytest.param("diff", {}, id="diff"), pytest.param("defo", {}, id="defo"),
         pytest.param("diff", dict(low_bits=4), id="diff-low_bits4"),
         pytest.param("defo", dict(fused=True, low_bits=4), id="defo-fused-low_bits4")]


@pytest.mark.parametrize("policy,knobs", PLANS)
def test_serve_records_matches_reference(inputs, policy, knobs):
    """Sample to 1e-5 of its scale (fp32 glue order, see module doc);
    modes and tile histograms exactly; float records to 1e-3 (one flipped
    int8 rounding moves a class fraction by 1/numel)."""
    tree, x_T, labels = inputs
    rrecs, rsample, _ = rharness.serve_records(
        jax.tree.map(jnp.asarray, tree), rdit.DiTCfg(**CFG_KW), rdiffusion.linear_schedule(1000),
        jnp.asarray(x_T), jnp.asarray(labels), RDittoPlan(steps=STEPS, policy=policy, **knobs))
    recs, sample, eng = _serve_port(inputs, DittoPlan(steps=STEPS, policy=policy, **knobs))
    rsample = np.asarray(rsample)
    np.testing.assert_allclose(sample.numpy(), rsample, rtol=0,
                               atol=1e-5 * np.abs(rsample).max())
    assert _int_records(recs) == _int_records(rrecs)
    if policy == "diff":  # the diff kernels ran on every compiled step
        assert sum(1 for r in recs if "tile_hist" in r) == 19 * (STEPS - 1)
    rbykey = {(r["layer"], r["step"]): r for r in rrecs}
    for r in recs:
        want = rbykey[(r["layer"], r["step"])]
        assert r.keys() == want.keys()
        for key in ("cls_act", "cls_diff"):
            if key in r:
                np.testing.assert_allclose(r[key], want[key], rtol=0, atol=1e-3)
    assert eng.summary()["steps"] == STEPS


@pytest.mark.parametrize("policy,knobs", [pytest.param("act", {}, id="act")] + PLANS + [
    pytest.param("diff", dict(fused=True), id="diff-fused")])
def test_compiled_equals_eager_sample(inputs, policy, knobs):
    """The kernel pass reproduces the eager-only pass bit for bit: same fp32
    glue, and the int32 products are exact in both, in every flow."""
    _, s_compiled, _ = _serve_port(inputs, DittoPlan(steps=STEPS, policy=policy, **knobs))
    _, s_eager, eng = _serve_port(inputs, DittoPlan(steps=STEPS, policy=policy, compiled=False))
    assert torch.equal(s_compiled, s_eager)
    assert torch.isfinite(s_compiled).all()


def test_plms_sampler_serves(inputs):
    recs, sample, _ = _serve_port(inputs, DittoPlan(steps=STEPS, policy="diff", sampler="plms"))
    assert sample.shape == (2, 8, 8, 4) and torch.isfinite(sample).all()
    assert {r["step"] for r in recs} == set(range(STEPS))


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "serve_diffusion_torch.py"] + sorted(
        (ROOT / "benchmarks").glob("torch_*.py"))
    assert len(files) >= 44
    for module in ("session.py", "scheduler.py"):
        assert ROOT / "src" / "repro_torch" / "serve" / module in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "flax"), f"{path}: imports {name}"


def test_entry_points_need_a_card_unless_cpu(inputs, monkeypatch):
    """No silent CPU fallback: without a card every entry point raises
    unless the caller asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree, x_T, labels = inputs
    cfg = dit.DiTCfg(**CFG_KW)
    params = bridge.params_from_numpy(tree, device="cpu")
    for call in (lambda d: DittoEngine(device=d),
                 lambda d: dit.init(torch.Generator().manual_seed(0), cfg, device=d),
                 lambda d: bridge.params_from_numpy(tree, device=d),
                 lambda d: make_denoise_fn(params, cfg, DittoEngine(device="cpu"), device=d),
                 lambda d: harness.serve_records(params, cfg, diffusion.linear_schedule(1000),
                                                 torch.from_numpy(x_T), None, DittoPlan(steps=1),
                                                 device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        call("cpu")
    with pytest.raises(TypeError):
        make_denoise_fn(params, cfg, DittoEngine(device="cpu"), "not a plan", device="cpu")
