"""Port engine, quantization, DiT glue and plan vs the JAX reference.

Integer results are held to the reference bit for bit: q-tensors, scales,
int32 accumulators, class fractions, records and Defo's mode decisions. A
layer given the reference's own fp32 input must reproduce its int32
output exactly. The fp32 glue (``nn/dit.apply``, schedules) is compared
to a tolerance, stated with each test: the two frameworks accumulate fp32
matmuls and reductions in different orders. Inside the port, the compiled
(kernel) pass must equal the eager pass bit for bit. Inputs come from
numpy with a seed and are fed to both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.core import diffusion as rdiffusion  # noqa: E402
from repro.core.ditto import DittoEngine as RDittoEngine  # noqa: E402
from repro.core.ditto import DittoPlan as RDittoPlan  # noqa: E402
from repro.core.ditto import LayerMeta as RLayerMeta  # noqa: E402
from repro.core.ditto import bops as rbops  # noqa: E402
from repro.core.ditto import classify as rclassify  # noqa: E402
from repro.core.ditto import defo as rdefo  # noqa: E402
from repro.core.ditto import quant as rquant  # noqa: E402
from repro.launch.steps import make_dit_model  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import dit as rdit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoEngine, DittoPlan, LayerMeta  # noqa: E402
from repro_torch.core.ditto import bops, classify, defo, quant  # noqa: E402
from repro_torch.core.ditto.compiled import CompiledDittoEngine  # noqa: E402
from repro_torch.core.ditto.engine import class_fractions  # noqa: E402
from repro_torch.nn import core as ncore  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.tree import map_tree  # noqa: E402

CFG_KW = dict(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
              n_classes=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _ref_tree(seed, cfg):
    """Reference init as numpy, with every adaLN ``mod`` weight refilled
    with N(0, 0.02) so the blocks reach the output (adaLN-Zero zeroes it)."""
    tree = jax.tree.map(lambda p: np.asarray(p.value), rdit.init(jax.random.PRNGKey(seed), cfg),
                        is_leaf=rcore.is_param)
    w = tree["blocks"]["mod"]["w"]
    tree["blocks"]["mod"]["w"] = (np.random.default_rng(seed).standard_normal(w.shape)
                                  * 0.02).astype(np.float32)
    return tree


# ------------------------------------------------------------------ quant
def test_quant_bitexact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 6, 40)) * 3).astype(np.float32)
    s = rquant.compute_scale(jnp.asarray(x))
    x[0, 0, :8] = (np.arange(8) + 0.5) * np.float32(s)  # round-half-even ties
    for axis in (None, 0, 2):
        _eq(quant.compute_scale(_t(x), axis=axis), rquant.compute_scale(jnp.asarray(x), axis=axis))
    for n in (1, 2, 4):
        _eq(quant.sample_scale(_t(x), n), rquant.sample_scale(jnp.asarray(x), n))
    with pytest.raises(ValueError):
        quant.sample_scale(_t(x), 3)
    sc = quant.sample_scale(_t(x), 4)
    _eq(quant.quantize(_t(x), sc), rquant.quantize(jnp.asarray(x), jnp.asarray(sc.numpy())))
    w = rng.standard_normal((40, 24)).astype(np.float32)
    qw, rqw = quant.quantize_weight(_t(w)), rquant.quantize_weight(jnp.asarray(w))
    _eq(qw.q, rqw.q)
    _eq(qw.scale, rqw.scale)
    d = rng.integers(-254, 255, size=(6, 40)).astype(np.int16)
    _eq(quant.int_matmul(_t(d), qw.q), rquant.int_matmul(jnp.asarray(d), rqw.q))


def test_classify_and_bops_bitexact():
    rng = np.random.default_rng(1)
    d = rng.choice([0, 0, 0, 1, -3, 7, -7, 8, -8, 100, -254], size=(256, 384)).astype(np.int16)
    pc, rc = classify.element_classes(_t(d)), rclassify.element_classes(jnp.asarray(d))
    for key in pc:
        _eq(pc[key], rc[key])
    _eq(classify.bitwidth_requirement(_t(d)), rclassify.bitwidth_requirement(jnp.asarray(d)))
    pt, rt = classify.tile_classes(_t(d)), rclassify.tile_classes(jnp.asarray(d))
    for key in pt:
        _eq(pt[key], rt[key])
    for axis in (0, -1):
        _eq(classify.spatial_diff(_t(d), axis=axis), rclassify.spatial_diff(jnp.asarray(d), axis=axis))
    assert bops.bops_elementwise(_t(d), 3.0) == rbops.bops_elementwise(jnp.asarray(d), 3.0)
    for hist in ((0, 0, 0), (5, 2, 9)):
        assert bops.tile_fractions(hist) == rbops.tile_fractions(hist)
        assert bops.bops_tile_mix(1e6, hist) == rbops.bops_tile_mix(1e6, hist)


def test_defo_graph_analysis_matches_reference():
    for graph, rgraph in ((defo.dit_graph(3), rdefo.dit_graph(3)),
                          (defo.ddpm_tiny_graph(2), rdefo.ddpm_tiny_graph(2))):
        got = {k: dataclasses.asdict(v) for k, v in defo.analyze(graph).items()}
        want = {k: dataclasses.asdict(v) for k, v in rdefo.analyze(rgraph).items()}
        assert got == want


# ----------------------------------------------------------------- engine
def _records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            assert g[key] == w[key], (g["layer"], g["step"], key, g[key], w[key])


def _drive_both(policy, layers, steps, collect_oracle=False):
    """Run one port and one reference engine over the same fp32 inputs.
    ``layers``: name -> (t, k, n, drift) dense layers; attention layers
    are named 'attn*' -> (b, m, n, d, drift)."""
    rng = np.random.default_rng(11)
    eng = DittoEngine(policy, collect_oracle=collect_oracle, device="cpu")
    reng = RDittoEngine(policy, collect_oracle=collect_oracle)
    inputs = {}
    for name, spec in layers.items():
        if name.startswith("attn"):
            eng.register_attention(LayerMeta(name, kind="attn_qk"))
            reng.register_attention(RLayerMeta(name, kind="attn_qk"))
            b, m, n, d, _ = spec
            inputs[name] = (rng.standard_normal((b, m, d)), rng.standard_normal((b, n, d)))
        else:
            t, k, n, _ = spec
            w = rng.standard_normal((k, n)).astype(np.float32)
            bias = rng.standard_normal(n).astype(np.float32)
            eng.register_linear(LayerMeta(name), _t(w), _t(bias))
            reng.register_linear(RLayerMeta(name), w, jnp.asarray(bias))
            inputs[name] = (rng.standard_normal((t, k)),)
    eng.begin_sample()
    reng.begin_sample()
    for _ in range(steps):
        for name, xs in inputs.items():
            xs32 = [x.astype(np.float32) for x in xs]
            if name.startswith("attn"):
                y = eng.attention_matmul(name, *(_t(x) for x in xs32))
                ry = reng.attention_matmul(name, *(jnp.asarray(x) for x in xs32))
            else:
                y = eng.linear(name, _t(xs32[0]))
                ry = reng.linear(name, jnp.asarray(xs32[0]))
            _eq(y, ry)  # same int32 accumulator and scales -> same fp32 out
            _eq(eng.layers[name].y_prev, reng.layers[name].y_prev)
            drift = layers[name][-1]
            inputs[name] = tuple(x + drift * rng.standard_normal(x.shape) for x in xs)
        eng.end_step()
        reng.end_step()
    return eng, reng


@pytest.mark.parametrize("policy", ["act", "diff", "spatial", "defo+"])
def test_engine_layers_match_reference_int32_and_records(policy):
    layers = {"a": (13, 40, 24, 0.05), "b": (130, 200, 96, 0.5),
              "attn0": (3, 10, 12, 16, 0.1)}
    eng, reng = _drive_both(policy, layers, steps=3, collect_oracle=True)
    _records_equal(eng.records, reng.records)


def test_defo_modes_match_reference():
    """A compute-bound layer with small Δs goes diff, a memory-bound one
    stays act; both engines decide alike (same fractions, same float
    cycle comparison)."""
    layers = {"big": (2048, 128, 256, 0.002), "small": (16, 64, 32, 1.0),
              "attn0": (2, 16, 16, 8, 0.01)}
    eng, reng = _drive_both("defo", layers, steps=3)
    modes = {n: st.mode for n, st in eng.layers.items()}
    assert modes == {n: st.mode for n, st in reng.layers.items()}
    assert modes["big"] == "diff" and modes["small"] == "act"
    _records_equal(eng.records, reng.records)
    assert eng.compiled_modes() == {n: m for n, m in modes.items()}


LINEAR_SHAPES = [(13, 40, 24), (130, 200, 96), (64, 129, 130)]


@pytest.mark.parametrize("t,k,n", LINEAR_SHAPES)
@pytest.mark.parametrize("policy", ["act", "diff"])
def test_compiled_linear_equals_eager(policy, t, k, n):
    """Kernel pass (plain versions on the CPU) == eager engine, int32."""
    g = torch.Generator().manual_seed(t + k + n)
    eng = DittoEngine(policy=policy, device="cpu")
    eng.register_linear(LayerMeta("l"), torch.randn(k, n, generator=g))
    eng.begin_sample()
    for _ in range(2):
        eng.linear("l", torch.randn(t, k, generator=g))
        eng.end_step()
    ceng = CompiledDittoEngine(eng)
    st = ceng.init_state()["l"]
    x = torch.randn(t, k, generator=g)
    y_eager = eng.linear("l", x)
    y, st2, aux = ceng.linear("l", x, st)
    _eq(eng.layers["l"].y_prev, st2["y_prev"])
    _eq(eng.layers["l"].x_prev, st2["x_prev"])
    _eq(y, y_eager)
    assert ("tile_hist" in aux) == (policy == "diff")
    assert class_fractions(aux["cls_act"].tolist())[0].item() == eng.records[-1]["cls_act"][0]


@pytest.mark.parametrize("b,m,d,n", [(3, 10, 16, 12), (2, 128, 64, 130)])
@pytest.mark.parametrize("policy", ["act", "diff"])
def test_compiled_attention_equals_eager(policy, b, m, d, n):
    g = torch.Generator().manual_seed(b + m + d + n)
    eng = DittoEngine(policy=policy, device="cpu")
    eng.register_attention(LayerMeta("qk", kind="attn_qk"))
    eng.begin_sample()
    for _ in range(2):
        eng.attention_matmul("qk", torch.randn(b, m, d, generator=g), torch.randn(b, n, d, generator=g))
        eng.end_step()
    ceng = CompiledDittoEngine(eng)
    st = ceng.init_state()["qk"]
    a, bb = torch.randn(b, m, d, generator=g), torch.randn(b, n, d, generator=g)
    y_eager = eng.attention_matmul("qk", a, bb)
    y, st2, _ = ceng.attention_matmul("qk", a, bb, st)
    _eq(eng.layers["qk"].y_prev, st2["y_prev"])
    _eq(y, y_eager)


def test_compiled_requires_calibration():
    eng = DittoEngine(policy="defo", device="cpu")
    eng.register_linear(LayerMeta("l"), torch.zeros(4, 4))
    eng.begin_sample()
    eng.linear("l", torch.ones(2, 4))
    eng.end_step()
    with pytest.raises(ValueError):  # defo decides after step 2
        CompiledDittoEngine(eng)
    eng2 = DittoEngine(policy="act", device="cpu")
    eng2.begin_sample()
    with pytest.raises(ValueError):  # no steps at all
        CompiledDittoEngine(eng2)


# ------------------------------------------------------------ fp32 glue
def test_dit_apply_matches_reference_fp32():
    """fp32 oracle on bridged weights. Tolerance 1e-4 relative to the
    output's scale: same math, fp32 matmuls and reductions accumulated in
    another order by XLA and by PyTorch."""
    cfg = rdit.DiTCfg(**CFG_KW)
    tree = _ref_tree(0, cfg)
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([900, 17], np.int32)
    labels = np.array([0, 3], np.int32)
    want = np.asarray(rdit.apply(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(lat),
                                 jnp.asarray(t), jnp.asarray(labels)))
    got = dit.apply(bridge.params_from_numpy(tree, device="cpu"), dit.DiTCfg(**CFG_KW),
                    _t(lat), _t(t), _t(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # a Param-tagged tree applies the same
    tagged = map_tree(lambda a: ncore.Param(a, ()), bridge.params_from_numpy(tree, device="cpu"))
    _eq(dit.apply(tagged, dit.DiTCfg(**CFG_KW), _t(lat), _t(t), _t(labels)), got)


def test_glue_traps_match_reference():
    """The three numerics traps of the reference's glue: [cos, sin] order,
    population variance in _ln, tanh-form GELU. Tolerances are a few fp32
    ulps of the compared values (different transcendental libraries)."""
    t = np.array([0, 1, 17, 999], np.int32)
    np.testing.assert_allclose(dit.timestep_embedding(_t(t), 256).numpy(),
                               np.asarray(rdit.timestep_embedding(jnp.asarray(t), 256)),
                               rtol=0, atol=2e-6 * 999)
    x = np.random.default_rng(4).standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(dit._ln(_t(x)).numpy(), np.asarray(rdit._ln(jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ncore.ACTIVATIONS["gelu"](_t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_schedules_and_timesteps_match_reference():
    """Timesteps exactly; alpha_bars to a few fp32 ulps (linspace, cos and
    cumprod are evaluated differently by the two frameworks). Cosine betas
    are not compared elementwise: near t = 0 they are 1 - a ratio of
    nearly equal cosines, where one ulp of a cosine is a large relative
    change of the beta."""
    for T, steps in ((1000, 20), (1000, 7), (100, 5), (10, 50)):
        assert diffusion.ddim_timesteps(T, steps) == [int(v) for v in rdiffusion.ddim_timesteps(T, steps)]
    np.testing.assert_allclose(diffusion.linear_schedule(1000).betas.numpy(),
                               np.asarray(rdiffusion.linear_schedule(1000).betas), rtol=2.5e-7)
    for make, rmake in ((diffusion.linear_schedule, rdiffusion.linear_schedule),
                        (diffusion.cosine_schedule, rdiffusion.cosine_schedule)):
        np.testing.assert_allclose(make(1000).alpha_bars.numpy(),
                                   np.asarray(rmake(1000).alpha_bars), rtol=2e-6, atol=0)
    rng = np.random.default_rng(5)
    x, eps = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    s, rs = diffusion.linear_schedule(1000), rdiffusion.linear_schedule(1000)
    for t, tp in ((950, 900), (50, -1)):
        np.testing.assert_allclose(
            diffusion.ddim_step(s, _t(x), _t(eps), t, tp).numpy(),
            np.asarray(rdiffusion.ddim_step(rs, jnp.asarray(x), jnp.asarray(eps), t, tp)),
            rtol=1e-5, atol=1e-5)


def test_plms_matches_reference_on_a_fixed_denoiser():
    """PLMS history weights, on a linear stand-in denoiser: same
    tolerance reasoning as the schedules."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    s, rs = diffusion.cosine_schedule(100), rdiffusion.cosine_schedule(100)
    got = diffusion.plms_sample(s, lambda z, t, lab: 0.1 * z, _t(x), steps=6)
    want = rdiffusion.plms_sample(rs, lambda z, t, lab: 0.1 * z, jnp.asarray(x), steps=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_dit_xl2_matches_reference_config():
    want = make_dit_model(rconfigs.get("dit-xl2"))
    assert dataclasses.asdict(dit.DIT_XL2) == dataclasses.asdict(want)
    assert (dit.DIT_XL2.head_dim, dit.DIT_XL2.n_tokens) == (72, 256)


def test_init_shapes_match_reference():
    cfg = dit.DiTCfg(**CFG_KW)
    got = dit.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = _ref_tree(0, rdit.DiTCfg(**CFG_KW))
    shapes = map_tree(lambda a: tuple(a.shape), got)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), want)
    assert not got["blocks"]["mod"]["w"].any()  # adaLN-Zero
    w = got["blocks"]["attn"]["wq"]["w"]
    assert abs(float(w.std()) * 8 - 1) < 0.1  # lecun: std 1/sqrt(fan_in=64)


# ------------------------------------------------------------------- plan
def test_plan_mirrors_reference():
    p, rp = DittoPlan(), RDittoPlan()
    for f in dataclasses.fields(DittoPlan):
        assert getattr(p, f.name) == getattr(rp, f.name), f.name
    assert p.cache_sig() == (rp.block, rp.collect_stats, rp.low_bits, rp.fused, rp.mesh_sig())
    assert p.replace(low_bits=4).cache_sig() != p.cache_sig()
    assert p.replace(steps=7).cache_sig() == p.cache_sig()
    for bad in (dict(low_bits=2), dict(block=0), dict(steps=0), dict(max_batch=6),
                dict(sampler="euler"), dict(policy="x")):
        with pytest.raises(ValueError):
            RDittoPlan(**bad)
        with pytest.raises(ValueError):
            DittoPlan(**bad)
