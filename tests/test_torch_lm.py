"""The port's LM substrate (serving path, dense stack) against the reference,
on the CPU.

Both packages get the same numpy inputs; the port's params come from the
reference's ``LM.init`` tree through ``bridge.params_from_numpy``. The
configs are the reference's ``smoke()`` variants (2 layers, d = 64,
float32). Tolerances, with their reasons:

* configs, shapes, cell applicability, embedding gathers and the cache
  layout: exact;
* elementwise float32 ops (norms, activations, RoPE inside attention):
  XLA and PyTorch may differ in the last ulp of ``rsqrt`` / ``tanh`` /
  ``exp``: max-abs difference <= 1e-6 of the reference's max-abs;
* anything with a float32 product or a softmax (MLPs, attention, logits,
  the whole LM, caches): XLA and PyTorch sum in other orders: max-abs
  difference <= 1e-5 of the reference's max-abs (``REL``);
* the reference's own identities inside the port keep the reference
  test's tolerance (decode vs forward 2e-3 relative; prefill vs forward
  rtol = atol = 2e-4; chunked vs full attention 1e-5).

Also here: the port's two deliberate divergences (the decode cache is
written in place; a position at or past the cache length raises), the
diffusion family refused by ``LM``, and the new modules import neither
JAX nor the JAX package. The recurrent families (``ssm``, ``hybrid``) are
held to the reference in ``tests/test_torch_recurrent.py``.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.nn import attention as rattn  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import embedding as rembed  # noqa: E402
from repro.nn import mlp as rmlp  # noqa: E402
from repro_torch import bridge, configs, tree  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.lm import _pad_vocab  # noqa: E402
from repro_torch.nn import attention, core, embedding, mlp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-5  # float32 products / softmax, CPU against CPU
ELEM = 1e-6  # float32 elementwise ops
DENSE_STACK = [n for n in rconfigs.names()
               if rconfigs.get(n).family in ("dense", "vlm", "audio")]
LM_ARCHS = ["qwen3-0.6b", "smollm-360m", "musicgen-medium", "internvl2-2b", "command-r-35b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


def t_(a):
    return torch.from_numpy(np.array(a, copy=True))


def numpy_tree(ptree):
    return jax.tree.map(lambda p: np.asarray(p.value), ptree, is_leaf=rcore.is_param)


def both(ptree):
    """A reference Param tree as (jnp values, the port's CPU tensors)."""
    nt = numpy_tree(ptree)
    return jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", rconfigs.names())
def test_config_matches_reference(name):
    ref, port = rconfigs.get(name), configs.get(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.smoke()) == dataclasses.asdict(ref.smoke())
    assert port.n_params() == ref.n_params()
    assert port.n_active_params() == ref.n_active_params()
    assert port.smoke().n_params() == ref.smoke().n_params()
    assert port.smoke().n_active_params() == ref.smoke().n_active_params()
    assert port.resolved_head_dim == ref.resolved_head_dim
    for shape in rconfigs.SHAPES:
        assert (configs.cell_applicable(port, configs.SHAPES[shape])
                == rconfigs.cell_applicable(ref, rconfigs.SHAPES[shape]))


def test_registry_and_shapes_match_reference():
    from repro.configs import base as rbase
    from repro_torch.configs import base

    assert configs.names() == rconfigs.names() and len(configs.names()) == 11
    assert configs.ASSIGNED == rconfigs.ASSIGNED and len(configs.ASSIGNED) == 10
    assert base.FAMILIES == rbase.FAMILIES
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(configs.ArchConfig)] == [
        f.name for f in dataclasses.fields(rconfigs.ArchConfig)]
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-2")
    assert _pad_vocab(151936) == 152064 and _pad_vocab(122753) == 122880


# ------------------------------------------------------------- norms, acts
def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    got = core.rmsnorm({"scale": t_(scale)}, t_(x))
    assert rel_err(got, rcore.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))) <= ELEM
    for p in ({"scale": scale}, {"scale": scale, "b": b}):
        got = core.layernorm({k: t_(v) for k, v in p.items()}, t_(x))
        want = rcore.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        assert rel_err(got, want) <= ELEM
    # init: ones (and zeros), the dims the reference gives; eps as the reference's
    assert core.rmsnorm_init(8)["scale"].tolist() == [1.0] * 8
    ln = core.layernorm_init(8)
    assert ln["scale"].tolist() == [1.0] * 8 and ln["b"].tolist() == [0.0] * 8
    assert "b" not in core.layernorm_init(8, bias=False)
    # bfloat16 in, bfloat16 out, float32 inside
    xb = t_(x).to(torch.bfloat16)
    assert core.rmsnorm({"scale": t_(scale)}, xb).dtype == torch.bfloat16
    assert core.layernorm({"scale": t_(scale)}, xb).dtype == torch.bfloat16


def test_activations_match_reference():
    x = np.random.default_rng(1).standard_normal((3, 40)).astype(np.float32) * 4
    assert set(core.ACTIVATIONS) == set(rcore.ACTIVATIONS)
    for name, fn in core.ACTIVATIONS.items():
        assert rel_err(fn(t_(x)), rcore.ACTIVATIONS[name](jnp.asarray(x))) <= ELEM, name


# ---------------------------------------------------------------- embedding
def test_embedding_and_logits_match_reference():
    key = jax.random.PRNGKey(3)
    remb, emb = both(rembed.embed_init(key, 300, 64))
    rhead, head = both(rembed.head_init(jax.random.fold_in(key, 1), 64, 300))
    tokens = np.random.default_rng(2).integers(0, 300, (2, 7)).astype(np.int32)
    got = embedding.embed(emb, t_(tokens))
    want = rembed.embed(remb, jnp.asarray(tokens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # a gather: exact
    np.testing.assert_array_equal(embedding.embed(emb, t_(tokens), scale=2.0).numpy(),
                                  np.asarray(rembed.embed(remb, jnp.asarray(tokens), scale=2.0)))
    x = np.random.default_rng(3).standard_normal((2, 7, 64)).astype(np.float32)
    assert rel_err(embedding.logits(head, t_(x)), rembed.logits(rhead, jnp.asarray(x))) <= REL
    assert rel_err(embedding.logits(None, t_(x), tied_table=emb["table"]),
                   rembed.logits(None, jnp.asarray(x), tied_table=remb["table"])) <= REL
    g = torch.Generator().manual_seed(0)
    assert embedding.embed_init(g, 300, 64)["table"].shape == (300, 64)
    assert embedding.head_init(g, 64, 300)["w"].shape == (64, 300)


# ---------------------------------------------------------------------- mlp
@pytest.mark.parametrize("act,bias", [("swiglu", False), ("geglu", False), ("gelu", True),
                                      ("swiglu", True)])
def test_mlp_matches_reference(act, bias):
    rcfg = rmlp.MlpCfg(64, 96, act=act, bias=bias)
    rp, p = both(rmlp.init(jax.random.PRNGKey(4), rcfg))
    if bias:  # the reference inits biases at zero: make them count
        rp, p = _refill_biases(rp, p)
    x = np.random.default_rng(4).standard_normal((2, 5, 64)).astype(np.float32)
    cfg = mlp.MlpCfg(64, 96, act=act, bias=bias)
    assert rel_err(mlp.apply(p, cfg, t_(x)), rmlp.apply(rp, rcfg, jnp.asarray(x))) <= REL
    port = mlp.init(torch.Generator().manual_seed(0), cfg)
    assert [(k, v.shape) for k, v in tree.paths(port)] == [
        (k, tuple(v.shape)) for k, v in tree.paths(p)]


def _refill_biases(rp, p, seed=9):
    """Both trees with every bias leaf ``b`` refilled N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    nt = jax.tree.map(np.asarray, rp)

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "b":
                t[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
    walk(nt)
    return jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")


# ---------------------------------------------------------------- attention
ATTN_CASES = {
    "causal": dict(),
    "gqa4": dict(n_heads=8, n_kv_heads=2),
    "qk_norm": dict(qk_norm=True, n_heads=4, n_kv_heads=2, rope_theta=1e6),
    "windowed": dict(window=5),
    "biased": dict(bias=True),
    "bidirectional": dict(causal=False),
    "bidirectional_windowed": dict(causal=False, window=3),
}


def _attn_pair(case, seed=5):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16)
    kw.update(ATTN_CASES[case])
    rcfg, cfg = rattn.AttentionCfg(**kw), attention.AttentionCfg(**kw)
    rp, p = both(rattn.init(jax.random.PRNGKey(seed), rcfg))
    if kw.get("bias"):
        rp, p = _refill_biases(rp, p)
    if kw.get("qk_norm"):  # the reference inits the head norms at one: make them count
        rng = np.random.default_rng(seed)
        nt = jax.tree.map(np.asarray, rp)
        for name in ("q_norm", "k_norm"):
            nt[name]["scale"] = (1 + 0.3 * rng.standard_normal(16)).astype(np.float32)
        rp, p = jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")
    return rcfg, cfg, rp, p


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case):
    rcfg, cfg, rp, p = _attn_pair(case)
    x = np.random.default_rng(6).standard_normal((2, 11, 64)).astype(np.float32)
    pos = np.arange(11, dtype=np.int32)
    want, rc = rattn.apply(rp, rcfg, jnp.asarray(x), positions=jnp.asarray(pos))
    got, c = attention.apply(p, cfg, t_(x), positions=t_(pos))
    assert rel_err(got, want) <= REL
    for name in ("k", "v"):
        assert rel_err(c[name], rc[name]) <= REL
    port = attention.init(torch.Generator().manual_seed(0), cfg)
    assert [(k, v.shape) for k, v in tree.paths(port)] == [
        (k, tuple(v.shape)) for k, v in tree.paths(p)]


@pytest.mark.parametrize("case", ["causal", "gqa4", "qk_norm", "windowed"])
def test_cached_attention_matches_reference(case):
    """The cached path at several positions, one token and three at a
    time, against a cache whose earlier slots hold random k / v: the
    output and the written cache as the reference's."""
    rcfg, cfg, rp, p = _attn_pair(case)
    rapply = jax.jit(rattn.apply, static_argnums=1)
    rng = np.random.default_rng(7)
    s_max, kvh = 12, cfg.n_kv_heads
    for pos, s in ((0, 1), (5, 1), (11, 1), (4, 3), (9, 3)):
        ck = rng.standard_normal((2, s_max, kvh, 16)).astype(np.float32)
        cv = rng.standard_normal((2, s_max, kvh, 16)).astype(np.float32)
        x = rng.standard_normal((2, s, 64)).astype(np.float32)
        positions = np.arange(pos, pos + s, dtype=np.int32)
        want, rc = rapply(rp, rcfg, jnp.asarray(x), positions=jnp.asarray(positions),
                          cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                          cache_pos=jnp.int32(pos))
        for p_arg in (pos, torch.tensor(pos)):
            cache = {"k": t_(ck), "v": t_(cv)}
            got, c = attention.apply(p, cfg, t_(x), positions=t_(positions), cache=cache,
                                     cache_pos=p_arg)
            assert rel_err(got, want) <= REL, (pos, s)
            for name in ("k", "v"):
                assert c[name] is cache[name]  # written in place
                assert rel_err(c[name], rc[name]) <= REL, (pos, s, name)
                # the slots outside the write are the old ones, bit for bit
                keep = np.r_[0:pos, pos + s:s_max]
                old = ck if name == "k" else cv
                np.testing.assert_array_equal(c[name].numpy()[:, keep], old[:, keep])


def test_sdpa_chunked_matches_reference():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    pos = np.arange(64, dtype=np.int32)
    for window in (None, 20):
        want = rattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   qpos=jnp.asarray(pos), kpos=jnp.asarray(pos), window=window,
                                   scale=0.25, chunk=16)
        got = attention._sdpa_chunked(t_(q), t_(k), t_(v), qpos=t_(pos), kpos=t_(pos),
                                      window=window, scale=0.25, chunk=16)
        assert rel_err(got, want) <= REL, window
        mask = attention._causal_mask(t_(pos), t_(pos), window)[None, None, None]
        full = attention._sdpa(t_(q), t_(k), t_(v), mask=mask, scale=0.25)
        assert rel_err(got, full.numpy()) <= 1e-5, window
    assert attention.CHUNK_Q == rattn.CHUNK_Q == 4096


# ------------------------------------------------------------------- the LM
def _arch(name, **repl):
    ref = rconfigs.get(name).smoke()
    if repl:
        ref = dataclasses.replace(ref, **repl)
    return ref, configs.ArchConfig(**dataclasses.asdict(ref))


def _inputs(arch, b, s, seed=11):
    """Numpy model inputs of (b, s) new positions, and the frontend prefix
    of a vision arch."""
    rng = np.random.default_rng(seed)
    out = {}
    if arch.frontend == "audio":
        out["embeds"] = rng.standard_normal((b, s, arch.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, arch.vocab_size, (b, s)).astype(np.int32)
    if arch.frontend == "vision":
        out["frontend_embeds"] = (rng.standard_normal((b, arch.n_frontend_tokens, arch.d_model))
                                  * 0.02).astype(np.float32)
    return out


def _step_inputs(inputs, i):
    return {k: v[:, i:i + 1] for k, v in inputs.items() if k != "frontend_embeds"}


@pytest.mark.parametrize("name,repl", [(n, {}) for n in LM_ARCHS]
                         + [("qwen3-0.6b", dict(vocab_size=300))],
                         ids=LM_ARCHS + ["qwen3-0.6b-vocab300"])
def test_lm_matches_reference(name, repl):
    """forward's logits, prefill's last logits and cache, and 12 decode
    steps (each step's logits, the final cache) against the reference's,
    from the same weights and inputs."""
    rarch, arch = _arch(name, **repl)
    rmodel, model = RLM(rarch), LM(arch)
    nt = numpy_tree(rmodel.init(jax.random.PRNGKey(0)))
    rp, p = jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")
    b, s = 2, 12
    inp = _inputs(arch, b, s)
    rin = {k: jnp.asarray(v) for k, v in inp.items()}
    pin = {k: t_(v) for k, v in inp.items()}

    want, _ = jax.jit(rmodel.forward)(rp, **rin)
    got, aux = model.forward(p, **pin)
    assert rel_err(got, want) <= REL and float(aux) == 0.0
    nf = arch.n_frontend_tokens if arch.frontend == "vision" else 0
    assert got.shape == (b, nf + s, model.vocab_padded)
    if model.vocab_padded != arch.vocab_size:  # the pad columns are masked
        assert (got[..., arch.vocab_size:] == -1e9).all()
        assert model.vocab_padded == 512

    rlast, rcache = jax.jit(rmodel.prefill)(rp, **rin)
    last, cache = model.prefill(p, **pin)
    assert rel_err(last, rlast) <= REL
    for n in ("k", "v"):
        assert cache[n].shape == rcache[n].shape
        assert rel_err(cache[n], rcache[n]) <= REL, n

    rstep = jax.jit(rmodel.decode_step)
    rc = rmodel.init_cache(b, s)
    c = model.init_cache(b, s, device="cpu")
    for i in range(s):
        rlg, rc = rstep(rp, rc, pos=jnp.int32(i), **{k: rin[k][:, i:i + 1] for k in
                                                     _step_inputs(inp, i)})
        lg, c = model.decode_step(p, c, pos=i, **{k: v for k, v in
                                                  _step_inputs(pin, i).items()})
        assert rel_err(lg, rlg) <= REL, i
    for n in ("k", "v"):
        assert rel_err(c[n], rc[n]) <= REL, n


def test_bridge_carries_the_reference_tree():
    """The reference's ``LM.init`` tree, as numpy leaves, is the port's tree
    leaf for leaf (paths, shapes and dtypes of the port's own init), the
    MoE configs' expert stacks included."""
    for name in DENSE_STACK + ["qwen2-moe-a2.7b", "arctic-480b"]:
        rarch, arch = _arch(name)
        nt = numpy_tree(RLM(rarch).init(jax.random.PRNGKey(0)))
        got = bridge.params_from_numpy(nt, device="cpu")
        own = LM(arch).init(torch.Generator().manual_seed(0), device="cpu")
        assert [(k, tuple(v.shape), v.dtype) for k, v in tree.paths(own)] == [
            (k, tuple(v.shape), v.dtype) for k, v in tree.paths(got)], name


@pytest.mark.parametrize("name", ["musicgen-medium", "internvl2-2b"])
def test_serving_steps_match_reference(name):
    """``make_prefill_step`` / ``make_decode_step`` route a batch as the
    reference's do: audio ``embeds``, a vision prefix at prefill only."""
    rarch, arch = _arch(name)
    nt = numpy_tree(RLM(rarch).init(jax.random.PRNGKey(1)))
    rp, p = jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")
    inp = _inputs(arch, 2, 6)
    rlast, rcache = rsteps.make_prefill_step(rarch)(rp, {k: jnp.asarray(v)
                                                        for k, v in inp.items()})
    last, cache = steps.make_prefill_step(arch)(p, {k: t_(v) for k, v in inp.items()})
    assert rel_err(last, rlast) <= REL
    n = cache["k"].shape[2]
    pad = lambda a: np.pad(np.asarray(a), ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0)))  # noqa: E731
    rc = {k: jnp.asarray(pad(v)) for k, v in rcache.items()}
    c = {k: t_(pad(v.numpy())) for k, v in cache.items()}
    nxt = _inputs(arch, 2, 1, seed=12)
    nxt.pop("frontend_embeds", None)
    rlg, rc = rsteps.make_decode_step(rarch)(rp, rc, dict({k: jnp.asarray(v) for k, v in
                                                           nxt.items()}, pos=jnp.int32(n)))
    lg, c = steps.make_decode_step(arch)(p, c, dict({k: t_(v) for k, v in nxt.items()}, pos=n))
    assert rel_err(lg, rlg) <= REL
    assert rel_err(c["k"], rc["k"]) <= REL


# ----------------------------------- the reference's identities, in the port
def _port_model(name, seed=0):
    arch = configs.get(name).smoke()
    model = LM(arch)
    return arch, model, model.init(torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("name", DENSE_STACK)
def test_decode_matches_forward(name):
    """tests/test_models.py::test_decode_matches_forward: rel < 2e-3."""
    arch, model, params = _port_model(name)
    b, s = 2, 12
    inp = {k: t_(v) for k, v in _inputs(arch, b, s).items() if k != "frontend_embeds"}
    full, _ = model.forward(params, **inp)
    cache = model.init_cache(b, s, device="cpu")
    outs = []
    for i in range(s):
        lg, cache = model.decode_step(params, cache, pos=i, **_step_inputs(inp, i))
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9) < 2e-3


def test_prefill_matches_forward_last_logit():
    """tests/test_models.py::test_prefill_matches_forward_last_logit."""
    arch, model, params = _port_model("qwen3-0.6b")
    tokens = t_(np.random.default_rng(0).integers(0, arch.vocab_size, (2, 10)))
    full, _ = model.forward(params, tokens=tokens)
    last, cache = model.prefill(params, tokens=tokens)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-4, atol=2e-4)
    assert cache["k"].shape == (arch.n_layers, 2, 10, arch.n_kv_heads, arch.resolved_head_dim)


def test_chunked_attention_equals_full():
    """tests/test_models.py::test_chunked_attention_equals_full."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4096, 4, 16), generator=g)
    k = torch.randn((2, 4096, 2, 16), generator=g)
    v = torch.randn((2, 4096, 2, 16), generator=g)
    pos = torch.arange(4096)
    mask = (pos[:, None] >= pos[None, :])[None, None, None]
    full = attention._sdpa(q, k, v, mask=mask, scale=0.25)
    ch = attention._sdpa_chunked(q, k, v, qpos=pos, kpos=pos, window=None, scale=0.25,
                                 chunk=1024)
    np.testing.assert_allclose(ch.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


def test_vlm_frontend_prefix():
    """tests/test_models.py::test_vlm_frontend_prefix."""
    arch, model, params = _port_model("internvl2-2b")
    tokens = t_(np.random.default_rng(0).integers(0, arch.vocab_size, (2, 6)))
    fe = torch.randn((2, arch.n_frontend_tokens, arch.d_model),
                     generator=torch.Generator().manual_seed(0)) * 0.02
    logits, _ = model.forward(params, tokens=tokens, frontend_embeds=fe)
    assert logits.shape[1] == 6 + arch.n_frontend_tokens


@pytest.mark.parametrize("name", DENSE_STACK)
def test_smoke_decode(name):
    """tests/test_arch_smoke.py::test_smoke_decode, for the dense stack."""
    arch, model, params = _port_model(name)
    cache = model.init_cache(2, 8, device="cpu")
    kwargs = ({"embeds": torch.randn((2, 1, arch.d_model))} if arch.frontend == "audio"
              else {"tokens": torch.zeros((2, 1), dtype=torch.int32)})
    logits, _ = model.decode_step(params, cache, pos=torch.tensor(0, dtype=torch.int32),
                                  **kwargs)
    assert logits.shape[:2] == (2, 1)
    assert not bool(torch.isnan(logits).any())


# ----------------------------------------------------------- the divergences
def test_decode_writes_the_cache_in_place():
    """The port's decode step returns the cache it was given, written at
    ``pos`` in every layer, every other slot unchanged."""
    arch, model, params = _port_model("qwen3-0.6b")
    cache = model.init_cache(2, 6, device="cpu")
    cache["k"].fill_(7.0)
    k0, v0 = cache["k"].clone(), cache["v"].clone()
    _, out = model.decode_step(params, cache, tokens=torch.ones((2, 1), dtype=torch.int64),
                               pos=3)
    assert out is cache and out["k"] is cache["k"] and out["v"] is cache["v"]
    for name, before in (("k", k0), ("v", v0)):
        changed = (cache[name] != before).any(dim=(0, 1, 3, 4))
        assert changed.tolist() == [False, False, False, True, False, False], name


def test_decode_past_the_cache_raises():
    """The reference's ``dynamic_update_slice`` clamps a start at or past the
    cache length onto the last slot; the port raises before writing."""
    arch, model, params = _port_model("smollm-360m")
    tok = torch.ones((2, 1), dtype=torch.int64)
    for pos in (6, 7, torch.tensor(6), -1):
        cache = model.init_cache(2, 6, device="cpu")
        with pytest.raises(ValueError, match="past the cache length 6"):
            model.decode_step(params, cache, tokens=tok, pos=pos)
        assert not cache["k"].any() and not cache["v"].any()
    cache = model.init_cache(2, 6, device="cpu")
    with pytest.raises(ValueError, match="past the cache length"):  # 3 new tokens from 4
        model.decode_step(params, cache, tokens=torch.ones((2, 3), dtype=torch.int64), pos=4)
    model.decode_step(params, cache, tokens=tok, pos=5)  # the last slot is fine
    # the reference clamps instead: position 6 lands on slot 5
    rarch, _ = _arch("smollm-360m")
    rmodel = RLM(rarch)
    rp = jax.tree.map(lambda p: p.value, rmodel.init(jax.random.PRNGKey(0)),
                      is_leaf=rcore.is_param)
    _, rc = rmodel.decode_step(rp, rmodel.init_cache(2, 6), tokens=jnp.ones((2, 1), jnp.int32),
                               pos=jnp.int32(6))
    assert bool(jnp.any(rc["k"][:, :, 5] != 0))


def test_dit_is_not_built_by_lm():
    """The diffusion family is the DiT's (``nn/dit.py``), not the LM's."""
    with pytest.raises(ValueError, match="not built by LM"):
        LM(configs.get("dit-xl2").smoke())


# ------------------------------------------------------------ the new modules
NEW_MODULES = ["configs/base.py", "configs/registry.py", "nn/core.py", "nn/embedding.py",
               "nn/mlp.py", "nn/attention.py", "nn/moe.py", "nn/xlstm.py", "nn/ssm.py",
               "models/__init__.py",
               "models/lm.py", "launch/steps.py", "launch/train.py", "data/synthetic.py"] + [f"configs/{n.replace('-', '_').replace('.', '_')}.py"
                                     for n in rconfigs.names()]


def test_new_modules_import_no_jax():
    for rel in NEW_MODULES:
        path = ROOT / "src" / "repro_torch" / rel
        assert path.exists(), path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, name)


def test_lm_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = configs.get("qwen3-0.6b").smoke()
    model = LM(arch)
    for call in (lambda d: model.init(torch.Generator().manual_seed(0), device=d),
                 lambda d: model.init_cache(1, 4, device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        call("cpu")
