"""The port's MoE layer (``nn/moe.py``) and the ``moe`` family's LM against
the reference, on the CPU.

Both packages get the same numpy inputs; the port's params come from the
reference's init trees through ``bridge.params_from_numpy``. The configs
are the reference's ``smoke()`` variants of qwen2-moe-a2.7b (a shared
expert with its sigmoid gate) and arctic-480b (a parallel dense FFN): 4
experts, top 2, float32. Tolerances, with their reasons (as in
``tests/test_torch_lm.py``):

* routing (the experts chosen, their order, each (token, choice)'s slot
  and the kept mask): exact, on inputs whose router probabilities the
  test asserts to be more than 1e-4 apart among each token's top k + 1
  (so no summation order can swap two choices);
* ``y``, ``aux``, logits and caches: XLA and PyTorch sum float32 products
  in other orders: max-abs difference <= 1e-5 of the reference's max-abs;
* the int8 round trip of ``w8_gather`` and its straight-through gradient:
  exact;
* the reference's own identities inside the port keep the reference
  test's tolerance (decode vs forward 2e-3 relative, at
  ``capacity_factor=8`` so no token is dropped).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.checkpoint import manager as rmanager  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import moe as rmoe  # noqa: E402
from repro_torch import bridge, configs, tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.synthetic import DataCfg, batch_for  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.nn import moe  # noqa: E402

REL = 1e-5  # float32 products / softmax, CPU against CPU
MARGIN = 1e-4  # least gap between a token's sorted top k + 1 router probabilities
MOE_ARCHS = ["qwen2-moe-a2.7b", "arctic-480b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
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


def moe_cfgs(name, **repl):
    """(the reference's MoeCfg, the port's) of ``name``'s smoke config."""
    arch = dataclasses.replace(rconfigs.get(name).smoke(), **repl)
    rcfg = RLM(arch).moe_cfg
    return rcfg, moe.MoeCfg(**dataclasses.asdict(rcfg))


def ref_route(params, rcfg, xg):
    """The reference's routing, ``src/repro/nn/moe.py:125-144`` (its
    ``apply`` returns only y and aux): (probs, flat_e, pos, keep)."""
    e, k = rcfg.n_experts, rcfg.top_k
    g, n, _ = xg.shape
    probs = jax.nn.softmax((xg.astype(jnp.float32) @ params["router"]["w"]), axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    cap = max(int(rcfg.capacity_factor * n * k / e), 1)
    flat_e = top_i.reshape(g, n * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - 1, flat_e[..., None], axis=2)[..., 0]
    keep = pos < cap
    return (np.asarray(probs), np.asarray(flat_e), np.asarray(jnp.where(keep, pos, cap - 1)),
            np.asarray(keep))


def assert_margin(probs, k):
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    gap = float((top[..., :-1] - top[..., 1:]).min())
    assert gap > MARGIN, f"inputs too close to a tie: gap {gap}"


def skewed_input(params, b, s, d, seed, skew):
    """(b, s, d) float32 standard normal, pushed along expert 0's router
    column by ``skew`` (a load that overflows expert 0's capacity)."""
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    w0 = np.asarray(params["router"]["w"])[:, 0]
    return (x + skew * w0 / np.linalg.norm(w0)).astype(np.float32)


# ------------------------------------------------------------- the layer
@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("b,s", [(2, 64), (2, 12)], ids=["groups=b", "one-group"])
@pytest.mark.parametrize("cf", [1.25, 8.0], ids=["drops", "no-drops"])
def test_moe_apply_matches_reference(name, b, s, cf):
    """Routing and the kept mask exact, y and aux within REL, for one group
    per sequence (s >= 64) and one group (s < 64), with and without
    dropped tokens."""
    rcfg, cfg = moe_cfgs(name, capacity_factor=cf)
    nt = numpy_tree(rmoe.init(jax.random.PRNGKey(3), rcfg))
    rp, p = jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")
    x = skewed_input(nt, b, s, rcfg.d_model, seed=5, skew=3.0)
    g = moe._choose_groups(b, s)
    assert g == (b if s >= 64 else 1)
    xg = x.reshape(g, -1, rcfg.d_model)
    probs, want_e, want_pos, want_keep = ref_route(rp, rcfg, jnp.asarray(xg))
    assert_margin(probs, rcfg.top_k)
    _, flat_e, pos, keep, aux, cap = moe.route(p, cfg, t_(xg))
    assert cap == max(int(cf * xg.shape[1] * rcfg.top_k / rcfg.n_experts), 1)
    np.testing.assert_array_equal(flat_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (not want_keep.all()) == (cf == 1.25)  # the drop cases drop, the others do not

    want_y, want_aux = jax.jit(lambda p_, x_: rmoe.apply(p_, rcfg, x_))(rp, jnp.asarray(x))
    y, aux = moe.apply(p, cfg, t_(x))
    assert rel_err(y, want_y) <= REL
    assert abs(float(aux) - float(want_aux)) <= REL * abs(float(want_aux))


def test_moe_ties_go_to_the_lower_expert():
    """A pinned tie: a zero router gives every expert 1 / E. ``lax.top_k``
    picks experts 0 and 1 for every token; ``torch.topk`` picked 2 and 3 on
    the CPU, so the port takes its top k from a stable sort and picks 0
    and 1 too; y and aux follow the reference's."""
    rcfg, cfg = moe_cfgs("qwen2-moe-a2.7b")
    nt = numpy_tree(rmoe.init(jax.random.PRNGKey(4), rcfg))
    nt["router"]["w"] = np.zeros_like(nt["router"]["w"])
    rp, p = jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")
    x = np.random.default_rng(6).standard_normal((1, 8, rcfg.d_model)).astype(np.float32)
    _, want_e, want_pos, want_keep = ref_route(rp, rcfg, jnp.asarray(x))
    _, flat_e, pos, keep, _, _ = moe.route(p, cfg, t_(x))
    assert want_e.reshape(8, 2).tolist() == [[0, 1]] * 8
    np.testing.assert_array_equal(flat_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    want_y, want_aux = rmoe.apply(rp, rcfg, jnp.asarray(x))
    y, aux = moe.apply(p, cfg, t_(x))
    assert rel_err(y, want_y) <= REL and float(aux) == pytest.approx(float(want_aux), rel=REL)


def test_moe_init_matches_reference_tree():
    """Paths, shapes, dtypes (the router float32 in a bf16 layer) and the
    lecun scale of the stacked experts (fan-in e * d, as the reference's
    ``_fan_in_out`` counts the expert axis)."""
    rcfg, cfg = moe_cfgs("qwen2-moe-a2.7b")
    want = numpy_tree(rmoe.init(jax.random.PRNGKey(0), rcfg, dtype=jnp.bfloat16))
    got = moe.init(torch.Generator().manual_seed(0), cfg, dtype=torch.bfloat16)
    wpaths = [("/".join(str(k.key) for k in path), v.shape, str(v.dtype))
              for path, v in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [(tree.key_of(k), tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.paths(got)] == wpaths
    big = dataclasses.replace(cfg, n_experts=16, d_model=256, d_ff_expert=64)
    w = moe.init(torch.Generator().manual_seed(0), big)["wg"]
    assert float(w.std()) == pytest.approx((16 * 256) ** -0.5, rel=0.02)


# ----------------------------------------------------------- w8 / ep_ff_data
def test_w8_gather_matches_reference_and_is_straight_through():
    """The int8 round trip equals the reference's bit for bit (a zero
    column keeps scale 1), and the gradient is the upstream one exactly,
    as the reference's custom vjp."""
    w = np.random.default_rng(0).standard_normal((4, 64, 32)).astype(np.float32)
    w[1, :, 3] = 0.0
    up = np.random.default_rng(1).standard_normal(w.shape).astype(np.float32)
    w8 = rmoe._make_w8_gather(lambda a, _axes: a)
    want = np.asarray(w8(jnp.asarray(w)))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(w8(a) * up))(jnp.asarray(w)))
    wt = t_(w).requires_grad_(True)
    got = moe.w8_gather(wt)
    (got * t_(up)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(wt.grad.numpy(), want_g)
    np.testing.assert_array_equal(wt.grad.numpy(), up)
    assert np.abs(want - w).max() <= np.abs(w).max(axis=1).max() / 127 / 2 + 1e-6


def test_w8_gather_close_and_trains():
    """tests/test_perf_paths.py::test_w8_gather_close_and_trains, plus the
    port's step against the reference's on the same params and batch."""
    rarch = dataclasses.replace(rconfigs.get("arctic-480b").smoke(), w8_gather=True)
    arch = configs.ArchConfig(**dataclasses.asdict(rarch))
    ropt = rsteps.make_optimizer(rarch, total=5)
    rstate = rsteps.init_state(rarch, jax.random.PRNGKey(0), ropt)
    batch = {k: np.asarray(v) for k, v in
             batch_for(arch, DataCfg(seed=0, batch=2, seq_len=16), 0, device="cpu").items()}
    p0 = jax.tree.map(np.asarray, rstate["params"])
    _, rm = jax.jit(rsteps.make_train_step(rarch, ropt))(
        rstate, {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()})
    opt = steps.make_optimizer(arch, total=5)
    params = bridge.params_from_numpy(p0, device="cpu")
    state = {"params": params, "opt": opt.init(params), "rng": torch.tensor(0)}
    state, m = steps.make_train_step(arch, opt)(state, {k: t_(v) for k, v in batch.items()})
    assert bool(torch.isfinite(m["loss"]))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["aux"]) == pytest.approx(float(rm["aux"]), rel=1e-5)


def test_ep_ff_data_equivalent():
    """tests/test_perf_paths.py::test_ep_ff_data_equivalent: the flag changes
    no math (in the port, the same bits), and both match the reference."""
    base = dataclasses.replace(rconfigs.get("arctic-480b").smoke(), capacity_factor=8.0)
    toks = np.random.default_rng(2).integers(0, base.vocab_size, (2, 12))
    nt = numpy_tree(RLM(base).init(jax.random.PRNGKey(0)))
    want, _ = RLM(base).forward(jax.tree.map(jnp.asarray, nt), tokens=jnp.asarray(toks))
    outs = {}
    for flag in (False, True):
        arch = configs.ArchConfig(**dataclasses.asdict(dataclasses.replace(base,
                                                                           ep_ff_data=flag)))
        outs[flag], _ = LM(arch).forward(bridge.params_from_numpy(nt, device="cpu"),
                                         tokens=t_(toks))
        own = LM(arch).init(torch.Generator().manual_seed(0), device="cpu")
        outs[flag, "init"] = tree.leaves(own)
    assert torch.equal(outs[True], outs[False])
    assert all(torch.equal(a, b) for a, b in zip(outs[True, "init"], outs[False, "init"]))
    assert rel_err(outs[True], want) <= REL


# ------------------------------------------------------------------ the LM
def _arch(name, **repl):
    ref = dataclasses.replace(rconfigs.get(name).smoke(), **repl)
    return ref, configs.ArchConfig(**dataclasses.asdict(ref))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_lm_matches_reference(name):
    """forward's logits and aux, prefill's last logits and cache, and 12
    decode steps (one group of B = 2 tokens a step, one slot an expert:
    the reference's decode capacity, dropping tokens) against the
    reference's, from the same weights and tokens."""
    rarch, arch = _arch(name)
    rmodel, model = RLM(rarch), LM(arch)
    nt = numpy_tree(rmodel.init(jax.random.PRNGKey(0)))
    rp, p = jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")
    b, s = 2, 12
    toks = np.random.default_rng(11).integers(0, arch.vocab_size, (b, s)).astype(np.int32)
    want, want_aux = jax.jit(rmodel.forward)(rp, tokens=jnp.asarray(toks))
    got, aux = model.forward(p, tokens=t_(toks))
    assert rel_err(got, want) <= REL
    assert float(aux) > 0 and float(aux) == pytest.approx(float(want_aux), rel=REL)

    rlast, rcache = jax.jit(rmodel.prefill)(rp, tokens=jnp.asarray(toks))
    last, cache = model.prefill(p, tokens=t_(toks))
    assert rel_err(last, rlast) <= REL
    for n in ("k", "v"):
        assert rel_err(cache[n], rcache[n]) <= REL, n

    assert moe.capacity(model.moe_cfg, b) == 1
    rstep = jax.jit(rmodel.decode_step)
    rc, c = rmodel.init_cache(b, s), model.init_cache(b, s, device="cpu")
    for i in range(s):
        rlg, rc = rstep(rp, rc, pos=jnp.int32(i), tokens=jnp.asarray(toks[:, i:i + 1]))
        lg, c = model.decode_step(p, c, pos=i, tokens=t_(toks[:, i:i + 1]))
        assert rel_err(lg, rlg) <= REL, i
    for n in ("k", "v"):
        assert rel_err(c[n], rc[n]) <= REL, n


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_decode_matches_forward(name):
    """tests/test_models.py::test_decode_matches_forward for the MoE configs
    (capacity_factor 8: no token drops), rel < 2e-3."""
    arch = dataclasses.replace(configs.get(name).smoke(), capacity_factor=8.0)
    model = LM(arch)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    b, s = 2, 12
    tokens = t_(np.random.default_rng(0).integers(0, arch.vocab_size, (b, s)))
    full, _ = model.forward(params, tokens=tokens)
    cache = model.init_cache(b, s, device="cpu")
    outs = []
    for i in range(s):
        lg, cache = model.decode_step(params, cache, pos=i, tokens=tokens[:, i:i + 1])
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9) < 2e-3


def test_moe_decode_capacity_is_the_reference_quirk():
    """Mirrored, not fixed: at decode, one group of B tokens gives each
    expert max(int(1.25 B k / E), 1) slots: 1 for qwen2-moe-a2.7b at
    B = 16, so most of a step's choices are dropped."""
    arch = configs.get("qwen2-moe-a2.7b")
    cfg = LM(arch).moe_cfg
    assert moe._choose_groups(16, 1) == 1 and moe.capacity(cfg, 16) == 1
    assert moe._choose_groups(2, 4096) == 2 and moe.capacity(cfg, 4096) == 341
    rcfg = RLM(rconfigs.get("qwen2-moe-a2.7b")).moe_cfg
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)


# ------------------------------------------------------------ checkpoints
def test_checkpoint_elastic_restore_list_state(tmp_path):
    """tests/test_runtime.py::test_checkpoint_elastic_restore_list_state:
    arctic-480b's smoke state (bf16 first moments, factored second
    moments: {row, col} dicts in the list) through the checkpoint manager,
    under the reference's keys."""
    arch = configs.get("arctic-480b").smoke()
    opt = steps.make_optimizer(arch, total=10)
    assert opt.factored and opt.moment_dtype == torch.bfloat16
    state = steps.init_state(arch, 0, opt, device="cpu")
    state, _ = steps.make_train_step(arch, opt)(
        state, batch_for(arch, DataCfg(batch=2, seq_len=8), 0, device="cpu"))
    assert any(isinstance(v, dict) for v in state["opt"]["v"])
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(1, state)
    out = mgr.restore(1, steps.init_state(arch, 1, opt, device="cpu"))
    la, lb = list(tree.paths(state)), list(tree.paths(out))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, a), (_, b2) in zip(la, lb):
        assert a.dtype == b2.dtype and torch.equal(a, b2), k
    with open(os.path.join(path, "meta")) as f:
        keys = json.load(f)["keys"]
    like = jax.tree.map(lambda a: jnp.zeros(a.shape),
                        tree.map_tree(lambda a: a.float().numpy(), state))
    assert keys == list(rmanager._flatten(like))
