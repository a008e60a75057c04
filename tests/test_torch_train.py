"""DiT training in the port against the reference, on the CPU.

Both packages get the same numpy inputs (params through
``bridge.params_from_numpy``, batches, timesteps and noise), at the
reference's ``smoke()`` size (2 layers, d = 64). Tolerances, with their
reasons:

* schedules and one AdamW update: rtol 1e-6 (float32 ops in the same
  order; ``cos``, ``pow`` and the reductions may differ in the last ulp
  between XLA and PyTorch); q_sample: the schedules' alpha_bars agree to
  2e-6 relative, so 2e-6 of the inputs' scale;
* the train loss and its gradients: XLA and PyTorch sum the float32
  products and reductions in other orders; each gradient leaf is held to
  1e-4 of its own largest entry;
* three train steps: Adam divides each gradient entry by its own running
  RMS, so an entry whose gradient is tiny moves by ~lr whatever its last
  bits; the params' updates are held in relative L2 (1e-2) per leaf and
  the losses to rtol 1e-5.

Also here: the two repairs of ``nn/dit.py`` (stacked block leaves unbound
once; the label rows as a one-hot product, whose backward is a product and
not atomic adds) leave the forward's bits as they were.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.core import diffusion as rdiffusion  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import dit as rdit  # noqa: E402
from repro.optim import AdamW as RAdamW  # noqa: E402
from repro.optim import make_schedule as rmake_schedule  # noqa: E402
from repro_torch import bridge, configs, tree  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.data.synthetic import DataCfg, batch_for  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.nn import core, dit  # noqa: E402
from repro_torch.optim import AdamW, make_schedule  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_(a, dtype=None):
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def smoke():
    return rconfigs.get("dit-xl2").smoke(), configs.get("dit-xl2").smoke()


def ref_params(arch, *, refill_mod=True):
    """The reference's DiT init as numpy (the adaLN ``mod`` weights refilled
    N(0, 0.02) so every block has a gradient)."""
    p = jax.tree.map(lambda p: np.asarray(p.value),
                     rdit.init(jax.random.PRNGKey(0), rsteps.make_dit_model(arch)),
                     is_leaf=rcore.is_param)
    if refill_mod:
        w = p["blocks"]["mod"]["w"]
        p["blocks"]["mod"]["w"] = (np.random.default_rng(1).standard_normal(w.shape)
                                   * 0.02).astype(np.float32)
    return p


# ------------------------------------------------------------------ configs
def test_configs_match_reference():
    def kept(port, ref):
        """The reference's values of the fields the port keeps."""
        return {f.name: getattr(ref, f.name) for f in dataclasses.fields(port)}

    for name in configs.names():
        ref, port = rconfigs.get(name), configs.get(name)
        assert dataclasses.asdict(port) == kept(port, ref)
        assert dataclasses.asdict(port.smoke()) == kept(port, ref.smoke())
        assert port.n_params() == ref.n_params()
        assert port.resolved_head_dim == ref.resolved_head_dim
    assert configs.names() == rconfigs.names()
    assert configs.torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-2")
    with pytest.raises(ValueError, match="not a torch dtype"):
        configs.torch_dtype("nope")
    arch, parch = smoke()
    assert steps.make_dit_model(parch) == dit.DiTCfg(**dataclasses.asdict(
        rsteps.make_dit_model(arch)))
    # a field the DiT does not build is refused, not ignored
    for bad in (dict(norm="rmsnorm"), dict(act="swiglu"), dict(n_kv_heads=2),
                dict(head_dim=32)):
        with pytest.raises(ValueError, match="the DiT builds"):
            steps.make_dit_model(dataclasses.replace(parch, **bad))
    # a dense config's count and smoke variant are the reference's
    lm, rlm = dataclasses.replace(parch, family="dense"), dataclasses.replace(arch, family="dense")
    assert lm.n_params() == rlm.n_params()
    assert dataclasses.asdict(lm.smoke()) == dataclasses.asdict(rlm.smoke())


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("name", ["cosine", "wsd", "const"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_schedules_match_reference(name, warmup):
    ref, port = rmake_schedule(name, 3e-4, warmup, 100), make_schedule(name, 3e-4, warmup, 100)
    stepsv = np.arange(0, 121)
    want = np.array([float(ref(int(s))) for s in stepsv], np.float32)
    got = np.array([float(port(int(s))) for s in stepsv], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # an int32 step tensor (the optimizer's) gives the same float32 values
    vec = port(torch.arange(0, 121, dtype=torch.int32))
    assert vec.dtype == torch.float32
    np.testing.assert_array_equal(vec.numpy(), got)


def test_wsd_schedule_shape():
    lr = make_schedule("wsd", 1.0, warmup=10, total=100)
    assert float(lr(0)) < 0.11
    assert abs(float(lr(50)) - 1.0) < 1e-6  # stable plateau
    assert float(lr(99)) < 0.2  # sharp decay at the end


# ----------------------------------------------------------------- q_sample
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_sample_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    t = np.array([0, 17, 500, 999], np.int32)
    jdt, tdt = jnp.dtype(dtype), configs.torch_dtype(dtype)
    want = rdiffusion.q_sample(rdiffusion.cosine_schedule(1000), jnp.asarray(x0, jdt),
                               jnp.asarray(t), jnp.asarray(eps, jdt))
    got = diffusion.q_sample(diffusion.cosine_schedule(1000), t_(x0, tdt), t_(t).long(),
                             t_(eps, tdt))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # bf16 promotes
    # the two alpha_bars agree to 2e-6 relative (tests/test_torch_engine.py),
    # and the two terms may cancel: an absolute bound of 2e-6 x (|x0| + |eps|)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6 * float(np.abs(x0).max() + np.abs(eps).max()))


# -------------------------------------------------------------------- AdamW
@pytest.mark.parametrize("factored", [False, True])
def test_adamw_update_matches_reference(factored):
    rng = np.random.default_rng(0)
    def draw():
        return {"a": rng.standard_normal((6, 5)).astype(np.float32),
                "b": {"c": rng.standard_normal(5).astype(np.float32),
                      "d": rng.standard_normal((3, 4, 5)).astype(np.float32)}}

    params, grads = draw(), draw()
    kw = dict(weight_decay=0.1, clip_norm=1.0, factored=factored)
    ref = RAdamW(lr=rmake_schedule("cosine", 1e-2, 2, 10), **kw)
    port = AdamW(lr=make_schedule("cosine", 1e-2, 2, 10), **kw)
    # a state two steps in, moments random (v positive)
    rstate = ref.init(jax.tree.map(jnp.asarray, params))
    rstate = jax.tree.map(lambda a: jnp.asarray(np.abs(rng.standard_normal(a.shape))
                                                .astype(np.float32) * 0.1), rstate)
    rstate["step"] = jnp.int32(2)
    state = {"m": [t_(np.asarray(m)) for m in rstate["m"]],
             "v": [tree.map_tree(lambda a: t_(np.asarray(a)), v) for v in rstate["v"]],
             "step": torch.tensor(2, dtype=torch.int32)}
    rp, rs, rstats = ref.update(jax.tree.map(jnp.asarray, grads), rstate,
                                jax.tree.map(jnp.asarray, params))
    pp, ps, pstats = port.update(tree.map_tree(t_, grads), state, tree.map_tree(t_, params))
    assert int(ps["step"]) == 3 and ps["step"].dtype == torch.int32
    for got, want in ((pp, rp), (ps["m"], rs["m"]), (ps["v"], rs["v"]),
                      ([pstats["grad_norm"], pstats["lr"]], [rstats["grad_norm"], rstats["lr"]])):
        gl, wl = tree.leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    if factored:  # the 2-D and 3-D leaves keep row / col means, the 1-D a full v
        assert [isinstance(v, dict) for v in ps["v"]] == [True, False, True]


def test_adamw_updates_in_place_and_keeps_dtypes():
    opt = AdamW(lr=make_schedule("const", 1e-2, 0, 10))
    params = {"w": torch.ones(4, 3, dtype=torch.bfloat16), "b": torch.zeros(3)}
    state = opt.init(params)
    w, m = params["w"], state["m"][1]
    new_p, new_s, _ = opt.update({"w": torch.ones(4, 3, dtype=torch.bfloat16),
                                  "b": torch.ones(3)}, state, params)
    assert new_p["w"] is w and new_s["m"][1] is m  # the same tensors, updated
    assert w.dtype == torch.bfloat16 and m.dtype == torch.float32
    assert float(w.float().max()) < 1.0 and int(new_s["step"]) == 1


def test_adamw_decreases_quadratic():
    opt = AdamW(lr=make_schedule("const", 1e-1, 0, 100), weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(50):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_factored_matches_full_roughly():
    """Factored v is a rank-1 approximation: element-wise it differs from
    full Adam, but the update direction (signs) and magnitude must agree."""
    g0 = torch.Generator().manual_seed(0)
    w0 = torch.randn((16, 24), generator=g0)
    g = torch.randn((16, 24), generator=g0) * 0.1
    outs = {}
    for factored in (False, True):
        opt = AdamW(lr=make_schedule("const", 1e-2, 0, 10), weight_decay=0.0,
                    factored=factored)
        p = {"w": w0.clone()}
        st = opt.init(p)
        for _ in range(10):
            p, st, _ = opt.update({"w": g}, st, p)
        outs[factored] = p["w"] - w0
    norm_ratio = float(outs[True].norm() / outs[False].norm())
    assert 0.7 < norm_ratio < 1.4, norm_ratio
    sign_agree = float((torch.sign(outs[True]) == torch.sign(outs[False])).float().mean())
    assert sign_agree > 0.98, sign_agree  # constant grads: sign(update)=-sign(g)


# --------------------------------------------------------- loss and gradient
def _inputs(arch, b=4):
    rng = np.random.default_rng(3)
    hw, ch = arch.input_size, arch.in_channels
    x0 = rng.standard_normal((b, hw, hw, ch)).astype(np.float32)
    eps = rng.standard_normal((b, hw, hw, ch)).astype(np.float32)
    t = rng.integers(0, 1000, b).astype(np.int32)
    labels = np.array([0, 3, 3, 9][:b], np.int32)  # a repeated label
    return x0, labels, t, eps


def test_train_loss_and_grads_match_reference():
    arch, parch = smoke()
    params = ref_params(arch)
    x0, labels, t, eps = _inputs(arch)
    dcfg = rsteps.make_dit_model(arch)
    sched = rdiffusion.cosine_schedule(1000)

    def loss_fn(p):  # src/repro/launch/steps.py, the diffusion train_step's loss
        x_t = rdiffusion.q_sample(sched, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))
        eps_hat = rdit.apply(p, dcfg, x_t, jnp.asarray(t), jnp.asarray(labels))
        return jnp.mean(jnp.square(eps_hat.astype(jnp.float32) - jnp.asarray(eps)))

    want_loss, want = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    train = steps.make_train_step(parch, steps.make_optimizer(parch))
    loss, grads = train.loss_and_grads(bridge.params_from_numpy(params, device="cpu"),
                                       {"x0": t_(x0), "labels": t_(labels).long()},
                                       t_(t).long(), t_(eps))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    got_paths = [tree.key_of(p) for p, _ in tree.paths(grads)]
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert got_paths == ["/".join(str(k.key) for k in path) for path, _ in want_flat]
    for (path, w), g in zip(want_flat, tree.leaves(grads)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        scale = np.abs(w).max()
        assert scale > 0, path  # every leaf gets a gradient (mod refilled)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_three_train_steps_match_reference():
    """The reference's jitted train step and the port's, fed the reference's
    own t / eps draws (made here as steps.py draws them) and batches."""
    arch, parch = smoke()
    ropt = rsteps.make_optimizer(arch, base_lr=1e-3, warmup=2, total=10)
    opt = steps.make_optimizer(parch, base_lr=1e-3, warmup=2, total=10)
    rstate = rsteps.init_state(arch, jax.random.PRNGKey(0), ropt)
    p0 = jax.tree.map(np.asarray, rstate["params"])
    params = bridge.params_from_numpy(p0, device="cpu")
    state = {"params": params, "opt": opt.init(params), "rng": torch.tensor(0)}
    rtrain, train = jax.jit(rsteps.make_train_step(arch, ropt)), steps.make_train_step(parch, opt)
    dc = rsyn.DataCfg(seed=0, batch=4, seq_len=1)
    for step in range(3):
        batch = rsyn.batch_for(arch, dc, step)
        # src/repro/launch/steps.py:66-69
        kt, ke = jax.random.split(jax.random.fold_in(rstate["rng"], rstate["opt"]["step"]))
        x0 = batch["x0"].astype(jnp.dtype(arch.activation_dtype))
        t = jax.random.randint(kt, (x0.shape[0],), 0, 1000)
        eps = jax.random.normal(ke, x0.shape, x0.dtype)
        rstate, rm = rtrain(rstate, batch)
        state, m = train.with_noise(state, {k: t_(v) for k, v in batch.items()},
                                    t_(t).long(), t_(eps))
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=1e-6)
    assert int(state["opt"]["step"]) == int(rstate["opt"]["step"]) == 3
    want_flat = jax.tree_util.tree_flatten_with_path(rstate["params"])[0]
    for (path, w), g, w0 in zip(want_flat, tree.leaves(state["params"]), jax.tree.leaves(p0)):
        dw, dg = np.asarray(w) - w0, g.numpy() - w0
        rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        assert rel < 1e-2, (jax.tree_util.keystr(path), rel)


def test_train_step_draws_noise_from_seed_and_step():
    _, parch = smoke()
    opt = steps.make_optimizer(parch)
    train = steps.make_train_step(parch, opt)
    state = steps.init_state(parch, 0, opt, device="cpu")
    batch = batch_for(parch, DataCfg(batch=3), 0, device="cpu")
    t1, e1 = train.noise(state, batch)
    t2, e2 = train.noise(state, batch)
    assert torch.equal(t1, t2) and torch.equal(e1, e2)
    assert t1.dtype == torch.int64 and int(t1.min()) >= 0 and int(t1.max()) < 1000
    assert e1.shape == batch["x0"].shape
    state["opt"]["step"] += 1
    assert not torch.equal(train.noise(state, batch)[1], e1)
    state["rng"] = torch.tensor(5)
    assert not torch.equal(train.noise(state, batch)[1], e1)
    # an LM arch gets the LM branch, whose loss is the reference's (the
    # step's parity: tests/test_torch_lm_train.py)
    rarch, larch = rconfigs.get("qwen3-0.6b").smoke(), configs.get("qwen3-0.6b").smoke()
    lm_step = steps.make_train_step(larch, steps.make_optimizer(larch))
    assert isinstance(lm_step, steps.LMTrainStep)
    ropt = rsteps.make_optimizer(rarch)
    rstate = rsteps.init_state(rarch, jax.random.PRNGKey(0), ropt)
    lb = batch_for(larch, DataCfg(batch=2, seq_len=8), 0, device="cpu")
    _, rm = jax.jit(rsteps.make_train_step(rarch, ropt))(
        rstate, {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in lb.items()})
    ce, _, _ = lm_step.loss_and_grads(
        bridge.params_from_numpy(jax.tree.map(np.asarray, rstate["params"]), device="cpu"), lb)
    np.testing.assert_allclose(float(ce), float(rm["loss"]), rtol=1e-5)


def test_tiny_dit_learns():
    """tests/test_system.py's trained_tiny_dit recipe, 30 of its 60 steps."""
    parch = dataclasses.replace(configs.get("dit-xl2").smoke(), n_layers=2, d_model=64)
    opt = steps.make_optimizer(parch, base_lr=2e-3, total=60)
    state = steps.init_state(parch, 0, opt, device="cpu")
    train = steps.make_train_step(parch, opt)
    dc = DataCfg(seed=0, batch=16)
    losses = []
    for step in range(30):
        state, m = train(state, batch_for(parch, dc, step, device="cpu"))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0], losses


def test_bf16_params_compute_in_float32():
    """DiT-XL/2's config stores bf16 and activates in bf16: x_t comes out
    float32 and so does the forward; the gradients come back in bf16."""
    _, parch = smoke()
    parch = dataclasses.replace(parch, param_dtype="bfloat16", activation_dtype="bfloat16")
    opt = steps.make_optimizer(parch)
    state = steps.init_state(parch, 0, opt, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tree.leaves(state["params"]))
    train = steps.make_train_step(parch, opt)
    batch = batch_for(parch, DataCfg(batch=2), 0, device="cpu")
    t, eps = train.noise(state, batch)
    assert eps.dtype == torch.bfloat16
    loss, grads = train.loss_and_grads(state["params"], batch, t, eps)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(g.dtype == torch.bfloat16 for g in tree.leaves(grads))
    state, m = train(state, batch)
    assert all(p.dtype == torch.bfloat16 for p in tree.leaves(state["params"]))
    assert all(m_.dtype == torch.float32 for m_ in state["opt"]["m"])


# ------------------------------------------------------ nn/dit.py repairs
def _apply_as_before(params, cfg, latents, t, labels):
    """nn/dit.py:apply as it was: each stacked leaf indexed per layer, the
    label rows gathered."""
    b, hh, ww, ch = latents.shape
    pp = cfg.patch
    x = latents.reshape(b, hh // pp, pp, ww // pp, pp, ch)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.n_tokens, cfg.patch_dim)
    x = core.dense(params["patch_embed"], x) + params["pos_embed"].to(latents.dtype)[None]
    c = dit.timestep_embedding(t, 256)
    c = core.dense(params["t_mlp2"], torch.nn.functional.silu(
        core.dense(params["t_mlp1"], c.to(latents.dtype))))
    c = c + params["label_embed"].to(latents.dtype)[labels]
    for i in range(cfg.n_layers):
        x = dit.block_apply(tree.map_tree(lambda a: a[i], params["blocks"]), cfg, x, c)
    mod = core.dense(params["final_mod"], torch.nn.functional.silu(c))
    shift, scale = torch.chunk(mod, 2, dim=-1)
    x = dit._modulate(dit._ln(x), shift, scale)
    x = core.dense(params["final_out"], x)
    x = x.reshape(b, hh // pp, ww // pp, pp, pp, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh, ww, ch)


def _graph_ops(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_dit_repairs_keep_forward_bits():
    arch, _ = smoke()
    cfg = dit.DiTCfg(**dataclasses.asdict(rsteps.make_dit_model(arch)))
    x0, labels, t, _ = _inputs(arch)
    params = bridge.params_from_numpy(ref_params(arch), device="cpu")
    args = (t_(x0), t_(t).long(), t_(labels).long())
    want = _apply_as_before(params, cfg, *args)
    assert torch.equal(dit.apply(params, cfg, *args), want)
    # with the gradients on: no per-layer select of a stack, no atomic gather
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    out = dit.apply(tree.unflatten_like(params, leaves), cfg, *args)
    assert torch.equal(out.detach(), want)
    ops = _graph_ops(out)
    assert "UnbindBackward0" in ops and "SelectBackward0" not in ops, ops
    assert "IndexBackward0" not in ops, ops


def test_label_rows_backward_matches_gather():
    g = torch.Generator().manual_seed(0)
    table = torch.randn((11, 16), generator=g)
    labels = torch.tensor([3, 3, 0, 10, 3])
    up = torch.randn((5, 16), generator=g)
    a = table.clone().requires_grad_(True)
    got = dit.label_rows(a, labels)
    assert torch.equal(got, table[labels])
    (got * up).sum().backward()
    b = table.clone().requires_grad_(True)
    (b[labels] * up).sum().backward()
    # three rows add into row 3: both sum them in float32, maybe in another order
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-6, atol=1e-7)
    assert torch.equal(a.grad[[1, 2]], torch.zeros(2, 16))
