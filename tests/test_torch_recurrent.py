"""The port's recurrent LM families against the reference, on the CPU:
``nn/core.py:segmented_scan``, ``nn/xlstm.py`` (xlstm-125m, the ``ssm``
family), ``nn/ssm.py`` and the ring-buffer shared attention (zamba2-7b,
the ``hybrid`` family).

Both packages get the same numpy inputs; the port's params come from the
reference's init trees through ``bridge.params_from_numpy``. The configs
are the reference's ``smoke()`` variants (d = 64, float32). Tolerances,
with their reasons:

* the scan's segments, remat, the ring's layout and positions: exact (the
  same ops on the same values);
* elementwise float32 ops (``logsigmoid`` / ``softplus``): the last ulp
  of ``exp`` / ``log1p``: max-abs difference <= 1e-6 of the reference's
  max-abs (``ELEM``);
* the layers, the whole LM over up to a dozen positions, caches, decode
  steps and gradients: XLA and PyTorch sum products and scans in other
  orders: max-abs difference <= 1e-5 of the reference's max-abs (``REL``);
* the whole LM over 128 positions (the chunked mLSTM / SSD, and the
  sLSTM's 128-step recurrence) and its prefill cache: 5e-5
  (``REL_LONG``). At that length float32 itself is that far off: the
  reference's logits are 1.0e-5 of their max-abs from a float64 run of the
  port's xlstm-125m (``test_xlstm_long_forward_is_float32_close`` holds
  both packages' logits to the float64 run);
* a decode step at position 524,287: the reference's jitted step takes
  sin / cos of the RoPE angles (up to 5.2e5 rad) from XLA's fused
  approximation, 3.6e-3 off the float64 value there, where PyTorch and an
  unjitted JAX op agree with it; that step's reference is run under
  ``jax.disable_jit()`` and held to ``REL``;
* the train step's gradients: 3e-5 at S = 16 (``GRAD``), 1e-4 at S = 128
  (``GRAD_LONG``). A per-head leaf's gradient (``A_log``) sums the terms of
  every token, head dim and state dim: 1.06e-5 of its max-abs off the
  jitted reference at S = 16; at S = 128 the reference's own float32
  gradients are up to 2.9e-5 off a float64 run of the port's xlstm-125m;
* the reference's own identities inside the port keep the reference
  test's tolerance (decode == forward 2e-3 relative; chunked == recurrent
  mLSTM rtol 3e-4 / atol 3e-5, SSD 2e-4 / 2e-5; SSD gradients 2e-3 /
  2e-4; prefill == forward rtol = atol = 2e-4).
"""
import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import ssm as rssm  # noqa: E402
from repro.nn import xlstm as rxlstm  # noqa: E402
from repro_torch import bridge, configs, tree  # noqa: E402
from repro_torch.data.synthetic import DataCfg, lm_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import TrainDriver  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.nn import core, ssm, xlstm  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-5
REL_LONG = 5e-5
GRAD = 3e-5
GRAD_LONG = 1e-4
ELEM = 1e-6
ARCHS = ["xlstm-125m", "zamba2-7b"]


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
    return jax.tree.map(lambda p: np.asarray(rcore.val(p)), ptree, is_leaf=rcore.is_param)


def both(ptree):
    """A reference Param tree as (jnp values, the port's CPU tensors)."""
    nt = numpy_tree(ptree)
    return jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")


def randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------ the scan
@pytest.mark.parametrize("length,segment", [(64, 16), (48, 32), (40, 256), (300, 256)])
def test_segmented_scan_equals_plain(length, segment):
    """tests/test_models.py::test_segmented_scan_equals_plain: the values
    as the reference's (``REL``: a 64-step tanh recurrence carries the last
    ulp of ``tanh``); in the port the segmented scan equals
    the plain loop bit for bit, forward and gradient (of the inputs, the
    initial carry and a weight the cell closes over), and under grad it
    recomputes each segment once (the cell runs twice a step)."""
    xs = randn(length, 4, seed=length)
    c0 = np.zeros(4, np.float32)
    w = 1.0 + 0.1 * randn(4, seed=1)

    def rcell(c, x):
        c = jnp.tanh(c + x)
        return c, c

    c2, y2 = rcore.segmented_scan(rcell, jnp.asarray(c0), jnp.asarray(xs), segment=segment)
    pc, py = core.segmented_scan(lambda c, x: (torch.tanh(c + x[0]),) * 2, t_(c0), (t_(xs),),
                                 segment=segment)
    assert rel_err(py, y2) <= REL and rel_err(pc, c2) <= REL

    calls = []

    def cell(c, x, w):
        calls.append(1)
        c = torch.tanh(c * w + x[0])
        return c, c * c

    def run(fn):
        calls.clear()
        leaves = [t_(a).requires_grad_(True) for a in (xs, c0, w)]
        with torch.enable_grad():
            c, y = fn(lambda c, x: cell(c, x, leaves[2]), leaves[1], (leaves[0],))
            grads = torch.autograd.grad((y.sum() + c.sum()), leaves)
        return c.detach(), y.detach(), grads, len(calls)

    plain = run(core.scan)
    seg = run(lambda cl, c, x: core.segmented_scan(cl, c, x, segment=segment))
    assert torch.equal(plain[0], seg[0]) and torch.equal(plain[1], seg[1])
    assert all(torch.equal(a, b) for a, b in zip(plain[2], seg[2]))
    checkpointed = length % segment == 0 and length > segment or (
        length % segment and math.gcd(segment, length) > 1 and length > math.gcd(segment, length))
    assert plain[3] == length and seg[3] == (2 * length if checkpointed else length)
    with torch.no_grad():  # no grad: the plain loop
        c, y = core.segmented_scan(lambda c, x: (torch.tanh(c + x[0]),) * 2, t_(c0), (t_(xs),),
                                   segment=segment)
    assert torch.equal(y, py)


# ---------------------------------------------------------- elementwise
def test_gates_match_reference():
    """``F.logsigmoid(f)`` is the reference's ``-softplus(-f)`` and
    ``F.softplus`` (threshold 20) its ``softplus``, over [-60, 60] (the
    threshold's neighbourhood included)."""
    x = np.concatenate([np.linspace(-60, 60, 4001), np.linspace(15, 25, 2001)]).astype(np.float32)
    lf = torch.nn.functional.logsigmoid(t_(x))
    assert rel_err(lf, -jax.nn.softplus(-jnp.asarray(x))) <= ELEM
    sp = torch.nn.functional.softplus(t_(x))
    assert rel_err(sp, jax.nn.softplus(jnp.asarray(x))) <= ELEM


# ---------------------------------------------------------------- mLSTM
def _xl_pair(**kw):
    rcfg = dataclasses.replace(rxlstm.XlstmCfg(64, n_heads=4), **kw)
    return rcfg, xlstm.XlstmCfg(**dataclasses.asdict(rcfg))


def _mlstm_state(b, cfg, seed):
    h, p = cfg.n_heads, cfg.head_dim
    return (randn(b, h, p, p, seed=seed, scale=0.3), randn(b, h, p, seed=seed + 1, scale=0.3),
            randn(b, h, seed=seed + 2))


@pytest.mark.parametrize("impl", ["recurrent", "chunked"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_matches_reference(impl, with_state):
    """The cell (through ``segmented_scan``) and the chunked form (chunk 8):
    the output and every state as the reference's."""
    rcfg, cfg = _xl_pair(impl=impl, chunk=8)
    rp, p = both(rxlstm.mlstm_init(jax.random.PRNGKey(2), rcfg))
    x = randn(2, 32, 64, seed=3, scale=2.0)
    st = _mlstm_state(2, rcfg, 4) if with_state else None
    want, wst = jax.jit(rxlstm.mlstm_apply, static_argnums=1)(
        rp, rcfg, jnp.asarray(x), state=st and tuple(map(jnp.asarray, st)))
    got, gst = xlstm.mlstm_apply(p, cfg, t_(x), state=st and tuple(map(t_, st)))
    assert rel_err(got, want) <= REL
    for a, b in zip(gst, wst):
        assert rel_err(a, b) <= REL
    own = xlstm.mlstm_init(torch.Generator().manual_seed(0), cfg)
    assert [(k, tuple(v.shape)) for k, v in tree.paths(own)] == [
        (k, tuple(v.shape)) for k, v in tree.paths(p)]


def test_chunked_mlstm_equals_recurrent():
    """tests/test_perf_paths.py::test_chunked_mlstm_equals_recurrent, in the
    port: the output and states within rtol 3e-4 / atol 3e-5, the chunked
    form's gradients finite."""
    rcfg, cfg_r = _xl_pair(impl="recurrent")
    cfg_c = dataclasses.replace(cfg_r, impl="chunked", chunk=8)
    _, p = both(rxlstm.mlstm_init(jax.random.PRNGKey(0), rcfg))
    x = t_(randn(2, 32, 64, seed=5, scale=2.0))
    y_r, st_r = xlstm.mlstm_apply(p, cfg_r, x)
    y_c, st_c = xlstm.mlstm_apply(p, cfg_c, x)
    np.testing.assert_allclose(y_c.numpy(), y_r.numpy(), rtol=3e-4, atol=3e-5)
    for a, b in zip(st_c, st_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4, atol=3e-5)
    leaves = [t.requires_grad_(True) for t in tree.leaves(p)]
    with torch.enable_grad():
        y, _ = xlstm.mlstm_apply(tree.unflatten_like(p, leaves), cfg_c, x)
        grads = torch.autograd.grad((y ** 2).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("family", ["mlstm", "ssd"])
def test_chunked_gradients_match_reference(family):
    """The chunked forms' gradients (each chunk checkpointed in both
    packages) against ``jax.grad`` of the reference's: every param and the
    input; all finite. A loss of sum(y^2) at chunk 8 over 4 chunks, from a
    random state."""
    x = randn(2, 32, 64, seed=6)
    if family == "mlstm":
        rcfg, cfg = _xl_pair(impl="chunked", chunk=8)
        rp, p = both(rxlstm.mlstm_init(jax.random.PRNGKey(3), rcfg))
        st = _mlstm_state(2, rcfg, 7)
        rst, pst = tuple(map(jnp.asarray, st)), tuple(map(t_, st))
        rfn = lambda pp, xx: rxlstm.mlstm_apply(pp, rcfg, xx, state=rst)[0]  # noqa: E731
        pfn = lambda pp, xx: xlstm.mlstm_apply(pp, cfg, xx, state=pst)[0]  # noqa: E731
    else:
        rcfg, cfg = _mamba_pair(impl="ssd", chunk=8)
        rp, p = both(rssm.init(jax.random.PRNGKey(3), rcfg))
        rp, p = _refill_ssm(rp, p)
        h0 = randn(2, rcfg.n_heads, 16, 16, seed=7)
        rfn = lambda pp, xx: rssm.apply(pp, rcfg, xx, state=jnp.asarray(h0))[0]  # noqa: E731
        pfn = lambda pp, xx: ssm.apply(pp, cfg, xx, state=t_(h0))[0]  # noqa: E731
    rg = jax.jit(jax.grad(lambda pp, xx: jnp.sum(rfn(pp, xx) ** 2), argnums=(0, 1)))(
        rp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for t in tree.leaves(p)] + [t_(x).requires_grad_(True)]
    with torch.enable_grad():
        y = pfn(tree.unflatten_like(p, leaves[:-1]), leaves[-1])
        grads = torch.autograd.grad((y ** 2).sum(), leaves)
    want = jax.tree.leaves(rg[0]) + [rg[1]]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert bool(torch.isfinite(g).all())
        if np.abs(np.asarray(w)).max() > 0:
            assert rel_err(g, w) <= REL
        else:
            assert not g.any()


# ---------------------------------------------------------------- sLSTM
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_matches_reference(with_state):
    rcfg, cfg = _xl_pair()
    rp, p = both(rxlstm.slstm_init(jax.random.PRNGKey(4), rcfg))
    x = randn(2, 20, 64, seed=8, scale=2.0)
    st = None
    if with_state:
        st = (randn(2, 64, seed=9), np.abs(randn(2, 64, seed=10)) + 1, randn(2, 64, seed=11),
              randn(2, 4, seed=12))
    want, wst = jax.jit(rxlstm.slstm_apply, static_argnums=1)(
        rp, rcfg, jnp.asarray(x), state=st and tuple(map(jnp.asarray, st)))
    got, gst = xlstm.slstm_apply(p, cfg, t_(x), state=st and tuple(map(t_, st)))
    assert rel_err(got, want) <= REL
    for a, b in zip(gst, wst):
        assert rel_err(a, b) <= REL
    own = xlstm.slstm_init(torch.Generator().manual_seed(0), cfg)
    assert [(k, tuple(v.shape)) for k, v in tree.paths(own)] == [
        (k, tuple(v.shape)) for k, v in tree.paths(p)]
    assert own["ri"].shape == (4, 16, 16)  # a bare leaf, not a {"w": ...} dict


# --------------------------------------------------------------- Mamba2
def _mamba_pair(**kw):
    rcfg = dataclasses.replace(rssm.MambaCfg(64, d_state=16, head_dim=16), **kw)
    return rcfg, ssm.MambaCfg(**dataclasses.asdict(rcfg))


def _refill_ssm(rp, p, seed=13):
    """Both trees with the zero-initialized ``conv_b`` and ``dt_bias`` refilled
    N(0, 0.1), so that they count."""
    nt = jax.tree.map(np.asarray, rp)
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "dt_bias"):
        nt[k] = (rng.standard_normal(nt[k].shape) * 0.1).astype(np.float32)
    return jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_depthwise_conv_matches_reference(with_state):
    w, b, x = randn(4, 48, seed=14), randn(48, seed=15), randn(2, 9, 48, seed=16)
    st = randn(2, 3, 48, seed=17) if with_state else None
    want, wst = rssm._causal_depthwise_conv(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x),
                                            st if st is None else jnp.asarray(st))
    got, gst = ssm._causal_depthwise_conv(t_(w), t_(b), t_(x), st if st is None else t_(st))
    assert rel_err(got, want) <= REL
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))  # a slice: exact


@pytest.mark.parametrize("impl", ["recurrent", "ssd"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_matches_reference(impl, with_state):
    """The Mamba2 cell (through ``segmented_scan``) and the chunked SSD
    (chunk 8): the output, the SSM state and the conv state as the
    reference's."""
    rcfg, cfg = _mamba_pair(impl=impl, chunk=8)
    rp, p = _refill_ssm(*both(rssm.init(jax.random.PRNGKey(5), rcfg)))
    x = randn(2, 32, 64, seed=18)
    h0 = randn(2, rcfg.n_heads, 16, 16, seed=19) if with_state else None
    cv = randn(2, 3, rcfg.d_inner + 32, seed=20) if with_state else None
    want, (wh, wcv) = jax.jit(rssm.apply, static_argnums=1)(
        rp, rcfg, jnp.asarray(x), state=h0 if h0 is None else jnp.asarray(h0),
        conv_state=cv if cv is None else jnp.asarray(cv))
    got, (gh, gcv) = ssm.apply(p, cfg, t_(x), state=h0 if h0 is None else t_(h0),
                               conv_state=cv if cv is None else t_(cv))
    assert rel_err(got, want) <= REL
    assert rel_err(gh, wh) <= REL
    assert rel_err(gcv, wcv) <= REL
    own = ssm.init(torch.Generator().manual_seed(0), cfg)
    assert [(k, tuple(v.shape), v.dtype) for k, v in tree.paths(own)] == [
        (k, tuple(v.shape), v.dtype) for k, v in tree.paths(p)]


def test_ssd_equals_recurrent():
    """tests/test_perf_paths.py::test_ssd_equals_recurrent, in the port."""
    rcfg, cfg_r = _mamba_pair(impl="recurrent")
    cfg_s = dataclasses.replace(cfg_r, impl="ssd", chunk=8)
    _, p = both(rssm.init(jax.random.PRNGKey(0), rcfg))
    x = t_(randn(2, 32, 64, seed=21))
    h0 = t_(randn(2, cfg_r.n_heads, 16, 16, seed=22))
    y_r, (h_r, _) = ssm.apply(p, cfg_r, x, state=h0)
    y_s, (h_s, _) = ssm.apply(p, cfg_s, x, state=h0)
    np.testing.assert_allclose(y_s.numpy(), y_r.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(h_s.numpy(), h_r.numpy(), rtol=2e-4, atol=2e-5)


def test_ssd_gradients_match_recurrent():
    """tests/test_perf_paths.py::test_ssd_gradients_match_recurrent, in the
    port: every gradient finite and within rtol 2e-3 / atol 2e-4."""
    rcfg = rssm.MambaCfg(32, d_state=8, head_dim=8, impl="recurrent")
    cfg_r = ssm.MambaCfg(**dataclasses.asdict(rcfg))
    cfg_s = dataclasses.replace(cfg_r, impl="ssd", chunk=8)
    _, p = both(rssm.init(jax.random.PRNGKey(1), rcfg))
    x = t_(randn(2, 16, 32, seed=23))

    def grads(cfg):
        leaves = [t.detach().requires_grad_(True) for t in tree.leaves(p)]
        with torch.enable_grad():
            y, _ = ssm.apply(tree.unflatten_like(p, leaves), cfg, x)
            return torch.autograd.grad((y ** 2).sum(), leaves)

    g_s, g_r = grads(cfg_s), grads(cfg_r)
    assert all(bool(torch.isfinite(g).all()) for g in g_s)
    for a, b in zip(g_s, g_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)


# ------------------------------------------------------------------ the LM
def _arch(name, **repl):
    ref = dataclasses.replace(rconfigs.get(name).smoke(), **repl)
    return ref, configs.ArchConfig(**dataclasses.asdict(ref))


def _models(name, seed=0, **repl):
    rarch, arch = _arch(name, **repl)
    rmodel, model = rlm.LM(rarch), LM(arch)
    rp, p = both(rmodel.init(jax.random.PRNGKey(seed)))
    return arch, rmodel, model, rp, p


def _tokens(arch, b, s, seed=11):
    return np.random.default_rng(seed).integers(0, arch.vocab_size, (b, s)).astype(np.int32)


def _cache_err(got: dict, want: dict) -> dict:
    assert sorted(got) == sorted(want)
    out = {}
    for k in got:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        if k == "a_p":  # positions: exact
            np.testing.assert_array_equal(got[k].numpy(), w)
        else:
            out[k] = rel_err(got[k].float(), w.astype(np.float32))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_configs_build(name):
    """``LM`` builds the full-size config and its smoke variant; the dit
    config stays refused (test_torch_lm.py)."""
    for arch in (configs.get(name), configs.get(name).smoke()):
        model = LM(arch)
        assert (model.xl_cfg is not None) == (arch.family == "ssm")
        assert (model.mamba_cfg is not None) == (arch.family == "hybrid")
    assert not hasattr(plm, "NOT_PORTED")


@pytest.mark.parametrize("name", ARCHS)
def test_bridge_carries_the_reference_tree(name):
    """The reference's ``LM.init`` tree converts leaf by leaf into the port's
    own tree (paths, shapes, dtypes; the stacks on (n_super, per_super) and
    the unstacked shared block), and at bfloat16 the dtypes agree too
    (``A_log``, ``D`` and ``dt_bias`` stay float32)."""
    rarch, arch = _arch(name)
    got = bridge.params_from_numpy(numpy_tree(rlm.LM(rarch).init(jax.random.PRNGKey(0))),
                                   device="cpu")
    own = LM(arch).init(torch.Generator().manual_seed(0), device="cpu")
    assert [(k, tuple(v.shape), v.dtype) for k, v in tree.paths(own)] == [
        (k, tuple(v.shape), v.dtype) for k, v in tree.paths(got)]
    rarch16, arch16 = _arch(name, param_dtype="bfloat16")
    shapes = jax.eval_shape(rlm.LM(rarch16).init, jax.random.PRNGKey(0))
    want = [(tuple(s.value.shape), str(s.value.dtype)) for s in
            jax.tree.leaves(shapes, is_leaf=rcore.is_param)]
    own16 = LM(arch16).init(torch.Generator().manual_seed(0), device="cpu")
    assert [(tuple(v.shape), str(v.dtype).replace("torch.", "")) for v in
            tree.leaves(own16)] == want


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("s", [12, 128])
def test_lm_matches_reference(name, s):
    """forward's logits, and prefill's last logits and every cache entry,
    against the reference's: at S = 12 the cells, at S = 128 the chunked
    mLSTM / SSD and a 128-step sLSTM."""
    arch, rmodel, model, rp, p = _models(name)
    tol = REL if s <= 12 else REL_LONG
    toks = _tokens(arch, 2, s)
    want, _ = jax.jit(rmodel.forward)(rp, tokens=jnp.asarray(toks))
    got, aux = model.forward(p, tokens=t_(toks))
    assert rel_err(got, want) <= tol and float(aux) == 0.0
    rlast, rcache = jax.jit(rmodel.prefill)(rp, tokens=jnp.asarray(toks))
    last, cache = model.prefill(p, tokens=t_(toks))
    assert rel_err(last, rlast) <= tol
    errs = _cache_err(cache, rcache)
    assert max(errs.values()) <= tol, errs


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_reference(name):
    """12 decode steps from an empty cache: each step's logits and the final
    cache (every state, the ring and its positions) as the reference's; the
    cache is written in place."""
    arch, rmodel, model, rp, p = _models(name)
    toks = _tokens(arch, 2, 12)
    rstep = jax.jit(rmodel.decode_step)
    rc, c = rmodel.init_cache(2, 12), model.init_cache(2, 12, device="cpu")
    assert sorted(c) == sorted(rc)
    for k in c:  # the same layout, -1e30 / -1 fills included: exact
        np.testing.assert_array_equal(c[k].numpy(), np.asarray(rc[k]))
    held = {k: v for k, v in c.items()}
    for i in range(12):
        rlg, rc = rstep(rp, rc, tokens=jnp.asarray(toks[:, i:i + 1]), pos=jnp.int32(i))
        lg, out = model.decode_step(p, c, tokens=t_(toks[:, i:i + 1]), pos=i)
        assert out is c and all(c[k] is held[k] for k in c)
        assert rel_err(lg, rlg) <= REL, i
    errs = _cache_err(c, rc)
    assert max(errs.values()) <= REL, errs


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """tests/test_models.py::test_decode_matches_forward: rel < 2e-3."""
    arch = configs.get(name).smoke()
    model = LM(arch)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = t_(_tokens(arch, 2, 12))
    full, _ = model.forward(params, tokens=toks)
    cache = model.init_cache(2, 12, device="cpu")
    dec = [model.decode_step(params, cache, tokens=toks[:, i:i + 1], pos=i)[0]
           for i in range(12)]
    dec = torch.cat(dec, dim=1)
    assert float((dec - full).abs().max()) / float(full.abs().max()) < 2e-3


def test_prefill_matches_forward_last_logit():
    """tests/test_models.py::test_prefill_matches_forward_last_logit, for both
    recurrent archs (rtol = atol = 2e-4)."""
    for name in ARCHS:
        arch = configs.get(name).smoke()
        model = LM(arch)
        params = model.init(torch.Generator().manual_seed(1), device="cpu")
        toks = t_(_tokens(arch, 2, 10, seed=3))
        full, _ = model.forward(params, tokens=toks)
        last, _ = model.prefill(params, tokens=toks)
        np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_windowed_ring_decode_matches_forward():
    """tests/test_models.py::test_windowed_ring_decode_matches_forward: with a
    window of 8 the ring wraps over 20 decode steps and equals the windowed
    forward (rel < 2e-3); each step's logits, the ring and its positions also
    as the reference's."""
    arch, rmodel, model, rp, p = _models("zamba2-7b", attn_window=8)
    toks = _tokens(arch, 2, 20)
    full, _ = model.forward(p, tokens=t_(toks))
    cache, rc = model.init_cache(2, 20, device="cpu"), rmodel.init_cache(2, 20)
    assert cache["a_k"].shape[2] == 8
    rstep = jax.jit(rmodel.decode_step)
    outs = []
    for i in range(20):
        lg, cache = model.decode_step(p, cache, tokens=t_(toks[:, i:i + 1]), pos=i)
        rlg, rc = rstep(rp, rc, tokens=jnp.asarray(toks[:, i:i + 1]), pos=jnp.int32(i))
        assert rel_err(lg, rlg) <= REL, i
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - full).abs().max()) / float(full.abs().max()) < 2e-3
    assert cache["a_p"].tolist() == [[16, 17, 18, 19, 12, 13, 14, 15]]
    errs = _cache_err(cache, rc)
    assert max(errs.values()) <= REL, errs


@pytest.mark.parametrize("s,w", [(12, 8), (8, 8), (5, 8), (20, 32), (17, 4)])
def test_ring_from_full_matches_reference(s, w):
    k, v = randn(2, s, 3, 4, seed=24), randn(2, s, 3, 4, seed=25)
    want = rlm._ring_from_full(jnp.asarray(k), jnp.asarray(v), w)
    got = plm._ring_from_full(t_(k), t_(v), w)
    for g, wt in zip(got, want):
        assert g.dtype == torch.from_numpy(np.array(wt)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt))


@pytest.mark.parametrize("name", ARCHS)
def test_decode_far_past_the_prompt(name):
    """A decode step at position 524,287 (``long_500k``'s last) after a
    12-token prefill: no raise (the ring wraps at ``pos % W``; the states
    have no length), the logits and the cache as the reference's (run
    unjitted: see the module's docstring), with the position an int and a
    0-d tensor."""
    arch, rmodel, model, rp, p = _models(name)
    toks = _tokens(arch, 2, 13)
    _, rc = jax.jit(rmodel.prefill)(rp, tokens=jnp.asarray(toks[:, :12]))
    far = 524_287
    # the hybrid's RoPE: XLA's fused sin / cos are 3.6e-3 off at 5.2e5 rad
    with jax.disable_jit(disable=name == "zamba2-7b"):
        rlg, rc2 = rmodel.decode_step(rp, rc, tokens=jnp.asarray(toks[:, 12:]),
                                      pos=jnp.int32(far))
    for pos in (far, torch.tensor(far, dtype=torch.int32)):
        _, c = model.prefill(p, tokens=t_(toks[:, :12]))
        lg, c = model.decode_step(p, c, tokens=t_(toks[:, 12:]), pos=pos)
        assert rel_err(lg, rlg) <= REL
        errs = _cache_err(c, rc2)
        assert max(errs.values()) <= REL, errs
        if name == "zamba2-7b":  # slot 524287 % 12 = 7 now holds the far position
            assert c["a_p"][0, far % 12] == far


def _ref_loss_for(rarch):
    """The reference's train loss (``loss_for`` of its train step)."""
    fn = rsteps.make_train_step(rarch, rsteps.make_optimizer(rarch))
    return dict(zip(fn.__code__.co_freevars, fn.__closure__))["loss_for"].cell_contents


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("seq", [16, 128])
def test_train_step_gradients_match_reference(name, seq):
    """``LMTrainStep``'s loss and gradients against ``jax.grad`` of the
    reference's train loss (CE + 0.01 aux) on an ``lm_batch``: at S = 16
    the cells, at S = 128 the chunked forms (remat on, as the configs
    say); the shared attention's one set of weights gets the sum over its
    applications, as the reference's. The gradients are held to ``GRAD``
    (S = 16) and ``GRAD_LONG`` (S = 128): see the module's docstring."""
    rarch, arch = _arch(name)
    tol = GRAD if seq <= 16 else GRAD_LONG
    rp, p = both(rlm.LM(rarch).init(jax.random.PRNGKey(2)))
    batch = lm_batch(arch, DataCfg(seed=0, batch=2, seq_len=seq), 0, device="cpu")
    rbatch = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in batch.items()}
    (_, (rce, _)), rg = jax.jit(jax.value_and_grad(_ref_loss_for(rarch), has_aux=True))(
        rp, rbatch)
    train = steps.make_train_step(arch, steps.make_optimizer(arch))
    ce, aux, grads = train.loss_and_grads(p, batch)
    assert float(ce) == pytest.approx(float(rce), rel=REL) and float(aux) == 0.0
    got, want = tree.leaves(grads), jax.tree.leaves(rg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert rel_err(g, w) <= tol


@pytest.mark.parametrize("name,seq", [("xlstm-125m", 16), ("xlstm-125m", 320),
                                      ("zamba2-7b", 16), ("zamba2-7b", 128)])
def test_remat_is_bit_exact(name, seq):
    """``cfg.remat`` (each super-block, and in the hybrid each Mamba2 layer,
    recomputed in the backward, around the chunks' and the scan segments'
    own checkpoints; at S = 320 the cells run in 5 segments of 64) leaves the
    loss and every gradient as they are without it, bit for bit."""
    arch = configs.get(name).smoke()
    params = LM(arch).init(torch.Generator().manual_seed(0), device="cpu")
    batch = lm_batch(arch, DataCfg(seed=1, batch=2, seq_len=seq), 0, device="cpu")
    out = {}
    for remat in (True, False):
        train = steps.make_train_step(dataclasses.replace(arch, remat=remat),
                                      steps.make_optimizer(arch))
        out[remat] = train.loss_and_grads(params, batch)
    (ce1, _, g1), (ce0, _, g0) = out[True], out[False]
    assert torch.equal(ce1, ce0)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g1), tree.leaves(g0)))
    assert all(bool(g.abs().sum() > 0) for g in tree.leaves(g1) if g.dim() > 1)


def test_xlstm_long_forward_is_float32_close():
    """What ``REL_LONG`` rests on: at S = 128, float32 is about 1e-5 of the
    logits' scale off a float64 run of the same model (the port's xlstm-125m
    in float64). Both packages' float32 logits stay within ``REL_LONG`` of
    it, and the port's are no further off than twice the reference's."""
    arch, rmodel, model, rp, p = _models("xlstm-125m")
    toks = _tokens(arch, 2, 128)
    want, _ = jax.jit(rmodel.forward)(rp, tokens=jnp.asarray(toks))
    got, _ = model.forward(p, tokens=t_(toks))
    arch64 = dataclasses.replace(arch, param_dtype="float64", activation_dtype="float64")
    p64 = tree.map_tree(lambda a: a.double(), p)
    with torch.no_grad():
        truth, _ = LM(arch64).forward(p64, tokens=t_(toks))
    ref_err, port_err = rel_err(np.asarray(want), truth.numpy()), rel_err(got, truth.numpy())
    assert ref_err <= REL_LONG and port_err <= REL_LONG
    assert port_err <= 2 * ref_err, (port_err, ref_err)


@pytest.mark.parametrize("name", ARCHS)
def test_train_driver_resume_bitexact(name, tmp_path):
    """``TrainDriver`` takes the recurrent families with no family-specific
    code: 4 steps straight equal 2 + a restart + 2, bit for bit."""
    arch = configs.get(name).smoke()
    kw = dict(batch=2, seq=16, total_steps=4, ckpt_every=0, device="cpu")
    d1 = TrainDriver(arch, workdir=str(tmp_path / "a"), **kw)
    s1, _ = d1.run()
    TrainDriver(arch, workdir=str(tmp_path / "b"), **kw).run(steps=2)
    d3 = TrainDriver(arch, workdir=str(tmp_path / "b"), **kw)
    s3, step = d3.run()
    assert step == 4 and all(np.isfinite(m["loss"]) for m in d1.metrics_log)
    assert [m["loss"] for m in d3.metrics_log] == [m["loss"] for m in d1.metrics_log[2:]]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(s1), tree.leaves(s3)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_widened_ring_decodes_as_forward():
    """``chip_smoke.py:padded_cache`` widens a prefill's ring (W = the
    prompt's length) to the window, zero k / v and position -1 in the new
    slots: a decode past the prompt then equals the windowed forward
    (rel < 2e-3) and the reference's decode over a ring of the window's
    width. An xLSTM cache has no length and passes through."""
    smoke = _chip_smoke()
    arch, rmodel, model, rp, p = _models("zamba2-7b", attn_window=8)
    toks = _tokens(arch, 2, 14)
    _, pc = model.prefill(p, tokens=t_(toks[:, :5]))
    cache = smoke.padded_cache(model, pc, 64)
    assert cache["a_k"].shape[2] == 8 and cache["a_p"].tolist() == [[0, 1, 2, 3, 4, -1, -1, -1]]
    full, _ = model.forward(p, tokens=t_(toks))
    rc = rmodel.init_cache(2, 14)
    rstep = jax.jit(rmodel.decode_step)
    for i in range(5):
        _, rc = rstep(rp, rc, tokens=jnp.asarray(toks[:, i:i + 1]), pos=jnp.int32(i))
    outs = []
    for i in range(5, 14):
        lg, cache = model.decode_step(p, cache, tokens=t_(toks[:, i:i + 1]), pos=i)
        rlg, rc = rstep(rp, rc, tokens=jnp.asarray(toks[:, i:i + 1]), pos=jnp.int32(i))
        assert rel_err(lg, rlg) <= REL
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - full[:, 5:]).abs().max()) / float(full.abs().max()) < 2e-3
    xarch = configs.get("xlstm-125m").smoke()
    xm = LM(xarch)
    xc = xm.init_cache(2, 4, device="cpu")
    assert smoke.padded_cache(xm, xc, 64) is xc


@pytest.mark.parametrize("n", [1, 5, 8, 128])
def test_cummax_is_torch_cummax(n):
    """``xlstm.cummax`` (element-wise maxima, no scatter in its backward) has
    ``torch.cummax``'s and the reference's ``lax.cummax`` values bit for
    bit, and without ties ``torch.cummax``'s gradient (each entry a sum of
    the same terms in another order: within 1e-6)."""
    a = randn(3, n, 4, seed=n)
    got = xlstm.cummax(t_(a))
    np.testing.assert_array_equal(got.numpy(), torch.cummax(t_(a), dim=1).values.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.lax.cummax(jnp.asarray(a), axis=1)))
    w = t_(randn(3, n, 4, seed=n + 1))
    grads = []
    for fn in (xlstm.cummax, lambda x: torch.cummax(x, dim=1).values):
        x = t_(a).requires_grad_(True)
        with torch.enable_grad():
            grads.append(torch.autograd.grad((fn(x) * w).sum(), x)[0])
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-6, atol=1e-6)
