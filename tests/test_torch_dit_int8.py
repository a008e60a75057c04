"""The W8A8 DiT step (``models/dit_int8.py``) in the port against the
reference, on the CPU.

Both packages quantize the same numpy weights: the int8 weights and their
float32 scales must be bit-identical (the same true divisions, rounding
half to even). Given the reference's own int8 operands, the port's product
(``ops.int8_act_matmul``, the kernel's plain version here) must give the
reference's int32 product exactly. The whole step is held to the
reference's within 1e-3 of the output's scale: XLA and PyTorch sum the
float32 glue (LayerNorm, softmax, attention products) in other orders, and
a one-ulp difference can flip an activation's int8 rounding. As
``tests/test_perf_paths.py`` does for the reference, the step must stay
within 0.1 (relative L2) of the float DiT.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import dit_int8 as rq  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro.nn import dit as rdit  # noqa: E402
from repro_torch import bridge, configs, tree  # noqa: E402
from repro_torch.kernels import int8_matmul as k_int8  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import dit_int8  # noqa: E402
from repro_torch.nn import dit  # noqa: E402

# tests/test_perf_paths.py::test_int8_dit_serve_close_to_fp32's model
CFG_KW = dict(d_model=64, n_layers=3, n_heads=4, patch=2, in_channels=4, input_size=8,
              n_classes=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["zero_mod", "refilled_mod"])
def model(request):
    """(reference cfg, port cfg, numpy params): the reference's init, as
    published (adaLN-Zero: the blocks' gates start at 0) or with the
    ``mod`` weights refilled N(0, 0.02) so every block reaches the output."""
    rcfg = rdit.DiTCfg(**CFG_KW)
    p = jax.tree.map(lambda p: np.asarray(p.value), rdit.init(jax.random.PRNGKey(0), rcfg),
                     is_leaf=rcore.is_param)
    if request.param == "refilled_mod":
        w = p["blocks"]["mod"]["w"]
        p["blocks"]["mod"]["w"] = (np.random.default_rng(1).standard_normal(w.shape)
                                   * 0.02).astype(np.float32)
    return rcfg, dit.DiTCfg(**CFG_KW), p


def inputs():
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    return lat, np.array([700.0, 500.0], np.float32), np.array([1, 2], np.int32)


def test_quantize_params_bit_identical(model):
    rcfg, cfg, p = model
    want = rq.quantize_params(jax.tree.map(jnp.asarray, p), rcfg)
    got = dit_int8.quantize_params(bridge.params_from_numpy(p, device="cpu"), cfg)
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_flat = list(tree.paths(got))
    assert [tree.key_of(k) for k, _ in got_flat] == [
        "/".join(str(k.key) for k in path) for path, _ in want_flat]
    for (path, w), (_, g) in zip(want_flat, got_flat):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=jax.tree_util.keystr(path))


def test_int8_product_exact_on_reference_operands(model):
    """The reference's _qdense operands, quantized by the reference; the
    port quantizes the same activations to the same bits and multiplies
    them to the same int32 product."""
    rcfg, _, p = model
    qp = rq.quantize_params(jax.tree.map(jnp.asarray, p), rcfg)
    rng = np.random.default_rng(5)
    for w8, rows in ((qp["patch_embed"]["w8"], (2, 16)), (qp["t_mlp2"]["w8"], (2,)),
                     (jax.tree.map(lambda a: a[1], qp["blocks"]["mlp"]["wi"]["w8"]), (2, 16)),
                     (jax.tree.map(lambda a: a[2], qp["blocks"]["mod"]["w8"]), (2,))):
        k = w8["q"].shape[0]
        x = (rng.standard_normal(rows + (k,)) * 3).astype(np.float32)
        # src/repro/models/dit_int8.py:_qdense, its quantization and product
        amax = jnp.max(jnp.abs(jnp.asarray(x)))
        xs = jnp.where(amax > 0, amax / 127.0, 1.0)
        xq = jnp.clip(jnp.round(jnp.asarray(x) / xs), -127, 127).astype(jnp.int8)
        want = jax.lax.dot_general(xq, w8["q"], (((xq.ndim - 1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        got_q, got_s = dit_int8.quantize_act(torch.from_numpy(x))
        assert got_q.dtype == torch.int8
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(xq))
        assert float(got_s) == float(xs)
        prod = dit_int8.int8_product(torch.from_numpy(np.array(xq)),
                                     torch.from_numpy(np.array(w8["q"])))
        assert prod.dtype == torch.int32
        np.testing.assert_array_equal(prod.numpy(), np.asarray(want))
    # an all-zero activation keeps the scale at 1, as the reference's
    assert float(dit_int8.quantize_act(torch.zeros(2, 8))[1]) == 1.0


def test_apply_matches_reference(model):
    rcfg, cfg, p = model
    lat, t, labels = inputs()
    want = rq.apply(rq.quantize_params(jax.tree.map(jnp.asarray, p), rcfg), rcfg,
                    jnp.asarray(lat), jnp.asarray(t), jnp.asarray(labels))
    qp = dit_int8.quantize_params(bridge.params_from_numpy(p, device="cpu"), cfg)
    got = dit_int8.apply(qp, cfg, torch.from_numpy(lat), torch.from_numpy(t),
                         torch.from_numpy(labels).long())
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_apply_close_to_float_apply(model):
    """tests/test_perf_paths.py::test_int8_dit_serve_close_to_fp32, in the port."""
    _, cfg, p = model
    lat, t, labels = (torch.from_numpy(a) for a in inputs())
    params = bridge.params_from_numpy(p, device="cpu")
    y_fp = dit.apply(params, cfg, lat, t, labels.long())
    y_q8 = dit_int8.apply(dit_int8.quantize_params(params, cfg), cfg, lat, t, labels.long())
    rel = float(torch.linalg.norm(y_q8 - y_fp) / torch.linalg.norm(y_fp))
    assert rel < 0.1, rel


def test_denoise_steps_and_no_launch_on_the_cpu():
    """make_denoise_step(int8=) runs the two models; on CPU tensors the
    product takes the plain version and launches no kernel."""
    arch = configs.get("dit-xl2").smoke()
    cfg = steps.make_dit_model(arch)
    params = dit.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=torch.Generator().manual_seed(1))
    qp = dit_int8.quantize_params(params, cfg)
    g = torch.Generator().manual_seed(2)
    batch = {"latents": torch.randn((2, 8, 8, 4), generator=g), "t": torch.tensor([3, 900]),
             "labels": torch.tensor([0, 9])}
    before = k_int8.launches
    y_q8 = steps.make_denoise_step(arch, int8=True)(qp, batch)
    assert k_int8.launches == before
    assert torch.equal(y_q8, dit_int8.apply(qp, cfg, batch["latents"], batch["t"],
                                            batch["labels"]))
    y_fp = steps.make_denoise_step(arch)(params, batch)
    assert torch.equal(y_fp, dit.apply(params, cfg, batch["latents"], batch["t"],
                                       batch["labels"]))
    assert float(torch.linalg.norm(y_q8 - y_fp) / torch.linalg.norm(y_fp)) < 0.1


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
def test_card_step_launches_int8_matmul_and_matches_the_cpu():
    """On the card every product launches the hand-written kernel; products
    are exact, so only the float32 glue may differ from the CPU's."""
    arch = configs.get("dit-xl2").smoke()
    cfg = steps.make_dit_model(arch)
    params = dit.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    qp = dit_int8.quantize_params(params, cfg)
    lat, t, labels = (torch.from_numpy(a) for a in inputs())
    want = dit_int8.apply(qp, cfg, lat, t, labels.long())
    before = k_int8.launches
    got = dit_int8.apply(tree.map_tree(lambda a: a.cuda(), qp), cfg, lat.cuda(), t.cuda(),
                         labels.long().cuda())
    # per block: mod, q, k, v, o, wi, wo; then patch_embed, t_mlp1, t_mlp2,
    # final_mod, final_out
    assert k_int8.launches - before == 7 * cfg.n_layers + 5
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-3 * float(want.abs().max()))
