"""The difference GEMMs' inputs on the CPU: the sparse tile-class pattern
the card's parity phase holds, and the K-major weights the compiled pass
hands the kernels.

The kernels split K at 128-K class-tile boundaries and walk only live
tiles (``csrc/diff_gemm_sm90.cuh``); which split a launch takes is the
kernel's own choice and is held on the card by chip_smoke.py, at every
split count. Here the plain versions that the wrappers run on a CPU tensor
are held to the reference's Pallas kernels (interpret mode) on Δ whose tile
classes 0 / 1 / 2 interleave along K, with a row of tiles that has no live
tile, in every flow and both weight layouts. The compiled pass keeps each
linear weight as (N, K): it must equal the reference's ``w_q`` transposed
bit for bit, and the compiled layer must still equal the eager one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.ditto import DittoEngine as RDittoEngine  # noqa: E402
from repro.core.ditto import LayerMeta as RLayerMeta  # noqa: E402
from repro.core.ditto.compiled import CompiledDittoEngine as RCompiledDittoEngine  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core.ditto import DittoEngine, LayerMeta  # noqa: E402
from repro_torch.core.ditto.compiled import CompiledDittoEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FLOWS = {"two_pass": {}, "low_bits4": dict(low_bits=4), "fused": dict(fused=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse_pair(rng, m, k):
    """(x_t, x_prev) int8 whose 128 x 128 tile classes interleave 0 / 1 / 2
    along K, shifted by row; the first row of tiles has no live tile in the
    first half of K, the last row none at all."""
    gm, gk = -(-m // 128), -(-k // 128)
    i, j = np.arange(gm)[:, None], np.arange(gk)[None, :]
    cls = (i + j) % 3
    cls[0, :gk // 2] = 0
    cls[gm - 1] = 0
    cls = np.repeat(np.repeat(cls, 128, 0), 128, 1)[:m, :k]
    x_t = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    d = np.where(cls == 2, rng.integers(-254, 255, size=(m, k)),
                 np.where(cls == 1, rng.integers(-7, 8, size=(m, k)), 0))
    return x_t, np.clip(x_t.astype(np.int32) - d, -127, 127).astype(np.int8)


@pytest.mark.parametrize("with_y_prev", [True, False])
@pytest.mark.parametrize("w_transposed", [False, True])
@pytest.mark.parametrize("flow", list(FLOWS))
def test_sparse_tile_classes_match_pallas(with_y_prev, w_transposed, flow):
    m, k, n = 300, 640, 96
    rng = np.random.default_rng(11 + 2 * with_y_prev + w_transposed)
    x_t, x_p = _sparse_pair(rng, m, k)
    w = rng.integers(-127, 128, size=(n, k) if w_transposed else (k, n)).astype(np.int8)
    y_prev = rng.integers(-2**20, 2**20, size=(m, n)).astype(np.int32) if with_y_prev else None
    want_y, want_c = rops.ditto_linear_step(
        jnp.asarray(x_t), jnp.asarray(x_p), jnp.asarray(w),
        None if y_prev is None else jnp.asarray(y_prev), w_transposed=w_transposed,
        **FLOWS[flow])
    got_y, got_c = ops.ditto_linear_step(
        torch.from_numpy(x_t), torch.from_numpy(x_p), torch.from_numpy(np.ascontiguousarray(w)),
        None if y_prev is None else torch.from_numpy(y_prev), w_transposed=w_transposed,
        **FLOWS[flow])
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    cls = got_c.numpy()
    assert {0, 1, 2} <= set(cls.flatten().tolist())
    assert (cls[-1] == 0).all() and (cls[0, :cls.shape[1] // 2] == 0).all()


@pytest.mark.parametrize("policy", ["act", "diff"])
def test_compiled_weights_are_reference_w_q_transposed(policy):
    """The compiled pass's K-major ``w_qk`` equals the reference compiled
    engine's ``w_q`` transposed, bit for bit, and its layers still equal
    the eager ones."""
    rng = np.random.default_rng(5)
    eng = DittoEngine(policy, device="cpu")
    reng = RDittoEngine(policy)
    shapes = {"a": (13, 40, 24), "b": (130, 200, 96)}
    for name, (_, k, n) in shapes.items():
        w = rng.standard_normal((k, n)).astype(np.float32)
        eng.register_linear(LayerMeta(name), torch.from_numpy(w))
        reng.register_linear(RLayerMeta(name), w)
    eng.begin_sample()
    reng.begin_sample()
    for _ in range(2):
        for name, (t, k, _) in shapes.items():
            x = rng.standard_normal((t, k)).astype(np.float32)
            eng.linear(name, torch.from_numpy(x))
            reng.linear(name, jnp.asarray(x))
        eng.end_step()
        reng.end_step()
    ceng, rceng = CompiledDittoEngine(eng), RCompiledDittoEngine(reng)
    state = ceng.init_state()
    for name, (t, k, n) in shapes.items():
        w_qk = ceng.params[name]["w_qk"]
        assert w_qk.shape == (n, k) and w_qk.dtype == torch.int8 and w_qk.is_contiguous()
        np.testing.assert_array_equal(w_qk.numpy(), np.asarray(rceng.params[name]["w_q"]).T)
        x = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32))
        y, st, _ = ceng.linear(name, x, state[name])
        np.testing.assert_array_equal(y.numpy(), eng.linear(name, x).numpy())
        np.testing.assert_array_equal(st["y_prev"].numpy(), eng.layers[name].y_prev.numpy())
