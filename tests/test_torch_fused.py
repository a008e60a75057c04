"""The port's packed-int4 and fused-flow kernels vs the reference, bit for bit.

Inputs are made with numpy from a seed and fed to both packages: the
reference runs its Pallas kernels in interpret mode on the CPU (as its own
tests do), the port's wrappers run their plain PyTorch versions (a CPU
tensor selects them). Shapes sit off the 128-tile grid; rows mix every
tile class, with Δ on the class boundaries {0, 7, 8}. The Δ-cache planes
of ``diff_encode_fused`` are compared only on the tiles whose class gates
them in: the kernel leaves the rest unwritten (the reference's interpreter
leaves them at its buffer's fill).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import dma_model as rdma  # noqa: E402
from repro.kernels import fused_step as rfused  # noqa: E402
from repro.kernels import int4_pack as rpack  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import dma_model, fused_step, int4_pack, ops, ref  # noqa: E402
from repro_torch.kernels.common import pad2  # noqa: E402

from _torch_mixes import delta_pair  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mixed_rows(rng, m, k):
    """Rows in bands of every class, plus a whole class-0 tile and a whole
    class-1 tile, so every class occurs as a tile class."""
    x_t, x_p = delta_pair(rng, (m, k), "full")
    for r0, mix in zip(range(0, m, 32), ["zero", "low", "edge", "full", "zero", "low",
                                         "low", "zero", "full"]):
        x_t[r0:r0 + 32], x_p[r0:r0 + 32] = delta_pair(rng, (min(32, m - r0), k), mix)
    x_p[:128, :128] = x_t[:128, :128]
    if m > 128:
        x_t[128:256, :128], x_p[128:256, :128] = delta_pair(rng, (min(128, m - 128), 128), "low")
    return x_t, x_p


def test_pack_int4_matches_reference():
    """Every lane pair in [-8, 7], both ways; plus the reference's behaviour
    out of range (each lane keeps its low nibble)."""
    lanes = np.arange(-8, 8)
    pairs = np.stack(np.meshgrid(lanes, lanes, indexing="ij"), -1).reshape(1, -1)  # (1, 512)
    got = int4_pack.pack_int4(_t(pairs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rpack.pack_int4(jnp.asarray(pairs))))
    np.testing.assert_array_equal(int4_pack.unpack_int4(got).numpy(), pairs)
    lo, hi = int4_pack.unpack_int4_lanes(got)
    rlo, rhi = rpack.unpack_int4_lanes(jnp.asarray(got.numpy()))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    wide = np.random.default_rng(0).integers(-254, 255, size=(3, 40))
    np.testing.assert_array_equal(int4_pack.pack_int4(_t(wide)).numpy(),
                                  np.asarray(rpack.pack_int4(jnp.asarray(wide))))
    with pytest.raises(ValueError, match="even"):
        int4_pack.pack_int4(torch.zeros(2, 3, dtype=torch.int32))


FLOWS = {"low_bits4": dict(low_bits=4), "fused": dict(fused=True),
         "fused_low_bits4": dict(fused=True, low_bits=4)}


@pytest.mark.parametrize("shape", [(288, 160, 130), (160, 288, 96)])
@pytest.mark.parametrize("with_y_prev", [True, False])
@pytest.mark.parametrize("w_transposed", [False, True])
@pytest.mark.parametrize("flow", list(FLOWS))
def test_ditto_linear_step_packed_and_fused_match_pallas(shape, with_y_prev, w_transposed,
                                                         flow):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n + 2 * with_y_prev + w_transposed)
    x_t, x_p = _mixed_rows(rng, m, k)
    w = rng.integers(-127, 128, size=(n, k) if w_transposed else (k, n)).astype(np.int8)
    y_prev = rng.integers(-2**20, 2**20, size=(m, n)).astype(np.int32) if with_y_prev else None
    want_y, want_c = rops.ditto_linear_step(
        jnp.asarray(x_t), jnp.asarray(x_p), jnp.asarray(w),
        None if y_prev is None else jnp.asarray(y_prev), w_transposed=w_transposed,
        **FLOWS[flow])
    got_y, got_c = ops.ditto_linear_step(_t(x_t), _t(x_p), _t(w),
                                         None if y_prev is None else _t(y_prev),
                                         w_transposed=w_transposed, **FLOWS[flow])
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    assert {0, 1, 2} <= set(got_c.flatten().tolist())


@pytest.mark.parametrize("mix", ["zero", "low", "edge", "full", "mixed", "lone"])
def test_diff_encode_fused_matches_pallas(mix):
    """Classes in full; ``dc`` on class >= 1 tiles and ``dh`` on class-2
    tiles; and Δ = lo + (dh << 4) rebuilt from the port's planes."""
    rng = np.random.default_rng(len(mix))
    x_t, x_p = (_mixed_rows(rng, 288, 160) if mix == "mixed"
                else delta_pair(rng, (288, 160), mix))
    xt, xp = pad2(_t(x_t), 128, 128), pad2(_t(x_p), 128, 128)
    cls, dc, dh = fused_step.diff_encode_fused(xt, xp)
    rcls, rdc, rdh = (np.asarray(a) for a in rfused.diff_encode_fused(
        jnp.asarray(xt.numpy()), jnp.asarray(xp.numpy())))
    np.testing.assert_array_equal(cls.numpy(), rcls)
    live = np.repeat(np.repeat(rcls >= 1, 128, 0), 64, 1)
    full = np.repeat(np.repeat(rcls == 2, 128, 0), 128, 1)
    np.testing.assert_array_equal(dc.numpy()[live], rdc[live])
    np.testing.assert_array_equal(dh.numpy()[full], rdh[full])
    lo = int4_pack.unpack_int4(dc).numpy()
    d = xt.numpy().astype(np.int32) - xp.numpy().astype(np.int32)
    rebuilt = lo + np.where(full, dh.numpy().astype(np.int32) << 4, 0)
    np.testing.assert_array_equal(np.where(live.repeat(2, 1), rebuilt, 0), d)


def test_fused_matmul_reads_only_gated_tiles():
    """Garbage in the ungated parts of the cache (what a kernel leaves in a
    fresh buffer) changes nothing: class 0 reads no plane, class 1 no dh."""
    rng = np.random.default_rng(7)
    x_t, x_p = _mixed_rows(rng, 256, 384)
    xt, xp = _t(x_t), _t(x_p)
    w = _t(rng.integers(-127, 128, size=(384, 256)).astype(np.int8))
    cls, dc, dh = fused_step.diff_encode_fused(xt, xp)
    assert {0, 1, 2} <= set(cls.flatten().tolist())
    live = ref.tile_mask(cls, (128, 64), lambda c: c >= 1)
    full = ref.tile_mask(cls, (128, 128), lambda c: c == 2)
    dc_junk = torch.where(live, dc, _t(rng.integers(-128, 128, dc.shape).astype(np.int8)))
    dh_junk = torch.where(full, dh, _t(rng.integers(-128, 128, dh.shape).astype(np.int8)))
    want = ref.ditto_diff_matmul_ref(xt, xp, w, classes=cls)
    np.testing.assert_array_equal(fused_step.ditto_fused_matmul(w, dc_junk, dh_junk, cls).numpy(),
                                  want.numpy())


def test_low_bits4_plain_packs_class1_tiles():
    """The int4 branch's plain version really goes through the packed word:
    a tile marked class 1 whose Δ does not fit a nibble keeps only each
    lane's low nibble, as the kernel's packing does."""
    rng = np.random.default_rng(11)
    x_t, x_p = delta_pair(rng, (128, 256), "full")
    xt, xp = _t(x_t), _t(x_p)
    w = _t(rng.integers(-127, 128, size=(256, 128)).astype(np.int8))
    cls = torch.tensor([[1, 2]], dtype=torch.int32)
    got = ref.ditto_diff_matmul_ref(xt, xp, w, classes=cls, low_bits=4)
    d = xt.int() - xp.int()
    nib = ((d[:, :128] & 0xF) ^ 8) - 8
    want = ref.exact_matmul(nib, w[:128]) + ref.exact_matmul(d[:, 128:], w[128:])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not torch.equal(got, ref.ditto_diff_matmul_ref(xt, xp, w, classes=cls))


@pytest.mark.parametrize("flow", list(FLOWS))
def test_attention_delta_batched_matches_pallas_per_element(flow):
    """One batched port call == the reference's per-element calls."""
    rng = np.random.default_rng(3)
    b, m, n, d = 3, 96, 130, 40
    q_t, q_p = delta_pair(rng, (b, m, d), "low")
    k_t, k_p = delta_pair(rng, (b, n, d), "full")
    k_p[1] = k_t[1]  # one element whose ΔK tiles are all class 0
    s_prev = rng.integers(-2**20, 2**20, size=(b, m, n)).astype(np.int32)
    got, (cls_dk, cls_dq) = ops.attention_delta(_t(q_t), _t(q_p), _t(k_t), _t(k_p), _t(s_prev),
                                                **FLOWS[flow])
    for i in range(b):
        want, (wdk, wdq) = rops.attention_delta(
            *(jnp.asarray(a[i]) for a in (q_t, q_p, k_t, k_p, s_prev)), **FLOWS[flow])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(cls_dk[i].numpy(), np.asarray(wdk))
        np.testing.assert_array_equal(cls_dq[i].numpy(), np.asarray(wdq))


@pytest.mark.parametrize("seed", range(4))
def test_hold_maps_and_dma_model_match_reference(seed):
    rng = np.random.default_rng(seed)
    gm, gk, gn = rng.integers(1, 5, size=3)
    cls = rng.integers(0, 3, size=(gm, gk)).astype(np.int32)
    if seed == 0:
        cls[:] = 0  # nothing is ever needed: every index falls back to 0
    for wt in (False, True):
        got = fused_step.hold_maps(_t(cls), int(gn), w_transposed=wt)
        want = rfused.hold_maps(jnp.asarray(cls), int(gn), w_transposed=wt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert dma_model.fused_tile_dma(cls, int(gn), w_transposed=wt) == \
            rdma.fused_tile_dma(cls, int(gn), w_transposed=wt)
    assert dma_model.two_pass_tile_dma(cls, int(gn)) == rdma.two_pass_tile_dma(cls, int(gn))
    for yp in (True, False):
        assert dma_model.model_hbm_bytes(cls, int(gn), y_prev=yp) == \
            rdma.model_hbm_bytes(cls, int(gn), y_prev=yp)
