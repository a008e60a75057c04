"""Port kernels vs the reference's Pallas kernels, bit for bit.

Inputs are made with numpy from a seed and fed to both packages: the
reference's ops run their Pallas kernels in interpret mode on the CPU (as
its own tests do), the port's wrappers run their plain PyTorch versions
(a CPU tensor selects them). Shapes are deliberately off the 128-tile
grid, Δ mixes sit on the class boundaries {0, 7, 8}, and y_prev is given
and absent, with plain and transposed weights. The card leg holds each
CUDA kernel against its plain version and skips where there is no card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.common import DEFAULT_LOW_BITS as REF_DEFAULT_LOW_BITS  # noqa: E402
from repro.kernels.diff_encode import LOW_BIT_MAX as REF_LOW_BIT_MAX  # noqa: E402
from repro_torch.kernels import common, ops, ref  # noqa: E402
from repro_torch.kernels import diff_encode as pdiff_encode  # noqa: E402
from repro_torch.kernels import ditto_diff_matmul as pdiff_mm  # noqa: E402
from repro_torch.kernels import fused_step as pfused  # noqa: E402
from repro_torch.kernels import int8_matmul as pint8  # noqa: E402

from _torch_mixes import delta_pair  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i8(rng, shape, lo=-127, hi=127):
    return rng.integers(lo, hi + 1, size=shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_constants_match_reference():
    assert common.LOW_BIT_MAX == REF_LOW_BIT_MAX
    assert common.DEFAULT_LOW_BITS == REF_DEFAULT_LOW_BITS


# off-grid shapes, then the act path's padding cases: attention's head-dim
# K = 72, final.out's N = 16, mod's M = 2 (the batch), and a leading batch
# dim of 4 (attention's batch x heads, one launch) held per element
ACT_SHAPES = [pytest.param(*s, id="-".join(map(str, (*s[0], *s[1:])))) for s in [
    ((), 96, 128, 160), ((), 160, 96, 128), ((), 128, 160, 96),
    ((), 40, 72, 96), ((), 96, 160, 16), ((), 2, 160, 96), ((4,), 48, 72, 40)]]


@pytest.mark.parametrize("lead,m,k,n", ACT_SHAPES)
@pytest.mark.parametrize("w_transposed", [False, True])
def test_int8_act_matmul_matches_pallas(lead, m, k, n, w_transposed):
    rng = np.random.default_rng(len(lead) + m + 7 * k + n + w_transposed)
    x = _i8(rng, lead + (m, k), -128, 127)
    w = _i8(rng, lead + ((n, k) if w_transposed else (k, n)), -128, 127)
    got = ops.int8_act_matmul(_t(x), _t(w), w_transposed=w_transposed)
    assert got.shape == lead + (m, n) and got.dtype == torch.int32
    for i in np.ndindex(*lead):
        w_kn = w[i].T if w_transposed else w[i]
        want = np.asarray(rops.int8_act_matmul(jnp.asarray(x[i]), jnp.asarray(w_kn)))
        np.testing.assert_array_equal(got[i].numpy(), want)
    if not w_transposed and not lead:  # the scaled fp32 act path on top of it
        xs = np.float32(0.03)
        ws = rng.random(n).astype(np.float32)
        np.testing.assert_array_equal(
            ops.quantized_matmul(_t(x), _t(w), torch.tensor(xs), _t(ws)).numpy(),
            np.asarray(rops.quantized_matmul(jnp.asarray(x), jnp.asarray(w), xs, jnp.asarray(ws))))


MIXES = ["zero", "low", "edge", "full", "lone"]


@pytest.mark.parametrize("mix", MIXES)
def test_encode_classes_matches_pallas(mix):
    rng = np.random.default_rng(MIXES.index(mix))
    x_t, x_p = delta_pair(rng, (160, 288), mix)
    if mix == "edge":  # one tile exactly at the low/full boundary each way
        x_p[:128, :128] = np.clip(x_t[:128, :128].astype(np.int32) - 7, -127, 127)
    want = np.asarray(rops.encode_classes(jnp.asarray(x_t), jnp.asarray(x_p)))
    got = ops.encode_classes(_t(x_t), _t(x_p))
    np.testing.assert_array_equal(got.numpy(), want)


# encode launches of the main path at B = 2 (class tiles, batch included,
# after the ops wrappers' 128-padding) -> the cluster size each takes on a
# 132-SM H100, the fastest or within 4 % of it in the sweep of
# benchmarks/torch_encode_sweep.py with the operands as the step finds them
PATH_ENCODE_CLUSTERS = {
    "wq/wk/wv/wo/wi/final.out x (512, 1152)": (36, 2),
    "mod x (2 -> 128, 1152)": (9, 8),
    "wd x (512, 4608)": (144, 1),
    "attention q / k sub-ops 32 x (256, 72 -> 128)": (64, 2),
    "attention pv dK 32 x (72 -> 128, 256)": (64, 2),
    "attention pv dQ 32 x (256, 256)": (128, 1),
}


@pytest.mark.parametrize("sms", [66, 114, 132])
def test_encode_cluster_rule(sms):
    """A size the kernels have (1, 2, 4 or 8, each dividing a tile's 128
    rows), the largest whose grid gives no SM a second block (1 where even
    that does), and the path's choices."""
    for tiles in range(1, 600):
        c = common.encode_cluster(tiles, sms)
        assert c in common.ENCODE_CLUSTERS and c in (1, 2, 4, 8) and 128 % c == 0
        assert c == 1 or tiles * c <= sms
        assert c == 8 or tiles * 2 * c > sms
    if sms == 132:
        got = {name: common.encode_cluster(t, sms) for name, (t, _) in PATH_ENCODE_CLUSTERS.items()}
        assert got == {name: c for name, (_, c) in PATH_ENCODE_CLUSTERS.items()}


@pytest.mark.parametrize("shape", [(160, 288, 96), (288, 160, 130)])
@pytest.mark.parametrize("with_y_prev", [True, False])
@pytest.mark.parametrize("w_transposed", [False, True])
def test_ditto_linear_step_matches_pallas(shape, with_y_prev, w_transposed):
    m, k, n = shape
    rng = np.random.default_rng(m * k + n + 2 * with_y_prev + w_transposed)
    # rows mix every class: zero, low, edge and full bands
    x_t, x_p = delta_pair(rng, (m, k), "full")
    for r0, mix in zip(range(0, m, 32), ["zero", "low", "edge", "full", "zero"]):
        x_t[r0:r0 + 32], x_p[r0:r0 + 32] = delta_pair(rng, (min(32, m - r0), k), mix)
    x_p[:128, :128] = x_t[:128, :128]  # one whole class-0 tile
    w = _i8(rng, (n, k) if w_transposed else (k, n))
    y_prev = rng.integers(-2**20, 2**20, size=(m, n)).astype(np.int32) if with_y_prev else None
    want_y, want_c = rops.ditto_linear_step(
        jnp.asarray(x_t), jnp.asarray(x_p), jnp.asarray(w),
        None if y_prev is None else jnp.asarray(y_prev), w_transposed=w_transposed)
    got_y, got_c = ops.ditto_linear_step(_t(x_t), _t(x_p), _t(w),
                                         None if y_prev is None else _t(y_prev),
                                         w_transposed=w_transposed)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    assert 0 in got_c and 2 in got_c


def test_attention_delta_batched_matches_pallas_per_element():
    """One batched port call == the reference's per-element calls."""
    rng = np.random.default_rng(3)
    b, m, n, d = 3, 96, 130, 40
    q_t, q_p = delta_pair(rng, (b, m, d), "low")
    k_t, k_p = delta_pair(rng, (b, n, d), "full")
    s_prev = rng.integers(-2**20, 2**20, size=(b, m, n)).astype(np.int32)
    got, (cls_dk, cls_dq) = ops.attention_delta(_t(q_t), _t(q_p), _t(k_t), _t(k_p), _t(s_prev))
    for i in range(b):
        want, (wdk, wdq) = rops.attention_delta(*(jnp.asarray(a[i]) for a in
                                                  (q_t, q_p, k_t, k_p, s_prev)))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(cls_dk[i].numpy(), np.asarray(wdk))
        np.testing.assert_array_equal(cls_dq[i].numpy(), np.asarray(wdq))


def test_plain_diff_matmul_skips_class0_tiles_like_the_kernel():
    """The plain version is the kernel's function for ANY class map: a
    tile marked 0 contributes nothing even if its Δ is not zero."""
    rng = np.random.default_rng(5)
    x_t, x_p = delta_pair(rng, (256, 256), "full")
    w = _t(_i8(rng, (256, 128)))
    cls = torch.tensor([[0, 2], [2, 0]], dtype=torch.int32)
    got = pdiff_mm.ditto_diff_matmul(_t(x_t), _t(x_p), w, None, cls)
    d = _t(x_t).int() - _t(x_p).int()
    d[:128, :128] = 0
    d[128:, 128:] = 0
    np.testing.assert_array_equal(got.numpy(), ref.exact_matmul(d, w).numpy())


def test_unported_variants_raise():
    """Every variant of the reference runs now (``low_bits=4`` and
    ``fused=True`` give the two-pass result); what stays refused is input
    outside the kernels' domain."""
    x = torch.ones(128, 128, dtype=torch.int8)
    want, want_c = ops.ditto_linear_step(x, torch.zeros_like(x), x)
    for knobs in (dict(low_bits=4), dict(fused=True)):
        got, got_c = ops.ditto_linear_step(x, torch.zeros_like(x), x, **knobs)
        assert torch.equal(got, want) and torch.equal(got_c, want_c)
    with pytest.raises(ValueError):
        ops.ditto_linear_step(x, x, x, low_bits=2)
    with pytest.raises(ValueError, match="tile"):
        pint8.int8_matmul(torch.zeros(100, 128, dtype=torch.int8), x)
    with pytest.raises(ValueError, match="even"):
        pdiff_mm.ditto_diff_matmul(x[:1, :3], x[:1, :3], x[:3, :1], None,
                                   torch.ones(1, 1, dtype=torch.int32), bm=1, bn=1, bk=3,
                                   low_bits=4)
    with pytest.raises(ValueError, match="even"):
        pfused.diff_encode_fused(x[:, :99], x[:, :99], bk=33)


def _counts():
    return (pint8.launches, pdiff_encode.launches, pdiff_mm.launches, pdiff_mm.launches_int4,
            pfused.encode_launches, pfused.matmul_launches)


def test_cpu_wrappers_launch_nothing():
    before = _counts()
    x = torch.ones(128, 128, dtype=torch.int8)
    ops.ditto_linear_step(x, x, x)
    ops.ditto_linear_step(x, x, x, low_bits=4)
    ops.ditto_linear_step(x, x, x, fused=True)
    ops.int8_act_matmul(x, x)
    assert _counts() == before


# ------------------------------------------------------------- card leg
PATH_SHAPES = [((), 512, 1152, 1152, False), ((), 128, 1152, 6912, False),
               ((32,), 256, 128, 256, True), ((32,), 256, 256, 128, False)]


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("lead,m,k,n,w_transposed", PATH_SHAPES)
def test_cuda_kernels_match_plain_versions(lead, m, k, n, w_transposed):
    g = torch.Generator(device="cuda").manual_seed(m + k + n)

    def r8(*shape, lo=-127, hi=128):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int8)

    x_t = r8(*lead, m, k)
    x_p = (x_t.int() - torch.randint(-8, 9, x_t.shape, generator=g, device="cuda",
                                     dtype=torch.int32)).clamp(-127, 127).to(torch.int8)
    x_p[..., :128, :128] = x_t[..., :128, :128]
    w = r8(*lead, n, k) if w_transposed else r8(*lead, k, n)
    y_prev = torch.randint(-2**20, 2**20, (*lead, m, n), generator=g, device="cuda",
                           dtype=torch.int32)
    n0 = _counts()
    y = pint8.int8_matmul(x_t, w, w_transposed=w_transposed)
    assert torch.equal(y, ref.int8_matmul_ref(x_t, w, w_transposed=w_transposed))
    cls = pdiff_encode.diff_encode(x_t, x_p)
    assert torch.equal(cls, ref.diff_encode_ref(x_t, x_p, (128, 128)))
    cls_f, dc, dh = pfused.diff_encode_fused(x_t, x_p)
    want_c, want_dc, want_dh = ref.diff_encode_fused_ref(x_t, x_p, (128, 128))
    live = ref.tile_mask(want_c, (128, 64), lambda c: c >= 1)
    full = ref.tile_mask(want_c, (128, 128), lambda c: c == 2)
    assert torch.equal(cls_f, want_c)
    assert torch.equal(dc[live], want_dc[live]) and torch.equal(dh[full], want_dh[full])
    for yp in (y_prev, None):
        want = ref.ditto_diff_matmul_ref(x_t, x_p, w, yp, cls, w_transposed=w_transposed)
        got = pdiff_mm.ditto_diff_matmul(x_t, x_p, w, yp, cls, w_transposed=w_transposed)
        assert torch.equal(got, want)
        got = pdiff_mm.ditto_diff_matmul(x_t, x_p, w, yp, cls, low_bits=4,
                                         w_transposed=w_transposed)
        assert torch.equal(got, ref.ditto_diff_matmul_ref(x_t, x_p, w, yp, cls, low_bits=4,
                                                          w_transposed=w_transposed))
        got = pfused.ditto_fused_matmul(w, dc, dh, cls_f, yp, w_transposed=w_transposed)
        bare = ref.ditto_fused_matmul_ref(w, dc, dh, cls_f, w_transposed=w_transposed)
        assert torch.equal(got, bare if yp is None else bare + yp) and torch.equal(got, want)
    assert _counts() == (n0[0] + 1, n0[1] + 1, n0[2] + 2, n0[3] + 2, n0[4] + 1, n0[5] + 2)
