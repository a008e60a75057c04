"""The compiled step's int8 boundary: ``kernels/quant_rows.py``.

``quantize_rows`` and ``dequantize_rows`` take the place of the compiled
pass's quantise and dequantise chains. On the CPU they run their plain
versions, which are held here to the chains the compiled pass ran before
(``quant.quantize`` and ``y.to(float32) * s_row * s_col + bias``) and to
numpy; on ``meta`` they record their launch and return empties; a
compiled two-block DiT equals the eager engine bit for bit under each
plan. The card tests hold both kernels to the plain chains bit for bit at
every shape the benchmark's cells reach, and a captured two-block step to
its uncaptured run; they skip without a card. This file imports no JAX,
so on the card it runs as
``PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_quant_rows.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import trace_audit as ta  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoPlan, quant  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import common, quant_rows  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve.cache import CompiledRunnerCache  # noqa: E402
from repro_torch.sim import harness  # noqa: E402
from repro_torch.tree import map_tree  # noqa: E402

CFG = dit.DiTCfg(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
                 n_classes=4)
STEPS = 4
# the three plans of the replayed step: the two-pass flow, its int4 branch, the fused flow
PLANS = {"default": {}, "low_bits4": dict(low_bits=4), "fused": dict(fused=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny CPU ops: PyTorch's thread pool costs more than it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _old_dequantize(y, s_row, s_col, bias=None):
    """The compiled pass's dequantise chain as it was written there."""
    out = y.to(torch.float32) * s_row * s_col
    return out if bias is None else out + bias


def _quant_operand(rng, shape, scale_shape):
    """fp32 x and a positive scale grouping its rows, with exact ties at
    k + 0.5 (power-of-two scales), values far past ±127 scales and whole
    rows of zeros."""
    s = (2.0 ** rng.integers(-6, 2, scale_shape)).astype(np.float32)
    x = (rng.standard_normal(shape) * 60).astype(np.float32) * s
    flat = x.reshape(-1)
    k = flat.size // 7
    flat[:k] = (rng.integers(-130, 130, k) + 0.5) * np.broadcast_to(s, x.shape).reshape(-1)[:k]
    flat[k:2 * k] *= 40.0
    rows = x.reshape(-1, shape[-1])
    if len(rows) > 1:
        rows[len(rows) // 2] = 0.0
    return torch.from_numpy(x), torch.from_numpy(s)


QUANT_CASES = {"linear": ((48, 40), (48, 1)), "batch": ((6, 16, 20), (6, 1, 1)),
               "one_row": ((1, 96), (1, 1))}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantize_plain_leg_is_the_chain(case):
    shape, scale_shape = QUANT_CASES[case]
    x, s = _quant_operand(np.random.default_rng(len(shape)), shape, scale_shape)
    got = quant_rows.quantize_rows(x, s)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert torch.equal(got, quant.quantize(x, s))
    want = np.clip(np.rint(x.numpy() / s.numpy()), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == 127).any() and (got == -127).any()
    tie = x.numpy() / s.numpy()
    assert (np.abs(tie - np.trunc(tie)) == 0.5).any()  # ties went to even (numpy's rint)


def test_quantize_plain_leg_on_a_transposed_operand():
    """Attention's P V hands V^T, a transposed view, as its b operand."""
    x, s = _quant_operand(np.random.default_rng(3), (4, 12, 8), (4, 1, 1))
    xt = x.transpose(-1, -2)
    assert not xt.is_contiguous()
    assert torch.equal(quant_rows.quantize_rows(xt, s), quant.quantize(xt, s))


DEQUANT_CASES = {
    # (y shape, s_row shape, s_col shape, bias, padded width: y a column slice)
    "linear_bias": ((40, 24), (40, 1), (1, 24), True, None),
    "linear": ((40, 24), (40, 1), (1, 24), False, None),
    "linear_strided": ((40, 10), (40, 1), (1, 10), True, 16),
    "batch": ((6, 16, 20), (6, 1, 1), (6, 1, 1), False, None),
    "batch_strided": ((6, 16, 9), (6, 1, 1), (6, 1, 1), False, 16),
    "batch_rows_strided": ((6, 10, 9), (6, 1, 1), (6, 1, 1), False, 16),
}


def _padded_int32(rng, shape, padded):
    """Random int32 of ``shape``; with ``padded``, the slice of a tensor
    whose rows (the last but one dim) and columns are padded up to it."""
    if padded is None:
        return torch.from_numpy(rng.integers(-2**27, 2**27, shape).astype(np.int32))
    full = shape[:-2] + (-(-shape[-2] // padded) * padded, padded)
    y = torch.from_numpy(rng.integers(-2**27, 2**27, full).astype(np.int32))
    return y[..., :shape[-2], :shape[-1]]


def _dequant_operands(rng, case):
    shape, rs, cs, with_bias, padded = DEQUANT_CASES[case]
    y = _padded_int32(rng, shape, padded)
    s_row = torch.from_numpy(rng.uniform(1e-3, 1.0, rs).astype(np.float32))
    s_col = torch.from_numpy(rng.uniform(1e-3, 1.0, cs).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32)) if with_bias \
        else None
    return y, s_row, s_col, bias


@pytest.mark.parametrize("case", list(DEQUANT_CASES))
def test_dequantize_plain_leg_is_the_chain(case):
    y, s_row, s_col, bias = _dequant_operands(np.random.default_rng(5), case)
    assert y.is_contiguous() == (DEQUANT_CASES[case][4] is None)
    got = quant_rows.dequantize_rows(y, s_row, s_col, bias)
    assert got.dtype == torch.float32 and got.shape == y.shape
    assert torch.equal(got, _old_dequantize(y, s_row, s_col, bias))
    # numpy, one float32 rounding a step
    want = (y.numpy().astype(np.float32) * s_row.numpy()) * s_col.numpy()
    if bias is not None:
        want = want + bias.numpy()
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_strides():
    a = torch.zeros(3, 5, 16)
    assert common.row_strides(a) == (5, 16, 80)
    assert common.row_strides(a[..., :9]) == (5, 16, 80)  # a padded result cut back
    assert common.row_strides(a[:, :2, :9]) == (2, 16, 80)  # rows and columns cut back
    assert common.row_strides(a.reshape(15, 16)[:, :3]) == (15, 16, 240)
    assert common.row_strides(a[:1, :1]) == (1, 16, 16)
    assert common.row_strides(a.transpose(-1, -2)) is None
    assert common.row_strides(torch.zeros(4, 1).expand(4, 8)) is None
    assert common.row_strides(torch.zeros(2, 3, 4, 16)[:, ::2]) is None  # batch dims apart


def test_scales_must_group_rows():
    x = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="does not group the rows"):
        quant_rows.quantize_rows(x, torch.ones(1, 16))  # a column scale
    with pytest.raises(ValueError, match="does not group the rows"):
        quant_rows.quantize_rows(x, torch.ones(8))
    y = torch.zeros(8, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not group the rows"):
        quant_rows.dequantize_rows(y, torch.ones(4, 1), torch.ones(16))
    with pytest.raises(ValueError, match="bias"):
        quant_rows.dequantize_rows(y, torch.ones(8, 1), torch.ones(1, 16), torch.ones(8))


def test_fake_legs_record_and_return_empties():
    counts = (quant_rows.quantize_launches, quant_rows.dequantize_launches)
    seen = []
    x = torch.empty(6, 16, 20, device="meta")
    y = torch.empty(6, 16, 128, dtype=torch.int32, device="meta")[..., :72]
    with common.recording(launches=lambda name, static: seen.append((name, static))):
        q = quant_rows.quantize_rows(x, torch.empty(6, 1, 1, device="meta"))
        out = quant_rows.dequantize_rows(y, torch.empty(6, 1, 1, device="meta"),
                                         torch.empty(6, 1, 1, device="meta"))
    assert (q.shape, q.dtype, q.device.type) == (x.shape, torch.int8, "meta")
    assert (out.shape, out.dtype, out.is_contiguous()) == (y.shape, torch.float32, True)
    assert [n for n, _ in seen] == ["quantize_rows", "dequantize_rows"]
    assert seen[0][1]["operands"] == (((6, 16, 20), "torch.float32"),
                                      ((6, 1, 1), "torch.float32"))
    assert seen[1][1]["operands"][0] == ((6, 16, 72), "torch.int32")
    assert seen[1][1]["operands"][3] is None
    assert (quant_rows.quantize_launches, quant_rows.dequantize_launches) == counts


# layout -> (x of shape (6, 16, 20) on meta, the copy's bytes the launch counts)
LAYOUTS = {"contiguous": (lambda: torch.empty(6, 16, 20, device="meta"), 0),
           "transposed": (lambda: torch.empty(6, 20, 16, device="meta").mT, 0),
           "strided": (lambda: torch.empty(6, 16, 40, device="meta")[..., ::2], 8 * 1920)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fake_quantize_counts_a_copy_only_where_it_makes_one(layout):
    """A contiguous or transposed operand is read in place (5 bytes an
    element and the scales); any other layout is copied first, 8 bytes an
    element more."""
    make, copied = LAYOUTS[layout]
    x = make()
    work = []
    with common.recording(lambda name, **kw: work.append(kw["nbytes"])):
        q = quant_rows.quantize_rows(x, torch.empty(6, 1, 1, device="meta"))
    assert (q.shape, q.is_contiguous()) == (x.shape, True)
    assert work == [5.0 * x.numel() + 4 * 6 + copied]


WRAPPERS = {  # name -> (operand dtype, the call)
    "quantize_rows": (torch.float32, lambda t: quant_rows.quantize_rows(t, torch.ones(8, 1))),
    "dequantize_rows": (torch.int32, lambda t: quant_rows.dequantize_rows(
        t, torch.ones(8, 1), torch.ones(1, 16))),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrappers_refuse_a_dtensor(name):
    dtype, call = WRAPPERS[name]
    x = torch.ones((8, 16), dtype=dtype)
    with mesh_mod.local_group("cpu"):
        dx = sharding.layout(x, sharding.replicated(mesh_mod.make_test_mesh()))
        with pytest.raises(TypeError, match="row_local"):
            call(dx)
    call(x)  # a plain tensor takes the plain version


def test_step_launches_the_boundary_once_a_crossing():
    """On ``meta``: a quantise and a dequantise a linear layer, two
    quantises and a dequantise an attention product, in every plan."""
    linears, products = 7 * CFG.n_layers + 1, 2 * CFG.n_layers
    with op_analysis.fake_mode():
        state = ta.abstract_state(CFG, 2)
        for knobs in PLANS.values():
            for modes in (ta.uniform_modes(CFG, "act"), ta.uniform_modes(CFG, "diff")):
                args = ta.abstract_inputs(CFG, 2)
                rec = ta.record_step(CFG, modes, DittoPlan(**knobs),
                                     args[:2] + (state,) + args[2:])
                counts = rec.launch_counts()
                assert counts["quantize_rows"] == linears + 2 * products
                assert counts["dequantize_rows"] == linears + products


@pytest.fixture(scope="module")
def model():
    params = dit.init(torch.Generator().manual_seed(0), CFG, device="cpu")
    rng = np.random.default_rng(0)
    w = params["blocks"]["mod"]["w"]  # adaLN-Zero: refill so the blocks reach the sample
    params["blocks"]["mod"]["w"] = torch.from_numpy(
        (rng.standard_normal(tuple(w.shape)) * 0.02).astype(np.float32))
    x_T = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    return params, x_T, torch.tensor([0, 3])


def _serve(model, plan, device="cpu", **kw):
    params, x_T, labels = model
    return harness.serve_records(params, CFG, diffusion.linear_schedule(1000), x_T, labels,
                                 plan, device=device, **kw)


@pytest.mark.parametrize("plan", list(PLANS))
def test_compiled_step_equals_eager(model, plan):
    base = DittoPlan(steps=STEPS, policy="diff", **PLANS[plan])
    _, compiled, _ = _serve(model, base)
    _, eager, _ = _serve(model, base.replace(compiled=False))
    assert torch.isfinite(compiled).all() and torch.equal(compiled, eager)


# ------------------------------------------------------------------- card
def _cell_shapes():
    """(x shape, scale shape) of every quantise and (y shape, padded width,
    s_row shape, s_col shape, bias) of every dequantise of a replayed step
    at the cells' buckets: DiT-XL/2 at 256 tokens x 16 rows and 1024
    tokens x 4 rows (d 1152, MLP 4608, mod 6912, 16 heads of 72, 16
    outputs a token)."""
    quants, dequants = [], []
    for rows, tokens in ((16, 256), (4, 1024)):
        t, bh = rows * tokens, rows * 16
        quants += [((rows, 1152), (rows, 1)), ((t, 1152), (t, 1)), ((t, 4608), (t, 1)),
                   ((bh, tokens, 72), (bh, 1, 1)), ((bh, tokens, tokens), (bh, 1, 1))]
        dequants += [((rows, 6912), None, (rows, 1), (1, 6912), True),
                     ((t, 1152), None, (t, 1), (1, 1152), True),
                     ((t, 4608), None, (t, 1), (1, 4608), True),
                     ((t, 16), 128, (t, 1), (1, 16), True),
                     ((bh, tokens, tokens), None, (bh, 1, 1), (bh, 1, 1), False),
                     ((bh, tokens, 72), 128, (bh, 1, 1), (bh, 1, 1), False)]
    return quants, dequants


def test_card_kernels_equal_the_chains(card):
    g = torch.Generator(device=card).manual_seed(7)
    rng = np.random.default_rng(7)
    quants, dequants = _cell_shapes()
    dequants.append(((4, 16, 16), 128, (4, 1, 1), (4, 1, 1), False))  # rows padded too
    before = (quant_rows.quantize_launches, quant_rows.dequantize_launches)
    for shape, sshape in quants:
        s = torch.rand(sshape, generator=g, device=card) * 0.05 + 1e-3
        x = torch.randn(shape, generator=g, device=card) * 50 * s
        flat = x.view(-1)
        flat[:4096] = (torch.randint(-130, 130, (4096,), generator=g, device=card) + 0.5) \
            * s.reshape(-1)[0]
        flat[4096:4101] = torch.tensor([float("inf"), -float("inf"), 1e30, -1e30,
                                        float("nan")])
        xs = [x]
        if len(shape) == 3 and shape[-1] == 72:  # P V's b operand: V^T
            xs.append(x.transpose(-1, -2))
        for xx in xs:
            got = quant_rows.quantize_rows(xx, s)
            assert torch.equal(got, quant.quantize(xx, s)), (tuple(xx.shape), xx.stride())
    for shape, padded, rs, cs, with_bias in dequants:
        y = _padded_int32(rng, shape, padded).to(card)
        s_row = torch.rand(rs, generator=g, device=card) * 1e-3
        s_col = torch.rand(cs, generator=g, device=card) * 1e-2
        bias = torch.randn(shape[-1], generator=g, device=card) if with_bias else None
        got = quant_rows.dequantize_rows(y, s_row, s_col, bias)
        assert torch.equal(got, _old_dequantize(y, s_row, s_col, bias)), (shape, padded)
    # scales read as scalars, and x off a 16-byte boundary: 4-byte offsets
    # are taken (x then takes the scalar path), transposed too
    x = torch.randn(33 * 40 + 1, generator=g, device=card)[1:].view(33, 40)
    s = torch.rand(34, 1, generator=g, device=card)[1:]
    assert torch.equal(quant_rows.quantize_rows(x, s), quant.quantize(x, s))
    xt = torch.randn(3 * 40 * 33 + 1, generator=g, device=card)[1:].view(3, 40, 33).mT
    st = torch.rand(3 * 33 + 1, generator=g, device=card)[1:].view(3, 33, 1)
    assert torch.equal(quant_rows.quantize_rows(xt, st), quant.quantize(xt, st))
    torch.cuda.synchronize()
    assert (quant_rows.quantize_launches - before[0],
            quant_rows.dequantize_launches - before[1]) == (len(quants) + 4, len(dequants))


def test_card_kernels_past_32_bit_indices(card):
    """Past 2^31 elements the kernels index in 64 bits: a quantise of
    (466034, 4608) through the wrapper (10.7 GB), and a dequantise of 2^31
    + 16384 threads' elements (34.4 GB of output) through the C entry, its
    64-row y read again for each of 131073 batches (batch stride 0), both
    held to the chains chunk by chunk."""
    g = torch.Generator(device=card).manual_seed(3)
    rows, width = 466034, 4608
    assert rows * width > 2**31
    s = torch.rand((rows, 1), generator=g, device=card) * 0.05 + 1e-3
    x = torch.randn((rows, width), generator=g, device=card).mul_(50 * s)
    tail = x.view(-1)[-4096:]  # past 2^31: ties, clamps and specials
    tail.copy_((torch.randint(-130, 130, (4096,), generator=g, device=card) + 0.5) * s[-1])
    tail[:5] = torch.tensor([float("inf"), -float("inf"), 1e30, -1e30, float("nan")])
    q = quant_rows.quantize_rows(x, s)
    for r in range(0, rows, 65536):
        assert torch.equal(q[r:r + 65536], quant.quantize(x[r:r + 65536], s[r:r + 65536])), r
    del x, q, tail
    torch.cuda.empty_cache()

    batch_rows, width, batches = 64, 1024, 2**17 + 1
    assert batches * batch_rows * (width // 4) > 2**31
    y = torch.randint(-2**27, 2**27, (batch_rows, width), generator=g, device=card,
                      dtype=torch.int32)
    s_row = torch.rand(batches, generator=g, device=card) * 1e-3
    s_col = torch.rand(width, generator=g, device=card) * 1e-2
    bias = torch.randn(width, generator=g, device=card)
    out = torch.empty((batches, batch_rows, width), device=card)
    common.call("dequantize_rows", "ditto_dequantize_rows", quant_rows._DEQUANTIZE_ARGTYPES,
                card, y.data_ptr(), out.data_ptr(), s_row.data_ptr(), s_col.data_ptr(),
                bias.data_ptr(), batches * batch_rows, width, batch_rows, width, 0,
                batch_rows, 0)
    for b in range(0, batches, 4096):
        nb = min(4096, batches - b)
        want = _old_dequantize(y.expand(nb, batch_rows, width), s_row[b:b + nb, None, None],
                               s_col, bias)
        assert torch.equal(out[b:b + nb], want), b
    del out
    torch.cuda.empty_cache()


@pytest.mark.parametrize("plan", list(PLANS))
def test_card_captured_step_equals_uncaptured(card, model, plan):
    """The step captured into a CUDA graph and replayed equals the same
    step run uncaptured and the eager engine; each capture counts one
    quantise and one dequantise a linear layer, two quantises and one
    dequantise an attention product."""
    base = DittoPlan(steps=STEPS, policy="diff", **PLANS[plan])
    params, x_T, labels = model
    model = map_tree(lambda p: p.to(card), params), x_T.to(card), labels.to(card)
    cache = CompiledRunnerCache()
    _, captured, _ = _serve(model, base, card, runner_cache=cache, bucket=2)
    _, uncaptured, _ = _serve(model, base, card)
    _, eager, _ = _serve(model, base.replace(compiled=False), card)
    assert torch.equal(captured, uncaptured) and torch.equal(captured, eager)
    linears, products = 7 * CFG.n_layers + 1, 2 * CFG.n_layers
    (launches,) = cache.capture_launches.values()
    assert launches["quantize_rows"] == linears + 2 * products
    assert launches["dequantize_rows"] == linears + products
    assert cache.replayed_launches()["quantize_rows"] > 0
