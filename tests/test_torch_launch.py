"""The port's launch tooling against the reference's, on the CPU:
``configs.input_specs``, ``launch/roofline.py`` (the wire factors, the
model FLOPs, the roofline dict under the reference's constants),
``launch/op_analysis.py`` (the counterpart of the reference's
``hlo_analysis``: a scanned product's FLOPs, a step's FLOPs against the
reference's analysis of the same step jitted, hand-counted bytes and peak,
the in-place rule, collectives on the ``fake`` backend, ``int8_matmul``'s
fake leg) and ``launch/dryrun.py`` (the layouts against the reference's
specs, the affine extrapolation, ``run_cell`` on every family);
``launch/roofline_md.py`` renders what ``dryrun.main`` wrote.
"""
import dataclasses
import importlib
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as RAbstractMesh  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.configs.base import ShapeCell as RShapeCell  # noqa: E402
from repro.configs.base import input_specs as r_input_specs  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import roofline as rroof  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.distributed import collectives, sharding  # noqa: E402
from repro_torch.kernels import common, int8_matmul  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, roofline, roofline_md  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.nn import core  # noqa: E402

SHAPE_NAMES = list(configs.SHAPES)
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_dryrun():
    """The reference's dryrun module, imported with ``XLA_FLAGS`` restored:
    it sets the flag at import, which must not reach the other tests (the
    backend is up before, so the flag changes nothing here)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


# ------------------------------------------------------------- input_specs
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("name", rconfigs.names())
def test_input_specs_match_reference(name, batch):
    """Keys, shapes and dtypes for all four shapes, at the cell's batch and
    with ``batch_override``."""
    for shape in SHAPE_NAMES:
        got = configs.input_specs(configs.get(name), configs.SHAPES[shape], batch_override=batch)
        want = r_input_specs(rconfigs.get(name), rconfigs.SHAPES[shape], batch_override=batch)
        assert list(got) == list(want), (name, shape)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (name, shape, k)
            assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), (name, shape, k)


# ---------------------------------------------------------------- roofline
@pytest.mark.parametrize("op", COLLECTIVE_OPS)
def test_wire_factor_matches_reference(op):
    for n in range(1, 17):
        assert roofline._wire_factor(op, n) == rroof._wire_factor(op, n), (op, n)


@pytest.mark.parametrize("name", rconfigs.names())
def test_model_flops_match_reference(name):
    for shape in SHAPE_NAMES:
        assert roofline.model_flops(configs.get(name), configs.SHAPES[shape]) == \
            rroof.model_flops(rconfigs.get(name), rconfigs.SHAPES[shape]), (name, shape)


@pytest.mark.parametrize("flops,nbytes,wire,mf,n", [
    (3.2e15, 4.1e12, 2.5e10, 1.9e17, 256),
    (1.0e12, 9.0e13, 0.0, 5.0e11, 1),
    (7.0e14, 1.0e11, 8.0e12, 1.0e17, 512),
])
def test_roofline_terms_match_reference(flops, nbytes, wire, mf, n):
    """The reference's dict, given the reference's constants."""
    got = roofline.roofline_terms(flops, nbytes, wire, model_flops_global=mf, n_chips=n,
                                  peak_flops=rroof.PEAK_FLOPS, hbm_bw=rroof.HBM_BW,
                                  link_bw=rroof.ICI_BW)
    want = rroof.roofline_terms(flops, nbytes, wire, model_flops_global=mf, n_chips=n)
    assert got == want


def test_roofline_terms_by_dtype_and_link():
    """Each dtype's FLOPs over its own peak; a collective over the link its
    group crosses; no per-device program leaves the collective term out."""
    by_dtype = {torch.bfloat16: 9.89e14, torch.float32: 6.7e13, torch.int8: 1.979e15}
    r = roofline.roofline_terms(sum(by_dtype.values()), 0.0, None, model_flops_global=0.0,
                                n_chips=1, flops_by_dtype=by_dtype)
    assert r["compute_s"] == pytest.approx(3.0, rel=1e-12)
    assert r["collective_s"] is None and r["dominant"] == "compute"
    colls = [{"wire_bytes": 4.5e11, "bandwidth": roofline.ranks_bandwidth(range(8))},
             {"wire_bytes": 5.0e10, "bandwidth": roofline.ranks_bandwidth([0, 8])}]
    r = roofline.roofline_terms(0.0, 0.0, 5.0e11, model_flops_global=0.0, n_chips=16,
                                peak_flops=roofline.PEAK_FLOPS, collectives=colls)
    assert r["collective_s"] == pytest.approx(2.0, rel=1e-12)
    # a group along one dim of a row-major mesh: inside a node when that
    # dim's size times the inner dims' sizes is at most 8
    for sizes, dim, inside in [((16, 16), 1, False), ((16, 16), 0, False), ((4, 2), 0, True),
                               ((2, 16, 8), 2, True), ((2, 4, 2), 1, True), ((4, 4), 0, False)]:
        ranks = torch.arange(math.prod(sizes)).reshape(sizes).movedim(dim, -1)
        want = roofline.NVLINK_BW if inside else roofline.IB_BW
        assert {roofline.ranks_bandwidth(g.tolist()) for g in ranks.reshape(-1, sizes[dim])} \
            == {want}, (sizes, dim)


# ---------------------------------------------------------------- analyzer
@pytest.mark.parametrize("how", ["loop", "segmented_scan"])
def test_analyzer_counts_scan_flops(how):
    """The counterpart of ``test_runtime.py::test_hlo_analyzer_counts_scan_flops``:
    4 layers of tanh(x @ w), each layer's product counted as it runs."""
    g = torch.Generator().manual_seed(0)
    ws = torch.randn((4, 64, 64), generator=g)
    x = torch.randn((8, 64), generator=g, requires_grad=True)

    def f(ws, x):
        if how == "loop":
            for w in ws:
                x = torch.tanh(x @ w)
            return x.sum()
        def cell(c, xs):
            h = torch.tanh(c @ xs[0])
            return h, h

        y, _ = core.segmented_scan(cell, x, (ws,), segment=2)
        return y.sum()

    res = op_analysis.analyze(f, ws, x)
    true_flops = 2 * 8 * 64 * 64 * 4
    assert abs(res["flops"] - true_flops) / true_flops < 0.01
    assert res["flops_by_dtype"] == {torch.float32: float(true_flops)}


def _ref_flops(rarch, rshape, b):
    """The reference's ``hlo_analysis`` of its step, jitted on one CPU device."""
    fn = (rsteps.make_denoise_step(rarch) if rarch.family == "diffusion"
          else rsteps.make_prefill_step(rarch))
    _, shapes = rsteps.param_axes(rarch)
    specs = r_input_specs(rarch, rshape, batch_override=b)
    compiled = jax.jit(fn).lower(shapes, specs).compile()
    return hlo_analysis.analyze(compiled.as_text())["flops"]


@pytest.mark.parametrize("name,seq,b", [("qwen3-0.6b", 64, 2), ("dit-xl2", 0, 16)])
def test_step_flops_match_reference_analysis(name, seq, b):
    """The dense LM prefill and the DiT denoiser at smoke size: the
    analyzer's FLOPs within 2 % of the reference's analysis of its step.
    The DiT at B = 16: ``nn/core.py:dense`` runs a product of fewer rows
    padded to 16 (row-invariant bits), so at B = 2 the port does 8x the
    reference's FLOPs on the conditioning rows, which at smoke width are a
    third of the step."""
    arch, rarch = configs.get(name).smoke(), rconfigs.get(name).smoke()
    got = dryrun.count_step(arch, configs.ShapeCell("x", "prefill", seq, b))["flops"]
    want = _ref_flops(rarch, RShapeCell("x", "prefill", seq, b), b)
    assert abs(got - want) / want < 0.02, (got, want)


def test_fake_count_equals_real_count():
    """The dense prefill counted on fake tensors and on real CPU tensors:
    the same ops, the same counts (the card's check of this is
    ``chip_smoke.py``'s launch phase)."""
    arch = configs.get("qwen3-0.6b").smoke()
    shape = configs.ShapeCell("x", "prefill", 32, 2)
    fake = dryrun.count_step(arch, shape)
    params = LM(arch).init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.randint(0, arch.vocab_size, (2, 32), dtype=torch.int32)}
    real = op_analysis.analyze(steps.make_prefill_step(arch), params, batch)
    for k in ("flops", "hbm_bytes", "flops_by_dtype", "argument_bytes", "output_bytes",
              "peak_bytes"):
        assert real[k] == fake[k], k


def test_bytes_and_peak_by_hand():
    """Three ops: a product, an in-place add, a cast. Bytes: operands plus
    results; the peak: the arguments, the product and the cast live
    together (the product's storage freed only after the cast)."""
    with op_analysis.fake_mode():
        a = torch.empty((16, 32), device="meta")  # 2048 B
        b = torch.empty((32, 8), device="meta")  # 1024 B

        def f(a, b):
            c = a @ b  # 512 B out
            c.add_(1.0)  # read + write c
            return c.to(torch.bfloat16)  # 512 B in, 256 B out

        res = op_analysis.analyze(f, a, b)
    assert res["flops"] == 2 * 16 * 32 * 8
    assert res["hbm_bytes"] == (2048 + 1024 + 512) + (512 + 512) + (512 + 256)
    assert res["argument_bytes"] == 3072
    assert res["output_bytes"] == 256
    assert res["peak_bytes"] == 3072 + 512 + 256
    assert res["temp_bytes"] == 512


def test_views_count_no_bytes_and_broadcast_counts_once():
    with op_analysis.fake_mode():
        a = torch.empty((4, 8), device="meta")  # 128 B

        def f(a):
            v = a.reshape(32)[None].expand(5, 32)  # views: 0 B
            return v * 2.0  # reads a's 32 elements once, writes 5 x 32

        res = op_analysis.analyze(f, a)
    assert res["hbm_bytes"] == 128 + 5 * 128


def test_in_place_rule_on_a_decode_step():
    """The decode writes one position of its cache in place: the cache's
    index_copy_ counts the new rows (read and written) and the index, not
    the whole cache."""
    arch = configs.get("qwen3-0.6b").smoke()
    b, slots = 2, 64
    dev = op_analysis.fake_device()
    with op_analysis.fake_mode():
        params = op_analysis.fake_like(steps.param_axes(arch)[1], dev)
        cache = op_analysis.fake_like(LM(arch).init_cache(b, slots, device="meta"), dev)
        batch = op_analysis.fake_like(configs.input_specs(
            arch, configs.ShapeCell("x", "decode", slots, b)), dev)
        res = op_analysis.analyze(steps.make_decode_step(arch), params, cache, batch)
    row = res["by_op"]["index_copy_"]
    new = b * 1 * arch.n_kv_heads * arch.resolved_head_dim * 4  # one position of k or v
    assert row[0] == 2 * arch.n_layers
    assert row[2] == 2 * arch.n_layers * (2 * new + 8)
    assert res["alias_bytes"] == sum(op_analysis.nbytes(t) for t in cache.values())


def test_collective_wire_bytes_on_the_fake_backend():
    """World size 4 on the ``fake`` backend: ``collectives.py``'s in-place
    all-reduce (wrapped for the analysis) and a functional all-gather (from
    the dispatch)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        g = torch.ones((64, 16))  # 4096 B
        res = op_analysis.analyze(
            lambda g, r: collectives.compressed_psum_grads({"w": g}, {"w": r}), g,
            torch.zeros((64, 16)))
        (rec,) = res["collectives"]
        assert rec["op"] == "all-reduce" and rec["group_size"] == 4
        assert rec["wire_bytes"] == 4096 * 2 * 3 / 4
        assert rec["bandwidth"] == roofline.NVLINK_BW
        # read and written once, whether or not its c10d op reaches the mode
        assert res["by_op"]["dist.all_reduce"] == [1, 0.0, 2 * 4096]
        assert not [op for op in res["by_op"] if "allreduce" in op]
        assert dist.all_reduce is not None and dist.all_reduce.__module__ == \
            "torch.distributed.distributed_c10d"  # unwrapped again

        x = torch.ones((8, 16))
        res = op_analysis.analyze(
            lambda x: fc.wait_tensor(fc.all_gather_tensor(x, 0, dist.group.WORLD)), x)
        (rec,) = res["collectives"]
        assert rec["op"] == "all-gather" and rec["group_size"] == 4
        assert rec["result_bytes"] == 4 * 8 * 16 * 4
        assert rec["wire_bytes"] == rec["result_bytes"] * 3 / 4
        assert res["coll_by_op"] == {"all-gather": {"count": 1,
                                                     "wire_bytes": rec["wire_bytes"]}}
        summary = roofline.collective_summary(res["collectives"])
        assert summary["total_wire_bytes"] == rec["wire_bytes"] and summary["count"] == 1
    finally:
        dist.destroy_process_group()


def test_int8_matmul_fake_leg_records_its_work():
    """On fake tensors the wrapper returns an empty int32 result of the
    output's shape and records 2 batch M N K int8 operations; without a
    recorder the call records nothing."""
    seen = []
    with op_analysis.fake_mode():
        x = torch.empty((3, 256, 128), dtype=torch.int8, device="meta")
        w = torch.empty((3, 384, 128), dtype=torch.int8, device="meta")
        with common.recording(lambda name, **kw: seen.append((name, kw))):
            y = int8_matmul.int8_matmul(x, w, w_transposed=True)
        int8_matmul.int8_matmul(x, w, w_transposed=True)
    assert tuple(y.shape) == (3, 256, 384) and y.dtype == torch.int32
    assert common.is_fake(y)
    assert seen == [("int8_matmul", dict(flops=2.0 * 3 * 256 * 384 * 128,
                                         nbytes=float(3 * 256 * 128 + 3 * 384 * 128
                                                      + 4 * 3 * 256 * 384),
                                         dtype=torch.int8))]


def test_int8_denoiser_counts_its_kernel():
    """The W8A8 denoiser at smoke size: every product reaches the kernel's
    fake leg, whose work is in the FLOPs, as int8."""
    arch = configs.get("dit-xl2").smoke()
    res = dryrun.count_step(arch, configs.ShapeCell("x", "prefill", 0, 2), variant="int8")
    k = res["kernels"]["int8_matmul"]
    assert k["calls"] > 0 and k["flops"] == res["flops_by_dtype"][torch.int8]


# ------------------------------------------------------------------ dryrun
@pytest.mark.parametrize("multi_pod", [False, True])
def test_state_and_cache_layouts_match_reference(multi_pod):
    """``state_shardings`` and ``cache_shardings_dict`` of every config on a
    production mesh, each leaf's placements those of the reference's spec."""
    rdry = _ref_dryrun()
    sizes, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    rmesh = RAbstractMesh(sizes, names)
    mesh = mesh_mod.AbstractMesh(sizes, names)
    for name in rconfigs.names():
        arch, rarch = configs.get(name), rconfigs.get(name)
        rules = sharding.make_rules(arch, multi_pod=multi_pod)
        rrules = rsh.make_rules(rarch, multi_pod=multi_pod)
        got = dryrun.state_shardings(arch, mesh, rules, steps.make_optimizer(arch))
        want = rdry.state_shardings(rarch, rmesh, rrules, rsteps.make_optimizer(rarch))
        got_leaves = tree.leaves(got)
        want_leaves = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "spec"))
        assert len(got_leaves) == len(want_leaves), name
        for lay, ref in zip(got_leaves, want_leaves):
            assert lay.placements == sharding.placements(tuple(ref.spec), mesh), name
        if arch.family == "diffusion":
            continue
        for shape in ("decode_32k", "long_500k"):
            spec = configs.SHAPES[shape]
            cache = LM(arch).init_cache(spec.global_batch, spec.seq_len, device="meta")
            rcache = jax.eval_shape(lambda: RLM(rarch).init_cache(spec.global_batch,
                                                                  spec.seq_len))
            assert sorted(cache) == sorted(rcache), name
            got_c = dryrun.cache_shardings_dict(arch, mesh, rules, cache)
            want_c = rdry.cache_shardings_dict(rarch, rmesh, rrules, rcache)
            for k in cache:
                assert tuple(cache[k].shape) == tuple(rcache[k].shape), (name, k)
                assert got_c[k].placements == sharding.placements(tuple(want_c[k].spec),
                                                                  mesh), (name, shape, k)


def test_affine_extrapolation_equals_a_direct_count():
    """xlstm's prefill at smoke size (the chunked mLSTM, the sLSTM cell a
    token), counted at 256, 512 and 768 tokens and extrapolated to 1024,
    against a direct count at 1024; a count off by one is not affine."""
    arch = configs.get("xlstm-125m").smoke()
    shape = configs.ShapeCell("x", "prefill", 1024, 1)
    lengths = [256, 512, 768]
    counts = [dryrun.count_step(arch, dataclasses.replace(shape, seq_len=n)) for n in lengths]
    got = dryrun.extrapolate(counts, lengths, 1024)
    want = dryrun.count_step(arch, shape)
    assert got is not None
    for k in ("flops", "hbm_bytes", "peak_bytes", "argument_bytes", "output_bytes",
              "temp_bytes", "flops_by_dtype", "by_op"):
        assert got[k] == want[k], k
    bent = [dict(c) for c in counts]
    bent[2] = dict(bent[2], flops=bent[2]["flops"] + 1)
    assert dryrun.extrapolate(bent, lengths, 1024) is None


# one smoke config of each family, at a shape whose count is quick
FAMILY_CELLS = [("qwen3-0.6b", "prefill_32k"), ("qwen2-moe-a2.7b", "train_4k"),
                ("xlstm-125m", "decode_32k"), ("zamba2-7b", "long_500k"),
                ("internvl2-2b", "train_4k"), ("musicgen-medium", "decode_32k"),
                ("dit-xl2", "train_4k")]


@pytest.mark.parametrize("mesh", ["1", "16x16"])
@pytest.mark.parametrize("name,shape", FAMILY_CELLS)
def test_run_cell_every_family(name, shape, mesh):
    arch = configs.get(name).smoke()
    rec = dryrun.run_cell(arch, shape, mesh=mesh, batch=2)
    assert rec["arch"] == name and rec["mesh"] == mesh and rec["batch"] == 2
    if mesh == "1":
        assert rec["status"] == "ok" and rec["n_chips"] == 1
        assert rec["cost"]["flops_per_device"] > 0 and rec["fits"]
        assert rec["roofline"]["collective_s"] == 0.0
        assert rec["roofline"]["dominant"] in ("compute", "memory")
        assert rec["memory"]["peak_bytes_per_device"] >= rec["memory"]["argument_bytes_per_device"]
    else:
        # the sharded step over DTensors on the fake 256-rank mesh, counted for
        # one rank; the layouts' bytes as before
        assert rec["status"] == "ok" and rec["n_chips"] == 256
        assert rec["cost"]["flops_per_device"] > 0
        assert rec["collectives"]["total_wire_bytes"] > 0 and rec["collectives"]["by_op"]
        assert rec["roofline"]["collective_s"] > 0
        assert rec["memory"]["peak_bytes_per_device"] >= rec["memory"]["argument_bytes_per_device"]
        m = rec["layout"]
        assert m["param_bytes_per_device"] > 0 and m["batch_bytes_per_device"] > 0
        assert ("opt_bytes_per_device" in m) == (configs.SHAPES[shape].kind == "train")
        assert m["batch_shards"] == 16
        assert m["state_bytes_per_device"] == sum(
            v for k, v in m.items() if k.endswith("_per_device") and k != "state_bytes_per_device")


def test_main_writes_records(tmp_path):
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k", "--both-meshes",
                        "--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "smollm-360m_long_500k_16x16.json", "smollm-360m_long_500k_2x16x16.json"]


def test_roofline_md_renders_main_records(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.roofline_md`` over the records that
    ``dryrun.main`` wrote (smoke configs): a table for each mesh, the W8A8
    cell's row on one card and on 16x16 with its variant and batch, the
    skip rows' reason, the layout row's state bytes and an error row."""
    real_get = configs.get
    monkeypatch.setattr(dryrun.configs, "get", lambda name: real_get(name).smoke())
    out = str(tmp_path)
    for argv in (["--arch", "dit-xl2", "--shape", "prefill_32k", "--mesh", "16x16",
                  "--variant", "int8", "--batch", "32"],
                 ["--arch", "dit-xl2", "--shape", "prefill_32k", "--mesh", "1",
                  "--variant", "int8", "--batch", "2"],
                 ["--arch", "smollm-360m", "--shape", "long_500k", "--both-meshes"],
                 ["--arch", "qwen3-0.6b", "--shape", "train_4k", "--mesh", "16x16",
                  "--layouts-only"]):
        assert dryrun.main(argv + ["--out", out]) == 0

    def broken(*a, **k):
        raise RuntimeError("counted nothing")

    monkeypatch.setattr(dryrun, "count_step", broken)
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh", "1",
                        "--out", out]) == 1
    capsys.readouterr()
    assert roofline_md.main(["--dir", out]) == 0
    text = capsys.readouterr().out
    tables = text.split("### ")[1:]
    assert [t.split(":")[0] for t in tables] == [
        "Roofline on one H100", "Roofline on one device of the 16x16 mesh",
        "Roofline on one device of the 2x16x16 mesh"]
    rows = {m: [ln for ln in t.splitlines() if ln.startswith("| ") and "---" not in ln][1:]
            for m, t in zip(dryrun.MESHES, tables)}
    assert [r.split(" | ")[:4] for r in rows["1"]] == [
        ["| dit-xl2", "prefill_32k", "int8", "2"], ["| qwen3-0.6b", "decode_32k", "-", "-"]]
    assert "ERROR" in rows["1"][1] and "counted nothing" in rows["1"][1]
    w8a8 = next(r for r in rows["16x16"] if r.startswith("| dit-xl2"))
    cells = w8a8.split(" | ")
    assert cells[2:4] == ["int8", "32"] and cells[8] in ("compute", "memory")
    assert cells[-1] == "True |"
    layout = next(r for r in rows["16x16"] if r.startswith("| qwen3-0.6b"))
    assert "state, layouts only" in layout and dryrun.LAYOUT_ONLY in layout
    assert len(rows["2x16x16"]) == 1 and "SKIP(full-attention)" in rows["2x16x16"][0]
    assert roofline_md.main(["--dir", out, "--mesh", "2x16x16"]) == 0
    assert capsys.readouterr().out.count("### ") == 1
    assert roofline_md.main(["--dir", str(tmp_path / "none")]) == 1
