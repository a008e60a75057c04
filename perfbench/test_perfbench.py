"""CPU tests of the benchmark: the cells and their model families resolve
from their files, the yardstick's arithmetic, the family's draws held to
recorded digests, the run's last line, the reference against the program,
the control and planted faults failing ``correct``, and the imports. A run
here drives the program's plain CPU path at a tiny size; nothing here
needs a card."""
from __future__ import annotations

import ast
import hashlib
import json
import math
import re
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import control, harness, roofline, stats, tracing

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())

TINY = {"input_size": 8, "patch_size": 2, "in_channels": 4, "hidden_size": 64, "depth": 2,
        "num_heads": 2, "mlp_ratio": 4.0, "num_classes": 10}
SEED = 2**31 + 17
DIT = harness.load_family("dit")


def tiny_cell(name: str) -> harness.Cell:
    """A cell of BENCHMARK.json at a size the CPU runs in a second: a
    two-block DiT, 4 DDIM steps, buckets up to 4, every request compared."""
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, model=TINY, reference_block=4,
                       plan=dict(cell.config["plan"], steps=4, max_batch=4))
    tr = dict(cell.traffic, sample_requests=10_000)
    if tr["kind"] == "backlog":
        tr["images_per_request"] = 2
    else:
        tr.update(rate_per_s=12.0, tail_s=0.5, warm_s=0.5, clients=8, deadline_ms=2000)
    cell.traffic = tr
    return cell


def tiny_run(name: str, seconds: float = 0.6) -> dict:
    return harness.run_cell(tiny_cell(name), SEED, seconds, False, device="cpu")


# ---------------------------------------------------------------- the cells
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_from_its_files(workload):
    cell = harness.load_cell(workload)
    assert cell.traffic["kind"] in harness.TRAFFIC_KINDS
    assert cell.config["model"]["hidden_size"] == 1152
    assert 0 < cell.config["correct"]["latent_rel_err"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in names


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for item in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", ()):
            assert w in {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert (HERE.parent / c["file"]).is_file()
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_names_a_family_with_the_whole_interface(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    family = json.loads((HERE.parent / entry["file"]).read_text())["family"]
    assert (HERE / "families" / f"{family}.py").is_file()
    mod = harness.load_family(family)
    assert all(callable(getattr(mod, f)) for f in harness.FAMILY_INTERFACE)
    for w in BENCH["workloads"]:
        if w["config"] == config:
            assert harness.load_cell(w["name"]).family.__file__ == mod.__file__


@pytest.mark.parametrize("family, looked_for", [(None, "perfbench/configs/dit-xl2-256.json"),
                                                ("nosuch", "families/nosuch.py")])
def test_load_cell_refuses_a_missing_or_an_unknown_family(family, looked_for, tmp_path):
    """A configuration without ``family``, or naming one with no module,
    is refused, and the message names the file looked for."""
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    entry = next(c for c in BENCH["configs"] if c["name"] == "dit-xl2-256")
    config = json.loads((HERE.parent / entry["file"]).read_text())
    del config["family"]
    if family is not None:
        config["family"] = family
    (tmp_path / entry["file"]).parent.mkdir(parents=True)
    (tmp_path / entry["file"]).write_text(json.dumps(config))
    with pytest.raises(SystemExit, match=re.escape(looked_for)):
        harness.load_cell("dit-xl2-256.offline", root=tmp_path)


# --------------------------------------------------------------- yardstick
@pytest.mark.parametrize("size, gmacs", [(32, 118.6), (64, 524.6)])
def test_model_macs_match_dit_paper(size, gmacs):
    """DiT-XL/2's Gflops (the DiT paper's table 4: multiply-accumulates)."""
    cell = harness.load_cell("dit-xl2-256.offline")
    model = dict(cell.config["model"], input_size=size)
    assert cell.family.model_macs(model) / 1e9 == pytest.approx(gmacs, rel=5e-4)


def test_frozen_bound_of_the_wi_launch():
    """PERF.md's kernel table: wi at B = 2 (x (512, 1152), W (4608, 1152)) is
    bound by its bytes at 0.00458 ms."""
    ops, nbytes = roofline.int8_matmul_work(1, 512, 1152, 4608, 1)
    assert nbytes / roofline.HBM_BYTES_PER_S > ops / roofline.PEAK_INT8_OPS
    assert round(roofline.launch_bound(ops, nbytes) * 1e3, 5) == 0.00458


def test_int8_launches_follow_the_modes():
    model = harness.load_cell("dit-xl2-256.offline").config["model"]
    modes = {"blk0.wq": "act", "blk0.wi": "diff", "blk0.qk": "act", "blk0.pv": "diff",
             "blk0.mod": "spatial", "final.out": "act", "blk1.qk": "spatial"}
    got = sorted(DIT.int8_matmul_launches(model, modes, 16))
    assert got == sorted([(1, 4096, 1152, 1152, 1), (256, 256, 72, 256, 256),
                          (1, 16, 1152, 6912, 1), (1, 4096, 1152, 16, 1)])


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _digest(named) -> str:
    h = hashlib.sha256()
    for name, t in named:
        h.update(repr((name, tuple(t.shape), str(t.dtype))).encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


#: The tiny model's weights and requests (3 images at indices 0, 7 and a
#: Poisson warm-up arrival's) on the CPU, recorded before DiT's draws moved
#: into ``families/dit.py``: the family draws them call for call as before.
DRAWS = {1: ("5cdcdf170dc27ba5", "7fc27afae92893c5", "2403420a5b56b108", "1cc2835eab0f7936"),
         2**31 + 17: ("bde1816f6ba41dc2", "cec4914ac1e5cb9f", "01f023845c18d0ca",
                      "91dc4e8c4ee7449d"),
         2**33 + 5: ("e037c24b67b7370e", "74d2397fba891dbe", "f880ea70d5ee4490",
                     "be4cef25797ce4f9")}


@pytest.mark.parametrize("seed", sorted(DRAWS))
def test_the_family_draws_the_recorded_weights_and_requests(seed):
    want = DRAWS[seed]
    assert _digest(_flat(DIT.make_weights(TINY, seed, "cpu"))) == want[0]
    for index, digest in zip((0, 7, harness.WARM_INDEX + 3), want[1:]):
        x, cond = DIT.make_request(TINY, seed, index, 3, "cpu")
        assert set(cond) == {"labels"}
        assert _digest([("x", x), ("labels", cond["labels"])]) == digest


def test_union_and_idle_share_of_synthetic_intervals():
    assert roofline.union_s([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == pytest.approx(3.0)
    tr = tracing.TraceData(device=[("k", 0.0, 1.0), ("k", 0.5, 2.0), ("m", 3.0, 4.0),
                                   ("k", 9.0, 12.0)])
    assert tr.busy_s(0.0, 10.0) == pytest.approx(4.0)  # (9, 12) clipped to (9, 10)
    assert tr.kernel_s(0.0, 10.0, "k") == (pytest.approx(3.5), 3)

    class R:
        trace, t_open, t_close, window_s = tr, 0.0, 10.0, 10.0

    assert stats.idle_frac(R) == pytest.approx(0.6)
    gaps = tracing.idle_gaps(tr, 0.0, 10.0)
    assert [k for k, _ in gaps] == ["after m", "after k"]
    assert [s for _, s in gaps] == [pytest.approx(5.0), pytest.approx(1.0)]


def test_percentile_and_late_requests():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile(range(101), 95) == pytest.approx(95)
    assert math.isinf(stats.percentile([1, 2, math.inf], 95))


def test_poisson_schedule_offers_every_seed_the_same_work():
    tr = harness.load_cell("dit-xl2-256.online").traffic
    (a, na), (b, nb) = (harness.poisson_schedule(tr, s, 50.0) for s in (1, 2**31 + 5))
    assert na == nb and a != b
    assert sorted(n for _, n in a[:na]) == sorted(n for _, n in b[:nb])
    gaps = [sorted(round(y - x, 9) for x, y in zip([0.0] + [o for o, _ in s[:na - 1]],
                                                  [o for o, _ in s[:na]])) for s in (a, b)]
    assert gaps[0] == gaps[1] and a[na - 1][0] == pytest.approx(b[nb - 1][0])
    assert a[na - 1][0] < 50.0


# ------------------------------------------------------------------- a run
LAST_LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("workload", ["dit-xl2-256.offline", "dit-xl2-256.online"])
def test_a_sound_run_is_correct_and_prints_the_last_line(workload, capsys):
    out = tiny_run(workload)
    assert LAST_LINE_KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["latent_rel_err"]["value"] <= out["checks"]["latent_rel_err"]["limit"]
    cell = harness.load_cell(workload)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)
    assert capsys.readouterr().err.rstrip().splitlines()[-1].startswith("check latent_rel_err")


#: A family that wraps DiT's and adds a tensor to ``cond``: each row names
#: its request and its image, so a row handed on out of place shows.
WRAPPED = """
import torch

from perfbench.harness import load_family

_dit = load_family("dit")
build_scheduler, make_weights = _dit.build_scheduler, _dit.make_weights
model_macs, int8_matmul_launches = _dit.model_macs, _dit.int8_matmul_launches
CALLS = {"submit": [], "reference": []}


def make_request(model, seed, index, images, device):
    x, cond = _dit.make_request(model, seed, index, images, device)
    tag = torch.stack([torch.full((images,), index), torch.arange(images)], dim=1)
    return x, dict(cond, tag=tag.to(device))


def submit(sched, x, cond, **kw):
    CALLS["submit"].append(cond)
    return _dit.submit(sched, x, cond, **kw)


def reference_sample(weights, config, x, cond, bits=8):
    CALLS["reference"].append(cond)
    return _dit.reference_sample(weights, config, x, cond, bits=bits)
"""


def test_a_family_under_another_root_gets_each_cond_tensor_in_place(tmp_path):
    """A run hands ``submit`` and ``reference_sample`` the same conditioning
    tensors, row for row, key by key, in the reference's blocks."""
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "wrapped.py").write_text(WRAPPED)
    cell = tiny_cell("dit-xl2-256.offline")
    cell.family = harness.load_family("wrapped", root=tmp_path)
    out = harness.run_cell(cell, SEED, 0.4, False, device="cpu")
    assert out["correct"] is True
    calls = cell.family.CALLS
    assert calls["submit"] and calls["reference"]
    submitted = {int(c["tag"][0, 0]): c for c in calls["submit"]}
    seen = []
    for cond in calls["reference"]:
        assert set(cond) == {"labels", "tag"}
        assert 0 < cond["labels"].shape[0] <= cell.config["reference_block"]
        for (index, j), label in zip(cond["tag"].tolist(), cond["labels"].tolist()):
            assert submitted[index]["labels"][j] == label
            seen.append((index, j))
    # every image of each compared request, once
    assert sorted(seen) == sorted((i, j) for i in {i for i, _ in seen}
                                  for j in range(submitted[i]["labels"].shape[0]))


def test_the_sweep_refuses_without_a_card(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    import sys

    monkeypatch.setattr(sys, "path", list(sys.path))
    from perfbench import sweep

    monkeypatch.setattr(sys, "argv", ["sweep.py", "--workload", "dit-xl2-256.online",
                                      "--rates", "1"])
    assert sweep.main() != 0 and capsys.readouterr().out == ""


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    rc = harness.main(["--workload", "dit-xl2-256.offline", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_reference_equals_the_program_on_a_two_block_dit():
    """The program's served latents (the family's scheduler, plain CPU
    path) and the family's reference's, from the same weights, noise and
    labels."""
    cell = tiny_cell("dit-xl2-256.offline")
    fam, m = cell.family, cell.config["model"]
    weights = fam.make_weights(m, SEED, "cpu")
    x, cond = fam.make_request(m, SEED, 0, 3, "cpu")
    sched = fam.build_scheduler(cell.config, weights, "cpu")
    try:
        got = fam.submit(sched, x, cond).result(timeout=120.0)
    finally:
        sched.close(drain=False, join_timeout_s=60.0)
    want = fam.reference_sample(weights, cell.config, x, cond)
    assert torch.equal(got, want)
    coarse = fam.reference_sample(weights, cell.config, x, cond, bits=4)
    assert not torch.allclose(coarse, want, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_int4_control_fails_the_limit(seed):
    cell = tiny_cell("dit-xl2-256.offline")
    cell.traffic["sample_requests"] = 3
    assert control.control_gap(cell, seed, "cpu") > cell.config["correct"]["latent_rel_err"]


def _unchanged_step(sched, x_t, eps_hat, t, t_prev):
    return x_t  # the sampler's state comes back as it went in


def _half_batch(orig):
    def serve_records(*args, **kw):
        records, sample, eng = orig(*args, **kw)
        half = (sample.shape[0] + 1) // 2
        sample = sample.clone()
        sample[half:] = sample[:half].mean(dim=0, keepdim=True)  # the rest: the mean
        return records, sample, eng
    return serve_records


def _altered_answer(orig):
    def serve_records(*args, **kw):
        records, sample, eng = orig(*args, **kw)
        sample = sample.clone()
        sample[0] = -sample[0]  # one image altered where it is produced
        return records, sample, eng
    return serve_records


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_answer"])
def test_a_planted_fault_makes_correct_false(fault, monkeypatch):
    from repro_torch.core import diffusion
    from repro_torch.sim import harness as sim_harness

    if fault == "state_unchanged":
        monkeypatch.setattr(diffusion, "ddim_step", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(sim_harness, "serve_records", _half_batch(sim_harness.serve_records))
    else:
        monkeypatch.setattr(sim_harness, "serve_records",
                            _altered_answer(sim_harness.serve_records))
    out = tiny_run("dit-xl2-256.offline", seconds=0.4)
    assert out["attempted"] > 0 and out["correct"] is False


# ----------------------------------------------------------------- imports
def _absolute(path: Path, name: str) -> str:
    """``name`` as imported from ``path`` in the ``perfbench`` package."""
    rest = name.lstrip(".")
    level = len(name) - len(rest)
    if not level:
        return name
    pkg = ["perfbench", *path.parent.relative_to(HERE).parts]
    return ".".join(pkg[:len(pkg) - level + 1] + ([rest] if rest else []))


def _imported(path: Path) -> set[str]:
    """Every module ``path`` imports, absolute, with ``from m import n``
    also as ``m.n``."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mod = _absolute(path, "." * node.level + (node.module or ""))
            out |= {mod} | {f"{mod}.{a.name}" for a in node.names}
    return out


SOURCES = sorted(p for p in HERE.rglob("*.py") if not p.name.startswith("test_"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package_import(path):
    tops = {m.split(".")[0] for m in _imported(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if path.parent.name == "reference":
        assert tops <= {"__future__", "math", "torch"}, tops


#: Where the model may be named: its family's module and its reference.
MODEL_DIRS = ("families", "reference")
DIT_MODULES = {"repro_torch.nn.dit", "perfbench.reference.dit"}


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if p.relative_to(HERE).parts[0] not in MODEL_DIRS],
    ids=lambda p: str(p.relative_to(HERE)))
def test_only_the_family_and_the_reference_import_the_model(path):
    assert not _imported(path) & DIT_MODULES


def test_the_import_check_resolves_relative_imports():
    assert "perfbench.reference.dit" in _imported(HERE / "families" / "dit.py")
    assert _absolute(HERE / "harness.py", ".reference") == "perfbench.reference"
    assert _absolute(HERE / "metrics" / "mfu.py", "..reference") == "perfbench.reference"


def test_the_run_names_jax_and_the_jax_package_by_whole_top_level_name(monkeypatch):
    import sys

    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []  # repro_torch is not repro
    monkeypatch.setitem(sys.modules, "repro.serve", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib", "repro"]
