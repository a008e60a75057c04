"""The port's training runtime on the CPU: checkpoints (atomic, async,
restore of list / dict optimizer state, bfloat16 leaves bit for bit), the
deterministic seekable data, the fault-tolerant ``TrainDriver`` (resume
within 1e-5 as the reference's test asks, and bit for bit here; async
saves; preemption) and ``launch.train.main``. Mirrors the training half of
``tests/test_runtime.py``. Also: the new modules import neither JAX nor
the JAX package, and their entry points need a card unless asked for the
CPU.
"""
import ast
import dataclasses
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.checkpoint import manager as rmanager  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.synthetic import DataCfg, batch_for, host_slice  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.train import TrainDriver  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
NEW_MODULES = ["tree.py", "configs/__init__.py", "configs/base.py", "configs/dit_xl2.py",
               "configs/registry.py", "optim/__init__.py", "optim/adamw.py",
               "optim/schedules.py", "data/__init__.py", "data/synthetic.py",
               "checkpoint/__init__.py", "checkpoint/manager.py", "launch/__init__.py",
               "launch/steps.py", "launch/train.py", "models/__init__.py",
               "models/dit_int8.py"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke():
    return configs.get("dit-xl2").smoke()


def assert_trees_equal(a, b):
    la, lb = list(tree.paths(a)), list(tree.paths(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device, p
        assert torch.equal(x, y), p


# --------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(0)
    t = {"a": torch.randn((4, 8), generator=g), "b": {"c": torch.arange(5)},
         "s": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, t)
    assert_trees_equal(mgr.restore(3, t), t)


def test_checkpoint_atomic_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3)})
    # a partial (uncommitted) dir must be invisible
    os.makedirs(tmp_path / "step_000000002")
    assert mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        mgr.restore(2, {"a": torch.zeros(3)})


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = {"a": torch.randn((16,), generator=torch.Generator().manual_seed(0))}
    for s in (1, 2, 3, 4):
        mgr.save_async(s, t)
    mgr.wait()
    mgr.save(5, t)
    assert mgr.all_steps()[-1] == 5 and len(mgr.all_steps()) <= 2


def test_save_async_snapshots_before_it_returns(tmp_path):
    """The next step may update the tensors in place at once."""
    mgr = CheckpointManager(str(tmp_path))
    t = {"a": torch.arange(6, dtype=torch.float32)}
    want = t["a"].clone()
    mgr.save_async(1, t)
    t["a"].add_(100.0)  # the next step's in-place update
    mgr.wait()
    assert torch.equal(mgr.restore(1, t)["a"], want)


def test_checkpoint_restore_list_state(tmp_path):
    """Optimizer state with list / dict-of-row-col leaves survives."""
    arch = dataclasses.replace(smoke(), factored_second_moment=True)
    opt = steps_mod.make_optimizer(arch, total=10)
    state = steps_mod.init_state(arch, 0, opt, device="cpu")
    state, _ = steps_mod.make_train_step(arch, opt)(
        state, batch_for(arch, DataCfg(batch=2), 0, device="cpu"))
    assert any(isinstance(v, dict) for v in state["opt"]["v"])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    like = steps_mod.init_state(arch, 1, opt, device="cpu")
    assert_trees_equal(mgr.restore(1, like), state)


def test_checkpoint_bf16_leaf_bit_for_bit(tmp_path):
    bits = torch.tensor([0, 0x8000, 0x3F80, 0x7F80, 0xFF80, 0x7FC1, 0x0001, 0x7F7F],
                        dtype=torch.int32).to(torch.int16)  # incl. -0, inf, -inf, nan
    t = {"w": bits.view(torch.bfloat16), "f": torch.ones(2)}
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(1, t)
    with open(os.path.join(path, "meta")) as f:
        assert json.load(f)["dtypes"] == {"f": "float32", "w": "bfloat16"}
    assert np.load(os.path.join(path, "arrays.npz"))["w"].dtype == np.uint16
    out = mgr.restore(1, t)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), bits)
    # restore casts to the like-tree's dtypes
    wide = mgr.restore(1, {"w": torch.zeros(8), "f": torch.zeros(2, dtype=torch.bfloat16)})
    assert wide["w"].dtype == torch.float32 and wide["f"].dtype == torch.bfloat16


def test_checkpoint_keys_match_reference(tmp_path):
    """A state tree's leaves have the reference's checkpoint keys, in its
    order."""
    arch = dataclasses.replace(smoke(), factored_second_moment=True)
    state = steps_mod.init_state(arch, 0, steps_mod.make_optimizer(arch), device="cpu")
    path = CheckpointManager(str(tmp_path)).save(0, state)
    with open(os.path.join(path, "meta")) as f:
        keys = json.load(f)["keys"]
    like = jax.tree.map(lambda a: jnp.zeros(a.shape), tree.map_tree(lambda a: a.numpy(), state))
    assert keys == list(rmanager._flatten(like))
    with pytest.raises(KeyError, match="missing keys"):
        CheckpointManager(str(tmp_path)).restore(0, {"extra": torch.zeros(1), **state})


# --------------------------------------------------------------------- data
def test_data_deterministic_and_seekable():
    arch = smoke()
    dc = DataCfg(seed=3, batch=4)
    b1 = batch_for(arch, dc, 17, device="cpu")
    b2 = batch_for(arch, dc, 17, device="cpu")
    assert torch.equal(b1["x0"], b2["x0"]) and torch.equal(b1["labels"], b2["labels"])
    b3 = batch_for(arch, dc, 18, device="cpu")
    assert not torch.equal(b1["x0"], b3["x0"])
    assert not torch.equal(batch_for(arch, DataCfg(seed=4, batch=4), 17, device="cpu")["x0"],
                           b1["x0"])
    h0, h1 = host_slice(b1, 0, 2), host_slice(b1, 1, 2)
    assert torch.equal(torch.cat([h0["x0"], h1["x0"]]), b1["x0"])
    with pytest.raises(ValueError, match="does not split"):
        host_slice(b1, 0, 3)
    assert b1["x0"].shape == (4, 8, 8, 4) and b1["x0"].dtype == torch.float32
    assert b1["labels"].dtype == torch.int64


def test_data_is_the_reference_mixture():
    """8 modes with means fixed by the seed, 0.25 noise, labels comp %
    n_classes: rows of one label differ only by the noise."""
    arch = dataclasses.replace(smoke(), n_classes=1000)
    b = batch_for(arch, DataCfg(seed=0, batch=256), 0, device="cpu")
    labels, x0 = b["labels"], b["x0"]
    assert set(labels.tolist()) <= set(range(8))
    for c in labels.unique().tolist():
        rows = x0[labels == c]
        if len(rows) > 8:
            resid = rows - rows.mean(0)
            assert 0.2 < float(resid.std()) < 0.3
    means = torch.stack([x0[labels == c].mean(0) for c in labels.unique().tolist()])
    assert 0.6 < float(means.std()) < 1.0
    # an LM arch's batch is the reference's lm_batch layout (its recipe:
    # tests/test_torch_lm_train.py)
    larch = configs.get("qwen3-0.6b").smoke()
    lb = batch_for(larch, DataCfg(batch=3, seq_len=8), 0, device="cpu")
    want = rsyn.batch_for(rconfigs.get("qwen3-0.6b").smoke(),
                          rsyn.DataCfg(batch=3, seq_len=8), 0)
    assert {k: tuple(v.shape) for k, v in lb.items()} == {k: v.shape for k, v in want.items()}
    assert torch.equal(lb["labels"][:, :-1], lb["tokens"][:, 1:])


# ------------------------------------------------------------- train driver
def test_train_driver_resume_bitexact(tmp_path):
    arch = smoke()
    kw = dict(workdir=str(tmp_path / "a"), batch=2, total_steps=8, ckpt_every=0,
              device="cpu")
    d1 = TrainDriver(arch, **kw)
    s1, _ = d1.run()
    loss_straight = d1.metrics_log[-1]["loss"]
    # interrupted run: 4 steps, then resume for the rest
    kw2 = dict(kw, workdir=str(tmp_path / "b"))
    d2 = TrainDriver(arch, **kw2)
    d2.run(steps=4)
    d3 = TrainDriver(arch, **kw2)
    s3, step = d3.run()
    assert abs(d3.metrics_log[-1]["loss"] - loss_straight) < 1e-5
    assert d3.metrics_log[-1]["step"] == d1.metrics_log[-1]["step"] == 7 and step == 8
    assert [m["step"] for m in d3.metrics_log] == [4, 5, 6, 7]
    # on the CPU the restart is bit for bit
    assert [m["loss"] for m in d3.metrics_log] == [m["loss"] for m in d1.metrics_log[4:]]
    assert_trees_equal(s3, s1)


def test_train_driver_async_saves_and_preemption(tmp_path, monkeypatch):
    arch = smoke()
    d = TrainDriver(arch, workdir=str(tmp_path / "a"), batch=2, total_steps=6, ckpt_every=2,
                    device="cpu")
    d.run()
    assert d.ckpt.all_steps() == [2, 4, 6]  # async at 2, 4; the final save at 6
    assert all(np.isfinite(m["loss"]) and m["lr"] > 0 for m in d.metrics_log)
    # a SIGTERM between steps checkpoints the next step at once and returns
    d2 = TrainDriver(arch, workdir=str(tmp_path / "b"), batch=2, total_steps=6, ckpt_every=0,
                     device="cpu")
    step_fn = d2.train_step

    def preempted_after_two(state, batch):
        out = step_fn(state, batch)
        if int(out[0]["opt"]["step"]) == 2:
            d2._preempted = True
        return out

    monkeypatch.setattr(d2, "train_step", preempted_after_two)
    _, step = d2.run()
    assert step == 2 and d2.ckpt.all_steps() == [2]


def test_train_main_on_cpu(tmp_path, capsys):
    d = train_mod.main(["--arch", "dit-xl2", "--smoke", "--steps", "3", "--batch", "2",
                        "--workdir", str(tmp_path), "--device", "cpu"])
    assert len(d.metrics_log) == 3 and d.ckpt.latest_step() == 3
    assert "[train] arch=dit-xl2 device=cpu steps=3" in capsys.readouterr().out


def test_serve_example_trains_before_serving(tmp_path, capsys):
    """``examples/serve_diffusion_torch.py --train-steps N`` trains the DiT
    with the port's train step, then serves the trained weights."""
    path = ROOT / "examples" / "serve_diffusion_torch.py"
    spec = importlib.util.spec_from_file_location("serve_diffusion_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    params = example.build_model(example.ARCH_SMALL, 0, torch.device("cpu"), 6)
    assert all(p.dtype == torch.float32 for p in tree.leaves(params))
    assert "trained dit-xl2 (2 x 64) for 6 step(s)" in capsys.readouterr().out
    random = example.build_model(example.ARCH_SMALL, 0, torch.device("cpu"))
    assert not torch.equal(params["blocks"]["mod"]["w"], random["blocks"]["mod"]["w"])
    st = example.main(["--device", "cpu", "--small", "--steps", "3", "--requests", "2",
                       "--batch", "2", "--train-steps", "4", "--log", str(tmp_path / "log.json")])
    assert st["requests"] == 2
    assert "for 4 step(s)" in capsys.readouterr().out


# ------------------------------------------------------------------- rules
def test_new_modules_import_neither_jax_nor_reference():
    for rel in NEW_MODULES:
        path = ROOT / "src" / "repro_torch" / rel
        assert path.exists(), path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "flax", "msgpack"), (
                    f"{path}: imports {name}")


def test_training_entry_points_need_a_card_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = smoke()
    opt = steps_mod.make_optimizer(arch)
    for call in (lambda d: TrainDriver(arch, workdir=str(tmp_path), device=d),
                 lambda d: batch_for(arch, DataCfg(), 0, device=d),
                 lambda d: steps_mod.init_state(arch, 0, opt, device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        call("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "dit-xl2", "--smoke", "--steps", "1",
                        "--workdir", str(tmp_path)])
