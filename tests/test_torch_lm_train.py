"""LM training in the port against the reference, on the CPU: the token
data, ``cross_entropy``, the LM train step (dense stack and MoE), gradient
accumulation, remat, the train driver and the entry points; and the
serving steps fed a training batch.

Both packages get the same numpy inputs (params through
``bridge.params_from_numpy``, batches drawn by the port's ``lm_batch``),
at the reference's ``smoke()`` size (2 layers, d = 64, float32).
Tolerances, with their reasons (as ``tests/test_torch_lm.py`` and
``tests/test_torch_train.py`` set them):

* ``cross_entropy``: 1e-6 relative (a float32 logsumexp and a mean);
* losses, ``aux`` and ``lr`` of a train step: 1e-5 relative (float32
  products summed in other orders);
* the params' updates: relative L2 per leaf <= 1e-2 (Adam divides each
  gradient entry by its own running RMS, so an entry whose gradient is tiny
  moves by ~lr whatever its last bits);
* logits of the serving steps: max-abs difference <= 1e-5 of the
  reference's max-abs;
* inside the port: remat on and off, and a restart, bit for bit; the
  reference's own accumulation test keeps its tolerances (5e-3 on the
  loss, 5e-2 relative on the gradient norm).
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.nn import core as rcore  # noqa: E402
from repro_torch import bridge, configs, tree  # noqa: E402
from repro_torch.data.synthetic import DataCfg, batch_for, lm_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.train import TrainDriver  # noqa: E402
from repro_torch.models import LM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-5
STACK = [n for n in rconfigs.names() if rconfigs.get(n).family in ("dense", "vlm", "audio")]
MOE = ["qwen2-moe-a2.7b", "arctic-480b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t_(a):
    return torch.from_numpy(np.array(a, copy=True))


def rel_err(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


def _arch(name, **repl):
    ref = dataclasses.replace(rconfigs.get(name).smoke(), **repl)
    return ref, configs.ArchConfig(**dataclasses.asdict(ref))


def np_batch(arch, batch=2, seq=16, step=0):
    return {k: v.numpy() for k, v in
            lm_batch(arch, DataCfg(seed=0, batch=batch, seq_len=seq), step, device="cpu").items()}


def for_ref(batch):
    """A numpy batch as the reference takes it (int32 token ids)."""
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def both_states(rarch, arch, ropt, opt):
    """The reference's init_state and the port's state on the same params."""
    rstate = rsteps.init_state(rarch, jax.random.PRNGKey(0), ropt)
    p0 = jax.tree.map(np.asarray, rstate["params"])
    params = bridge.params_from_numpy(p0, device="cpu")
    return rstate, {"params": params, "opt": opt.init(params), "rng": torch.tensor(0)}, p0


def assert_updates_close(rparams, params, p0):
    want_flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    got = tree.leaves(params)
    assert len(got) == len(want_flat)
    for (path, w), g, w0 in zip(want_flat, got, jax.tree.leaves(p0)):
        dw, dg = np.asarray(w) - w0, g.numpy() - w0
        rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        assert rel < 1e-2, (jax.tree_util.keystr(path), rel)


# -------------------------------------------------------- the serving fault
@pytest.mark.parametrize("name", ["qwen3-0.6b", "internvl2-2b", "musicgen-medium"])
def test_serving_steps_take_a_training_batch(name):
    """An ``lm_batch`` dict (with ``labels``) goes through both packages'
    prefill and decode steps; each step reads the reference's keys alone:
    ``tokens`` (``embeds`` for audio), a vision prefix at prefill. A
    non-audio batch that also carries ``embeds`` uses its tokens."""
    rarch, arch = _arch(name)
    nt = jax.tree.map(lambda p: np.asarray(p.value), RLM(rarch).init(jax.random.PRNGKey(1)),
                      is_leaf=rcore.is_param)
    rp, p = jax.tree.map(jnp.asarray, nt), bridge.params_from_numpy(nt, device="cpu")
    batch = np_batch(arch, seq=6)
    assert "labels" in batch
    if arch.frontend != "audio":  # a stray key the step must not read
        batch["embeds"] = np.ones((2, 6, arch.d_model), np.float32)
    rlast, rcache = rsteps.make_prefill_step(rarch)(rp, for_ref(batch))
    last, cache = steps.make_prefill_step(arch)(p, {k: t_(v) for k, v in batch.items()})
    assert rel_err(last, rlast) <= REL
    if arch.frontend != "audio":
        alone, _ = LM(arch).prefill(p, tokens=t_(batch["tokens"]),
                                    **({"frontend_embeds": t_(batch["frontend_embeds"])}
                                       if "frontend_embeds" in batch else {}))
        assert torch.equal(last, alone)
    pad = lambda a: np.pad(np.asarray(a), ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))  # noqa: E731
    n = cache["k"].shape[2]
    step_batch = {k: v[:, :1] for k, v in batch.items() if k != "frontend_embeds"}
    rlg, _ = rsteps.make_decode_step(rarch)(rp, {k: jnp.asarray(pad(v)) for k, v in
                                                 rcache.items()},
                                            dict(for_ref(step_batch), pos=jnp.int32(n)))
    lg, _ = steps.make_decode_step(arch)(p, {k: t_(pad(v.numpy())) for k, v in cache.items()},
                                         dict({k: t_(v) for k, v in step_batch.items()}, pos=n))
    assert rel_err(lg, rlg) <= REL


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("name", ["qwen3-0.6b", "internvl2-2b", "musicgen-medium"])
def test_lm_batch_follows_the_reference_recipe(name):
    """The reference's keys and shapes (token ids int64 here, int32 there),
    labels the tokens shifted left with a last 0, ids inside the vocab,
    ~75 % structured tokens, frontend stubs of scale 0.02; a pure function
    of (seed, step)."""
    rarch, arch = _arch(name)
    dc = DataCfg(seed=3, batch=4, seq_len=128)
    want = rsyn.lm_batch(rarch, rsyn.DataCfg(seed=3, batch=4, seq_len=128), 0)
    got = lm_batch(arch, dc, 0, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == (torch.int64 if want[k].dtype == jnp.int32 else torch.float32), k
    tok, lab = got["tokens"], got["labels"]
    assert torch.equal(lab[:, :-1], tok[:, 1:]) and not lab[:, -1].any()
    assert int(tok.min()) >= 0 and int(tok.max()) < arch.vocab_size
    pos = torch.arange(1, 129)
    share = max(float(((pos * d) % arch.vocab_size == tok[0]).float().mean()) for d in range(1, 7))
    assert 0.6 < share < 0.9, share
    for k in ("embeds", "frontend_embeds"):
        if k in got:
            assert 0.015 < float(got[k].std()) < 0.025
    again = batch_for(arch, dc, 0, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(batch_for(arch, dc, 1, device="cpu")["tokens"], tok)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 300)) * 5).astype(np.float32)
    labels = rng.integers(0, 300, (2, 7))
    want = float(rsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels.astype(np.int32))))
    got = steps.cross_entropy(t_(logits), t_(labels))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    # bf16 logits are cast up first, as the reference's
    lb = t_(logits).to(torch.bfloat16)
    assert float(steps.cross_entropy(lb, t_(labels))) == pytest.approx(
        float(rsteps.cross_entropy(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                                   jnp.asarray(labels.astype(np.int32)))), rel=1e-6)


# ---------------------------------------------------------------- the step
@pytest.mark.parametrize("name", STACK + MOE)
def test_lm_train_step_matches_reference(name):
    """Two train steps (tests/test_arch_smoke.py::test_smoke_forward_and_train
    with the reference as the oracle): loss, aux and lr within 1e-5, the
    params' updates within 1e-2."""
    rarch, arch = _arch(name)
    ropt = rsteps.make_optimizer(rarch, base_lr=1e-3, warmup=2, total=10)
    opt = steps.make_optimizer(arch, base_lr=1e-3, warmup=2, total=10)
    rstate, state, p0 = both_states(rarch, arch, ropt, opt)
    rtrain, train = jax.jit(rsteps.make_train_step(rarch, ropt)), steps.make_train_step(arch, opt)
    assert isinstance(train, steps.LMTrainStep)
    for step in range(2):
        batch = np_batch(arch, step=step)
        rstate, rm = rtrain(rstate, for_ref(batch))
        state, m = train(state, {k: t_(v) for k, v in batch.items()})
        assert sorted(m) == sorted(rm) == ["aux", "grad_norm", "loss", "lr"]
        for k in ("loss", "aux", "lr"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=REL, abs=1e-12), (k, step)
        assert np.isfinite(float(m["loss"]))
    assert (float(m["aux"]) > 0) == (arch.family == "moe")
    assert_updates_close(rstate["params"], state["params"], p0)


def _ref_effective_accum(arch, shards):
    """The reference's ``_effective_accum``, from its train step's closure."""
    fn = rsteps.make_train_step(arch, rsteps.make_optimizer(arch), batch_shards=shards)
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells["_effective_accum"].cell_contents


def test_effective_accum_matches_reference():
    base = rconfigs.get("qwen3-0.6b").smoke()
    table = []
    for accum in (1, 2, 3, 4, 8, 16):
        for shards in (1, 2, 4):
            rarch = dataclasses.replace(base, grad_accum=accum)
            ref = _ref_effective_accum(rarch, shards)
            step = steps.make_train_step(configs.ArchConfig(**dataclasses.asdict(rarch)),
                                         steps.make_optimizer(configs.get("qwen3-0.6b")),
                                         batch_shards=shards)
            for batch in (1, 2, 3, 4, 6, 8, 12, 16, 256):
                table.append((accum, shards, batch, step.effective_accum(batch), ref(batch)))
    assert all(got == want for *_, got, want in table), [r for r in table if r[-2] != r[-1]]
    assert (4, 1, 6, 3, 3) in table and (8, 4, 16, 4, 4) in table


@pytest.mark.parametrize("name,repl", [("qwen3-0.6b", {}),
                                       ("arctic-480b", dict(accum_dtype="bfloat16"))],
                         ids=["qwen3-0.6b", "arctic-480b-bf16-accum"])
def test_grad_accum_matches_reference(name, repl):
    """tests/test_arch_smoke.py::test_smoke_grad_accum_equivalence in the
    port (accum 2 against 1, the reference's tolerances), and the port's
    accum-2 step against the reference's: microbatch i holds rows i, i + 2
    (the MoE's capacity groups see those rows), gradients summed in the
    config's accumulation dtype."""
    rarch, arch = _arch(name, grad_accum=2, **repl)
    batch = np_batch(arch, batch=4)
    ropt = rsteps.make_optimizer(rarch, total=10)
    opt = steps.make_optimizer(arch, total=10)
    rstate, state, p0 = both_states(rarch, arch, ropt, opt)
    rstate, rm = jax.jit(rsteps.make_train_step(rarch, ropt))(rstate, for_ref(batch))
    train = steps.make_train_step(arch, opt)
    seen = []
    grads_of = train._grads

    def spy(params, mb):
        seen.append(mb["tokens"].clone())
        return grads_of(params, mb)

    train._grads = spy
    state, m = train(state, {k: t_(v) for k, v in batch.items()})
    assert [s.tolist() for s in seen] == [batch["tokens"][i::2].tolist() for i in range(2)]
    for k in ("loss", "aux", "lr", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=REL, abs=1e-12), k
    assert_updates_close(rstate["params"], state["params"], p0)
    # accum 1 against accum 2 in the port
    arch1 = dataclasses.replace(arch, grad_accum=1)
    opt1 = steps.make_optimizer(arch1, total=10)
    params = bridge.params_from_numpy(p0, device="cpu")
    _, m1 = steps.make_train_step(arch1, opt1)(
        {"params": params, "opt": opt1.init(params), "rng": torch.tensor(0)},
        {k: t_(v) for k, v in batch.items()})
    assert abs(float(m1["loss"]) - float(m["loss"])) < 5e-3
    assert abs(float(m1["grad_norm"]) - float(m["grad_norm"])) / float(m1["grad_norm"]) < 5e-2


@pytest.mark.parametrize("name", ["qwen3-0.6b", "qwen2-moe-a2.7b", "internvl2-2b"])
def test_remat_is_bit_exact(name):
    """``cfg.remat`` recomputes each block in the backward: the loss and
    every gradient equal those without it, bit for bit."""
    arch = configs.get(name).smoke()
    params = LM(arch).init(torch.Generator().manual_seed(0), device="cpu")
    batch = lm_batch(arch, DataCfg(seed=1, batch=2, seq_len=16), 0, device="cpu")
    out = {}
    for remat in (True, False):
        train = steps.make_train_step(dataclasses.replace(arch, remat=remat),
                                      steps.make_optimizer(arch))
        out[remat] = train.loss_and_grads(params, batch)
    (ce1, aux1, g1), (ce0, aux0, g0) = out[True], out[False]
    assert torch.equal(ce1, ce0) and torch.equal(aux1, aux0)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g1), tree.leaves(g0)))
    assert all(bool(g.abs().sum() > 0) for g in tree.leaves(g1)
               if g.dim() > 1)  # every weight gets a gradient


# ------------------------------------------------------------------ driver
def test_train_driver_resume_bitexact(tmp_path):
    """tests/test_runtime.py::test_train_driver_resume_bitexact (smollm-360m
    smoke, seq 16); in the port the restart is bit for bit."""
    arch = configs.get("smollm-360m").smoke()
    kw = dict(workdir=str(tmp_path / "a"), batch=2, seq=16, total_steps=8, ckpt_every=0,
              device="cpu")
    d1 = TrainDriver(arch, **kw)
    s1, _ = d1.run()
    kw2 = dict(kw, workdir=str(tmp_path / "b"))
    TrainDriver(arch, **kw2).run(steps=4)
    d3 = TrainDriver(arch, **kw2)
    s3, step = d3.run()
    assert abs(d3.metrics_log[-1]["loss"] - d1.metrics_log[-1]["loss"]) < 1e-5
    assert d3.metrics_log[-1]["step"] == d1.metrics_log[-1]["step"] == 7 and step == 8
    assert [m["loss"] for m in d3.metrics_log] == [m["loss"] for m in d1.metrics_log[4:]]
    la, lb = tree.leaves(s1["params"]), tree.leaves(s3["params"])
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert d1.data_cfg.seq_len == 16


# ------------------------------------------------------------ entry points
def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_points_on_cpu(tmp_path, capsys):
    """``launch.train --seq`` on an LM, ``examples/train_lm_torch.py``
    (preempt, checkpoint, resume) and ``examples/quickstart_torch.py``, each
    briefly, on the CPU."""
    d = train_mod.main(["--arch", "smollm-360m", "--smoke", "--steps", "2", "--batch", "2",
                        "--seq", "8", "--workdir", str(tmp_path / "t"), "--device", "cpu"])
    assert len(d.metrics_log) == 2 and d.data_cfg.seq_len == 8
    assert "[train] arch=smollm-360m device=cpu steps=2" in capsys.readouterr().out
    lm = _load("examples/train_lm_torch.py")
    d2 = lm.main(["--device", "cpu", "--steps", "6", "--preempt-at", "3", "--seq", "16",
                  "--workdir", str(tmp_path / "lm")])
    out = capsys.readouterr().out
    assert "[phase1] steps=3" in out and "[phase2] resumed -> step 6" in out
    assert [m["step"] for m in d2.metrics_log] == [3, 4, 5]
    qs = _load("examples/quickstart_torch.py")
    qs.main(["--device", "cpu", "--train-steps", "3", "--sample-steps", "4"])
    out = capsys.readouterr().out
    assert "[train] step    0" in out and "[ditto] FP32-vs-Ditto rel L2" in out
    assert "[sim]  ditto+" in out


def test_lm_entry_points_need_a_card_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = configs.get("qwen3-0.6b").smoke()
    opt = steps.make_optimizer(arch)
    for call in (lambda d: lm_batch(arch, DataCfg(), 0, device=d),
                 lambda d: steps.init_state(arch, 0, opt, device=d),
                 lambda d: TrainDriver(arch, workdir=str(tmp_path), device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        call("cpu")
