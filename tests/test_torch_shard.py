"""The reference's ``shard=`` in the port's LM steps, and the diffusion
family's steps on DTensors, on the CPU: the sharded train, prefill and
decode steps, the float and W8A8 denoisers and the DiT train step against
the unsharded ones and against the reference's sharded steps.

* (a) the builders' default and ``make_shard_fn(rules, None)`` are the
  identity: every family's ``smoke()`` steps bit for bit;
* (b) on a one-rank (1, 1) gloo mesh, qwen3-0.6b, qwen2-moe-a2.7b and
  xlstm-125m: the sharded steps equal the unsharded ones bit for bit
  (xlstm-125m's decode logits within 1e-6: a block's memory layout picks
  the CPU BLAS's path for its last product), and
  the reference's sharded steps (``jax.make_mesh`` with ``Auto`` axes; its
  default ``Explicit`` axes refuse ``with_sharding_constraint``) within
  rtol = atol = 2e-4, the LM parity tolerance of ``tests/test_torch_lm.py``;
  dit-xl2's float and W8A8 denoisers bit for bit, and within 1e-3 of the
  output's scale of the reference's jitted
  ``make_denoise_step`` on the same mesh (``tests/test_torch_dit_int8.py``'s
  tolerance: a one-ulp difference in the glue can flip an int8 rounding);
* (c) 2 and 4 gloo ranks in their own processes (``tests/_torch_shard_worker.py``),
  meshes (2, 1), (1, 2) and (2, 2): a train step with its update, a
  prefill and two decode steps of qwen3-0.6b, qwen2-moe-a2.7b (experts on
  'model') and qwen3-0.6b with ``fsdp=True, grad_accum=2`` (the microbatch
  and carry constraints), and on (1, 2) qwen3-0.6b with one kv head (the
  decode cache split over its slots), and dit-xl2's float denoiser, W8A8
  denoiser and train step (``with_noise``), against the unsharded steps.
  The W8A8 denoiser's int8 operands and int32 products bit for bit, on
  every mesh; its output and the float denoiser's keep the batch split
  over 'data'. Bit for bit where the
  mesh splits rows only and no product's contraction or sum crosses ranks
  (each case names those outputs); everything else within rtol = atol =
  1e-5 in float32 (gradients and losses sum over the split batch, a split
  contraction sums over 'model', and the CPU BLAS sums a product of two
  rows in another order than one of four);
* (d) the dry run's fake backend at (16, 16): a ``smoke()`` sharded train
  step's counted collectives include the gradient's reduction over 'data';
  the fake group refuses to start while another group is up; the W8A8
  denoiser's cell on both production meshes counts one rank's rows: its
  ``int8_matmul`` work equals the one-card step's at the rank's batch, and
  its only collectives are the activations' 4-byte max;
* (e) a DTensor given to a kernel wrapper raises ``TypeError``.

Inputs come from a numpy seed; the params from the port's init at seed 0
(the reference gets the same arrays).
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Shard  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.kernels import diff_encode, ditto_diff_matmul, fused_step  # noqa: E402
from repro_torch.kernels import int8_matmul  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.nn import moe  # noqa: E402

import _torch_shard_worker as worker  # noqa: E402

FAMILIES = ["qwen3-0.6b", "qwen2-moe-a2.7b", "xlstm-125m", "zamba2-7b", "internvl2-2b",
            "musicgen-medium"]
B, S, SEED = 4, 16, 3
REF_TOL = 2e-4
RANK_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_all_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# ------------------------------------------------------------- (a) identity
@pytest.mark.parametrize("name", FAMILIES)
def test_identity_shard_every_family(name):
    """``shard=None`` (the builders' default) and ``make_shard_fn(rules,
    None)``: the same train step, prefill and decode steps, bit for bit."""
    arch = worker.make_arch(name)
    state, batch = worker.make_state(arch), worker.make_batch(arch, B, S, SEED)
    plain = worker.run_steps(arch, state, batch)
    ident = worker.run_steps(arch, state, batch,
                             shard=sharding.make_shard_fn(sharding.make_rules(arch), None))
    _assert_all_equal(ident, plain)
    assert any(k.startswith("decode/cache/") for k in plain)


def test_identity_shard_diffusion_and_defaults():
    """The diffusion train step ignores ``shard`` (as the reference's); every
    builder takes ``shard=`` with the identity default."""
    arch = configs.get("dit-xl2").smoke()
    opt = steps.make_optimizer(arch)
    st = steps.init_state(arch, 0, opt, device="cpu")
    x0 = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (2, arch.input_size, arch.input_size, arch.in_channels)).astype(np.float32))
    batch = {"x0": x0, "labels": torch.tensor([1, 2])}
    a = steps.make_train_step(arch, opt)
    b = steps.make_train_step(arch, opt, shard=sharding.make_shard_fn(
        sharding.make_rules(arch), None))
    noise = a.noise(st, batch)
    la, _ = a.loss_and_grads(st["params"], batch, *noise)
    lb, _ = b.loss_and_grads(st["params"], batch, *noise)
    assert torch.equal(la, lb)
    lm_arch = configs.get("qwen3-0.6b").smoke()
    assert LM(lm_arch).shard(x0, ("batch",)) is x0
    assert steps.LMTrainStep(lm_arch, opt).shard is None
    import inspect

    from repro_torch.launch.train import TrainDriver
    for fn, names in ((LM.__init__, ("shard",)), (moe.apply, ("shard",)),
                      (steps.make_train_step, ("shard",)), (steps.LMTrainStep, ("shard",)),
                      (steps.make_prefill_step, ("shard",)), (steps.make_decode_step, ("shard",)),
                      (TrainDriver.__init__, ("mesh", "shard"))):
        params = inspect.signature(fn).parameters
        for n in names:
            assert params[n].default is None, (fn, n)


# ----------------------------------------------------- (b) one rank, reference
def _ref_flat(t):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def _reference(rarch, rstate, batch):
    """The reference's sharded steps on a (1, 1) Auto-axes mesh, keyed as
    ``worker.run_steps`` keys the port's outputs."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    shard = rsh.make_shard_fn(rsh.make_rules(rarch), mesh)
    ropt = rsteps.make_optimizer(rarch)
    np_b = {k: (v.numpy().astype(np.int32) if v.dtype == torch.int64 else v.numpy())
            for k, v in batch.items()}
    out = {}
    new, metrics = jax.jit(rsteps.make_train_step(rarch, ropt, shard=shard))(
        rstate, {"tokens": np_b["tokens"], "labels": np_b["labels"]})
    out.update({f"train/{k}": v for k, v in metrics.items()})
    out.update({f"train/state/{k}": v for k, v in _ref_flat(new).items()})
    logits, cache = jax.jit(rsteps.make_prefill_step(rarch, shard=shard))(
        rstate["params"], {"tokens": np_b["tokens"]})
    out["prefill/logits"] = logits
    out.update({f"prefill/cache/{k}": v for k, v in cache.items()})
    if "k" in cache:  # room for the decode steps
        pad = ((0, 0), (0, 0), (0, worker.DECODE_STEPS), (0, 0), (0, 0))
        cache = {k: jnp.pad(v, pad) for k, v in cache.items()}
    decode = jax.jit(rsteps.make_decode_step(rarch, shard=shard))
    for i in range(worker.DECODE_STEPS):
        logits, cache = decode(rstate["params"], cache,
                               {"tokens": np_b["next"][:, i:i + 1], "pos": S + i})
        out[f"decode{i}/logits"] = logits
    out.update({f"decode/cache/{k}": v for k, v in cache.items()})
    return out


@pytest.mark.parametrize("name", ["qwen3-0.6b", "qwen2-moe-a2.7b", "xlstm-125m"])
def test_one_rank_against_reference(name):
    rarch = rconfigs.get(name).smoke()
    arch = configs.ArchConfig(**dataclasses.asdict(rarch))
    state, batch = worker.make_state(arch), worker.make_batch(arch, B, S, SEED)
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state["params"])
    rstate = {"params": rparams, "opt": rsteps.make_optimizer(rarch).init(rparams),
              "rng": jax.random.PRNGKey(0)}
    plain = worker.run_steps(arch, state, batch)
    with mesh_mod.local_group("cpu"):
        got = worker.run_steps(arch, state, batch, mesh_mod.make_test_mesh())
    # one rank: every split is the whole block, so bit for bit; but the
    # sLSTM's decode output reaches its last product as a transposed view
    # unsharded (matmul's batched path) and as a contiguous block sharded
    # (the folded product): those logits within 1e-6
    relaxed = {f"decode{i}/logits" for i in range(worker.DECODE_STEPS)} \
        if arch.family == "ssm" else set()
    _assert_all_equal({k: v for k, v in got.items() if k not in relaxed},
                      {k: v for k, v in plain.items() if k not in relaxed})
    for k in relaxed:
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(), rtol=1e-6, atol=1e-6)
    want = _reference(rarch, rstate, batch)
    for k, w in want.items():
        if k == "train/state/rng":
            continue  # the reference's PRNG key; the port's seed
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=REF_TOL, atol=REF_TOL,
                                   err_msg=k)
    assert {k for k in got if k != "train/state/rng"} == {k for k in want if k != "train/state/rng"}


def _reference_denoisers(rarch, params, inputs) -> dict:
    """The reference's float and W8A8 ``make_denoise_step`` jitted on a
    (1, 1) Auto-axes mesh, as its dry run lays the cell out: params by
    ``spec_for`` of ``param_axes`` (the W8A8 weights replicated), the batch
    over 'data'; keyed as ``worker.run_diffusion`` keys the outputs."""
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.models import dit_int8 as rq

    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rules = rsh.make_rules(rarch)
    batch = {"latents": jnp.asarray(inputs["latents"].numpy()),
             "t": jnp.asarray(inputs["t"].numpy()),
             "labels": jnp.asarray(inputs["labels"].numpy().astype(np.int32))}
    b_sh = {k: NamedSharding(mesh, PartitionSpec("data")) for k in batch}
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    out = {}
    for int8, key in ((False, "denoise/out"), (True, "q8/out")):
        axes, shapes = rsteps.param_axes(rarch, int8=int8)
        p_sh = jax.tree.map(
            lambda ax, sds: NamedSharding(mesh, rsh.spec_for(ax, sds.shape, rules, mesh)),
            axes, shapes, is_leaf=lambda x: isinstance(x, tuple)
            and all(isinstance(e, (str, type(None))) for e in x))
        p = rq.quantize_params(rparams, rsteps.make_dit_model(rarch)) if int8 else rparams
        out[key] = jax.jit(rsteps.make_denoise_step(rarch, int8=int8),
                           in_shardings=(p_sh, b_sh))(p, batch)
    return out


def test_diffusion_one_rank_against_reference():
    """dit-xl2's float and W8A8 denoisers on the one-rank (1, 1) gloo mesh:
    bit for bit against the unsharded steps, the W8A8 products' operands and
    results included, and within 1e-3 of the output's scale of the
    reference's on its (1, 1) mesh (the train step: on the gloo ranks)."""
    rarch = rconfigs.get(worker.DIT).smoke()
    arch = configs.ArchConfig(**dataclasses.asdict(rarch))
    state, inputs = worker.make_dit_state(arch), worker.make_dit_inputs(arch, B, SEED)
    plain, _ = worker.run_diffusion(arch, state, inputs, train=False)
    with mesh_mod.local_group("cpu"):
        got, placements = worker.run_diffusion(arch, state, inputs, mesh_mod.make_test_mesh(),
                                               train=False)
    _assert_all_equal(got, plain)
    assert placements["q8/out"][0] == placements["denoise/out"][0] == Shard(0)
    n_products = 7 * arch.n_layers + 5
    assert {k for k in got if k.startswith("q8/")} == {"q8/out"} | {
        f"q8/{i}/{t}" for i in range(n_products) for t in ("xq", "y")}
    for k, w in _reference_denoisers(rarch, state["params"], inputs).items():
        w = np.asarray(w)
        assert got[k].shape == w.shape
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                   err_msg=k)


# --------------------------------------------------------- (c) gloo ranks
CASES = [("qwen3-0.6b", {}), ("qwen2-moe-a2.7b", {}),
         ("qwen3-0.6b", {"fsdp": True, "grad_accum": 2})]
# one kv head, which 'model' cannot split: the decode cache splits over its
# slots instead, and the decode's softmax runs over the ranks
SLOT_SPLIT = ("qwen3-0.6b", {"n_kv_heads": 1})
# (2, 1) splits the rows alone: outputs whose every product keeps its whole
# contraction and row count >= 2 on each rank, and that sum nothing over the
# batch, come out bit for bit (the tied head of qwen3 is a transposed
# product, which the CPU BLAS sums in another order for two rows than four)
EXACT = {("qwen3-0.6b", False): ("prefill/cache/", "decode/cache/"),
         ("qwen2-moe-a2.7b", False): ("prefill/",),
         ("qwen3-0.6b", True): ("prefill/cache/", "decode/cache/")}
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
EXTRA = {(1, 2): [SLOT_SPLIT]}
DIFFUSION = (worker.DIT, {})


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_sharded_steps(world, tmp_path):
    import torch.multiprocessing as mp

    cases = [(name, repl, shape) for shape in MESHES[world]
             for name, repl in CASES + EXTRA.get(shape, []) + [DIFFUSION]]
    job = dict(cases=cases, batch=B, seq=S, seed=SEED)
    ctx = mp.start_processes(worker.run, args=(world, str(tmp_path / "store"), str(tmp_path), job),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("gloo ranks did not finish in 120 s")
    got = torch.load(tmp_path / "out.pt")
    assert len(got) == len(cases)
    arch = worker.make_arch(worker.DIT)
    want, _ = worker.run_diffusion(arch, worker.make_dit_state(arch),
                                   worker.make_dit_inputs(arch, B, SEED))
    for shape in MESHES[world]:
        res, placements = got[worker.DIT, shape]
        assert res.keys() == want.keys()
        for k in want:
            if k.startswith("q8/") and k != "q8/out":  # int8 operands, int32 products
                assert res[k].dtype == want[k].dtype and torch.equal(res[k], want[k]), (shape, k)
            else:
                np.testing.assert_allclose(res[k].numpy(), want[k].numpy(), rtol=RANK_TOL,
                                           atol=RANK_TOL, err_msg=f"{worker.DIT} {shape} {k}")
        if shape[0] > 1:  # the batch split over 'data' kept
            for k in ("denoise/out", "q8/out"):
                assert placements[k][0] == Shard(0), (shape, k, placements[k])
    for name, repl, shape in cases:
        if (name, repl) == DIFFUSION:
            continue
        arch = worker.make_arch(name, **repl)
        want = worker.run_steps(arch, worker.make_state(arch), worker.make_batch(arch, B, S, SEED))
        res = got[name, tuple(sorted(repl.items())), shape]
        assert res.keys() == want.keys()
        exact = EXACT.get((name, bool(repl)), ()) if shape == (2, 1) else ()
        for k in want:
            if k.startswith(exact):
                assert torch.equal(res[k], want[k]), (name, repl, shape, k)
            else:
                np.testing.assert_allclose(res[k].numpy(), want[k].numpy(), rtol=RANK_TOL,
                                           atol=RANK_TOL, err_msg=f"{name} {repl} {shape} {k}")


# ------------------------------------------------------------ (d) fake backend
def test_fake_mesh_train_step_reduces_grads_over_data():
    """A smoke sharded train step on the (16, 16) fake mesh at a batch the
    'data' axis splits: the counted collectives include the gradients'
    reduction over rank 0's 'data' group (ranks 0, 16, ..., 240), and the
    record is the per-device program's; a decode on the (2, 16, 16) mesh,
    its batch over ('pod', 'data')."""
    arch = configs.get("qwen3-0.6b").smoke()
    shape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=64)
    rules = sharding.make_rules(arch)
    with mesh_mod.fake_mesh(mesh_mod.make_production_mesh()) as mesh:
        res = dryrun.count_sharded(arch, shape, mesh, rules, batch=32)
    data_group = list(range(0, 256, 16))
    reduced = [r for r in res["collectives"]
               if r["op"] in ("all-reduce", "reduce-scatter") and r["ranks"] == data_group]
    assert reduced and sum(r["result_bytes"] for r in reduced) > 0
    assert not torch.distributed.is_initialized()
    rec = dryrun.run_cell(arch, "train_4k", mesh="16x16", batch=32, seq=64)
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["collectives"]["by_op"] and rec["cost"]["flops_per_device"] > 0
    rec = dryrun.run_cell(arch, "decode_32k", mesh="2x16x16", batch=64, seq=64)
    assert rec["status"] == "ok" and rec["n_chips"] == 512 and rec["collectives"]["by_op"]
    assert rec["layout"]["batch_shards"] == 32


def test_fake_mesh_refuses_a_running_group():
    with mesh_mod.local_group("cpu"):
        with pytest.raises(RuntimeError, match="starts only alone"):
            with mesh_mod.fake_mesh(mesh_mod.make_production_mesh()):
                pass
    assert not torch.distributed.is_initialized()


def test_train_driver_on_one_rank_mesh(tmp_path):
    """``TrainDriver(mesh=, shard=)`` lays its state and batches out on the
    (1, 1) gloo mesh: the losses and the final state of three steps equal
    the unsharded driver's bit for bit, and its checkpoint holds the whole
    values."""
    from repro_torch.launch.train import TrainDriver

    arch = configs.get("qwen3-0.6b").smoke()
    kw = dict(batch=B, seq=S, total_steps=3, ckpt_every=0, device="cpu")
    plain = TrainDriver(arch, workdir=str(tmp_path / "plain"), **kw)
    want, _ = plain.run()
    with mesh_mod.local_group("cpu"):
        mesh = mesh_mod.make_test_mesh()
        drv = TrainDriver(arch, workdir=str(tmp_path / "sharded"), mesh=mesh,
                          shard=sharding.make_shard_fn(sharding.make_rules(arch), mesh), **kw)
        got, step = drv.run()
        whole = [worker.whole(t) for t in tree.leaves(got)]
    assert step == 3
    assert [m["loss"] for m in drv.metrics_log] == [m["loss"] for m in plain.metrics_log]
    assert all(torch.equal(g, w) for g, w in zip(whole, tree.leaves(want)))
    restored = drv.ckpt.restore(3, want)
    assert all(torch.equal(r, w) for r, w in zip(tree.leaves(restored), tree.leaves(want)))


def test_worker_imports_neither_jax_nor_reference():
    import ast
    import pathlib

    src = pathlib.Path(worker.__file__).read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro", "flax"), name


@pytest.mark.parametrize("mesh,rank_batch", [("16x16", 2), ("2x16x16", 1)])
def test_w8a8_denoiser_sharded_on_production_meshes(mesh, rank_batch):
    """The W8A8 denoiser's cell at B = 32 on a production mesh is counted for
    one rank: ``ok`` with a positive cost, one rank's ``int8_matmul`` calls,
    FLOPs and bytes those of the one-card step at the rank's 32 / 16 or
    32 / 32 rows, its int8 FLOPs at the int8 peak; the collectives are
    the per-tensor scales' max, 4 bytes a product and batch axis (the
    batch is never gathered)."""
    arch = configs.get(worker.DIT).smoke()
    rec = dryrun.run_cell(arch, "prefill_32k", mesh=mesh, variant="int8", batch=32)
    assert rec["status"] == "ok" and rec["variant"] == "int8"
    assert rec["cost"]["flops_per_device"] > 0 and rec["roofline"]["compute_s"] > 0
    one = dryrun.count_step(arch, configs.SHAPES["prefill_32k"], variant="int8",
                            batch=rank_batch)
    assert rec["cost"]["kernels"] == one["kernels"]
    assert rec["cost"]["kernels"]["int8_matmul"]["calls"] == 7 * arch.n_layers + 5
    assert rec["cost"]["flops_by_dtype"]["int8"] == one["kernels"]["int8_matmul"]["flops"]
    assert rec["layout"]["batch_shards"] == 32 // rank_batch
    coll = rec["collectives"]["summary"]
    n_axes = len(sharding.batch_axes(mesh_mod.make_production_mesh(
        multi_pod=mesh == "2x16x16"), sharding.make_rules(arch, multi_pod=mesh == "2x16x16")))
    assert set(coll["by_op"]) == {"all-reduce"}
    assert coll["count"] == n_axes * (7 * arch.n_layers + 5)
    assert coll["total_result_bytes"] == 4 * coll["count"]


# ----------------------------------------------------- (e) kernel wrappers
WRAPPERS = {
    "int8_matmul": lambda x: int8_matmul.int8_matmul(x, x),
    "diff_encode": lambda x: diff_encode.diff_encode(x, x),
    "ditto_diff_matmul": lambda x: ditto_diff_matmul.ditto_diff_matmul(
        x, x, x, None, torch.zeros((1, 1), dtype=torch.int32)),
    "diff_encode_fused": lambda x: fused_step.diff_encode_fused(x, x),
    "ditto_fused_matmul": lambda x: fused_step.ditto_fused_matmul(
        x, x[:, :64], x, torch.zeros((1, 1), dtype=torch.int32)),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_kernel_wrapper_refuses_a_dtensor(name):
    """A DTensor reaches no kernel and no plain version: the wrapper raises
    ``TypeError`` and names ``sharding.row_local``."""
    x = torch.ones((128, 128), dtype=torch.int8)
    with mesh_mod.local_group("cpu"):
        dx = sharding.layout(x, sharding.replicated(mesh_mod.make_test_mesh()))
        with pytest.raises(TypeError, match="row_local"):
            WRAPPERS[name](dx)
    WRAPPERS[name](x)  # a plain tensor takes the plain version
