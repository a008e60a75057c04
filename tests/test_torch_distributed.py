"""The port's ``distributed/`` against the reference's, on the CPU: the
sharding rules and ``param_axes`` of every config at full width on both
production meshes, ``spec_for`` on hand-made shapes, the int8
error-feedback all-reduce bit for bit (one rank, and two and four gloo
ranks in their own processes, with the layouts each rank holds), the GPipe
pipeline against the reference's ``lax.scan`` stack and bit for bit against
the port's own sequential stack, the elastic restore, and the two example
entry points.

The reference's meshes here are ``AbstractMesh(axis_sizes, axis_names)``:
its own ``AbstractMesh(((axis, n),))`` form (``distributed/sharding.py:42``)
is refused by this JAX.
"""
import ast
import dataclasses
import importlib.util
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as RAbstractMesh  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.distributed import collectives as rcoll  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.distributed import collectives, pipeline, sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import LM, dit_int8  # noqa: E402
from repro_torch.nn import core, dit  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _ref_flat(t, is_leaf=None):
    """'/'-joined key -> leaf of a reference tree, as the port's checkpoint
    keys name them."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)[0]}


def _port_flat(t):
    return {tree.key_of(p): leaf for p, leaf in tree.paths(t)}


# ------------------------------------------------------------------- rules
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("name", rconfigs.names())
def test_make_rules_every_config(name, multi_pod):
    assert sharding.make_rules(configs.get(name), multi_pod=multi_pod) == rsh.make_rules(
        rconfigs.get(name), multi_pod=multi_pod)


@pytest.mark.parametrize("name,int8", [(n, False) for n in rconfigs.names()]
                         + [("dit-xl2", True)])
def test_param_axes_and_specs_match_reference(name, int8):
    """Leaf for leaf at full width: the logical axes, the shapes and dtypes
    (the port's meta tensors against the reference's eval_shape), and each
    leaf's spec on both production meshes."""
    r_axes, r_shapes = rsteps.param_axes(rconfigs.get(name), int8=int8)
    axes, shapes = steps.param_axes(configs.get(name), int8=int8)
    ra, rs = _ref_flat(r_axes, _is_axes), _ref_flat(r_shapes)
    pa, ps = _port_flat(axes), _port_flat(shapes)
    assert list(ra) == list(pa) == list(rs) == list(ps)
    assert all(s.device.type == "meta" for s in ps.values())
    for k in ra:
        assert tuple(ra[k]) == pa[k], k
        assert tuple(rs[k].shape) == tuple(ps[k].shape), k
        assert str(rs[k].dtype) == str(ps[k].dtype).removeprefix("torch."), k
    for multi_pod, (sizes, names) in MESHES.items():
        rmesh, mesh = RAbstractMesh(sizes, names), mesh_mod.make_production_mesh(
            multi_pod=multi_pod)
        assert mesh.shape == dict(zip(names, sizes))
        rules = sharding.make_rules(configs.get(name), multi_pod=multi_pod)
        for k in ra:
            want = tuple(rsh.spec_for(ra[k], rs[k].shape, rules, rmesh))
            assert sharding.spec_for(pa[k], tuple(ps[k].shape), rules, mesh) == want, k


def test_tags_change_nothing_untagged():
    """With tags off the initializers return the tensors they returned
    before (plain, the same draws); under ``tagged`` the same values come as
    Params."""
    arch = configs.get("zamba2-7b").smoke()
    plain = LM(arch).init(torch.Generator().manual_seed(0), device="cpu")
    with core.tagged():
        tagged = LM(arch).init(torch.Generator().manual_seed(0), device="cpu")
    values, axes = core.split(tagged)
    assert all(isinstance(a, torch.Tensor) for a in tree.leaves(plain))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(plain), tree.leaves(values)))
    assert all(len(a) == v.dim() for a, v in zip(tree.leaves(axes), tree.leaves(values)))


SPEC_CASES = [
    # (axes, shape, fsdp, multi_pod): divisibility, duplicates, the left pad
    (("embed", "mlp"), (64, 48), True, False),
    (("embed", "mlp"), (64, 48), False, False),
    (("vocab", "embed"), (122753, 64), True, False),  # vocab indivisible: replicated
    (("expert", "embed", "mlp"), (64, 32, 48), True, False),  # 'model' once: EP wins
    (("expert", "mlp", "embed"), (60, 48, 64), True, False),  # 60 experts: mlp takes 'model'
    (("heads", "kv"), (32, 32), False, False),  # kv loses 'model' to heads
    (("embed", "mlp"), (4, 64, 48), True, False),  # short tag: left-padded
    (("mlp",), (2, 3, 64), False, True),
    (("batch", None, "embed"), (64, 8, 32), True, True),  # ('pod', 'data') on one dim
    (("batch", None, "embed"), (48, 8, 32), True, True),  # 48 % 32: replicated, then embed
    (("batch", None), (32, 8), False, False),
    (("layer", "super", "seq", "embed2", "moe_ff"), (2, 2, 8, 8, 32), False, False),
    (("unknown", None), (16, 16), False, False),
]


@pytest.mark.parametrize("axes,shape,fsdp,multi_pod", SPEC_CASES)
def test_spec_for_hand_made(axes, shape, fsdp, multi_pod):
    arch = dataclasses.replace(configs.get("qwen3-0.6b"), fsdp=fsdp)
    rules = sharding.make_rules(arch, multi_pod=multi_pod)
    sizes, names = MESHES[multi_pod]
    want = tuple(rsh.spec_for(axes, shape, rules, RAbstractMesh(sizes, names)))
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    spec = sharding.spec_for(axes, shape, rules, mesh)
    assert spec == want
    # placements: Shard(d) on each mesh dim the spec names at dim d
    where = {a: d for d, e in enumerate(spec) if e
             for a in ((e,) if isinstance(e, str) else e)}
    assert sharding.placements(spec, mesh) == tuple(
        Shard(where[n]) if n in where else Replicate() for n in names)


def test_placements_refuse_out_of_mesh_order():
    mesh = mesh_mod.make_production_mesh(multi_pod=True)
    assert sharding.placements((("pod", "data"), None), mesh) == (Shard(0), Shard(0),
                                                                  Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements((("data", "pod"), None), mesh)


# ------------------------------------------------------------- collectives
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_compressed_leaf_bit_for_bit(dtype):
    """``quantize_int8`` and five rounds of ``_compressed_psum_leaf`` over a
    one-rank group against the reference's ``axis_names=()``: q, scale,
    the mean (in the gradient's dtype) and the residual, bit for bit."""
    rng = np.random.default_rng(3)
    gs = (rng.standard_normal((5, 37, 29)) * np.array([0.3, 1e-3, 7.0, 0.0, 2.0])[:, None, None]
          ).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    r_resid = jnp.zeros(gs.shape[1:], jnp.float32)
    resid = torch.zeros(gs.shape[1:])
    with mesh_mod.local_group("cpu"):
        for g_np in gs:
            g = torch.from_numpy(g_np).to(tdt)
            rg = jnp.asarray(g_np).astype(jdt)
            q, s = collectives.quantize_int8(g)
            rq, rs = rcoll.quantize_int8(rg)
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
            assert s.item() == float(rs)
            out, resid = collectives._compressed_psum_leaf(g, resid)
            r_out, r_resid = rcoll._compressed_psum_leaf(rg, r_resid, axis_names=())
            assert out.dtype == tdt
            np.testing.assert_array_equal(out.to(torch.float32).numpy(),
                                          np.asarray(r_out.astype(jnp.float32)))
            np.testing.assert_array_equal(resid.numpy(), np.asarray(r_resid))


def test_int8_quant_roundtrip():
    x = torch.randn((128,), generator=torch.Generator().manual_seed(0)) * 5
    q, s = collectives.quantize_int8(x)
    err = (collectives.dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_compressed_psum_error_feedback_converges():
    """With error feedback, accumulated compressed updates converge to the
    exact sum over steps (one participant: the all-reduce is the identity);
    the tree form keeps the tree."""
    n_steps = 60
    gs = torch.randn((n_steps, 64), generator=torch.Generator().manual_seed(0)) * 0.3
    resid = collectives.zeros_residuals({"w": [gs[0]]})
    acc = torch.zeros(64)
    allreduce = collectives.make_compressed_allreduce()
    with mesh_mod.local_group("cpu"):
        for i in range(n_steps):
            out, resid = allreduce({"w": [gs[i]]}, resid)
            acc = acc + out["w"][0]
    np.testing.assert_allclose((acc + resid["w"][0]).numpy(), gs.sum(0).numpy(), rtol=1e-4,
                               atol=1e-4)


def _block_of(spec, shape, coord, sizes):
    """The index block that the device at mesh coordinates ``coord`` holds
    of a reference ``NamedSharding`` with ``spec``: a dim split over axes
    (a1, ..., ak) is cut into prod(sizes) blocks, indexed by the
    coordinates in that order, the first the major."""
    index = []
    for dim, entry in zip(shape, spec):
        group = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n, at = 1, 0
        for a in group:
            at = at * sizes[a] + coord[a]
            n *= sizes[a]
        index.append(slice(at * dim // n, (at + 1) * dim // n))
    return tuple(index)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_allreduce_and_layouts(world, tmp_path):
    """``world`` gloo ranks in their own processes: each rank's compressed
    all-reduce mean against the reference's dequantized payloads, (d_0 +
    d_1) / 2 bit for bit on two ranks (four sum in gloo's order: within one
    float32 ulp-scale tolerance, every rank the same bits), its residual bit
    for bit; and the block of each leaf that each rank holds under
    ``make_shard_fn`` against the reference's spec at the same mesh
    coordinates: a (2, 1) ('data', 'model') mesh on two ranks, a (2, 2, 1)
    ('pod', 'data', 'model') mesh under ``multi_pod`` on four (the batch
    dim over ('pod', 'data'))."""
    import torch.multiprocessing as mp

    import _torch_dist_worker

    multi_pod = world == 4
    mesh_shape = (2, 2, 1) if multi_pod else (2, 1)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    arch = dataclasses.replace(configs.get("qwen3-0.6b").smoke(), fsdp=True)
    rules = sharding.make_rules(arch, multi_pod=multi_pod)
    rng = np.random.default_rng(world)
    grads = [torch.from_numpy((rng.standard_normal((33, 17)) * (r + 1)).astype(np.float32))
             for r in range(world)]
    axes, shapes = steps.param_axes(arch)
    leaves = {tree.key_of(p): (torch.from_numpy(rng.standard_normal(tuple(s.shape)).astype(
        np.float32)), a) for (p, s), a in zip(tree.paths(shapes), tree.leaves(axes))}
    leaves["acts"] = (torch.from_numpy(rng.standard_normal((8, 4, 6)).astype(np.float32)),
                      ("batch", None, None))
    job = dict(grads=grads, mesh_shape=mesh_shape, mesh_names=names, rules=rules,
               leaves=leaves)
    ctx = mp.start_processes(_torch_dist_worker.run,
                             args=(world, str(tmp_path / "store"), str(tmp_path), job),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("gloo ranks did not finish in 120 s")
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]

    deq = [np.asarray(rcoll.dequantize_int8(*rcoll.quantize_int8(jnp.asarray(g.numpy()))))
           for g in grads]
    want = sum(deq[1:], deq[0]) / np.float32(world)
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["resid"].numpy(), grads[r].numpy() - deq[r])
        assert torch.equal(res["mean"], got[0]["mean"])
        if world == 2:
            np.testing.assert_array_equal(res["mean"].numpy(), want)
        else:
            np.testing.assert_allclose(res["mean"].numpy(), want, rtol=1e-6, atol=1e-7)

    sizes = dict(zip(names, mesh_shape))
    rmesh = RAbstractMesh(mesh_shape, names)
    sharded = set()
    for res in got:
        coord = dict(zip(names, res["coord"]))
        for k, (v, a) in leaves.items():
            spec = tuple(rsh.spec_for(a, tuple(v.shape), rules, rmesh))
            assert torch.equal(res["local"][k], v[_block_of(spec, v.shape, coord, sizes)]), k
            if any(spec):
                sharded.add(k)
    assert "acts" in sharded and len(sharded) >= 4
    assert {res["coord"] for res in got} == set(np.ndindex(*mesh_shape))


# ---------------------------------------------------------------- pipeline
def _tanh_layer(w, x):
    return torch.tanh(x @ w)


@pytest.mark.parametrize("n_stages", [1, 4])
def test_pipeline_matches_sequential(n_stages):
    """``pipeline_apply`` over ``n_stages`` CPU stages: against the
    reference's ``lax.scan`` stack (tests/test_pipeline.py's tolerance) and
    bit for bit against the port's layers run in order on each microbatch."""
    rng = np.random.default_rng(0)
    n_layers, b, d, m = 8, 8, 16, 4
    ws = (rng.standard_normal((n_layers, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((b, d)).astype(np.float32)
    y = pipeline.pipeline_apply(_tanh_layer, torch.from_numpy(ws), torch.from_numpy(x),
                                stages=(torch.device("cpu"),) * n_stages, n_microbatches=m)

    def body(h, w):
        return jnp.tanh(h @ w), None

    want, _ = jax.lax.scan(body, jnp.asarray(x), jnp.asarray(ws))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    seq = []
    for h in torch.from_numpy(x).chunk(m):
        for w in torch.from_numpy(ws):
            h = _tanh_layer(w, h)
        seq.append(h)
    assert torch.equal(y, torch.cat(seq))


def test_pipeline_refuses_uneven_splits():
    ws, x = torch.zeros((6, 4, 4)), torch.zeros((8, 4))
    stages = (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_apply(_tanh_layer, ws[:4], x, stages=stages, n_microbatches=3)
    with pytest.raises(ValueError, match="stages"):
        pipeline.pipeline_apply(_tanh_layer, ws, x, stages=stages)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_w8a8_pipeline_bit_for_bit():
    """``chip_smoke.py``'s phase (d) at a tiny DiT: the W8A8 blocks through
    4 stages, the conditioning carried as one more token row, equal to the
    sequential stack on each microbatch bit for bit, and to ``apply``'s
    stack on a whole microbatch."""
    smoke = _chip_smoke()
    cfg = dit.DiTCfg(d_model=32, n_layers=8, n_heads=4, input_size=8, n_classes=10)
    params = dit.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    blocks = dit_int8.quantize_params(params, cfg)["blocks"]
    g = torch.Generator().manual_seed(1)
    x = torch.randn((8, cfg.n_tokens, cfg.d_model), generator=g)
    c_act = torch.nn.functional.silu(torch.randn((8, cfg.d_model), generator=g))
    got = pipeline.pipeline_apply(smoke.pipe_layer(cfg), blocks,
                                  torch.cat([x, c_act[:, None]], dim=1),
                                  stages=(torch.device("cpu"),) * 4, n_microbatches=4)
    want = smoke.pipe_sequential(blocks, x, c_act, cfg, 4)
    assert torch.equal(got[:, :-1], want) and torch.equal(got[:, -1], c_act)


# ---------------------------------------------------------------- restore
def test_restore_with_shardings_is_bit_identical(tmp_path):
    """A state saved plainly, restored with ``shardings=`` from
    ``param_shardings`` (fsdp rules: some leaves Shard) over a one-rank
    (1, 1) gloo mesh: every leaf a DTensor with its layout's placements,
    bit for bit (bfloat16 leaves included)."""
    arch = dataclasses.replace(configs.get("qwen3-0.6b").smoke(), fsdp=True,
                               param_dtype="bfloat16")
    state = steps.init_state(arch, 0, steps.make_optimizer(arch), device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    axes, _ = steps.param_axes(arch)
    with mesh_mod.local_group("cpu"):
        mesh = mesh_mod.make_test_mesh()
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        lays = {"params": sharding.param_shardings(axes, state["params"],
                                                   sharding.make_rules(arch), mesh),
                "opt": tree.map_tree(lambda _: sharding.replicated(mesh), state["opt"]),
                "rng": sharding.replicated(mesh)}
        got = mgr.restore(3, state, shardings=lays)
        pairs = list(zip(tree.leaves(state), tree.leaves(got), tree.leaves(lays)))
        assert any(Shard(0) in lay.placements or Shard(1) in lay.placements
                   for _, _, lay in pairs)
        for a, d, lay in pairs:
            assert isinstance(d, DTensor) and tuple(d.placements) == lay.placements
            assert d.dtype == a.dtype and torch.equal(d.to_local(), a)
        assert any(a.dtype == torch.bfloat16 for a, _, _ in pairs)


# ------------------------------------------------------------ entry points
def _load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_on_cpu(tmp_path, capsys):
    """``examples/elastic_rescale_torch.py --device cpu`` (restore onto the
    mesh bit for bit, 5 more steps equal to the unrestored run's) and
    ``examples/train_lm_torch.py``'s compressed-gradient phase."""
    losses = _load("examples/elastic_rescale_torch.py").main(
        ["--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[mesh B] restored onto a (1, 1) ('data', 'model') mesh (cpu): bit-identical" in out
    assert len(losses) == 5 and all(np.isfinite(losses))
    err = _load("examples/train_lm_torch.py").grad_compress("cpu")
    assert err < 1e-6
    assert "[grad-compress] int8 error-feedback accumulated error" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


def test_examples_import_neither_jax_nor_reference():
    for rel in ("examples/elastic_rescale_torch.py", "examples/train_lm_torch.py",
                "tests/_torch_dist_worker.py"):
        for node in ast.walk(ast.parse((ROOT / rel).read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro", "flax"), (rel, name)


def test_local_group_starts_and_stops():
    assert not torch.distributed.is_initialized()
    with mesh_mod.local_group("cpu"):
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_backend() == "gloo"
        with mesh_mod.local_group("cpu"):  # a group already up stays
            pass
        assert torch.distributed.is_initialized()
    assert not torch.distributed.is_initialized()
