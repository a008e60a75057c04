"""The sharded LM and diffusion steps against the unsharded ones: the
inputs, the runs, and the rank body of the multi-rank gloo test in
tests/test_torch_shard.py.

Imports only ``torch`` and the port (not JAX): the rank body runs in fresh
interpreters started by ``torch.multiprocessing``. :func:`run_steps` runs
one train step (with its update), a prefill and two decode steps on a
state and a batch, unsharded (``mesh=None``) or laid out on a
``DeviceMesh`` with ``shard=make_shard_fn(rules, mesh)``, and returns
every output as plain tensors (a DTensor gathered whole), so that the two
runs compare leaf for leaf. :func:`run_diffusion` does the same for the
float denoiser, the W8A8 denoiser (with each product's int8 operand and
int32 result) and the DiT train step.
"""
import contextlib
import copy
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch import tree as tr
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, steps
from repro_torch.models import LM, dit_int8

DECODE_STEPS = 2


def make_arch(name: str, **repl) -> configs.ArchConfig:
    return dataclasses.replace(configs.get(name).smoke(), **repl)


def make_batch(arch, batch: int, seq: int, seed: int) -> dict:
    """numpy-seeded int64 tokens / labels (B, S) and the decode tokens (B,
    DECODE_STEPS) ('next'); an audio arch's float32 frame embeddings
    N(0, 0.02^2) ('embeds' (B, S, D), 'next_embeds' (B, DECODE_STEPS, D)),
    a vision arch's prefix ('frontend_embeds' (B, n_frontend_tokens, D))."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab_size, (batch, seq + 1 + DECODE_STEPS))
    out = {"tokens": toks[:, :seq], "labels": toks[:, 1:seq + 1], "next": toks[:, seq + 1:]}
    if arch.frontend == "audio":
        emb = rng.standard_normal((batch, seq + DECODE_STEPS, arch.d_model)) * 0.02
        out["embeds"], out["next_embeds"] = emb[:, :seq], emb[:, seq:]
    elif arch.frontend == "vision":
        out["frontend_embeds"] = rng.standard_normal(
            (batch, arch.n_frontend_tokens, arch.d_model)) * 0.02
    return {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v)
            for k, v in out.items()}


def make_state(arch, params=None) -> dict:
    """The train state on the CPU: ``params`` (a plain tree) or the port's
    init from seed 0."""
    opt = steps.make_optimizer(arch)
    if params is None:
        return steps.init_state(arch, 0, opt, device="cpu")
    return {"params": params, "opt": opt.init(params), "rng": torch.tensor(0)}


def whole(t):
    """A copy of ``t``'s whole value (a later step may write ``t`` in place)."""
    return (t.full_tensor() if isinstance(t, DTensor) else t).clone()


def _lay(tree, lays):
    return tr.unflatten_like(tree, [sh.layout(a, lay)
                                    for a, lay in zip(tr.leaves(tree), tr.leaves(lays))])


def _grow(cache: dict, model: LM, batch: int, length: int) -> dict:
    """A stack's k / v cache ``length`` slots long holding ``cache``'s
    slots first, in the layout ``model`` allocates a cache of that length
    in (padded whole, then laid out: a slice of a dim split over ranks is
    not a view to copy into); a recurrent cache as it is."""
    if "k" not in cache:
        return cache
    grown = model.init_cache(batch, length, device="cpu")
    for k in ("k", "v"):
        pad = F.pad(whole(cache[k]), (0, 0, 0, 0, 0, length - cache[k].shape[2]))
        if isinstance(grown[k], DTensor):
            pad = sh.layout(pad, sh.Layout(grown[k].device_mesh, grown[k].placements))
        grown[k] = pad
    return grown


def run_steps(arch, state: dict, batch: dict, mesh=None, *, shard=None) -> dict:
    """{'train/...', 'prefill/...', 'decode<i>/...': plain tensors} of a train
    step, a prefill over the batch's prompt and DECODE_STEPS decode steps of
    its 'next' tokens (frames) after it, the serving steps on the params
    before the update. With ``mesh``: state, batch and cache laid out by
    the dry run's layouts and the steps built with ``make_shard_fn(rules,
    mesh)``; else the steps built with ``shard`` on plain tensors. ``state``
    is not modified."""
    b, s = batch["tokens"].shape
    opt = steps.make_optimizer(arch)
    work, params = copy.deepcopy(state), state["params"]
    shards = 1
    train_batch = {k: v for k, v in batch.items() if not k.startswith("next")}
    if mesh is not None:
        rules = sh.make_rules(arch)
        shard = sh.make_shard_fn(rules, mesh)
        shards = dryrun._batch_shards(mesh, rules)
        lays = dryrun.state_shardings(arch, mesh, rules, opt)
        work = _lay(work, lays)
        params = _lay(params, lays["params"])
        nf = arch.n_frontend_tokens if arch.frontend == "vision" else 0
        b_lays, _ = dryrun.batch_shardings(arch, configs.ShapeCell("t", "train", s + nf, b),
                                           mesh, rules)
        train_batch = {k: sh.layout(v, b_lays[k]) for k, v in train_batch.items()}
    out = {}
    new_state, metrics = steps.make_train_step(arch, opt, shard=shard,
                                               batch_shards=shards)(work, train_batch)
    out.update({f"train/{k}": whole(v) for k, v in metrics.items()})
    out.update({f"train/state/{tr.key_of(p)}": whole(v) for p, v in tr.paths(new_state)})

    logits, cache = steps.make_prefill_step(arch, shard=shard)(params, train_batch)
    out["prefill/logits"] = whole(logits)
    out.update({f"prefill/cache/{k}": whole(v) for k, v in cache.items()})
    length = s + (arch.n_frontend_tokens if arch.frontend == "vision" else 0)
    cache = _grow(cache, LM(arch, shard=shard), b, length + DECODE_STEPS)
    decode = steps.make_decode_step(arch, shard=shard)
    for i in range(DECODE_STEPS):
        step = {"tokens": batch["next"][:, i:i + 1], "pos": length + i}
        if arch.frontend == "audio":
            step["embeds"] = batch["next_embeds"][:, i:i + 1]
        if mesh is not None:
            step = {k: shard(v, ("batch",) + (None,) * (v.dim() - 1)) if torch.is_tensor(v)
                    else v for k, v in step.items()}
        logits, cache = decode(params, cache, step)
        out[f"decode{i}/logits"] = whole(logits)
    out.update({f"decode/cache/{k}": whole(v) for k, v in cache.items()})
    return out


DIT = "dit-xl2"


def make_dit_inputs(arch, batch: int, seed: int) -> dict:
    """numpy-seeded inputs of the diffusion steps: the denoisers' latents
    (B, H, W, C), timesteps t (B,) float32 and labels (B,); the train step's
    x0 and, laid out as x0, its timesteps 'train_t' (B,) int64 and noise
    'eps' (B, H, W, C)."""
    rng = np.random.default_rng(seed)
    hw, ch = arch.input_size, arch.in_channels
    img = (batch, hw, hw, ch)
    out = {"latents": rng.standard_normal(img).astype(np.float32),
           "t": rng.integers(0, 1000, (batch,)).astype(np.float32),
           "labels": rng.integers(0, arch.n_classes, (batch,)),
           "x0": rng.standard_normal(img).astype(np.float32),
           "train_t": rng.integers(0, 1000, (batch,)),
           "eps": rng.standard_normal(img).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in out.items()}


def make_dit_state(arch, seed: int = 0) -> dict:
    """The DiT train state on the CPU from the port's init at ``seed``, its
    blocks' ``mod`` weights refilled N(0, 0.02^2) from a numpy seed (the
    adaLN-Zero init gates every block off, which would leave the blocks out
    of the denoisers' outputs)."""
    state = make_state(arch)
    w = state["params"]["blocks"]["mod"]["w"]
    w.copy_(torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        tuple(w.shape)).astype(np.float32) * 0.02))
    return state


@contextlib.contextmanager
def int8_products(out: dict):
    """Record each ``dit_int8.int8_product``'s int8 operand and int32 result,
    whole, into ``out`` ('q8/<i>/xq', 'q8/<i>/y'), in call order."""
    product = dit_int8.int8_product

    def recorded(xq, wq):
        y = product(xq, wq)
        i = len(out) // 2
        out[f"q8/{i}/xq"], out[f"q8/{i}/y"] = whole(xq), whole(y)
        return y

    dit_int8.int8_product = recorded
    try:
        yield
    finally:
        dit_int8.int8_product = product


def run_diffusion(arch, state: dict, inputs: dict, mesh=None, *,
                  train: bool = True) -> tuple[dict, dict]:
    """({'denoise/out', 'q8/out', 'q8/<i>/xq', 'q8/<i>/y', 'train/...':
    plain tensors}, {output: its placements}) of the float denoiser, the
    W8A8 denoiser on ``quantize_params`` of the same params, and (``train``)
    a DiT train step (with its update) through ``with_noise`` at the
    inputs' t and eps.
    With ``mesh``: the params and the train state laid out by the dry run's
    layouts (the W8A8 weights by ``param_axes(int8=True)``'s, whole), the
    inputs by its batch layouts, the steps run under
    ``sharding.replicating``; the placements are then the outputs'."""
    opt = steps.make_optimizer(arch)
    params, work = state["params"], copy.deepcopy(state)
    qparams = dit_int8.quantize_params(params, steps.make_dit_model(arch))
    serve = {k: inputs[k] for k in ("latents", "t", "labels")}
    train_batch = {"x0": inputs["x0"], "labels": inputs["labels"]}
    noise = (inputs["train_t"], inputs["eps"])
    shard = None
    if mesh is not None:
        rules = sh.make_rules(arch)
        shard = sh.make_shard_fn(rules, mesh)
        lays = dryrun.state_shardings(arch, mesh, rules, opt)
        work = _lay(work, lays)
        params = _lay(params, lays["params"])
        q_axes, q_shapes = steps.param_axes(arch, int8=True)
        qparams = _lay(qparams, sh.param_shardings(q_axes, q_shapes, rules, mesh))
        b = serve["latents"].shape[0]
        serve_lays, _ = dryrun.batch_shardings(arch, configs.SHAPES["prefill_32k"], mesh, rules,
                                               batch=b)
        serve = {k: sh.layout(v, serve_lays[k]) for k, v in serve.items()}
        train_lays, _ = dryrun.batch_shardings(arch, configs.SHAPES["train_4k"], mesh, rules,
                                               batch=b)
        train_batch = {k: sh.layout(v, train_lays[k]) for k, v in train_batch.items()}
        noise = tuple(sh.layout(v, sh.Layout(mesh, train_lays["x0"].placements))
                      for v in noise)
    out, placements = {}, {}
    with sh.replicating(shard):
        y = steps.make_denoise_step(arch)(params, serve)
        out["denoise/out"] = whole(y)
        with int8_products(out):
            y8 = steps.make_denoise_step(arch, int8=True)(qparams, serve)
        out["q8/out"] = whole(y8)
        if train:
            step = steps.make_train_step(arch, opt)
            new_state, metrics = step.with_noise(work, train_batch, *noise)
            out.update({f"train/{k}": whole(v) for k, v in metrics.items()})
            out.update({f"train/state/{tr.key_of(p)}": whole(v) for p, v in tr.paths(new_state)})
    if mesh is not None:
        placements = {"denoise/out": tuple(y.placements), "q8/out": tuple(y8.placements)}
    return out, placements


def run(rank: int, world: int, store_path: str, out_dir: str, job: dict) -> None:
    """One gloo rank: each case of ``job['cases']`` ((name, config changes,
    mesh shape)) run sharded on a ('data', 'model') mesh of that shape over
    the ``world`` ranks (:func:`run_diffusion` for a diffusion config, keyed
    (name, mesh shape)); rank 0 saves the outputs to ``out_dir/out.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        got = {}
        for name, repl, shape in job["cases"]:
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                              mesh_dim_names=("data", "model"))
            arch = make_arch(name, **repl)
            if arch.family == "diffusion":
                got[name, shape] = run_diffusion(
                    arch, make_dit_state(arch), make_dit_inputs(arch, job["batch"], job["seed"]),
                    mesh)
                continue
            got[name, tuple(sorted(repl.items())), shape] = run_steps(
                arch, make_state(arch), make_batch(arch, job["batch"], job["seq"], job["seed"]),
                mesh)
        if rank == 0:
            torch.save(got, os.path.join(out_dir, "out.pt"))
    finally:
        dist.destroy_process_group()
