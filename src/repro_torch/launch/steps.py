"""Train and serve step builders for the diffusion (DiT) family and the
LM stack.

Mirror of ``src/repro/launch/steps.py``: ``make_optimizer``,
``make_dit_model``, ``cross_entropy``, ``make_train_step`` (the diffusion
branch, :class:`DiffusionTrainStep`, and the LM's, :class:`LMTrainStep`),
``init_state``, ``make_denoise_step`` (float and W8A8), and the LM's
``make_prefill_step`` / ``make_decode_step`` (``models/lm.py``). PyTorch
runs eagerly, so a step is a plain function of (state, batch); autograd
gives the backward, and the optimizer updates the state's tensors in place.

Numerics kept from the reference: ``x0`` and ``eps`` are cast to the
config's activation dtype, and ``q_sample``'s float32 ``sqrt(abar)``
promotes ``x_t`` to float32, so the whole forward (the bfloat16 weights
cast up by ``nn/core.py:dense``) and the loss run in float32: DiT-XL/2's
"bfloat16" config stores bfloat16 and computes in float32. TF32 stays off
(PyTorch's default for matmuls).

The LM step keeps the reference's: the loss is the float32 cross-entropy
plus ``aux_weight`` times the MoE layers' aux loss; the batch splits into
``_effective_accum`` microbatches along dim 1 of a (B / a, a, ...)
reshape (microbatch i holds rows i, i + a, ...), whose gradients add up in
``arch.accum_dtype`` and are divided by their count.

``param_axes`` gives the logical-axes tree of a config's params and their
shapes without allocating them, for ``distributed/sharding.py``.

``shard=`` (the LM steps; the diffusion branch ignores it, as the
reference's does) is the reference's sharding constraint: a
``distributed/sharding.py:make_shard_fn`` over a ``DeviceMesh`` lays the
tensors at the reference's sites out on the mesh (the embedded tokens and
the MoE's groups on 'batch', the experts' buffer on 'expert', each
microbatch on 'batch', the gradient carry in the params' layouts). The
step then runs on DTensors: its inputs laid out by the caller
(``param_shardings``, ``cache_shardings_dict``, ...), DTensor's sharding
propagation partitions every op, and a tensor the step makes itself is
taken as replicated (``sharding.replicating``). A constraint moves data and
never changes a value: the sharded step returns what the unsharded one
does, up to the order of the sums that cross ranks.

The diffusion steps take no ``shard``, as the reference's take none; they
run on DTensors laid out by the caller (the params by ``param_shardings``,
the batch over the batch axes) under ``sharding.replicating``, as the
reference's jitted step runs on sharded arrays.
"""
from __future__ import annotations

from typing import Callable

import torch

from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from .. import tree as tr
from ..configs.base import ArchConfig, torch_dtype
from ..core import diffusion
from ..data.synthetic import generator
from ..distributed import sharding
from ..kernels.common import resolve_device
from ..models.lm import LM
from ..nn import core as nncore
from ..nn import dit as dit_mod
from ..optim import AdamW, make_schedule


def make_optimizer(arch: ArchConfig, *, base_lr: float = 3e-4, warmup: int = 100,
                   total: int = 10000) -> AdamW:
    return AdamW(
        lr=make_schedule(arch.lr_schedule, base_lr, warmup=warmup, total=total),
        moment_dtype=torch_dtype(arch.optimizer_dtype),
        factored=arch.factored_second_moment,
    )


def driver_warmup(total_steps: int) -> int:
    """The warmup steps of the optimizer the train driver builds for a run
    of ``total_steps`` steps."""
    return min(20, total_steps // 10 + 1)


def make_dit_model(arch: ArchConfig) -> dit_mod.DiTCfg:
    """The DiT of ``arch``: LayerNorm, GELU, MLP ratio 4 and full
    multi-head attention over ``d_model // n_heads`` per head, as the
    reference builds it whatever the config says; a config asking for
    another norm, activation or head layout is refused rather than
    ignored."""
    heads = (arch.n_kv_heads, arch.resolved_head_dim * arch.n_heads)
    if (arch.norm, arch.act, heads) != ("layernorm", "gelu", (arch.n_heads, arch.d_model)):
        raise ValueError(f"{arch.name}: the DiT builds layernorm / gelu / n_kv_heads = n_heads "
                         f"and head_dim = d_model // n_heads, not {arch.norm} / {arch.act} / "
                         f"{arch.n_kv_heads} kv heads of {arch.resolved_head_dim}")
    return dit_mod.DiTCfg(
        d_model=arch.d_model,
        n_layers=arch.n_layers,
        n_heads=arch.n_heads,
        patch=arch.patch,
        in_channels=arch.in_channels,
        input_size=arch.input_size,
        n_classes=arch.n_classes,
    )


def _ce_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The float32 CE of each (row, position)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return logz - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE in float32. logits (B, S, V), labels (B, S) integer.

    DTensor logits: the vocab is gathered whole and each rank takes the CE
    of its own rows under ``local_map`` (DTensor's gather of the gold logit
    splits the vocab into a masked partial sum, which it then reduces
    against a mask of the gather's shape, not the row's)."""
    if not isinstance(logits, DTensor):
        return torch.mean(_ce_rows(logits, labels))
    vocab, mesh = logits.dim() - 1, logits.device_mesh
    pl = [Replicate() if p.is_shard(vocab) or p.is_partial() else p for p in logits.placements]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    rows = local_map(_ce_rows, out_placements=pl, in_placements=(pl, pl), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)
    return torch.mean(rows)


class DiffusionTrainStep:
    """``(state, batch) -> (state, metrics)``; state = {params, opt, rng}.

    Split in two so that a test can feed its own noise: :meth:`noise` draws
    the timesteps and the noise of a step, :meth:`with_noise` does the loss,
    the backward and the update."""

    def __init__(self, arch: ArchConfig, opt: AdamW):
        self.arch, self.opt = arch, opt
        self.dcfg = make_dit_model(arch)
        self.adtype = torch_dtype(arch.activation_dtype)
        self.sched = diffusion.cosine_schedule(1000)
        self._sched_on: dict = {}

    def noise(self, state, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """(t int64 (B,), eps (B, H, W, C) in the activation dtype), drawn on
        the CPU from the generator of (rng seed, step) and moved to x0's
        device: a pure function of the state's seed and step, as the
        reference's ``fold_in(rng, step)`` (its bits differ). Reads the step
        from the state, one scalar a step."""
        x0 = batch["x0"]
        g = generator("noise", int(state["rng"]), int(state["opt"]["step"]))
        t = torch.randint(0, self.sched.T, (x0.shape[0],), generator=g)
        eps = torch.randn(tuple(x0.shape), generator=g).to(self.adtype)
        return t.to(x0.device), eps.to(x0.device)

    def loss_and_grads(self, params, batch, t, eps):
        """(loss, grads): the denoising MSE of ``params`` at (x0, t, eps) and
        its gradient tree (each leaf in its param's dtype)."""
        x0 = batch["x0"].to(self.adtype)
        x_t = diffusion.q_sample(self._schedule(x0.device), x0, t, eps.to(self.adtype))
        leaves = [p.detach().requires_grad_(True) for p in tr.leaves(params)]
        with torch.enable_grad():
            eps_hat = dit_mod.apply(tr.unflatten_like(params, leaves), self.dcfg, x_t, t,
                                    batch.get("labels"))
            loss = torch.mean(torch.square(eps_hat.to(torch.float32) - eps.to(torch.float32)))
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tr.unflatten_like(params, list(grads))

    def with_noise(self, state, batch, t, eps):
        loss, grads = self.loss_and_grads(state["params"], batch, t, eps)
        new_params, new_opt, stats = self.opt.update(grads, state["opt"], state["params"])
        return {"params": new_params, "opt": new_opt, "rng": state["rng"]}, {"loss": loss, **stats}

    def __call__(self, state, batch):
        return self.with_noise(state, batch, *self.noise(state, batch))

    def _schedule(self, device) -> diffusion.NoiseSchedule:
        if device not in self._sched_on:
            self._sched_on[device] = self.sched.to(device)
        return self._sched_on[device]


def _lm_inputs(arch: ArchConfig, batch: dict, *, prefix: bool) -> dict:
    """The keys of ``batch`` an LM serving step reads, as the reference's
    steps pick them: ``embeds`` for an audio arch, else ``tokens``; a
    vision arch's ``frontend_embeds`` where ``prefix`` and present. Every
    other key (``labels``, ...) is ignored."""
    kwargs = {}
    if arch.frontend == "audio":
        kwargs["embeds"] = batch["embeds"]
    else:
        kwargs["tokens"] = batch["tokens"]
    if prefix and arch.frontend == "vision" and "frontend_embeds" in batch:
        kwargs["frontend_embeds"] = batch["frontend_embeds"]
    return kwargs


class LMTrainStep:
    """``(state, batch) -> (state, metrics)`` for the LM stack; state =
    {params, opt, rng}; metrics {loss (the CE alone), aux, grad_norm, lr}.

    ``batch_shards``: the devices the batch is split over; ``grad_accum``
    is capped so that each microbatch still divides them. ``shard``: the
    reference's constraints (each microbatch on 'batch', the gradients
    and their accumulation carry in the params' layouts, and the model's
    own); the identity if None."""

    def __init__(self, arch: ArchConfig, opt: AdamW, *, shard=None, aux_weight: float = 0.01,
                 batch_shards: int = 1):
        self.arch, self.opt = arch, opt
        self.shard = shard
        self.model = LM(arch, shard=shard)
        # the params' logical axes, leaf for leaf: the layouts of the carry
        self.p_axes = tr.leaves(param_axes(arch)[0]) if shard is not None else None
        self.aux_weight = aux_weight
        self.batch_shards = max(batch_shards, 1)
        self.nf = arch.n_frontend_tokens if arch.frontend == "vision" else 0
        self.acc_dtype = torch_dtype(arch.accum_dtype)

    def effective_accum(self, total_batch: int) -> int:
        """The reference's ``_effective_accum``: ``grad_accum`` cut to the
        largest count that divides the batch into microbatches that divide
        the shards."""
        shards = self.batch_shards
        a = min(max(self.arch.grad_accum, 1), max(total_batch // shards, 1))
        while a > 1 and (total_batch % a or (total_batch // a) % shards):
            a -= 1
        return a

    def loss_for(self, params, mb) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(ce + aux_weight * aux, ce, aux) of one microbatch."""
        logits, aux = self.model.forward(params, **_lm_inputs(self.arch, mb, prefix=bool(self.nf)))
        if self.nf:
            logits = logits[:, self.nf:]
        ce = cross_entropy(logits, mb["labels"])
        return ce + self.aux_weight * aux, ce, aux

    def _grads(self, params, mb):
        """(ce, aux, gradient leaves in the params' dtypes) of one microbatch;
        a leaf the loss does not reach (an audio arch's token table) gets
        zeros, as under ``jax.grad``."""
        leaves = [p.detach().requires_grad_(True) for p in tr.leaves(params)]
        with torch.enable_grad():
            loss, ce, aux = self.loss_for(tr.unflatten_like(params, leaves), mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return ce.detach(), aux.detach(), self._in_param_layouts(list(grads))

    def _in_param_layouts(self, leaves: list) -> list:
        """The reference's ``constrain_grads``: each leaf laid out as its
        param by ``shard`` (a gradient's pending sum over the batch is
        reduced there, once); unchanged without ``shard``."""
        if self.shard is None:
            return leaves
        return [self.shard(a, ax) for a, ax in zip(leaves, self.p_axes)]

    def loss_and_grads(self, params, batch):
        """(ce, aux, grads) of the batch, over its microbatches."""
        accum = self.effective_accum(next(iter(batch.values())).shape[0])
        if accum == 1:
            ce, aux, grads = self._grads(params, batch)
            return ce, aux, tr.unflatten_like(params, grads)
        # microbatch i: rows i, i + accum, ... (dim 1 of a (B / a, a, ...) reshape)
        mbs = {k: v.reshape((v.shape[0] // accum, accum) + v.shape[1:]) for k, v in batch.items()}
        if self.shard is not None:
            mbs = {k: self.shard(v, ("batch",) + (None,) * (v.dim() - 1))
                   for k, v in mbs.items()}
        acc = self._in_param_layouts([torch.zeros_like(p, dtype=self.acc_dtype)
                                      for p in tr.leaves(params)])
        ce_acc = aux_acc = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        for i in range(accum):
            ce, aux, grads = self._grads(params, {k: v[:, i] for k, v in mbs.items()})
            for a, g in zip(acc, grads):
                a.add_(g.to(self.acc_dtype))
            del grads
            ce_acc, aux_acc = ce_acc + ce, aux_acc + aux
        for a in acc:
            a.div_(torch.full((), accum, dtype=a.dtype, device=a.device))
        return ce_acc / accum, aux_acc / accum, tr.unflatten_like(params, acc)

    def __call__(self, state, batch):
        with sharding.replicating(self.shard):
            ce, aux, grads = self.loss_and_grads(state["params"], batch)
            new_params, new_opt, stats = self.opt.update(grads, state["opt"], state["params"])
        return ({"params": new_params, "opt": new_opt, "rng": state["rng"]},
                {"loss": ce, "aux": aux, **stats})


def make_train_step(arch: ArchConfig, opt: AdamW, *, shard=None, aux_weight: float = 0.01,
                    batch_shards: int = 1) -> DiffusionTrainStep | LMTrainStep:
    """(state, batch) -> (state, metrics); state = {params, opt, rng}.
    ``shard``: the LM step's sharding constraints (``LMTrainStep``); the
    diffusion step ignores it, as the reference's does."""
    if arch.family == "diffusion":
        return DiffusionTrainStep(arch, opt)
    return LMTrainStep(arch, opt, shard=shard, aux_weight=aux_weight, batch_shards=batch_shards)


def make_prefill_step(arch: ArchConfig, *, shard=None) -> Callable:
    """``(params, batch) -> (last-position logits, cache)``: the prompt's
    forward, its k / v kept (cache length = prompt length). ``batch`` holds
    ``tokens`` (B, S), or ``embeds`` (B, S, D) for an audio arch, and for a
    vision arch optionally ``frontend_embeds`` (B, n_frontend_tokens, D);
    other keys are ignored. Serving records no autograd graph (the steps
    run under ``torch.no_grad``), so the recurrent layers take no
    checkpoints. ``shard``: as ``LM(shard=)``; the cache is then allocated
    in its mesh layout (``cache_shardings_dict``)."""
    model = LM(arch, shard=shard)

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, **_lm_inputs(arch, batch, prefix=True))

    return prefill_step


def make_decode_step(arch: ArchConfig, *, shard=None) -> Callable:
    """``(params, cache, batch) -> (logits, cache)``: one decode step at
    ``batch["pos"]`` (an int or a 0-d integer tensor) over ``tokens`` (B, 1),
    or ``embeds`` (B, 1, D) for an audio arch; other keys are ignored. The
    step is written into ``cache`` (k / v, or the recurrent states and the
    ring), which is returned; no autograd graph is recorded. ``shard``: as
    ``LM(shard=)``."""
    model = LM(arch, shard=shard)

    @torch.no_grad()
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, pos=batch["pos"],
                                 **_lm_inputs(arch, batch, prefix=False))

    return decode_step


def make_denoise_step(arch: ArchConfig, *, int8: bool = False) -> Callable:
    """One denoiser forward (the unit the Ditto sampler iterates).
    ``int8``: the W8A8 serving path (``models.dit_int8``), whose products run
    on the port's ``int8_matmul`` kernel on the card.

    Both take the batch split: on DTensors (the latents, t and labels split
    over the batch axes, the params laid out by ``param_axes``' layouts, the
    W8A8 weights whole), run under ``sharding.replicating``, each rank
    denoises its own rows and the output keeps the split; the W8A8 step's
    per-tensor scales are the whole batch's, and each rank's products
    launch the kernel on its own rows."""
    if arch.family != "diffusion":
        raise ValueError(f"make_denoise_step needs the diffusion family, not {arch.family}")
    dcfg = make_dit_model(arch)
    if int8:
        from ..models import dit_int8

        def denoise_step_q8(qparams, batch):
            return dit_int8.apply(qparams, dcfg, batch["latents"], batch["t"], batch.get("labels"))

        return denoise_step_q8

    def denoise_step(params, batch):
        return dit_mod.apply(params, dcfg, batch["latents"], batch["t"], batch.get("labels"))

    return denoise_step


def init_state(arch: ArchConfig, seed: int, opt: AdamW, *, device=None) -> dict:
    """Initialize {params, opt, rng} for training on ``device`` (default:
    the card): params (the DiT's, or ``LM(arch).init``'s) drawn from a
    generator on the device seeded with ``seed``; ``rng`` is the seed of
    the noise draws, a CPU int64 tensor (so the checkpoint keeps it and
    reading it costs no transfer)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if arch.family == "diffusion":
        params = dit_mod.init(gen, make_dit_model(arch), device=dev,
                              dtype=torch_dtype(arch.param_dtype))
    else:
        params = LM(arch).init(gen, device=dev)
    return {"params": params, "opt": opt.init(params),
            "rng": torch.tensor(seed, dtype=torch.int64)}


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device. Initializers make their
    tensors on their generator's device, so under it they allocate nothing
    (``torch.randn`` takes a CPU generator for a meta tensor)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_axes(arch: ArchConfig, *, int8: bool = False):
    """(logical-axes tree, shape tree) of the params of ``arch``, without
    allocating them: the initializers run on the meta device under
    ``nn/core.py:tagged``, so the shape tree's leaves are meta tensors (a
    shape and a dtype; the reference's PRNG key has no counterpart: a meta
    tensor draws nothing). ``int8``: the W8A8 serving tree of
    ``models/dit_int8.quantize_params``, every leaf replicated (axes
    ``()``)."""
    gen = _MetaGenerator()
    if arch.family == "diffusion":
        dcfg = make_dit_model(arch)
        with nncore.tagged():
            tree = dit_mod.init(gen, dcfg, device="meta", dtype=torch_dtype(arch.param_dtype))
        if int8:
            from ..models import dit_int8

            shapes = dit_int8.quantize_params(tree, dcfg)
            return tr.map_tree(lambda _: (), shapes), shapes
    else:
        with nncore.tagged():
            tree = LM(arch).init(gen, device="meta")
    shapes, axes = nncore.split(tree)
    return axes, shapes
