"""Train and serve step builders: the diffusion (DiT) family, and the
LM's serving steps.

Mirror of ``src/repro/launch/steps.py``: ``make_optimizer``,
``make_dit_model``, the diffusion branch of ``make_train_step``,
``init_state`` and ``make_denoise_step`` (float and W8A8), and the LM's
``make_prefill_step`` / ``make_decode_step`` (the dense stack,
``models/lm.py``). PyTorch runs
eagerly, so a step is a plain function of (state, batch); autograd gives
the backward, and the optimizer updates the state's tensors in place.

Numerics kept from the reference: ``x0`` and ``eps`` are cast to the
config's activation dtype, and ``q_sample``'s float32 ``sqrt(abar)``
promotes ``x_t`` to float32, so the whole forward (the bfloat16 weights
cast up by ``nn/core.py:dense``) and the loss run in float32: DiT-XL/2's
"bfloat16" config stores bfloat16 and computes in float32. TF32 stays off
(PyTorch's default for matmuls).

LM training (``cross_entropy``, the LM branch of ``make_train_step`` and
``init_state``) comes with the LM substrate's training slice, and
``param_axes`` with ``distributed/`` (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree as tr
from ..configs.base import ArchConfig, torch_dtype
from ..core import diffusion
from ..data.synthetic import generator
from ..kernels.common import resolve_device
from ..models.lm import LM
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


def _diffusion_only(arch: ArchConfig, what: str) -> None:
    if arch.family != "diffusion":
        raise NotImplementedError(f"{what} for the {arch.family} family is not ported: LM "
                                  f"training comes with the LM substrate's training slice "
                                  f"(ROADMAP.md, queue 1, item 8a)")


class DiffusionTrainStep:
    """``(state, batch) -> (state, metrics)``; state = {params, opt, rng}.

    Split in two so that a test can feed its own noise: :meth:`noise` draws
    the timesteps and the noise of a step, :meth:`with_noise` does the loss,
    the backward and the update."""

    def __init__(self, arch: ArchConfig, opt: AdamW):
        _diffusion_only(arch, "make_train_step")
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


def make_train_step(arch: ArchConfig, opt: AdamW) -> DiffusionTrainStep:
    """(state, batch) -> (state, metrics); state = {params, opt, rng}."""
    return DiffusionTrainStep(arch, opt)


def make_prefill_step(arch: ArchConfig) -> Callable:
    """``(params, batch) -> (last-position logits, cache)``: the prompt's
    forward, its k / v kept (cache length = prompt length). ``batch`` holds
    ``tokens`` (B, S), or ``embeds`` (B, S, D) for an audio arch, and for a
    vision arch optionally ``frontend_embeds`` (B, n_frontend_tokens, D);
    :meth:`LM.prefill` takes it as keywords."""
    model = LM(arch)

    def prefill_step(params, batch):
        return model.prefill(params, **batch)

    return prefill_step


def make_decode_step(arch: ArchConfig) -> Callable:
    """``(params, cache, batch) -> (logits, cache)``: one decode step at
    ``batch["pos"]`` (an int or a 0-d integer tensor) over ``tokens`` (B, 1),
    or ``embeds`` (B, 1, D) for an audio arch; :meth:`LM.decode_step` takes
    ``batch`` as keywords. The step's k / v are written into ``cache``,
    which is returned."""
    model = LM(arch)

    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, **batch)

    return decode_step


def make_denoise_step(arch: ArchConfig, *, int8: bool = False) -> Callable:
    """One denoiser forward (the unit the Ditto sampler iterates).
    ``int8``: the W8A8 serving path (``models.dit_int8``), whose products run
    on the port's ``int8_matmul`` kernel on the card."""
    _diffusion_only(arch, "make_denoise_step")
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
    the card): params drawn from a generator on the device seeded with
    ``seed``; ``rng`` is the seed of the noise draws, a CPU int64 tensor
    (so the checkpoint keeps it and reading it costs no transfer)."""
    _diffusion_only(arch, "init_state")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = dit_mod.init(gen, make_dit_model(arch), device=dev,
                          dtype=torch_dtype(arch.param_dtype))
    return {"params": params, "opt": opt.init(params),
            "rng": torch.tensor(seed, dtype=torch.int64)}
