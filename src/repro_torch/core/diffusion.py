"""Diffusion process substrate: noise schedules, q_sample, DDIM/PLMS samplers.

Mirror of ``src/repro/core/diffusion.py``. The samplers drive a generic
``denoise_fn(x_t, t, labels) -> eps_hat``; Ditto wraps that callable with
temporal-difference processing (the sampler loop is exactly the temporal
axis the paper exploits). Schedules are float32 tensors; move one to the
latents' device with :meth:`NoiseSchedule.to`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..nn.core import divide


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: torch.Tensor  # (T,)

    @property
    def alphas(self):
        return 1.0 - self.betas

    @property
    def alpha_bars(self):
        return torch.cumprod(self.alphas, dim=0)

    @property
    def T(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "NoiseSchedule":
        return NoiseSchedule(self.betas.to(device))


def linear_schedule(T: int = 1000, b0: float = 1e-4, b1: float = 2e-2) -> NoiseSchedule:
    return NoiseSchedule(torch.linspace(b0, b1, T, dtype=torch.float32))


def cosine_schedule(T: int = 1000, s: float = 8e-3) -> NoiseSchedule:
    t = divide(torch.arange(T + 1, dtype=torch.float32), float(T))
    f = torch.cos(divide(t + s, 1 + s) * math.pi / 2) ** 2
    abar = f / f[0]
    betas = torch.clip(1 - abar[1:] / abar[:-1], 1e-6, 0.999)
    return NoiseSchedule(betas)


def q_sample(sched: NoiseSchedule, x0, t, eps):
    """Forward process: x_t = sqrt(abar_t) x0 + sqrt(1-abar_t) eps.

    ``abar`` is float32, so a bfloat16 ``x0`` / ``eps`` promotes to a float32
    ``x_t``, as in the reference. The schedule may lie on the CPU: its
    ``alpha_bars`` follow ``t`` to its device."""
    abar = sched.alpha_bars.to(t.device)[t]
    shape = (-1,) + (1,) * (x0.ndim - 1)
    return torch.sqrt(abar).reshape(shape) * x0 + torch.sqrt(1 - abar).reshape(shape) * eps


def ddim_timesteps(T: int, steps: int) -> list[int]:
    """Descending subset of timesteps for DDIM (e.g. T=1000, steps=50)."""
    stride = max(T // steps, 1)
    return list(range(0, T, stride))[:steps][::-1]


def ddim_step(sched: NoiseSchedule, x_t, eps_hat, t: int, t_prev: int):
    """One deterministic DDIM update x_t -> x_{t_prev}."""
    abars = sched.alpha_bars
    abar_t = abars[t]
    abar_p = abars[t_prev] if t_prev >= 0 else torch.ones((), dtype=abars.dtype,
                                                           device=abars.device)
    x0_pred = (x_t - torch.sqrt(1 - abar_t) * eps_hat) / torch.sqrt(abar_t)
    dir_xt = torch.sqrt(1 - abar_p) * eps_hat
    return torch.sqrt(abar_p) * x0_pred + dir_xt


def ddim_sample(sched: NoiseSchedule, denoise_fn, x_T, *, steps: int, labels=None,
                callback=None):
    """Full DDIM sampling loop (Python loop: each step may change execution
    mode under Ditto/Defo, which is the point of the paper)."""
    ts = ddim_timesteps(sched.T, steps)
    x = x_T
    for i, t in enumerate(ts):
        t_prev = ts[i + 1] if i + 1 < len(ts) else -1
        t_vec = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        eps_hat = denoise_fn(x, t_vec, labels)
        x = ddim_step(sched, x, eps_hat, t, t_prev)
        if callback is not None:
            callback(step_index=i, t=t, x=x)
    return x


def plms_sample(sched: NoiseSchedule, denoise_fn, x_T, *, steps: int, labels=None,
                callback=None):
    """Pseudo linear multistep (PLMS, arXiv:2202.09778) — SDM's sampler."""
    ts = ddim_timesteps(sched.T, steps)
    x = x_T
    eps_hist: list = []
    for i, t in enumerate(ts):
        t_prev = ts[i + 1] if i + 1 < len(ts) else -1
        t_vec = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        eps = denoise_fn(x, t_vec, labels)
        if len(eps_hist) == 0:
            eps_prime = eps
        elif len(eps_hist) == 1:
            eps_prime = divide(3 * eps - eps_hist[-1], 2.0)
        elif len(eps_hist) == 2:
            eps_prime = divide(23 * eps - 16 * eps_hist[-1] + 5 * eps_hist[-2], 12.0)
        else:
            eps_prime = divide(55 * eps - 59 * eps_hist[-1] + 37 * eps_hist[-2]
                               - 9 * eps_hist[-3], 24.0)
        eps_hist.append(eps)
        if len(eps_hist) > 3:
            eps_hist.pop(0)
        x = ddim_step(sched, x, eps_prime, t, t_prev)
        if callback is not None:
            callback(step_index=i, t=t, x=x)
    return x


SAMPLERS = {"ddim": ddim_sample, "plms": plms_sample}
