"""LR schedules: cosine, WSD (warmup-stable-decay, MiniCPM), const.

Mirror of ``src/repro/optim/schedules.py``. A schedule maps a step (a
Python int or an integer tensor) to a float32 tensor on the step's
device, with the reference's float32 arithmetic; divisions by a Python
number go through ``nn/core.py:divide`` (a true division on the card).
"""
from __future__ import annotations

import math

import torch

from ..nn.core import divide


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine(base_lr: float, warmup: int, total: int, *, min_ratio: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = base_lr * torch.clamp(divide(step, float(max(warmup, 1))), max=1.0)
        prog = torch.clamp(divide(step - warmup, float(max(total - warmup, 1))), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def wsd(base_lr: float, warmup: int, total: int, *, decay_frac: float = 0.1,
        min_ratio: float = 0.01):
    """Warmup-Stable-Decay (arXiv:2404.06395): linear warmup, long stable
    plateau, sharp exponential-style decay in the final ``decay_frac``."""
    decay_start = int(total * (1 - decay_frac))

    def lr(step):
        step = _f32(step)
        warm = base_lr * torch.clamp(divide(step, float(max(warmup, 1))), max=1.0)
        prog = torch.clamp(divide(step - decay_start, float(max(total - decay_start, 1))),
                           0.0, 1.0)
        decay = base_lr * (min_ratio ** prog)  # exponential anneal to min_ratio
        out = torch.where(step < warmup, warm, torch.full_like(step, base_lr))
        return torch.where(step >= decay_start, decay, out)

    return lr


def const(base_lr: float, warmup: int = 0, total: int = 0):
    def lr(step):
        step = _f32(step)
        if warmup:
            return base_lr * torch.clamp(divide(step, float(warmup)), max=1.0)
        return torch.full_like(step, base_lr)

    return lr


def make(name: str, base_lr: float, warmup: int, total: int):
    return {"cosine": cosine, "wsd": wsd, "const": const}[name](base_lr, warmup, total)
