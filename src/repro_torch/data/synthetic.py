"""Deterministic, seekable synthetic data pipeline (diffusion family).

Mirror of ``src/repro/data/synthetic.py``. Every batch is a pure function
of (seed, step), so a restarted job resumes bit-identically: there is no
iterator state to lose. A batch is drawn on the CPU from a
``torch.Generator`` seeded from (seed, step), then moved to ``device``, so
the CPU and the card see the same batch. The draws follow the reference's
recipe, not its bits: ``jax.random`` and ``torch.Generator`` give other
numbers from the same seed, so a batch here is not the reference's batch
(tests feed both packages the same numpy arrays instead).

Diffusion streams are the reference's 8-mode Gaussian mixture of latents
(a learnable denoising target): per-mode means N(0, 0.8^2) fixed by
``seed + 7``, plus N(0, 0.25^2) noise, labels ``comp % n_classes``. The
token streams (``lm_batch``) come with the LM substrate (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device

N_MODES = 8


@dataclasses.dataclass(frozen=True)
class DataCfg:
    seed: int = 0
    batch: int = 8


def generator(*words) -> torch.Generator:
    """A CPU generator seeded from ``words`` (a stream name and integers):
    one stream per tuple, and unrelated streams for tuples that differ."""
    digest = hashlib.blake2b(repr(words).encode(), digest_size=8).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest, "little"))


def diffusion_batch(arch: ArchConfig, dc: DataCfg, step: int, *, device=None) -> dict:
    """Clean latents x0 (B, H, W, C) float32 from a K-mode Gaussian mixture
    + class labels (int64, torch's index dtype; the reference's are int32),
    on ``device`` (default: the card)."""
    dev = resolve_device(device)
    g = generator("data", dc.seed, step)
    hw, ch = arch.input_size, arch.in_channels
    comp = torch.randint(0, N_MODES, (dc.batch,), generator=g)
    # fixed per-mode means, deterministic in seed only
    means = torch.randn((N_MODES, hw, hw, ch), generator=generator("means", dc.seed + 7)) * 0.8
    x0 = means[comp] + 0.25 * torch.randn((dc.batch, hw, hw, ch), generator=g)
    out = {"x0": x0.to(torch.float32)}
    if arch.n_classes:
        out["labels"] = comp % arch.n_classes
    return {k: v.to(dev) for k, v in out.items()}


def batch_for(arch: ArchConfig, dc: DataCfg, step: int, *, device=None) -> dict:
    if arch.family != "diffusion":
        raise NotImplementedError(f"{arch.family} data (lm_batch) is not ported: the LM "
                                  f"substrate comes later (ROADMAP.md, queue 1)")
    return diffusion_batch(arch, dc, step, device=device)


def host_slice(batch: dict, host_id: int, n_hosts: int) -> dict:
    """Per-host shard of a global batch (multi-host data loading)."""
    def sl(a):
        b = a.shape[0]
        if b % n_hosts:
            raise ValueError(f"batch of {b} does not split over {n_hosts} hosts")
        per = b // n_hosts
        return a[host_id * per:(host_id + 1) * per]

    return {k: sl(v) for k, v in batch.items()}
