"""Deterministic, seekable synthetic data pipeline.

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
``seed + 7``, plus N(0, 0.25^2) noise, labels ``comp % n_classes``.

Token streams (``lm_batch``) are the reference's learnable recipe: a
Zipf-flavoured base stream over the vocab, and in 75 % of the positions
the structured token ``(position * drift) % vocab`` with a per-row drift
of 1-6, so the next token is predictable and cross-entropy falls. Token
ids are int64 (torch's index dtype; the reference's are int32).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device

N_MODES = 8


@dataclasses.dataclass(frozen=True)
class DataCfg:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128


def generator(*words) -> torch.Generator:
    """A CPU generator seeded from ``words`` (a stream name and integers):
    one stream per tuple, and unrelated streams for tuples that differ."""
    digest = hashlib.blake2b(repr(words).encode(), digest_size=8).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest, "little"))


def lm_batch(arch: ArchConfig, dc: DataCfg, step: int, *, device=None) -> dict:
    """tokens / labels (B, S) int64, ``labels`` the tokens shifted left with
    a last label of 0, plus the frontend stubs: audio frame ``embeds`` (B,
    S, D) or a vision prefix ``frontend_embeds`` (B, n_frontend_tokens, D),
    float32 N(0, 0.02^2); on ``device`` (default: the card)."""
    dev = resolve_device(device)
    g = generator("data", dc.seed, step)
    v, b, s = max(arch.vocab_size, 2), dc.batch, dc.seq_len
    u = 1e-6 + (1.0 - 1e-6) * torch.rand((b, s), generator=g)
    base = (torch.exp(u * math.log(v)) - 1.0).to(torch.int64) % v
    drift = torch.randint(1, 7, (b, 1), generator=g)
    structured = (torch.arange(1, s + 1).expand(b, s) * drift) % v
    mix = torch.rand((b, s), generator=g) < 0.75
    tokens = torch.where(mix, structured, base)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = 0
    out = {"tokens": tokens, "labels": labels}
    if arch.frontend == "audio":
        out["embeds"] = torch.randn((b, s, arch.d_model),
                                    generator=generator("embeds", dc.seed, step)) * 0.02
    elif arch.frontend and arch.n_frontend_tokens:
        out["frontend_embeds"] = torch.randn((b, arch.n_frontend_tokens, arch.d_model),
                                             generator=generator("frontend", dc.seed, step)) * 0.02
    return {k: t.to(dev) for k, t in out.items()}


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
    if arch.family == "diffusion":
        return diffusion_batch(arch, dc, step, device=device)
    return lm_batch(arch, dc, step, device=device)


def host_slice(batch: dict, host_id: int, n_hosts: int) -> dict:
    """Per-host shard of a global batch (multi-host data loading)."""
    def sl(a):
        b = a.shape[0]
        if b % n_hosts:
            raise ValueError(f"batch of {b} does not split over {n_hosts} hosts")
        per = b // n_hosts
        return a[host_id * per:(host_id + 1) * per]

    return {k: sl(v) for k, v in batch.items()}
