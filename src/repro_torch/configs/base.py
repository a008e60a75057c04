"""Architecture configuration.

Mirror of the parts of ``src/repro/configs/base.py`` that DiT training and
serving reach: :class:`ArchConfig`, ``resolved_head_dim``, ``n_params``
and ``smoke``, diffusion family only. :class:`ArchConfig` keeps the
fields the DiT path reads (``make_dit_model`` refuses a config whose
heads, ``norm`` or ``act`` the DiT does not build); the reference's
``d_ff``, ``vocab_size`` and ``sample_steps``, which its DiT does not
read either, and its LM, MoE, SSM and distribution fields come with the
LM substrate (ROADMAP.md, queue 1). Dtypes stay strings, as in the reference;
:func:`torch_dtype` maps one to a ``torch.dtype``. The dry-run's
``SHAPES``, ``ShapeCell``, ``cell_applicable`` and ``input_specs`` belong
to the launch tooling, a later slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    source: str = ""  # provenance note ([arXiv/hf; tier])
    head_dim: int = 0  # 0 -> d_model // n_heads
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu | geglu | silu
    # --- diffusion (DiT family) ---
    patch: int = 2
    in_channels: int = 4
    input_size: int = 32
    n_classes: int = 0
    # --- training ---
    lr_schedule: str = "cosine"  # cosine | wsd | const
    factored_second_moment: bool = False  # Adafactor-style v
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"  # AdamW moment dtype

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def n_params(self) -> int:
        """Approximate parameter count (the reference's diffusion formula)."""
        if self.family != "diffusion":
            raise NotImplementedError(f"n_params of the {self.family} family is not ported")
        d = self.d_model
        per = 4 * d * d + 2 * d * int(4 * d) + 7 * d * d  # attn + mlp + adaLN approx
        return self.n_layers * per

    def smoke(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        if self.family != "diffusion":
            raise NotImplementedError(f"smoke of the {self.family} family is not ported")
        n_heads = max(2, min(self.n_heads, 4))
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        return dataclasses.replace(
            self, n_layers=2, d_model=64, param_dtype="float32", activation_dtype="float32",
            head_dim=16, n_heads=n_heads, n_kv_heads=max(1, n_heads // ratio), input_size=8,
            in_channels=4, n_classes=self.n_classes and 10)


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string ("bfloat16", "float32", ...) as a torch.dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dt
