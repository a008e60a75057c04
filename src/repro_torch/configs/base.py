"""Architecture + shape configuration system.

Mirror of ``src/repro/configs/base.py``: every assigned architecture is
one :class:`ArchConfig` in its own module under ``repro_torch/configs``;
``registry.py`` exposes ``get(name)`` / ``names()``. ``SHAPES`` defines
the four assigned input-shape cells and :func:`cell_applicable` says
which (arch, shape) cells run. Dtypes stay strings, as in the reference;
:func:`torch_dtype` maps one to a ``torch.dtype``. :func:`input_specs`
gives a step's inputs as meta tensors (a shape and a dtype, no data), the
counterpart of the reference's ``ShapeDtypeStruct`` stand-ins, for the
dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "diffusion")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""  # provenance note ([arXiv/hf; tier])
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    attn_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu | geglu | silu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_shared: int = 0  # qwen2-moe style always-on expert
    d_ff_dense: int = 0  # arctic style parallel dense residual FFN
    capacity_factor: float = 1.25
    # --- SSM / hybrid (super-block layout) ---
    ssm_state: int = 64
    ssm_head_dim: int = 64
    n_super: int = 0  # number of super-blocks
    per_super: int = 0  # recurrent layers per super-block
    n_trailing: int = 0  # trailing recurrent layers after supers
    attn_window: int | None = None  # sliding window for (shared) attention
    # --- modality frontend stub ---
    frontend: str | None = None  # vision | audio
    n_frontend_tokens: int = 0
    # --- diffusion (DiT family) ---
    patch: int = 2
    in_channels: int = 4
    input_size: int = 32
    n_classes: int = 0
    sample_steps: int = 50
    # --- training ---
    lr_schedule: str = "cosine"  # cosine | wsd | const
    grad_accum: int = 1  # microbatches per step (activation memory / overlap)
    accum_dtype: str = "float32"  # grad-accumulation buffer dtype
    w8_gather: bool = False  # int8 FSDP weight gathers for MoE experts (STE)
    ep_ff_data: bool = False  # EP experts: shard ff dim over data (no weight gathers)
    factored_second_moment: bool = False  # Adafactor-style v (480B config)
    # --- distribution ---
    fsdp: bool = False  # additionally shard weights over the data axis
    remat: bool = True
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"  # AdamW moment dtype (bf16 for 480B)
    # --- cell applicability ---
    sub_quadratic: bool = False  # may run long_500k
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qd, kvd = self.n_heads * hd, self.n_kv_heads * hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "diffusion":
            per = 4 * d * d + 2 * d * int(4 * d) + 7 * d * d  # attn + mlp + adaLN approx
            return self.n_layers * per
        attn = d * qd + 2 * d * kvd + qd * d
        if self.family == "ssm":  # xlstm mixture, rough
            per = 10 * d * d
            return self.n_super * (self.per_super + 1) * per + emb
        if self.family == "hybrid":
            di = 2 * d
            mamba = 2 * d * di + d * (2 * self.ssm_state + di // self.ssm_head_dim) + di * d
            n_mamba = self.n_super * self.per_super + self.n_trailing
            shared = attn + 3 * d * f
            return n_mamba * mamba + shared + emb
        if self.n_experts:
            ff = (3 * d * self.d_ff * self.n_experts + 3 * d * self.d_ff_shared
                  + 3 * d * self.d_ff_dense)
        else:
            ff = (3 if self.act in ("swiglu", "geglu") else 2) * d * f
        return self.n_layers * (attn + ff) + emb

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ff = 3 * d * self.d_ff * self.top_k + 3 * d * self.d_ff_shared + 3 * d * self.d_ff_dense
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff) + emb

    def smoke(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        repl: dict[str, Any] = dict(
            n_layers=2,
            d_model=64,
            d_ff=128,
            vocab_size=256,
            param_dtype="float32",
            activation_dtype="float32",
            fsdp=False,
            grad_accum=1,
            accum_dtype="float32",
        )
        repl["head_dim"] = 16
        repl["n_heads"] = max(2, min(self.n_heads, 4))
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        repl["n_kv_heads"] = max(1, repl["n_heads"] // ratio)
        if self.n_experts:
            repl.update(n_experts=4, top_k=min(self.top_k, 2),
                        d_ff=32,
                        d_ff_shared=32 if self.d_ff_shared else 0,
                        d_ff_dense=32 if self.d_ff_dense else 0)
        if self.family in ("ssm", "hybrid"):
            repl.update(n_super=1, per_super=2, n_trailing=1 if self.n_trailing else 0,
                        ssm_state=16, ssm_head_dim=16, attn_window=self.attn_window and 32)
        if self.frontend:
            repl.update(n_frontend_tokens=4)
        if self.family == "diffusion":
            repl.update(input_size=8, in_channels=4, n_classes=self.n_classes and 10,
                        sample_steps=8)
        return dataclasses.replace(self, **repl)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(arch: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs; reason when skipped."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "SKIP(full-attention): 500k decode needs sub-quadratic attention"
    if arch.family == "diffusion" and shape.kind != "train":
        # diffusion archs use denoise-serve instead of token decode; they get
        # their own serve cell via the Ditto examples/benchmarks.
        return False, "SKIP(diffusion): token prefill/decode not defined; see serve_denoise"
    return True, ""


def input_specs(arch: ArchConfig, shape: ShapeCell, *, batch_override: int | None = None) -> dict:
    """Meta-tensor stand-ins for every model input of a step.

    Train: tokens + labels (+ frontend embeds). Prefill: tokens.
    Decode: tokens (B, 1) + position (the cache is the step's own argument).
    Diffusion: ``x0`` to train, ``latents`` + ``t`` to serve, ``labels``
    for a class-conditional model."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    adt = torch_dtype(arch.activation_dtype)

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    specs: dict[str, torch.Tensor] = {}
    nf = arch.n_frontend_tokens if arch.frontend else 0
    if arch.family == "diffusion":
        hw = arch.input_size
        if shape.kind == "train":  # diffusion training consumes clean x0
            specs["x0"] = spec((b, hw, hw, arch.in_channels), torch.float32)
        else:  # serve_denoise: one denoiser forward at the cell's batch
            specs["latents"] = spec((b, hw, hw, arch.in_channels), adt)
            specs["t"] = spec((b,), torch.float32)
        if arch.n_classes:
            specs["labels"] = spec((b,), torch.int32)
        return specs
    if shape.kind in ("train", "prefill"):
        st = s - nf
        specs["tokens"] = spec((b, st), torch.int32)
        if shape.kind == "train":
            specs["labels"] = spec((b, st), torch.int32)
        if arch.frontend == "audio":
            # audio stub: precomputed frame embeddings replace token embedding
            specs["embeds"] = spec((b, st, arch.d_model), adt)
        elif nf:
            specs["frontend_embeds"] = spec((b, nf, arch.d_model), adt)
    else:  # decode: one new token against a cache of seq_len
        specs["tokens"] = spec((b, 1), torch.int32)
        if arch.frontend == "audio":
            specs["embeds"] = spec((b, 1, arch.d_model), adt)
        specs["pos"] = spec((), torch.int32)
    return specs


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string ("bfloat16", "float32", ...) as a torch.dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dt
