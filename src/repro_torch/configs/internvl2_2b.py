"""InternVL2-2B — InternViT frontend (stub) + InternLM2 backbone. [arXiv:2404.16821; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    act="swiglu",
    norm="rmsnorm",
    fsdp=True,
    grad_accum=2,
    frontend="vision",
    n_frontend_tokens=256,  # precomputed InternViT patch embeddings (stub)
    source="arXiv:2404.16821; hf",
    notes="Vision frontend is a STUB: input_specs() provides precomputed "
    "patch embeddings (B, 256, d) prepended to the token sequence.",
)
