"""Qwen3-0.6B — dense GQA LM with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B; hf",
)
