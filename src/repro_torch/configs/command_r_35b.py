"""Command-R 35B — large dense GQA LM, no biases. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    act="swiglu",
    norm="layernorm",
    attn_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    fsdp=True,
    grad_accum=16,  # d=8192 activations
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    notes="35B dense; FSDP over data axis in addition to TP.",
)
