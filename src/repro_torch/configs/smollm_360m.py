"""SmolLM-360M — llama-arch small dense LM. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    grad_accum=8,  # 15 heads don't shard over model=16 -> scores replicate; shrink activations
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
    notes="15 heads do not divide the 16-way model axis; projections are "
    "sharded on flattened feature dims (960 % 16 == 0).",
)
