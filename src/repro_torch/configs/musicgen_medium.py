"""MusicGen-medium — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S, d_model) consumed directly by the backbone (the token
embedding table is bypassed); the LM head predicts the 2048-way codec
vocabulary.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    norm="layernorm",
    attn_bias=True,
    fsdp=True,
    grad_accum=4,  # 24 heads don't shard over model=16
    frontend="audio",
    source="arXiv:2306.05284; hf",
)
