"""Zamba2-7B — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242; unverified]

81 layers = 13 super-blocks of (5 Mamba2 + 1 shared-attention application)
+ 3 trailing Mamba2 (13*6 + 3 = 81). The attention block's weights are
shared across all 13 applications (Zamba-style). For the 500k-decode cell
the shared attention uses a 4096-token sliding window (ring-buffer cache),
keeping decode sub-quadratic and the cache bounded.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    n_super=13,
    per_super=5,
    n_trailing=3,
    attn_window=4096,
    act="swiglu",
    norm="rmsnorm",
    fsdp=True,
    grad_accum=4,
    sub_quadratic=True,  # Mamba2 O(1)/token + windowed shared attention
    source="arXiv:2411.15242; unverified",
)
