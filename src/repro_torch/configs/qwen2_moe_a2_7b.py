"""Qwen2-MoE-A2.7B — 60 routed experts top-4 + shared expert. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # routed expert intermediate
    vocab_size=151936,
    n_experts=60,
    top_k=4,
    d_ff_shared=5632,  # 4 fused shared experts (4 x 1408)
    act="swiglu",
    norm="rmsnorm",
    fsdp=True,  # 14.3B total params: weights+moments must shard over data too
    grad_accum=4,  # activation memory: 37GiB -> fits HBM
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
    notes="4 shared experts modeled as one fused 5632-wide gated shared expert. "
    "60 experts do not divide the 16-way model axis -> expert weights shard "
    "on their mlp/embed dims (TP+FSDP) instead of EP.",
)
