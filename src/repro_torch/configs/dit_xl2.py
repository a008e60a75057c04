"""DiT-XL/2 — the paper's own diffusion-transformer benchmark arch.

[Peebles & Xie, ICCV'23; paper Table I row `DiT`]. 28 layers, d=1152,
16 heads, patch 2 over 32x32x4 latents, class-conditional (ImageNet),
DDIM sampling. This is the architecture the Ditto technique is
demonstrated on end-to-end (quantized temporal-difference serving).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dit-xl2",
    family="diffusion",
    n_layers=28,
    d_model=1152,
    n_heads=16,
    n_kv_heads=16,
    head_dim=72,
    d_ff=4608,  # mlp_ratio 4
    vocab_size=0,
    patch=2,
    in_channels=4,
    input_size=32,
    n_classes=1000,
    sample_steps=250,  # paper Table I: DDIM 250 steps
    norm="layernorm",
    act="gelu",
    source="hf/arXiv:2212.09748 (DiT-XL/2); paper Table I",
)
