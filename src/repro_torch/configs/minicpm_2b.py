"""MiniCPM-2B — dense llama-like LM with WSD schedule. [arXiv:2404.06395; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    lr_schedule="wsd",
    fsdp=True,
    grad_accum=4,  # logits/activation memory
    source="arXiv:2404.06395; hf",
    notes="WSD schedule; llama-like; tied embeddings (MiniCPM uses embedding sharing).",
)
