"""xLSTM-125M — sLSTM + mLSTM blocks, fully recurrent. [arXiv:2405.04517; unverified]

12 layers as 2 super-blocks of (5 mLSTM + 1 sLSTM); d_ff=0 per the
assignment (xLSTM blocks carry their own internal projections).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    n_super=2,
    per_super=5,  # mLSTM per super-block; +1 sLSTM each
    norm="layernorm",
    sub_quadratic=True,  # recurrent decode: O(1)/token -> runs long_500k
    source="arXiv:2405.04517; unverified",
)
