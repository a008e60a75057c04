"""Snowflake Arctic 480B — 128-expert top-2 MoE + dense residual. [hf:Snowflake/snowflake-arctic-base; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,  # expert intermediate
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    d_ff_dense=4864,  # dense residual FFN in parallel with the MoE
    act="swiglu",
    norm="rmsnorm",
    fsdp=True,
    optimizer_dtype="bfloat16",  # 480B: fp32 moments do not fit 16G/chip
    factored_second_moment=True,  # Adafactor-style v: saves ~1TB fleet-wide
    grad_accum=8,  # after §Perf iter C, accum no longer drives collectives; 8 = best time
    accum_dtype="bfloat16",  # fp32 accum buffer alone would be 3.7G/chip
    # w8_gather=True was tried and REFUTED (§Perf arctic iteration B):
    # the STE cotangent path cost more wire than the int8 gather saved.
    ep_ff_data=True,  # shard expert ff dim over 'data': reduce activations, not weights (§Perf iter C)
    source="hf:Snowflake/snowflake-arctic-base; hf",
    notes="Dense-MoE hybrid residual; experts sharded EP over model axis and "
    "FSDP over data axis; bf16 m + factored v + bf16 grad accumulation "
    "(see DESIGN.md §5 / EXPERIMENTS.md §Dry-run).",
)
