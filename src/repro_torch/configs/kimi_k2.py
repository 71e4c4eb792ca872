"""kimi-k2-1t-a32b — trillion-parameter MoE (384 experts, top-8).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per-expert) vocab=163840, MoE 384e top-8 + 1 shared expert.  Uses
Adafactor + bf16 params: AdamW fp32 state for 1.04T params would need
~12.5 TB (> the 8 TB HBM of a 512-chip v5e slice); factored state keeps
the dry-run within footprint.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    rope_theta=50000.0,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  layer_pattern="all", shard_mode="expert",
                  num_shared_experts=1),
    param_dtype="bfloat16",
    optimizer="adafactor",
    source="[arXiv:2501.kimi2; unverified]",
)
