"""jamba-1.5-large-398b — hybrid Mamba + attention (1:7) with MoE.

[arXiv:2403.19887; hf]  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2.  Attention every 8th layer (1:7 interleave),
MoE every second layer (odd layers), dense FFN otherwise.  Uses the
memory-lean Adafactor optimizer + bf16 params so the 398B-param training
state is representable on a 512-chip v5e footprint.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  layer_pattern="every_2", shard_mode="expert"),
    ssm=SSMConfig(state_dim=128, head_dim=64, conv_width=4, expand=2,
                  chunk_size=256, ngroups=1),
    hybrid_period=8,
    hybrid_attn_index=4,          # Jamba places attention mid-period
    param_dtype="bfloat16",
    optimizer="adafactor",
    supports_long_context=True,   # hybrid: SSM carries long context
    source="[arXiv:2403.19887; hf]",
)
