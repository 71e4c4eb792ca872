"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA window 4096.  With 8 experts < 16-way
model axis, experts shard on their FFN dim ('ffn' mode).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    swa_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336,
                  layer_pattern="all", shard_mode="ffn"),
    supports_long_context=True,   # SWA -> sub-quadratic, bounded KV
    source="[arXiv:2401.04088; hf]",
)
