"""starcoder2-15b — GQA + RoPE code LM.

[arXiv:2402.19173; hf]  40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152.  StarCoder2 uses a standard (non-gated) GeLU MLP (d_ff = 4x).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=100000.0,
    mlp_type="gelu",
    source="[arXiv:2402.19173; hf]",
)
