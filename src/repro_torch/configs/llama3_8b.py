"""llama3-8b — GQA, 128k vocab.

[arXiv:2407.21783; unverified]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    source="[arXiv:2407.21783; unverified]",
)
