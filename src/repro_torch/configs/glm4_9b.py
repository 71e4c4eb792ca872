"""glm4-9b — RoPE + aggressive GQA (kv=2).

[hf:THUDM/glm-4-9b; hf]  40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10000.0,
    source="[hf:THUDM/glm-4-9b; hf]",
)
