"""mamba2-1.3b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  48L d_model=2048 d_ff=0 vocab=50280,
ssm_state=128.  Pure Mamba-2 blocks: no attention, no separate FFN
(d_ff=0); each layer is a single SSD mixer.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, conv_width=4, expand=2,
                  chunk_size=256, ngroups=1),
    supports_long_context=True,   # O(1)-state decode; run long_500k
    source="[arXiv:2405.21060; unverified]",
)
