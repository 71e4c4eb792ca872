"""internvl2-2b — InternViT + InternLM2 VLM; the ViT frontend is a STUB.

[arXiv:2404.16821; hf]  24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  Per the assignment, only the transformer BACKBONE is
modelled; ``input_specs()`` provides 256 precomputed patch embeddings
(InternVL's pixel-unshuffled 448px tile -> 256 visual tokens) which are
prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1000000.0,
    frontend_embeds=256,
    source="[arXiv:2404.16821; hf]",
)
