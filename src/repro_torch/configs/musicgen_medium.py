"""musicgen-medium — decoder-only LM over EnCodec tokens; frontend is a STUB.

[arXiv:2306.05284; hf]  48L d_model=1536 24H (kv=24 -> MHA) d_ff=6144
vocab=2048.  The EnCodec tokenizer is a stub: ``input_specs()`` provides
the audio-token stream directly (the assignment models the transformer
backbone only).  MusicGen uses a plain (non-gated) GeLU MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp_type="gelu",
    source="[arXiv:2306.05284; hf]",
)
