"""minicpm-2b — llama-like dense LM trained with the WSD schedule.

[arXiv:2404.06395; hf]  40L d_model=2304 36H (GQA kv=36 -> MHA) d_ff=5760
vocab=122753.  MiniCPM uses tied embeddings, depth-scaled residuals
(scale_depth=1.4 -> residual_scale = 1.4/sqrt(L)), scale_emb=12 and
logits divided by d_model/dim_model_base (256).
"""
import math

from repro_torch.configs.base import ArchConfig

_L = 40

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=_L,
    d_model=2304,
    num_heads=36,
    kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10000.0,
    tie_embeddings=True,
    residual_scale=1.4 / math.sqrt(_L),
    embed_scale=12.0,
    logit_scale=1.0 / (2304 / 256),
    lr_schedule="wsd",            # the paper's Warmup-Stable-Decay schedule
    source="[arXiv:2404.06395; hf]",
)
