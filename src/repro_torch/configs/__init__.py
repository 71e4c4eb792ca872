"""Architecture registry.

``get_config(name)`` returns the full published configuration;
``get_smoke_config(name)`` returns a reduced same-family config for CPU
smoke tests (small layers/width, few experts, tiny vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                PREFILL_32K, TRAIN_4K, ArchConfig, MoEConfig,
                                SSMConfig, ShapeSpec)

from repro_torch.configs.mamba2_1p3b import CONFIG as _mamba2
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.glm4_9b import CONFIG as _glm4
from repro_torch.configs.llama3_8b import CONFIG as _llama3
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2
from repro_torch.configs.jamba_1p5_large import CONFIG as _jamba
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.kimi_k2 import CONFIG as _kimi

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c
    for c in (_mamba2, _minicpm, _starcoder2, _glm4, _llama3, _internvl2,
              _jamba, _musicgen, _mixtral, _kimi)
}

ARCH_NAMES = tuple(REGISTRY.keys())


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config: runs a forward/train step on CPU."""
    full = get_config(name)
    moe = full.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=min(4, moe.num_experts),
                                  top_k=min(2, moe.top_k), d_ff_expert=64)
    ssm = full.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, state_dim=16, head_dim=16,
                                  chunk_size=32)
    period = full.hybrid_period
    n_layers = max(4, period) if period else 4
    return dataclasses.replace(
        full,
        num_layers=n_layers,
        d_model=64,
        num_heads=4 if full.num_heads else 0,
        kv_heads=min(max(full.kv_heads, 0), 2) if full.num_heads else 0,
        head_dim=16 if full.num_heads else 0,
        d_ff=96 if full.d_ff else 0,
        vocab_size=128,
        frontend_embeds=min(full.frontend_embeds, 8),
        moe=moe,
        ssm=ssm,
        hybrid_attn_index=min(full.hybrid_attn_index, n_layers - 1),
        residual_scale=full.residual_scale if full.residual_scale != 1.0
        else 1.0,
        param_dtype="float32",
        compute_dtype="float32",
    )


def get_shape(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


__all__ = [
    "REGISTRY", "ARCH_NAMES", "get_config", "get_smoke_config", "get_shape",
    "ArchConfig", "MoEConfig", "SSMConfig", "ShapeSpec",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K", "ALL_SHAPES",
]
