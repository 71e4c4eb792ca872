"""Size presets of the launch drivers: ``full`` (the published config),
``smoke`` (the reduced CPU config) and ``100m`` (about 65M parameters of
the arch's family), the same as the JAX package's ``launch/train.py``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config, get_smoke_config


def preset_config(arch: str, preset: str):
    if preset == "full":
        return get_config(arch)
    if preset == "smoke":
        return get_smoke_config(arch)
    if preset == "100m":
        cfg = get_config(arch)
        moe = cfg.moe
        if moe is not None:
            moe = dataclasses.replace(moe, num_experts=min(
                8, moe.num_experts), top_k=2, d_ff_expert=512)
        ssm = cfg.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, state_dim=64, head_dim=32)
        period = cfg.hybrid_period or 1
        return dataclasses.replace(
            cfg, num_layers=max(16 // period, 1) * period, d_model=512,
            num_heads=8 if cfg.num_heads else 0,
            kv_heads=min(cfg.kv_heads, 4) if cfg.num_heads else 0,
            head_dim=64 if cfg.num_heads else 0,
            d_ff=2048 if cfg.d_ff else 0,
            vocab_size=32768, moe=moe, ssm=ssm,
            frontend_embeds=min(cfg.frontend_embeds, 16),
            param_dtype="float32", compute_dtype="float32")
    raise ValueError(preset)
