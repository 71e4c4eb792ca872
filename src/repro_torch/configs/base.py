"""Architecture configuration dataclasses.

Every assigned architecture is expressed as an ``ArchConfig``, the same
dataclasses and values as the JAX package's, so a configuration names the
same model in both.  A model stack consumes only this dataclass, so adding
an architecture is a single new file in ``repro_torch/configs``.

Shape handling: each architecture carries the four assigned input shapes
(train_4k / prefill_32k / decode_32k / long_500k).  ``decode_*`` and
``long_*`` lower ``serve_step`` (one new token against a KV cache of
``seq_len``), not ``train_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # which layers are MoE: 'all', 'every_2' (odd layers dense), ...
    layer_pattern: str = "all"
    # sharding mode for the stacked expert tensor: 'expert' shards the E dim
    # on the model axis, 'ffn' shards the expert-ffn dim (for E < mesh model).
    shard_mode: str = "expert"
    num_shared_experts: int = 0
    # GShard-style per-group expert capacity factor.  Tokens overflowing an
    # expert's capacity are dropped (residual passes through) — a known
    # train/serve asymmetry of capacity-based TPU MoE (decode never drops).
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD / state-space duality) block configuration."""
    state_dim: int = 128
    head_dim: int = 64           # P in the SSD paper
    conv_width: int = 4
    expand: int = 2              # inner dim = expand * d_model
    chunk_size: int = 256        # SSD chunked-scan block length
    ngroups: int = 1             # B/C groups (GVA in mamba2)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # 'train' | 'prefill' | 'decode'


# The four assigned LM shapes (identical across the 10 archs).
TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attention-free archs
    kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # attention
    rope_theta: float = 10000.0
    swa_window: int = 0           # 0 = full attention; >0 = sliding-window
    attn_logit_softcap: float = 0.0
    # mlp
    mlp_type: str = "swiglu"      # swiglu | gelu
    # norm / embedding
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    residual_scale: float = 1.0   # MiniCPM-style depth scaling
    embed_scale: float = 1.0      # MiniCPM scale_emb
    logit_scale: float = 1.0      # MiniCPM: d_model / dim_model_base divisor
    # mixture-of-experts / state-space / hybrid
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid interleave: period and which index inside the period is attention
    # (Jamba: 1 attention per 8 layers).
    hybrid_period: int = 0        # 0 = not hybrid
    hybrid_attn_index: int = 0
    # modality frontend stub: number of prepended precomputed embeddings
    # (vlm: patch embeddings; audio: frame embeddings).  The frontend itself
    # (ViT / EnCodec) is a STUB per the assignment; input_specs() provides the
    # precomputed embeddings.
    frontend_embeds: int = 0
    # training numerics
    param_dtype: str = "float32"  # master/param dtype for training
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"      # adamw | adafactor (memory-lean for huge archs)
    lr_schedule: str = "cosine"   # cosine | wsd (MiniCPM warmup-stable-decay)
    # long_500k eligibility: sub-quadratic attention path exists
    # (SSM / hybrid / SWA archs). Pure full-attention archs skip long_500k.
    supports_long_context: bool = False
    source: str = ""              # [arXiv/hf; verification tier]

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included once if tied)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        total = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                 # lm head
        for i in range(L):
            total += d                                    # pre-mixer norm
            if self._layer_is_attn(i):
                q = d * self.num_heads * hd
                kv = 2 * d * self.kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
            else:
                total += self._ssm_params()
            total += d                                    # pre-ffn norm
            total += self._ffn_params(i)
        total += d                                        # final norm
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE counts top_k experts only)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for i in range(L):
            total += 2 * d
            if self._layer_is_attn(i):
                total += d * self.num_heads * hd + 2 * d * self.kv_heads * hd \
                    + self.num_heads * hd * d
            else:
                total += self._ssm_params()
            total += self._ffn_params(i, active=True)
        total += d
        return total

    # -- helpers -----------------------------------------------------------
    def _layer_is_attn(self, i: int) -> bool:
        if self.ssm is None:
            return True
        if self.hybrid_period:                            # hybrid (Jamba)
            return (i % self.hybrid_period) == self.hybrid_attn_index
        return False                                      # pure SSM (Mamba2)

    def _layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.layer_pattern == "all":
            return True
        if self.moe.layer_pattern == "every_2":
            return (i % 2) == 1
        raise ValueError(self.moe.layer_pattern)

    def _ffn_params(self, i: int, active: bool = False) -> int:
        d = self.d_model
        if self._layer_is_moe(i):
            m = self.moe
            n_mats = 3 if self.mlp_type == "swiglu" else 2
            per_expert = n_mats * d * m.d_ff_expert
            router = d * m.num_experts
            n_e = (m.top_k if active else m.num_experts) + m.num_shared_experts
            return router + n_e * per_expert
        if self.d_ff == 0:
            return 0                                      # attention/ssm-only
        n_mats = 3 if self.mlp_type == "swiglu" else 2
        return n_mats * d * self.d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_in = s.expand * d
        nheads = d_in // s.head_dim
        # in_proj: z, x, B, C, dt   (mamba2 fused projection)
        in_proj = d * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)
        conv = s.conv_width * (d_in + 2 * s.ngroups * s.state_dim)
        out_proj = d_in * d
        extra = 2 * nheads + d_in                         # A_log, D, gate norm
        return in_proj + conv + out_proj + extra

    def shapes(self) -> Tuple[ShapeSpec, ...]:
        out = []
        for s in ALL_SHAPES:
            if s.name == "long_500k" and not self.supports_long_context:
                continue
            out.append(s)
        return tuple(out)

    def skipped_shapes(self) -> Tuple[str, ...]:
        if self.supports_long_context:
            return ()
        return ("long_500k",)
