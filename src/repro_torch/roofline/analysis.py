"""Roofline terms from dry-run records, and the offload engine's
launch-cost seeds, for one NVIDIA H100.

Hardware model: NVIDIA H100 SXM (``NVIDIA H100 80GB HBM3``), data sheet,
dense rates at its 700 W power limit —
  peak bf16 compute  989 TFLOP/s per card (tensor cores)
  HBM bandwidth      3.35 TB/s per card
  NVLink 4           900 GB/s per card, both directions together

Terms (seconds per step), on records of the JAX package's dry-run layout
(``n_devices``, ``cost``, ``collectives``, ``arch``, ``shape``, and the
optional per-device ``flops_scaled`` / ``bytes_scaled``):
  compute    = FLOPs / peak            [per device]
  memory     = bytes / HBM_bw          [per device]
  collective = per-device wire bytes / link_bw

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per processed token
count — the 'useful' fraction MODEL_FLOPS / FLOPs flags remat /
dispatch / padding waste.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

from repro_torch.configs import get_config, get_shape


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12          # bf16 dense per card
    hbm_bw: float = 3.35e12             # bytes/s per card
    link_bw: float = 450e9              # bytes/s per card, one direction


# Integer instructions per byte of hashed input that the port's CUDA
# kernels need at the least (the instruction counts of PERF.md section 6,
# keyed by engine job kind): direct MD5 324 per 64-byte compression;
# sliding-window MD5 224 per window of 48 bytes (the 61 rounds that reach
# digest word a), one window per 4 bytes at the SAI's stride 4 (4x that at
# stride 1); gear 10 per byte (mix32 of b + 1 and the recurrence's
# shift-add).  The engine seeds one cost model per key.
HASH_OPS_PER_BYTE = {"direct": 324 / 64, "sliding": 224 / 4, "gear": 10.0}

# kind -> (sec_per_byte, launch_overhead_s): the engine's launch wall time
# on an H100 as its own cost model regressed it (KernelCostModel over the
# padded staging bytes of each launch, snapshot_stats()["cost_model"]),
# printed by chip_smoke.py phase 4 after its writes and verified reads of
# four 256 MiB checkpoint images under fixed, cdc, cdc stride 1 and
# cdc-gear.  A launch wall covers staging, copies, the kernel and the pull
# of its output.  Direct launches come in many sizes (251 of them), so
# both terms are measured.  Every gear and sliding launch of phase 4
# stages one whole 256 MiB image, so the regression cannot split their
# walls: the slope stays at the start it was given (1e-9 s/B, the
# engine's static start before these seeds) and the overhead is the rest
# of the measured wall at that size.
H100_LAUNCH_COST = {
    # NVIDIA H100 80GB HBM3, 700.00 W
    "direct": (4.969651475183955e-10, 0.021558080140323087),
    # NVIDIA H100 80GB HBM3, 700.00 W
    "sliding": (1e-09, 0.7377571693457641),
    # NVIDIA H100 80GB HBM3, 700.00 W
    "gear": (1e-09, 0.4109578496879988),
}


def hash_cost_seed(kind: str) -> Dict[str, float]:
    """Seed parameters for the offload engine's launch-cost model:
    ``sec_per_byte`` and a fixed ``launch_overhead_s``, as the engine
    measured them on an H100 (``H100_LAUNCH_COST``).  The engine
    (repro_torch.core.crystal.KernelCostModel) starts every dispatch
    decision from these and replaces them with EWMA-regressed measured
    values as launches retire.  An unknown kind raises ``KeyError``."""
    sec_per_byte, overhead_s = H100_LAUNCH_COST[kind]
    return {"sec_per_byte": float(sec_per_byte),
            "launch_overhead_s": float(overhead_s)}


def model_flops(arch: str, shape_name: str) -> float:
    """6*N*D convention (N = active params, D = tokens processed)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens          # forward only
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def _layer_flops(cfg, batch: int, seq_len: int):
    """(projection and FFN FLOPs per token over all layers, causal
    attention FLOPs of ``batch`` rows of ``seq_len`` tokens), 2 per
    multiply-add; see ``prefill_flops``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_mats = 3 if cfg.mlp_type == "swiglu" else 2
    w = cfg.swa_window or seq_len
    pairs = batch * sum(min(q + 1, w) for q in range(seq_len))
    per_token = 0
    attn = 0
    for i in range(cfg.num_layers):
        if cfg._layer_is_attn(i):
            per_token += 2 * d * hd * (2 * cfg.num_heads + 2 * cfg.kv_heads)
            attn += 4 * cfg.num_heads * hd * pairs
        else:
            s = cfg.ssm
            d_in = s.expand * d
            gn = s.ngroups * s.state_dim
            per_token += 2 * d * (2 * d_in + 2 * gn + d_in // s.head_dim) \
                + 2 * d_in * d
        if cfg._layer_is_moe(i):
            m = cfg.moe
            per_token += 2 * d * m.num_experts + 2 * n_mats * d \
                * m.d_ff_expert * (m.top_k + m.num_shared_experts)
        elif cfg.d_ff:
            per_token += 2 * n_mats * d * cfg.d_ff
    return per_token, attn


def prefill_flops(cfg, batch: int, seq_len: int) -> float:
    """FLOPs a prefill of ``batch`` prompts of ``seq_len`` tokens needs at
    the least, 2 per multiply-add: every layer's projections and FFN for
    every token (MoE: the router, ``top_k`` experts and the shared ones),
    causal attention scores and P.V over the (query, key) pairs a query
    may see (key <= query, within the sliding window), and the head on the
    last position only (prefill returns last-position logits).  Mamba-2's
    SSD scan is not counted, so for SSM layers the count falls short of
    the work, and its time of the least time."""
    per_token, attn = _layer_flops(cfg, batch, seq_len)
    head = 2 * cfg.d_model * cfg.vocab_size * batch
    return float(per_token * batch * seq_len + attn + head)


def train_step_flops(cfg, batch: int, seq_len: int, remat: bool = True,
                     q_block: int = 2048, ce_chunk: int = 512) -> float:
    """FLOPs one training step of ``batch`` rows of ``seq_len`` positions
    (frontend embeddings included) needs, 2 per multiply-add.  The
    forward is ``prefill_flops``'s layers and causal attention for every
    position, and the head at every position that predicts a label
    (``seq_len - 1``, or the text tokens after a frontend); backward is
    twice the forward (a product's grads for both of its operands): 6·N·T
    for the weights.  What runs again in backward: under remat
    (``nothing_saveable``) each superblock's forward, 2·N·T more for the
    layers' weights and once more the attention; attention's query blocks
    of ``q_block`` rows, when a row is longer than one; the head's
    chunks of ``ce_chunk`` positions, when the predicting positions split
    into more than one (``train.trainstep.blocked_cross_entropy``).
    Mamba-2's scan is not counted."""
    per_token, attn = _layer_flops(cfg, batch, seq_len)
    F = cfg.frontend_embeds
    predicting = seq_len - F if F else seq_len - 1
    head = 2 * cfg.d_model * cfg.vocab_size * batch * predicting
    layers = per_token * batch * seq_len
    total = 3 * (layers + attn + head)
    if remat:
        total += layers + attn
    if seq_len > q_block:
        total += attn
    if predicting > ce_chunk and predicting % ce_chunk == 0:
        total += head
    return float(total)


def decode_weight_bytes(cfg, bytes_per_param: int) -> float:
    """Bytes of the weights one decode step of a dense or SSM model must
    read: every weight but the embedding table, of which a step reads only
    its tokens' rows (a tied table is read whole, as the head).  A MoE
    step reads only the experts its tokens chose, which this count cannot
    know, so it raises."""
    if cfg.moe is not None:
        raise ValueError(f"{cfg.name}: a MoE step's expert reads depend on "
                         f"its tokens")
    n = cfg.param_count()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model
    return float(n * bytes_per_param)


def roofline_terms(rec: dict, hw: HW = HW()) -> dict:
    """rec: one dry-run JSON record -> roofline terms in seconds.

    ``flops_scaled`` / ``bytes_scaled`` / wire bytes are PER-DEVICE, with
    loop bodies scaled by trip count; terms therefore divide by per-card
    rates only.
    """
    chips = rec["n_devices"]
    flops = rec["cost"].get("flops", 0.0)
    flops_scaled = rec.get("flops_scaled") or flops
    hbm_bytes = rec["cost"].get("bytes accessed", 0.0)
    hbm_scaled = rec.get("bytes_scaled") or hbm_bytes
    wire = rec["collectives"]["total_wire_bytes"]

    compute_s = flops_scaled / hw.peak_flops
    memory_s = hbm_scaled / hw.hbm_bw
    collective_s = wire / hw.link_bw

    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = dominant.replace("_s", "")
    step_s = max(terms.values())

    mflops = model_flops(rec["arch"], rec["shape"]) / chips  # per device
    useful = mflops / flops_scaled if flops_scaled else 0.0
    # roofline fraction: useful model FLOPs over what a card could do in
    # the bottleneck-imposed step time.
    frac = mflops / (hw.peak_flops * step_s) if step_s else 0.0
    return dict(terms, dominant=bound, step_s=step_s,
                model_flops_per_chip=mflops, hlo_flops=flops_scaled,
                useful_flops_ratio=useful, roofline_fraction=frac)


def load_records(results_dir: str, tag: str = "") -> Dict[str, dict]:
    out = {}
    if not os.path.isdir(results_dir):
        return out
    for fn in sorted(os.listdir(results_dir)):
        if not fn.endswith(".json"):
            continue
        stem = fn[:-5]
        parts = stem.split("__")
        has_tag = len(parts) == 4
        if tag and (not has_tag or parts[3] != tag):
            continue
        if not tag and has_tag:
            continue
        with open(os.path.join(results_dir, fn)) as f:
            out[stem] = json.load(f)
    return out


def format_table(records: Dict[str, dict], hw: HW = HW(),
                 mesh: Optional[str] = "single") -> str:
    rows = []
    header = (f"{'arch':24s} {'shape':12s} {'mesh':6s} "
              f"{'compute_s':>10s} {'memory_s':>10s} {'collect_s':>10s} "
              f"{'bound':>10s} {'useful':>7s} {'roofl%':>7s}")
    rows.append(header)
    rows.append("-" * len(header))
    for key, rec in sorted(records.items()):
        if mesh and rec["mesh"] != mesh:
            continue
        t = roofline_terms(rec, hw)
        rows.append(
            f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:6s} "
            f"{t['compute_s']:10.4f} {t['memory_s']:10.4f} "
            f"{t['collective_s']:10.4f} {t['dominant']:>10s} "
            f"{t['useful_flops_ratio']:7.3f} "
            f"{100*t['roofline_fraction']:6.1f}%")
    return "\n".join(rows)
