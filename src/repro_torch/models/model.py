"""Composable decoder LM covering all 10 assigned architectures.

The layer stack is a repeating *pattern* of ``period`` sub-layers (period
1 for homogeneous archs, 8 for Jamba's 1:7 attention:mamba interleave),
applied ``n_super = L / period`` times.  The JAX package stacks each
pattern position's parameters over the superblocks and scans them; here
each superblock ``j`` is a submodule and the scan is a loop.  Parameter
names follow the reference's tree: ``blocks.<j>.pos<i>.attn.wq`` is slice
``j`` of the reference's leaf ``blocks/pos<i>/attn/wq``, so
``params_from_reference`` / ``params_to_reference`` carry weights across
mechanically.

The serving cache keeps the reference's stacked layout,
``{pos<i>: {k, v} | {ssm, conv_x, conv_B, conv_C}}`` with a leading
``n_super`` axis.  ``decode_step`` writes it in place (the reference's
``donate_argnums``) and returns it.

Sharding: under a ``ShardCtx`` (``models.sharding``) every parameter is a
DTensor on the context's mesh, placed by the reference's partition specs
(a block parameter takes its stacked leaf's spec without the leading
superblock dim), and the training forward constrains the activations to
the data axes at each superblock, as the reference does.  A vocab-sharded
embedding is looked up by ``VocabParallelEmbed``.  Ops that mix a DTensor
with a plain tensor (positions, masks, rope tables) run under
``sharded_scope``, which treats the plain tensor as replicated; the
train step holds it over the forward and the backward.

Remat: under ``remat_policy="nothing_saveable"`` (the reference's
baseline) each superblock of the training forward runs under
``torch.utils.checkpoint``, so backward keeps only the superblocks'
inputs and recomputes the rest; ``"everything_saveable"`` keeps every
activation.  ``"dots_saveable"`` and ``"dots_with_no_batch_dims_saveable"``
(and JAX's aliases ``checkpoint_dots``, ``checkpoint_dots_with_no_batch_dims``)
checkpoint each superblock selectively
(``create_selective_checkpoint_contexts``): the results of ``mm``,
``addmm``, ``bmm`` and ``baddbmm``, or only of ``mm`` and ``addmm`` (the
projections; the attention and MoE products have batch dims), are saved
and the rest recomputed.  Inside a query-block checkpoint of attention
nothing is saved, as in the reference, whose inner ``jax.checkpoint`` is
``nothing_saveable``.  Serving (``prefill``, ``decode_step``) runs under
``serving_mode()`` (``torch.inference_mode``; ``torch.no_grad`` under a
ctx) and saves nothing either way.  Under a ctx the serving cache is a
set of DTensors placed by ``cache_pspecs``: the KV slots are sharded over
the model axis, and decode attention combines each rank's slots over the
model group (``_decode_sharded``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import stacked
from repro_torch.models.sharding import (P, Reduced, ShardCtx, block_spec,
                                         cache_spec, constrain, local_shard,
                                         param_spec, param_specs, placements)

Pytree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

_aten = torch.ops.aten
# remat policies of the training forward (``jax.checkpoint_policies``
# names) that save products: the ops whose results each keeps
_SAVED_PRODUCTS = {
    "dots_saveable": {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm},
    "dots_with_no_batch_dims_saveable": {_aten.mm, _aten.addmm},
}
_ALIASES = {"checkpoint_dots": "dots_saveable",
            "checkpoint_dots_with_no_batch_dims":
            "dots_with_no_batch_dims_saveable"}
REMAT_POLICIES = ("nothing_saveable", "everything_saveable",
                  *_SAVED_PRODUCTS, *_ALIASES)
# ``jax.checkpoint_policies`` entries that build a policy from arguments
# (names, offload memories, two policies), which a name alone cannot give
_POLICIES_WITH_ARGUMENTS = ("offload_dot_with_no_batch_dims",
                            "save_and_offload_only_these_names",
                            "save_any_names_but_these",
                            "save_anything_except_these_names",
                            "save_from_both_policies",
                            "save_only_these_names")


def _check_remat_policy(name: str) -> str:
    """The policy ``name`` stands for (an alias resolved); raises on a
    policy that takes arguments and on an unknown name."""
    if name in _POLICIES_WITH_ARGUMENTS:
        raise ValueError(f"remat policy {name!r} takes arguments (names, "
                         f"offload memories or policies), which a policy "
                         f"name cannot give; use one of {REMAT_POLICIES}")
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; known: "
                         f"{REMAT_POLICIES}")
    return _ALIASES.get(name, name)


def _selective_remat(saved: set):
    """``context_fn`` of a superblock's checkpoint that saves the results
    of the ops in ``saved`` and recomputes everything else, saving
    nothing inside a query-block checkpoint."""
    def policy(ctx, op, *args, **kwargs):
        if op.overloadpacket in saved and not L.in_inner_remat():
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return lambda: create_selective_checkpoint_contexts(policy)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Without a card, a CUDA device raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


class Params(nn.Module):
    """A group of parameters named as in the reference's tree; indexable
    by name (``p["wq"]``) like the reference's dicts."""

    def __init__(self, shapes: dict, dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            if isinstance(shape, dict):
                self.add_module(name, Params(shape, dtype, device))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device)))

    def __getitem__(self, name: str):
        return getattr(self, name)


def _heads_in(x, w):
    """The reference's ``einsum("bsd,dhe->bshe", x, w)``: one product of
    x [B, S, d] and w [d, H, hd] taken as [d, H * hd].  Written as a
    matrix product so that a DTensor sharded over the batch and the heads
    only ever merges dims whose leading one is the sharded one."""
    out = x @ w.to(x.dtype).flatten(1)
    return out.unflatten(-1, w.shape[1:])


def _heads_out(o, w):
    """The reference's ``einsum("bshe,hed->bsd", o, w)``: o [B, S, H, hd]
    taken as [B, S, H * hd] against w [H, hd, d] as [H * hd, d]."""
    return o.flatten(2) @ w.to(o.dtype).flatten(0, 1)


class VocabParallelEmbed(torch.autograd.Function):
    """Embedding lookup of a table sharded by rows (the vocab) over one
    process group: each rank looks up the ids in its own rows, zeros the
    rest, and the group sums the results.  Backward adds the output's
    grad into this rank's rows only (the output's grad is the same on
    every rank of the group, so no collective).  On plain (local)
    tensors: ``ids`` any shape, ``table`` this rank's ``[V / n, d]``
    rows, ``start`` its first row's id."""

    @staticmethod
    def forward(ctx, ids, table, start: int, group):
        local = ids - start
        hit = (local >= 0) & (local < table.shape[0])
        local = torch.where(hit, local, 0)
        out = nn.functional.embedding(local, table) * hit[..., None]
        dist.all_reduce(out, group=group)
        ctx.save_for_backward(local, hit)
        ctx.rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad):
        local, hit = ctx.saved_tensors
        d = grad.shape[-1]
        g = (grad * hit[..., None]).reshape(-1, d)
        dtable = torch.zeros((ctx.rows, d), dtype=grad.dtype,
                             device=grad.device)
        dtable.index_add_(0, local.reshape(-1), g)
        return None, dtable, None, None


class _RegionInput(torch.autograd.Function):
    """Megatron's f at the start of a tensor-parallel region: identity
    forward; backward places the grad as the activations are placed
    (``placements``), all-reducing the partial sums over 'model' that the
    region's sharded products leave."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


class LMModel(nn.Module):
    def __init__(self, cfg: ArchConfig, attn_score_dtype: str = "float32",
                 device="cuda", remat_policy: str = "nothing_saveable", *,
                 ctx: Optional[ShardCtx] = None):
        super().__init__()
        policy = _check_remat_policy(remat_policy)
        dev = resolve_device(device)
        self.cfg = cfg
        self.ctx = ctx
        self.remat_policy = remat_policy
        self._remat_saved = _SAVED_PRODUCTS.get(policy)
        self._remat = policy != "everything_saveable"
        self.score_dtype = _DTYPES[attn_score_dtype]
        # MHA head counts that do not divide the model axis replicate
        # attention under the baseline rules; with ctx.uneven, H (and K,
        # MHA only) are padded to the next multiple of the axis, in the
        # parameter shapes themselves, as the reference does
        ms = ctx.model_size if ctx is not None else 1
        H, K = cfg.num_heads, cfg.kv_heads
        if ctx is not None and ctx.uneven and H and H == K and H % ms:
            H = K = -(-H // ms) * ms
        self.n_heads = H
        self.n_kv = K
        period = cfg.hybrid_period
        if not period:
            period = 2 if (cfg.moe and cfg.moe.layer_pattern == "every_2") \
                else 1
        assert cfg.num_layers % period == 0, (cfg.num_layers, period)
        self.period = period
        self.n_super = cfg.num_layers // period
        self.kinds = []
        for i in range(period):
            mixer = "attn" if cfg._layer_is_attn(i) else "ssm"
            if cfg.moe is not None and cfg._layer_is_moe(i):
                ffn = "moe"
            elif cfg.d_ff > 0:
                ffn = "dense"
            else:
                ffn = None
            self.kinds.append((mixer, ffn))
        self.pdt = _DTYPES[cfg.param_dtype]
        self.cdt = _DTYPES[cfg.compute_dtype]

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=self.pdt,
                                            device=dev))
        self.embed = param((cfg.vocab_size, cfg.d_model))
        self.final_norm = param((cfg.d_model,))
        if not cfg.tie_embeddings:
            self.head = param((cfg.d_model, cfg.vocab_size))
        block = {f"pos{i}": self._sublayer_shapes(*kind)
                 for i, kind in enumerate(self.kinds)}
        self.blocks = nn.ModuleList(
            [Params(block, self.pdt, dev) for _ in range(self.n_super)])
        if ctx is not None:
            self._distribute()

    def _distribute(self):
        """Every parameter as a DTensor on the context's mesh, placed by
        its reference leaf's spec; each rank keeps its own shard of the
        (not yet set) tensor, with no collective."""
        ctx = self.ctx
        for name, prm in list(self.named_parameters()):
            parts = name.split(".")
            if parts[0] == "blocks":
                path, shape = ("blocks", *parts[2:]), (self.n_super,
                                                       *prm.shape)
            else:
                path, shape = tuple(parts), tuple(prm.shape)
            spec = param_spec(path, shape, self.cfg, ctx.model_size,
                              uneven=ctx.uneven)
            if parts[0] == "blocks":
                spec = block_spec(spec)
            owner = self.get_submodule(".".join(parts[:-1]))
            owner.register_parameter(parts[-1], nn.Parameter(
                distribute_tensor(prm.detach(), ctx.mesh,
                                  placements(spec, ctx.mesh),
                                  src_data_rank=None)))

    def sharded_scope(self):
        """A context in which ops may mix this model's DTensors with plain
        tensors, which count as replicated (nothing without a ctx).  Hold
        it over a forward and its backward."""
        return implicit_replication() if self.ctx is not None \
            else contextlib.nullcontext()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    # parameter shapes / init
    # ------------------------------------------------------------------
    def _sublayer_shapes(self, mixer: str, ffn: Optional[str]) -> dict:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        out: Dict[str, Any] = {"norm1": (d,)}
        if mixer == "attn":
            out["attn"] = {
                "wq": (d, self.n_heads, hd),
                "wk": (d, self.n_kv, hd),
                "wv": (d, self.n_kv, hd),
                "wo": (self.n_heads, hd, d),
            }
        else:
            out["ssm"] = ssm_lib.ssm_param_shapes(d, cfg.ssm)
        if ffn == "dense":
            out["norm2"] = (d,)
            out["mlp"] = L.mlp_param_shapes(d, cfg.d_ff, cfg.mlp_type)
        elif ffn == "moe":
            out["norm2"] = (d,)
            out["moe"] = moe_lib.moe_param_shapes(d, cfg.moe, cfg.mlp_type)
        return out

    def param_shapes(self) -> Pytree:
        """The reference's parameter tree of shapes: block leaves stacked
        over the ``n_super`` superblocks.  Every leaf has dtype ``pdt``."""
        cfg = self.cfg
        shapes: Dict[str, Any] = {
            "embed": (cfg.vocab_size, cfg.d_model),
            "final_norm": (cfg.d_model,),
            "blocks": {},
        }
        if not cfg.tie_embeddings:
            shapes["head"] = (cfg.d_model, cfg.vocab_size)
        for i, (mixer, ffn) in enumerate(self.kinds):
            sub = self._sublayer_shapes(mixer, ffn)
            shapes["blocks"][f"pos{i}"] = compat.tree_map(
                lambda s: (self.n_super, *s), sub,
                is_leaf=lambda s: isinstance(s, tuple))
        return shapes

    def param_pspecs(self) -> Pytree:
        """The reference's partition specs of its (stacked) parameter
        tree."""
        assert self.ctx is not None
        return param_specs(self.cfg, self.param_shapes(), self.ctx)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None):
        """Random weights by the reference's per-leaf rules (ones for the
        norms and D, zeros for the conv biases, Mamba-2's A_log and dt_bias
        draws, normal with std 0.02 for embed/head and 1/sqrt(d)
        elsewhere), drawn
        from ``generator`` (on the parameters' device; seed 0 if None).
        The values differ from ``jax.random``'s: carry the reference's
        own weights with ``params_from_reference``."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        d = self.cfg.d_model
        for path, prm in self.named_parameters():
            name = path.rsplit(".", 1)[-1]
            shape, dev = prm.shape, prm.device

            def draw(fn):
                return fn(shape, generator=generator, device=dev,
                          dtype=torch.float32)
            if name in ("norm1", "norm2", "final_norm", "gate_norm", "D"):
                prm.fill_(1.0)
            elif name in ("conv_x_b", "conv_B_b", "conv_C_b"):
                prm.zero_()
            elif name == "A_log":
                u = draw(torch.rand) * 15.0 + 1.0              # U(1, 16)
                stacked.assign(prm, torch.log(u))
            elif name == "dt_bias":
                lo, hi = math.log(1e-3), math.log(1e-1)
                dt = torch.exp(draw(torch.rand) * (hi - lo) + lo)
                stacked.assign(prm, dt + torch.log(-torch.expm1(-dt)))
            else:
                scale = 0.02 if name in ("embed", "head") \
                    else 1.0 / math.sqrt(d)
                stacked.assign(prm, draw(torch.randn) * scale)
        return self

    # ------------------------------------------------------------------
    # forward components
    # ------------------------------------------------------------------
    def _qkv(self, p, x, positions):
        cfg = self.cfg
        q, k, v = (_heads_in(x, p[n]) for n in ("wq", "wk", "wv"))
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _attend(self, q, k, v, positions):
        """``gqa_attention`` of q [B, S, H, hd] against k, v.  On DTensors
        each rank attends its own rows and heads on its local shards: rows
        are independent, and so are heads where q's and k's heads are both
        split evenly (a GQA group stays on one rank).  Where q's heads are
        split evenly and k's are whole (fewer KV heads than the axis), each
        rank takes the KV heads its own query heads read, when its heads
        are whole groups or lie in one group; otherwise the heads are
        gathered whole over that mesh dim first."""
        cfg = self.cfg

        def attend(q, k, v):
            return L.gqa_attention(q, k, v, positions, positions,
                                   swa_window=cfg.swa_window,
                                   softcap=cfg.attn_logit_softcap,
                                   score_dtype=self.score_dtype)
        if not isinstance(q, DTensor):
            return attend(q, k, v)
        mesh = q.device_mesh
        H, K = q.shape[2], k.shape[2]
        G = H // K
        want_q, want_k, grad_k, picks = [], [], [], []
        for i, (p, pk) in enumerate(zip(q.placements, k.placements)):
            n = mesh.size(i)
            if p == Shard(0):
                want_q.append(p), want_k.append(p), grad_k.append(p)
            elif p == pk == Shard(2) and H % n == K % n == 0:
                want_q.append(p), want_k.append(p), grad_k.append(p)
            elif p == Shard(2) and H % n == 0 and (
                    (H // n) % G == 0 or G % (H // n) == 0):
                # this rank's query heads read KV heads [a, a + c) of the
                # whole k, v; their grads are this rank's part of a sum
                h = H // n
                picks.append(((mesh.get_local_rank(i) * h) // G,
                              max(h // G, 1)))
                want_q.append(p), want_k.append(Replicate())
                grad_k.append(Partial())
            else:
                want_q.append(Replicate()), want_k.append(Replicate())
                grad_k.append(Replicate())
        ql = local_shard(q, want_q)
        kl, vl = (local_shard(t, want_k, grad_k) for t in (k, v))
        if picks:
            (a, c), = picks
            kl, vl = kl[:, :, a:a + c], vl[:, :, a:a + c]
        return DTensor.from_local(attend(ql, kl, vl), mesh, want_q)

    def _attend_own_heads(self, p, x, positions):
        """Attention of the training forward where the query heads are
        split evenly over the model axis and the KV heads are too few to
        split (their weights replicated): each rank projects its own rows
        onto its own query heads and only the KV heads those read, on
        local shards, as XLA's partitioner does.  Returns the output as a
        DTensor (rows and query heads sharded), or None where another
        layout applies."""
        mesh = x.device_mesh
        wq, wk = p["wq"], p["wk"]
        m = mesh.mesh_dim_names.index(self.ctx.model_axis)
        H, K = wq.shape[1], wk.shape[1]
        n, G = mesh.size(m), H // K
        if wq.placements[m] != Shard(1) or wk.placements[m] != Replicate() \
                or H % n or not ((H // n) % G == 0 or G % (H // n) == 0):
            return None
        h = H // n
        a = (mesh.get_local_rank(m) * h) // G
        kv = slice(a, a + max(h // G, 1))
        rows = [Replicate() if i == m else pl
                for i, pl in enumerate(x.placements)]
        shards_rows = [isinstance(pl, Shard) for pl in rows]
        # x is whole over 'model' and each rank's q, k, v read it: its grad
        # is a partial sum there; a weight's grad comes from this rank's
        # rows (partial over the row axes) and, for the KV weights that
        # every rank slices differently, partial over 'model' too
        xl = local_shard(x, rows, [Partial() if i == m else pl
                                   for i, pl in enumerate(rows)])

        def weight(w):
            return local_shard(w, w.placements, [
                Partial() if r or (i == m and w.placements[m] == Replicate())
                else pl for i, (r, pl) in enumerate(zip(shards_rows,
                                                        w.placements))])
        ql = _heads_in(xl, weight(wq))
        kl = _heads_in(xl, weight(wk)[:, kv])
        vl = _heads_in(xl, weight(p["wv"])[:, kv])
        cfg = self.cfg
        ql = L.apply_rope(ql, positions, cfg.rope_theta)
        kl = L.apply_rope(kl, positions, cfg.rope_theta)
        o = L.gqa_attention(ql, kl, vl, positions, positions,
                            swa_window=cfg.swa_window,
                            softcap=cfg.attn_logit_softcap,
                            score_dtype=self.score_dtype)
        return DTensor.from_local(o, mesh, [Shard(2) if i == m else pl
                                            for i, pl in enumerate(rows)])

    def _attention_full(self, p, x, positions, want_cache: bool,
                        capacity: int = 0):
        if not want_cache and isinstance(x, DTensor):
            o = self._attend_own_heads(p, x, positions)
            if o is not None:
                return _heads_out(o, p["wo"]), None
        q, k, v = self._qkv(p, x, positions)
        o = self._attend(q, k, v, positions)
        out = _heads_out(o, p["wo"])
        if not want_cache:
            return out, None
        S = x.shape[1]
        C = capacity
        if C <= S:                       # ring (SWA) or exact-fit cache
            k_c = torch.roll(k[:, S - C:], S % C, dims=1)
            v_c = torch.roll(v[:, S - C:], S % C, dims=1)
        else:
            pad = torch.zeros((k.shape[0], C - S, *k.shape[2:]),
                              dtype=k.dtype, device=k.device)
            k_c, v_c = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
        return out, {"k": k_c, "v": v_c}

    def _attention_decode(self, p, x, cache: dict, pos: torch.Tensor):
        """pos: 0-d, or [B] for ragged continuous batching (per-slot
        positions).  Writes the new k, v into ``cache`` in place."""
        cfg = self.cfg
        ragged = pos.ndim == 1
        k_c, v_c = cache["k"], cache["v"]
        posv = pos[:, None] if ragged else pos.reshape(1)
        q, k, v = self._qkv(p, x, posv)
        if isinstance(k_c, DTensor):
            return _heads_out(self._decode_sharded(q, k, v, k_c, v_c, pos),
                              p["wo"])
        C = k_c.shape[1]
        slots = torch.arange(C, dtype=torch.int64, device=x.device)
        slot = pos % C
        if ragged:
            rows = torch.arange(x.shape[0], device=x.device)
            k_c[rows, slot] = k[:, 0].to(k_c.dtype)
            v_c[rows, slot] = v[:, 0].to(v_c.dtype)
        else:
            k_c.index_copy_(1, slot.reshape(1), k.to(k_c.dtype))
            v_c.index_copy_(1, slot.reshape(1), v.to(v_c.dtype))
        o = L.decode_attention(q, k_c, v_c, self._slot_positions(slots, pos,
                                                                 C), pos,
                               softcap=cfg.attn_logit_softcap)
        return _heads_out(o, p["wo"])

    def _slot_positions(self, slots, pos, C: int):
        """The absolute position each cache slot in ``slots`` holds: the
        slot itself, or on a ring (SWA) cache the latest position that
        maps to it."""
        cfg = self.cfg
        if cfg.swa_window and cfg.swa_window == C:
            p_ = pos[:, None] if pos.ndim == 1 else pos
            return p_ - ((p_ - slots) % C)
        return slots

    def _decode_sharded(self, q, k, v, k_c, v_c, pos):
        """Decode attention against a KV cache whose slots are sharded over
        the model axis (``cache_pspecs``, the flash-decoding layout).  Each
        rank holds its batch rows' share of the slots: the new k, v are
        written by the rank whose slot range holds ``pos % C``, into its
        own shard, and attention runs over the local slots, combined over
        the model group (``decode_attention``'s ``group``).  Returns the
        attention output as a DTensor of the batch rows, every head
        whole."""
        mesh = k_c.device_mesh
        m = mesh.mesh_dim_names.index(self.ctx.model_axis)
        rows = [Replicate() if i == m else pl
                for i, pl in enumerate(k_c.placements)]
        ql, kl, vl = (t.redistribute(mesh, rows).to_local()
                      for t in (q, k, v))
        kc, vc = k_c.to_local(), v_c.to_local()
        C, Cl = k_c.shape[1], kc.shape[1]
        n, r = mesh.size(m), mesh.get_local_rank(m)
        off = min(r * -(-C // n), C)        # torch.chunk's split of C
        if pos.ndim == 1:                   # this rank's rows' positions
            pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim
                                     ).redistribute(mesh, rows).to_local()
        local = pos % C - off
        inside = (local >= 0) & (local < Cl)
        idx = torch.where(inside, local, 0)
        for cache, new in ((kc, kl), (vc, vl)):
            new = new.to(cache.dtype)
            if pos.ndim == 1:
                b = torch.arange(cache.shape[0], device=cache.device)
                cache[b, idx] = torch.where(inside[:, None, None], new[:, 0],
                                            cache[b, idx])
            else:
                at = idx.reshape(1)
                cache.index_copy_(1, at, torch.where(
                    inside, new, cache.index_select(1, at)))
        slots = off + torch.arange(Cl, dtype=torch.int64, device=kc.device)
        o = L.decode_attention(ql, kc, vc, self._slot_positions(slots, pos, C),
                               pos, softcap=self.cfg.attn_logit_softcap,
                               group=mesh.get_group(m))
        return DTensor.from_local(o, mesh, rows)

    def _sublayer(self, p, x, kind, positions, mode: str, cache=None,
                  pos=None, capacity: int = 0):
        cfg = self.cfg
        mixer, ffn = kind
        h = self._region(_RegionInput,
                         L.rms_norm(x, p["norm1"], cfg.norm_eps))
        new_cache = None
        if mixer == "attn":
            if mode == "decode":
                a = self._attention_decode(p["attn"], h, cache, pos)
            else:
                a, new_cache = self._attention_full(
                    p["attn"], h, positions, want_cache=(mode == "prefill"),
                    capacity=capacity)
        else:
            if mode == "decode":
                a, new_cache = ssm_lib.ssm_decode_step(h, cache, p["ssm"],
                                                       cfg.d_model, cfg.ssm)
            elif mode == "prefill":
                a, new_cache = ssm_lib.ssm_forward(h, p["ssm"], cfg.d_model,
                                                   cfg.ssm,
                                                   return_state=True)
            else:
                a = ssm_lib.ssm_forward(h, p["ssm"], cfg.d_model, cfg.ssm)
        # the residual stream keeps the activations' layout: a mixer's or
        # an FFN's partial sums over 'model' are all-reduced (Megatron's
        # layout; DTensor's own choice may scatter them over 'model')
        x = x + cfg.residual_scale * self._region(Reduced, a)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if ffn is not None:
            h = self._region(_RegionInput,
                             L.rms_norm(x, p["norm2"], cfg.norm_eps))
            if ffn == "moe":
                y, aux = moe_lib.moe_mlp(h, p["moe"], cfg.moe, cfg.mlp_type)
            else:
                y = L.mlp(h, p["mlp"], cfg.mlp_type)
            x = x + cfg.residual_scale * self._region(Reduced, y)
        return x, aux, new_cache

    def _lookup(self, tokens):
        """The embedding rows of ``tokens``.  A table sharded by vocab over
        the model axis goes through ``VocabParallelEmbed`` (DTensor's own
        rule for a row-sharded table and data-sharded ids fails); the
        result is sharded like ``tokens`` and replicated over the model
        axis."""
        emb = self.embed
        if not isinstance(emb, DTensor):
            return torch.nn.functional.embedding(tokens, emb)
        mesh, axis = self.ctx.mesh, self.ctx.model_axis
        m = mesh.mesh_dim_names.index(axis)
        if emb.placements[m] != Shard(0):
            return torch.nn.functional.embedding(tokens, emb)
        if not isinstance(tokens, DTensor):
            tokens = DTensor.from_local(tokens, mesh,
                                        [Replicate()] * mesh.ndim)
        # this rank's rows get the grads of this rank's ids only: partial
        # over every mesh dim that shards the ids
        table = emb.to_local(grad_placements=[
            Partial() if i != m and isinstance(t, Shard) else p
            for i, (p, t) in enumerate(zip(emb.placements,
                                            tokens.placements))])
        rows = table.shape[0]
        out = VocabParallelEmbed.apply(tokens.to_local(), table,
                                       mesh.get_local_rank(axis) * rows,
                                       mesh.get_group(axis))
        return DTensor.from_local(out, mesh, [
            Replicate() if i == m else p
            for i, p in enumerate(tokens.placements)])

    def _embed(self, tokens, embeds):
        cfg = self.cfg
        x = self._lookup(tokens).to(self.cdt)
        x = x * cfg.embed_scale
        if embeds is not None:
            x = torch.cat([embeds.to(self.cdt), x], dim=1)
        return x

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.head

    def _unembed(self, x):
        head = self.unembed_matrix()
        logits = (x @ head.to(x.dtype)).float()
        return logits * self.cfg.logit_scale

    # ------------------------------------------------------------------
    # full-sequence forward
    # ------------------------------------------------------------------
    def _constrain_act(self, x):
        """Under a ctx, the activations' batch sharded over the data axes
        and replicated over the model axis."""
        if self.ctx is None or x.shape[0] == 1:
            return x
        dp = self.ctx.dp_axes
        return constrain(x, self.ctx, dp if len(dp) > 1 else dp[0], None,
                         None)

    def _region(self, fn, h):
        """``h`` through a region boundary (``_RegionInput`` or
        ``Reduced``) to the activations' layout under a ctx; without
        grad simply redistributed.  A model axis of one rank has no
        partial sums to reduce, and the boundary is left out."""
        if self.ctx is None or not isinstance(h, DTensor) \
                or h.shape[0] == 1 or self.ctx.model_size == 1:
            return h
        if not torch.is_grad_enabled():
            return self._constrain_act(h) if fn is Reduced else h
        dp = self.ctx.dp_axes
        return fn.apply(h, self.ctx.named(dp if len(dp) > 1 else dp[0],
                                          None, None))

    def _superblock(self, blk, x, aux, positions):
        x = self._constrain_act(x)
        for i, kind in enumerate(self.kinds):
            x, a, _ = self._sublayer(blk[f"pos{i}"], x, kind, positions,
                                     mode="train")
            aux = aux + a
        return x, aux

    def forward(self, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None,
                return_hidden: bool = False):
        """tokens: [B, S_text]; embeds: [B, F, d] (VLM stub) or None.
        Returns (logits [B, S, V] fp32, aux_loss scalar); with
        ``return_hidden`` the final-normed hidden states instead of
        logits."""
        x = self._embed(tokens, embeds)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self._remat and torch.is_grad_enabled()
        extra = {} if self._remat_saved is None else \
            {"context_fn": _selective_remat(self._remat_saved)}
        for blk in self.blocks:
            if remat:
                x, aux = checkpoint(self._superblock, blk, x, aux, positions,
                                    use_reentrant=False, **extra)
            else:
                x, aux = self._superblock(blk, x, aux, positions)
        # the final norm and the head see the activations' own layout
        # (DTensor may otherwise leave the residual sharded over 'model'
        # by d, and the head's product partial)
        x = self._constrain_act(x)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if return_hidden:
            return x, aux
        return self._unembed(x), aux

    # ------------------------------------------------------------------
    # prefill / decode (serving)
    # ------------------------------------------------------------------
    def capacity_for(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.swa_window:
            return min(cfg.swa_window, seq_len)
        return seq_len

    def serving_mode(self):
        """The context serving runs in: ``torch.inference_mode``, or under
        a ctx ``torch.no_grad`` with ``sharded_scope`` (DTensor's views
        under inference mode take the global sizes for the local ones)."""
        if self.ctx is None:
            return torch.inference_mode()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        stack.enter_context(self.sharded_scope())
        return stack

    def prefill(self, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None,
                capacity: Optional[int] = None):
        """Returns (cache, last-position logits [B, V]).  Under a ctx the
        cache is placed by ``cache_pspecs``."""
        with self.serving_mode():
            return self._prefill(tokens, embeds, capacity)

    def _prefill(self, tokens, embeds, capacity):
        x = self._embed(tokens, embeds)
        S = x.shape[1]
        capacity = capacity or self.capacity_for(S)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        per_block = []
        for blk in self.blocks:
            x = self._constrain_act(x)
            caches = {}
            for i, kind in enumerate(self.kinds):
                x, _, c = self._sublayer(blk[f"pos{i}"], x, kind, positions,
                                         mode="prefill", capacity=capacity)
                caches[f"pos{i}"] = c
            per_block.append(caches)
        cache = {key: {name: torch.stack([c[key][name] for c in per_block])
                       for name in per_block[0][key]}
                 for key in per_block[0]}
        if self.ctx is not None:
            specs = self.cache_pspecs(x.shape[0])
            cache = {key: {name: constrain(t, self.ctx, *specs[key][name])
                           for name, t in layer.items()}
                     for key, layer in cache.items()}
        x = L.rms_norm(x[:, -1:], self.final_norm, self.cfg.norm_eps)
        logits = self._unembed(x)[:, 0]
        return cache, logits

    def decode_step(self, cache: Pytree, tokens: torch.Tensor, pos):
        """tokens: [B, 1]; pos: the absolute position of the new token, a
        scalar or a [B] vector (ragged).  Writes ``cache`` in place and
        returns (cache, logits [B, V]).  An SSM conv tail whose new value
        has a wider dtype than the cache (f32 compute on a bf16 cache)
        replaces its stacked tensor with the wider one, as the reference's
        scan output does.  Under a ctx the cache is placed by
        ``cache_pspecs`` (as ``prefill`` leaves it)."""
        with self.serving_mode():
            return self._decode_step(cache, tokens, pos)

    def _decode_step(self, cache, tokens, pos):
        x = self._embed(tokens, None)
        pos = pos.to(x.device).long() if isinstance(pos, torch.Tensor) \
            else torch.full((), pos, dtype=torch.long, device=x.device)
        for j, blk in enumerate(self.blocks):
            for i, kind in enumerate(self.kinds):
                stack = cache[f"pos{i}"]
                layer = {name: t[j] for name, t in stack.items()}
                x, _, new = self._sublayer(blk[f"pos{i}"], x, kind, None,
                                           mode="decode", cache=layer,
                                           pos=pos)
                for name, t in (new or {}).items():
                    if stack[name].dtype != t.dtype:
                        stack[name] = stack[name].to(t.dtype)
                    stack[name][j].copy_(t)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = self._unembed(x)[:, 0]
        return cache, logits

    # ------------------------------------------------------------------
    # cache shapes
    # ------------------------------------------------------------------
    def cache_shapes(self, batch: int, seq_len: int) -> Pytree:
        """{pos<i>: {name: (shape, dtype)}}, stacked over superblocks; the
        KV cache is bf16, as in the reference."""
        cfg = self.cfg
        capacity = self.capacity_for(seq_len)
        hd = cfg.resolved_head_dim
        out = {}
        for i, (mixer, _) in enumerate(self.kinds):
            if mixer == "attn":
                kv = ((self.n_super, batch, capacity, self.n_kv, hd),
                      torch.bfloat16)
                out[f"pos{i}"] = {"k": kv, "v": kv}
            else:
                st = ssm_lib.ssm_state_shapes(batch, cfg.d_model, cfg.ssm)
                out[f"pos{i}"] = {k: ((self.n_super, *shape), dt)
                                  for k, (shape, dt) in st.items()}
        return out

    def cache_pspecs(self, batch: int) -> Pytree:
        """The reference's partition specs of the stacked cache."""
        ctx = self.ctx
        assert ctx is not None

        def stack(spec: P) -> P:
            return P(None, *spec)

        out = {}
        for i, (mixer, _) in enumerate(self.kinds):
            if mixer == "attn":
                s = stack(cache_spec("kv", ctx, batch))
                out[f"pos{i}"] = {"k": s, "v": s}
            else:
                out[f"pos{i}"] = {
                    "ssm": stack(cache_spec("ssm", ctx, batch)),
                    "conv_x": stack(cache_spec("conv", ctx, batch)),
                    "conv_B": stack(cache_spec("conv", ctx, batch)),
                    "conv_C": stack(cache_spec("conv", ctx, batch)),
                }
        return out


def build_model(cfg: ArchConfig, attn_score_dtype: str = "float32",
                device="cuda", remat_policy: str = "nothing_saveable", *,
                ctx: Optional[ShardCtx] = None) -> LMModel:
    """The model with its parameters allocated on ``device`` (CUDA unless
    the caller asks for the CPU) and not yet set: call ``init`` or
    ``params_from_reference``.  Under ``ctx`` the parameters are DTensors
    on its mesh (``device`` is then the mesh's device type)."""
    return LMModel(cfg, attn_score_dtype, device, remat_policy, ctx=ctx)


# --------------------------------------------------------------------------
# weights carried across from / to the JAX package's parameter tree
# --------------------------------------------------------------------------
def _ref_leaves(model: LMModel):
    """(reference path, [parameters]) for every leaf of the reference's
    tree: one parameter for a top-level leaf, one per superblock for a
    stacked block leaf."""
    out = []
    for path, _ in compat.tree_flatten_with_path(
            model.param_shapes(),
            is_leaf=lambda s: isinstance(s, tuple))[0]:
        keys = tuple(k.key for k in path)
        if keys[0] == "blocks":
            prms = []
            for blk in model.blocks:
                node = blk
                for k in keys[1:]:
                    node = node[k]
                prms.append(node)
            out.append((keys, prms))
        else:
            out.append((keys, [getattr(model, keys[0])]))
    return out


def param_tree(model: LMModel) -> Pytree:
    """The reference's parameter tree over the model's own parameters: a
    top-level leaf is its parameter, a stacked block leaf the list of its
    ``n_super`` per-superblock parameters (``models.stacked``).  The
    optimisers update it in place; ``models.stacked.stack`` gives the
    reference's stacked tensors."""
    tree: Dict[str, Any] = {}
    for keys, prms in _ref_leaves(model):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = prms if keys[0] == "blocks" else prms[0]
    return tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` as a numpy array (never a view of a parameter); a
    DTensor gathered whole."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")     # registered by ml_dtypes
        except TypeError as e:
            raise TypeError("a bf16 parameter needs numpy's bfloat16 dtype, "
                            "which ml_dtypes registers") from e
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


@torch.no_grad()
def params_from_reference(model: LMModel, tree: Pytree) -> LMModel:
    """Load the reference's ``model.init`` tree (nested dicts of numpy
    arrays, block leaves stacked over superblocks) into ``model``, cast to
    its parameter dtype.  Every leaf must be present with its shape."""
    stacked.copy_into(param_tree(model), tree)
    return model


def params_to_reference(model: LMModel) -> Pytree:
    """The reference's parameter tree (nested dicts of numpy arrays in the
    parameter dtype, block leaves stacked over superblocks)."""
    return stacked.map_leaves(_to_numpy, stacked.stack(param_tree(model)))
