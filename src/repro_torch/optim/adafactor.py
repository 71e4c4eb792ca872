"""Adafactor: factored second moments — the memory-lean optimizer used for
the 398B (jamba) and 1T (kimi-k2) archs, where AdamW fp32 state exceeds
the device memory of a slice.

For a [.., r, c] tensor the second moment is factored into row/col means
(O(r+c) state); 0/1-D tensors keep the full accumulator.  First moment is
omitted (beta1=0, the standard memory-lean setting).

Every rule acts on the JAX package's stacked leaf (``models.stacked``):
a stacked ``[n_super, d]`` norm scale is factored, its column means run
across superblocks, and the update's RMS clip covers the whole leaf.  So
the port stacks each leaf's grads for the update; state is stacked f32.
On a model's DTensors the state is DTensors placed by ``state_spec_like``
and the update runs on them (the row and column means of a sharded dim
become partial sums that DTensor reduces where the state is written).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.models import stacked
from repro_torch.models.sharding import P, map_specs
from repro_torch.optim.schedule import _f32


class Adafactor:
    def __init__(self, lr_fn, decay=0.8, eps=1e-30, clip_threshold=1.0,
                 weight_decay=0.0):
        self.lr_fn = lr_fn
        self.decay = decay
        self.eps = eps
        self.clip = clip_threshold
        self.weight_decay = weight_decay

    @staticmethod
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(self, params):
        """f32 zeros in the reference's stacked layout.  For a leaf of
        DTensors the state is a DTensor on their mesh, placed as
        ``state_spec_like`` places it: the row state keeps the leaf's
        shardings but that of its last dim, the column state moves the
        last dim's sharding to its own last dim and drops that of the
        second to last (a 0/1-D leaf's column state is replicated)."""
        def state(leaf, shape, dims):
            t = stacked.slices(leaf)[0]
            if not isinstance(t, DTensor):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=t.device)
            shift = 1 if isinstance(leaf, list) else 0
            out = []
            for pl in t.placements:
                d = dims.get(pl.dim + shift) if isinstance(pl, Shard) \
                    else None
                out.append(Shard(d) if d is not None else Replicate())
            return dtensor_zeros(shape, dtype=torch.float32,
                                 device_mesh=t.device_mesh, placements=out)

        def vr(leaf):
            s = stacked.ref_shape(leaf)
            if not self._factored(s):
                return state(leaf, s, {i: i for i in range(len(s))})
            return state(leaf, s[:-1], {i: i for i in range(len(s) - 1)})

        def vc(leaf):
            s = stacked.ref_shape(leaf)
            if not self._factored(s):
                return state(leaf, (1,), {})
            dims = {i: i for i in range(len(s) - 2)}
            dims[len(s) - 1] = len(s) - 2
            return state(leaf, s[:-2] + s[-1:], dims)

        return {"v_row": stacked.map_leaves(vr, params),
                "v_col": stacked.map_leaves(vc, params)}

    def state_spec_like(self, param_specs):
        """Specs of ``init``'s state from the (stacked) parameter specs:
        a factored leaf's row state drops the last dim, its column state
        the second to last; a 0/1-D leaf's column state is replicated."""
        def row(spec):
            return P(*spec[:-1]) if len(spec) >= 2 else spec

        def col(spec):
            if len(spec) >= 2:
                return P(*(spec[:-2] + spec[-1:]))
            return P(None)

        return {"v_row": map_specs(row, param_specs),
                "v_col": map_specs(col, param_specs)}

    @torch.no_grad()
    def update(self, grads, state, params, step):
        """Updates ``params`` (a parameter tree) and ``state`` in place, as
        the reference's donated update; returns both."""
        t = _f32(step) + 1
        beta2 = 1.0 - torch.pow(t, -self.decay)
        lr = self.lr_fn(step)
        for path, leaf in stacked.leaves(params):
            shape = stacked.ref_shape(leaf)
            g = stacked.get(grads, path)
            g = torch.stack([s.float() for s in g]) \
                if isinstance(g, list) else g.float()
            vr = stacked.get(state["v_row"], path)
            vc = stacked.get(state["v_col"], path)
            g2 = torch.square(g) + self.eps
            if self._factored(shape):
                vr.copy_(beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1))
                vc.copy_(beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2))
                row_mean = torch.mean(vr, dim=-1, keepdim=True)
                u = g * torch.rsqrt(vr / torch.clamp(row_mean, min=self.eps)
                                    )[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
            else:
                vr.copy_(beta2 * vr + (1 - beta2) * g2)
                u = g * torch.rsqrt(vr)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / self.clip, min=1.0)
            if not isinstance(leaf, list):
                u = u[None]
            for j, p in enumerate(stacked.slices(leaf)):
                uj = u[j]
                if len(shape) >= 2 and self.weight_decay:
                    uj = uj + self.weight_decay * p.float()
                p.copy_(p.float() - lr * uj)
        return params, state
