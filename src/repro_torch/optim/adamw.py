"""AdamW with decoupled weight decay.  State kept in fp32, in the JAX
package's stacked layout (see ``models.stacked``)."""
from __future__ import annotations

import torch

from repro_torch.models import stacked
from repro_torch.optim.schedule import _f32


class AdamW:
    def __init__(self, lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
        self.lr_fn = lr_fn
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params):
        return {"mu": stacked.map_leaves(stacked.zeros, params),
                "nu": stacked.map_leaves(stacked.zeros, params)}

    def state_spec_like(self, param_specs):
        """Optimizer-state specs mirror the (stacked) parameter specs."""
        return {"mu": param_specs, "nu": param_specs}

    @torch.no_grad()
    def update(self, grads, state, params, step):
        """Updates ``params`` (a parameter tree) and ``state`` in place, as
        the reference's donated update; returns both."""
        b1, b2 = self.b1, self.b2
        t = _f32(step) + 1
        lr = self.lr_fn(step)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for path, leaf in stacked.leaves(params):
            # no decay on norms/biases: the rank of the reference's leaf,
            # so its stacked [n_super, d] norm scales are decayed
            decay = len(stacked.ref_shape(leaf)) >= 2
            mu, nu = stacked.get(state["mu"], path), \
                stacked.get(state["nu"], path)
            if not isinstance(leaf, list):
                mu, nu = mu[None], nu[None]
            for j, (p, g) in enumerate(zip(
                    stacked.slices(leaf),
                    stacked.slices(stacked.get(grads, path)))):
                g = g.float()
                mu[j].mul_(b1).add_((1 - b1) * g)
                nu[j].mul_(b2).add_((1 - b2) * torch.square(g))
                delta = (mu[j] / bc1).div_(torch.sqrt(nu[j] / bc2)
                                           .add_(self.eps))
                if decay:
                    delta.add_(self.weight_decay * p.float())
                p.copy_(p.float() - lr * delta)
        return params, state
