"""The port's remat policies against the JAX package's ``jax.checkpoint``
policies, on the CPU.

* Under ``dots_saveable``, ``dots_with_no_batch_dims_saveable`` and JAX's
  aliases ``checkpoint_dots`` and ``checkpoint_dots_with_no_batch_dims``,
  the loss and every grad equal ``jax.value_and_grad`` of the reference's
  loss built with the same policy, on the same weights
  (``params_from_reference``) and batch, f32: within 1e-4 of each leaf's
  largest value (the port's own parity bound, ``test_torch_trainstep``).
  A remat policy changes what is kept, not the arithmetic.
* What runs again in backward: with checkpoint early stop off (so a
  recompute runs its block to the end), the ``mm``s backward runs beyond
  those of ``everything_saveable`` (which recomputes nothing) are 0 under
  ``dots_saveable`` and every one of the superblocks' forward ``mm``s
  under ``nothing_saveable``.
* Inside a query-block checkpoint of attention (a row longer than one
  block) the selective policies save nothing: ``dots_saveable`` runs the
  blocks' ``bmm``s again in backward as ``nothing_saveable`` does.
* A policy that takes arguments raises, naming the policy."""
import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro.configs import get_smoke_config as ref_smoke
from repro.models.model import build_model as ref_build
from repro.train import trainstep as ref_ts
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import stacked
from repro_torch.models.model import (build_model, param_tree,
                                      params_from_reference)
from repro_torch.train.trainstep import make_loss_fn

GRAD_TOL = 1e-4
POLICIES = ("dots_saveable", "dots_with_no_batch_dims_saveable",
            "checkpoint_dots", "checkpoint_dots_with_no_batch_dims")


class _Count(TorchDispatchMode):
    """How many times each op (its packet) runs."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = str(func.overloadpacket)
        self.n[key] = self.n.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_grads_equal_reference_checkpoint(policy):
    arch = "llama3-8b"
    ref = ref_build(ref_smoke(arch), remat_policy=policy)
    params = ref.init(jax.random.PRNGKey(0))
    port = params_from_reference(
        build_model(get_smoke_config(arch), device="cpu",
                    remat_policy=policy),
        jax.tree.map(np.asarray, params))
    tokens = np.random.default_rng(1).integers(
        0, ref.cfg.vocab_size, (2, 64)).astype(np.int32)
    (r_loss, _), r_g = jax.jit(jax.value_and_grad(
        ref_ts.make_loss_fn(ref), has_aux=True))(
            params, {"tokens": jax.numpy.asarray(tokens)})
    tree = param_tree(port)
    flat = [t for _, leaf in stacked.leaves(tree)
            for t in stacked.slices(leaf)]
    loss, _ = make_loss_fn(port)({"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, flat)
    assert abs(float(loss.detach()) - float(r_loss)) \
        <= GRAD_TOL * abs(float(r_loss))
    it = iter(grads)
    for path, leaf in stacked.leaves(tree):
        got = torch.stack([next(it) for _ in leaf]) if isinstance(
            leaf, list) else next(it)
        want = np.asarray(stacked.get(r_g, path))
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max()) / scale
        assert err <= GRAD_TOL, (path, err)


def _counts(policy, S, q_block=None):
    cfg = get_smoke_config("llama3-8b")
    model = build_model(cfg, device="cpu", remat_policy=policy).init(
        torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, S),
                           generator=torch.Generator().manual_seed(1))
    fw, bw = _Count(), _Count()
    with set_checkpoint_early_stop(False):
        with fw:
            loss, _ = make_loss_fn(model)({"tokens": tokens})
        with bw:
            torch.autograd.grad(loss, list(model.parameters()))
    return fw.n, bw.n


def test_mm_recomputed_in_backward():
    """Forward runs one ``mm`` per projection of every superblock and one
    for the head; backward runs every ``mm``'s two grads, plus the
    superblocks' forward ``mm``s again under ``nothing_saveable`` and
    none of them under ``dots_saveable``."""
    n = {p: _counts(p, 64) for p in ("everything_saveable",
                                     "nothing_saveable", "dots_saveable")}
    fw = n["everything_saveable"][0]["aten.mm"]
    base = n["everything_saveable"][1]["aten.mm"]
    assert base == 2 * fw
    cfg = get_smoke_config("llama3-8b")
    block_mms = cfg.num_layers * 7          # q, k, v, o, w1, w3, w2
    assert fw == block_mms + 1              # and the head
    assert n["dots_saveable"][1]["aten.mm"] - base == 0
    assert n["nothing_saveable"][1]["aten.mm"] - base == block_mms


def test_query_block_checkpoint_saves_nothing(monkeypatch):
    """A row of 4 query blocks: the attention ``bmm``s of every block run
    again in backward under ``dots_saveable`` (the inner checkpoint saves
    nothing), exactly as many as under ``nothing_saveable``."""
    monkeypatch.setattr(L.gqa_attention, "__defaults__",
                        (0, 0.0, 16, torch.float32))
    fw, bw_dots = _counts("dots_saveable", 64)
    _, bw_none = _counts("nothing_saveable", 64)
    assert fw["aten.bmm"] > 0
    assert bw_dots["aten.bmm"] == bw_none["aten.bmm"]
    assert bw_dots["aten.mm"] < bw_none["aten.mm"]


@pytest.mark.parametrize("policy", ["save_only_these_names",
                                    "offload_dot_with_no_batch_dims",
                                    "save_from_both_policies"])
def test_policy_with_arguments_raises(policy):
    with pytest.raises(ValueError, match=f"{policy}.*takes arguments"):
        build_model(get_smoke_config("llama3-8b"), device="cpu",
                    remat_policy=policy)
