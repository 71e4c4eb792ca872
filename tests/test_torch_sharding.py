"""The port's partition specs (``repro_torch.models.sharding``) against
the JAX package's: the same ``P`` entries for every parameter of every
REGISTRY config at model-axis sizes 1, 2 and 16, with and without
``uneven`` (which also pads the heads: the parameter shapes are held
equal too), and the same ZeRO-1, cache, optimiser-state and model cache
specs.  Exact equality: the rules are pure functions of path, shape and
config.

The port's models are built on the meta device over a ``DeviceMesh`` of
shape (1, m) that starts no process group (``_init_backend=False``,
this rank 0): every parameter is a DTensor placed by its spec, with no
memory and no collective.  The reference's context holds an
``AbstractMesh`` of the same shape."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import get_config as ref_get_config
from repro.models import sharding as ref_sh
from repro.models.model import build_model as ref_build
from repro.optim.adafactor import Adafactor as RefAdafactor
from repro.optim.adamw import AdamW as RefAdamW
from repro_torch.compat import tree_flatten_with_path
from repro_torch.configs import REGISTRY, get_config
from repro_torch.models import sharding as sh
from repro_torch.models.model import build_model
from repro_torch.optim import Adafactor, AdamW
from torch.distributed.device_mesh import DeviceMesh

SIZES = (1, 2, 16)


def _mesh(shape, names):
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


def _ctxs(m, uneven, dp=("data",)):
    shape = (*[1] * len(dp), m)
    names = (*dp, "model")
    port = sh.ShardCtx(mesh=_mesh(shape, names), dp_axes=dp, uneven=uneven)
    ref = ref_sh.ShardCtx(mesh=AbstractMesh(shape, names), dp_axes=dp,
                          uneven=uneven)
    return port, ref


def _port_specs(tree):
    kv, _ = tree_flatten_with_path(tree, is_leaf=lambda s: isinstance(s, sh.P))
    return {tuple(k.key for k in path): tuple(s) for path, s in kv}


def _ref_specs(tree):
    kv, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, PartitionSpec))
    return {tuple(k.key for k in path): tuple(s) for path, s in kv}


def _ref_shapes(model):
    kv, _ = jax.tree_util.tree_flatten_with_path(model.param_shapes())
    return {tuple(k.key for k in path): tuple(s.shape) for path, s in kv}


def _port_shapes(model):
    kv, _ = tree_flatten_with_path(model.param_shapes(),
                                   is_leaf=lambda s: isinstance(s, tuple))
    return {tuple(k.key for k in path): tuple(s) for path, s in kv}


def test_registries_match():
    assert list(REGISTRY) == list(REF_REGISTRY)


@pytest.mark.parametrize("uneven", [False, True], ids=["even", "uneven"])
@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("arch", list(REF_REGISTRY))
def test_param_pspecs_equal_reference(arch, m, uneven):
    pctx, rctx = _ctxs(m, uneven)
    ref = ref_build(ref_get_config(arch), rctx)
    port = build_model(get_config(arch), device="meta", ctx=pctx)
    assert (port.n_heads, port.n_kv) == (ref.n_heads, ref.n_kv)
    assert _port_shapes(port) == _ref_shapes(ref)
    specs = _port_specs(port.param_pspecs())
    assert specs == _ref_specs(ref.param_pspecs())
    # every parameter is a DTensor placed by its leaf's spec (a block
    # parameter by the stacked spec without its superblock dim)
    for name, prm in port.named_parameters():
        parts = name.split(".")
        path = ("blocks", *parts[2:]) if parts[0] == "blocks" \
            else tuple(parts)
        spec = sh.P(*specs[path])
        if parts[0] == "blocks":
            spec = sh.block_spec(spec)
        assert tuple(prm.placements) == sh.placements(spec, pctx.mesh), name
    # the optimisers' state specs mirror them as the reference's do
    for p_opt, r_opt in ((AdamW(None), RefAdamW(None)),
                         (Adafactor(None), RefAdafactor(None))):
        got = p_opt.state_spec_like(port.param_pspecs())
        want = r_opt.state_spec_like(ref.param_pspecs())
        assert set(got) == set(want)
        for key in got:
            assert _port_specs(got[key]) == _ref_specs(want[key]), key


@pytest.mark.parametrize("dp", [("data",), ("pod", "data")],
                         ids=["data", "pod-data"])
@pytest.mark.parametrize("arch", ["llama3-8b", "jamba-1.5-large-398b",
                                  "kimi-k2-1t-a32b"])
def test_zero1_and_cache_specs_equal_reference(arch, dp):
    pctx, rctx = _ctxs(16, False, dp)
    ref = ref_build(ref_get_config(arch), rctx)
    port = build_model(get_config(arch), device="meta", ctx=pctx)
    specs, shapes = _port_specs(port.param_pspecs()), _port_shapes(port)
    for dp_size in (2, 16, 32):
        for path, spec in specs.items():
            got = sh.zero1_spec(sh.P(*spec), shapes[path], dp, dp_size)
            want = ref_sh.zero1_spec(PartitionSpec(*spec), shapes[path], dp,
                                     dp_size)
            assert tuple(got) == tuple(want), (path, dp_size)
    for batch in (1, 4):
        for kind in ("kv", "ssm", "conv"):
            assert tuple(sh.cache_spec(kind, pctx, batch)) == \
                tuple(ref_sh.cache_spec(kind, rctx, batch))
        assert _port_specs(port.cache_pspecs(batch)) == \
            _ref_specs(ref.cache_pspecs(batch))
    with pytest.raises(ValueError):
        sh.cache_spec("other", pctx, 1)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((2, 2, 4), ("pod", "data", "model"))
    assert sh.placements(sh.P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(None, "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))
    assert sh.placements(sh.P(), mesh) == (Replicate(),) * 3
    ctx = sh.ShardCtx(mesh=mesh, dp_axes=("pod", "data"))
    assert ctx.model_size == 4
    assert ctx.named("data", None) == (Replicate(), Shard(0), Replicate())


def test_constrain_leaves_plain_tensors():
    x = torch.ones(4, 3)
    pctx, _ = _ctxs(2, False)
    assert sh.constrain(x, None, "data", None) is x
    assert sh.constrain(x, pctx, "data", None) is x
