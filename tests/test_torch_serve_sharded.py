"""Serving under a sharding context against the JAX package's
single-device serving, on the CPU.

A 4x2 ('data', 'model') mesh of 8 ``gloo`` processes runs the port's
sharded ``prefill`` (4 prompts of 32 tokens, one row per data rank) and
8 ``decode_step``s on llama3-8b's and mamba2-1.3b's smoke configs,
from the reference's weights (``params_from_reference``): the KV cache's
slots are sharded over 'model' (the flash-decoding layout of
``cache_pspecs``), the SSM state's heads likewise.  Each step is fed the
reference's token, so both run the same sequence.  Held against the
reference's jitted ``prefill`` / ``decode_step`` on one device, for a
scalar ``pos`` and a ragged one ([B], each row at its own position):
logits within 1e-4 of the reference's largest (the port's f32 bound,
``test_torch_models``) and the greedy tokens equal.  The cache stays in
``cache_pspecs``'s placement.  One launch of 8 ranks serves every case."""
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ranks import run_ranks
from repro.configs import get_smoke_config
from repro.models.model import build_model as ref_build

ARCHS = ("llama3-8b", "mamba2-1.3b")
TOL = 1e-4
B, S, N_DECODE = 4, 32, 8

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_shard_ctx
    from repro_torch.models import stacked
    from repro_torch.models.model import build_model, param_tree
    from repro_torch.models.sharding import placements

    rank, world, store, data = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    archs = sys.argv[5].split(",")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    ctx = make_shard_ctx(mesh)

    def load(path):
        tree = {}
        for key, a in np.load(path).items():
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(a)
        return tree

    def rows(t):
        return distribute_tensor(t, mesh, [Shard(0), Replicate()])

    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        model = build_model(cfg, device="cpu", ctx=ctx)
        stacked.copy_into(param_tree(model), load(f"{data}/{arch}_w.npz"))
        io = np.load(f"{data}/{arch}_io.npz")
        for mode in ("scalar", "ragged"):
            toks = torch.from_numpy(io["prompt"])
            cache, lg = model.prefill(rows(toks), capacity=int(io["cap"]))
            specs = model.cache_pspecs(toks.shape[0])
            placed = all(tuple(t.placements) == placements(
                specs[k][n], mesh) for k, layer in cache.items()
                for n, t in layer.items())
            logits, tokens = [lg.full_tensor().numpy()], []
            for i in range(io[f"{mode}_tok"].shape[0]):
                tok = torch.from_numpy(io[f"{mode}_tok"][i])
                pos = torch.as_tensor(io[f"{mode}_pos"][i])
                cache, lg = model.decode_step(cache, rows(tok), pos)
                lg = lg.full_tensor()
                logits.append(lg.numpy())
                tokens.append(torch.argmax(lg, -1).numpy())
            want = io[f"{mode}_logits"]
            err = max(float(np.abs(g - w).max()) / float(np.abs(w).max())
                      for g, w in zip(logits, want))
            same = all(np.array_equal(t, w) for t, w in
                       zip(tokens, io[f"{mode}_next"]))
            out[f"{arch}/{mode}"] = {"err": err, "tokens_equal": same,
                                     "placed": placed}
    print(json.dumps(out))
    dist.destroy_process_group()
""")


def _save(path, tree):
    np.savez(path, **{"/".join(k.key for k in kp): np.asarray(a)
                      for kp, a in jax.tree_util.tree_flatten_with_path(
                          tree)[0]})


def _reference(arch, tmp_path):
    """The reference's prefill and decode steps, for a scalar and a ragged
    ``pos``, saved with its weights for the ranks."""
    cfg = get_smoke_config(arch)
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    cap = S + N_DECODE
    prefill = jax.jit(lambda p, t: ref.prefill(p, t, capacity=cap))
    dec = jax.jit(ref.decode_step)
    io = {"prompt": prompt, "cap": np.int32(cap)}
    for mode in ("scalar", "ragged"):
        cache, lg = prefill(params, jnp.asarray(prompt))
        logits, toks, poss, nexts = [np.asarray(lg)], [], [], []
        tok = np.argmax(np.asarray(lg), -1)[:, None].astype(np.int32)
        for i in range(N_DECODE):
            # ragged: each row at its own position (row b is b behind)
            pos = np.int32(S + i) if mode == "scalar" else \
                (S + i - np.arange(B)).astype(np.int32)
            cache, lg = dec(params, cache, jnp.asarray(tok), jnp.asarray(pos))
            toks.append(tok)
            poss.append(pos)
            logits.append(np.asarray(lg))
            tok = np.argmax(np.asarray(lg), -1)[:, None].astype(np.int32)
            nexts.append(tok[:, 0])
        io.update({f"{mode}_tok": np.stack(toks),
                   f"{mode}_pos": np.stack(poss),
                   f"{mode}_logits": np.stack(logits),
                   f"{mode}_next": np.stack(nexts)})
    _save(tmp_path / f"{arch}_w.npz", params)
    np.savez(tmp_path / f"{arch}_io.npz", **io)


@pytest.fixture(scope="module")
def sharded_serving(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_sharded")
    for arch in ARCHS:
        _reference(arch, tmp)
    outs = run_ranks(WORKER, 8, tmp, tmp, ",".join(ARCHS))
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


@pytest.mark.parametrize("mode", ["scalar", "ragged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_equals_reference(sharded_serving, arch, mode):
    for r in sharded_serving:
        got = r[f"{arch}/{mode}"]
        assert got["err"] <= TOL, got
        assert got["tokens_equal"], got
        assert got["placed"], got
