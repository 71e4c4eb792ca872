"""The port's int8 cross-pod gradient sync
(``repro_torch.optim.grad_compress``): quantisation bit for bit against
the JAX package's on the same f32 input (``jnp.round`` and ``torch.round``
both round half to even), and the JAX package's
``tests/test_distributed.py::test_grad_compression_cross_pod`` contract
on a 2x4 ('pod', 'data') mesh of 8 ``gloo`` processes: over 20 steps the
error-fed int8 mean keeps the accumulated relative error under 0.05.

The ranks run as 8 subprocesses of this file's worker code
(``_torch_ranks.run_ranks``: a ``file://`` store in the test's own
directory, each rank under its own time limit)."""
import json
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from repro.optim import grad_compress as ref
from repro_torch.optim import grad_compress as gc


@pytest.mark.parametrize("log_scale", [-30, -6, 0, 3, 20])
def test_quantize_int8_equals_reference_bit_for_bit(log_scale):
    rng = np.random.default_rng(100 + log_scale)
    g = (rng.standard_normal((33, 65)) * 10.0 ** log_scale).astype(np.float32)
    q_r, s_r = ref.quantize_int8(jnp.asarray(g))
    q_p, s_p = gc.quantize_int8(torch.from_numpy(g))
    assert q_p.dtype == torch.int8 and s_p.dtype == torch.float32
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    assert s_p.numpy().view(np.int32) == np.asarray(s_r).view(np.int32)
    d_r = np.asarray(ref.dequantize_int8(q_r, s_r))
    d_p = gc.dequantize_int8(q_p, s_p).numpy()
    np.testing.assert_array_equal(d_p.view(np.int32), d_r.view(np.int32))


def test_quantize_int8_rounds_ties_to_even():
    # max 127 gives scale 1 (1 + 1e-12 rounds to 1 in f32): the values
    # are their own quotients, ties included
    g = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5], np.float32)
    q_r, _ = ref.quantize_int8(jnp.asarray(g))
    q_p, _ = gc.quantize_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    assert q_p.tolist() == [127, 2, -4, 0, 0, 2, 126]


def test_init_error_state_is_f32_zeros():
    grads = {"w": torch.ones(3, 4, dtype=torch.bfloat16),
             "b": [torch.ones(2)]}
    err = gc.init_error_state(grads)
    assert err["w"].dtype == torch.float32 and err["w"].shape == (3, 4)
    assert not err["w"].any() and err["b"][0].shape == (2,)


def test_cross_pod_sync_refuses_a_pod_sharded_spec():
    from repro_torch.models.sharding import P

    class Mesh:
        def get_group(self, axis):
            return None
    with pytest.raises(ValueError):
        gc.make_cross_pod_sync(Mesh(), {"w": P(("pod", "data"), None)})


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.sharding import P
    from repro_torch.optim.grad_compress import (make_cross_pod_sync,
                                                 init_error_state)
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    specs = {"w": P(None, None), "v": P(None, "data")}
    sync = make_cross_pod_sync(mesh, specs)
    rng = np.random.default_rng(0)
    accum_true = np.zeros((8, 16), np.float32)
    accum_q = {k: np.zeros((8, 16), np.float32) for k in specs}
    place = [Replicate(), Shard(1)]
    err = init_error_state({
        "w": torch.zeros(8, 16),
        "v": distribute_tensor(torch.zeros(8, 16), mesh, place)})
    for step in range(20):
        g = rng.standard_normal((8, 16)).astype(np.float32)
        grads = {"w": torch.from_numpy(g),
                 "v": distribute_tensor(torch.from_numpy(g), mesh, place)}
        out, err = sync(grads, err)
        assert tuple(out["v"].placements) == tuple(place)
        accum_true += g            # pods hold identical grads here
        accum_q["w"] += out["w"].numpy()
        accum_q["v"] += out["v"].full_tensor().numpy()
    rel = {k: float(np.abs(a - accum_true).max() / np.abs(accum_true).max())
           for k, a in accum_q.items()}
    print(json.dumps(rel))
    dist.destroy_process_group()
""")


def test_grad_compression_cross_pod(tmp_path):
    """int8 compressed sum across a 'pod' axis approximates the mean and
    error feedback keeps the bias bounded over steps, for a plain leaf
    (this rank's gradient) and a DTensor leaf sharded over 'data'."""
    outs = run_ranks(WORKER, 8, tmp_path)
    for out in outs:
        rel = json.loads(out.strip().splitlines()[-1])
        assert rel["w"] < 0.05 and rel["v"] < 0.05, rel
