"""The port's op-trace analyzer (``roofline.hlo_analysis``) against the
contracts of the JAX package's ``tests/test_hlo_analysis.py``, on the CPU.

The reference parses compiled HLO, where a scanned loop body appears once
and must be scaled by its trip count; XLA's own ``cost_analysis`` counts
it once (the reference asserts that undercount).  The port captures an
eager run, where every iteration dispatches its ops again, so a loop of 10
matmuls counts 10 both in the analyzer and in ``compat.cost_analysis``
(``FlopCounterMode``): that is the one deliberate difference, asserted
here as the port's own count.

* a loop of 10 matmuls counts 10; nested 5 x 3 loops count 15; one dot
  counts exactly;
* a row sliced per step (``index_select``, the counterpart of a dynamic
  slice) from a [100, 1024, 1024] array charges between 0.5x and 4x the
  array, not trips x array (fake tensors: nothing allocated);
* ``cost_analysis`` agrees with the analyzer on a model's train step;
* ``roofline.analysis.model_flops`` keeps the reference's conventions;
* ring conventions: a 4x2 ``gloo`` data-parallel step records the grads'
  all-reduce over the 4 data ranks at 2 (dp - 1) / dp of the local grad
  bytes (8 processes, ``_torch_ranks.run_ranks``)."""
import json
import textwrap

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_ranks import run_ranks
from repro_torch.compat import cost_analysis
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import build_model
from repro_torch.roofline.analysis import model_flops
from repro_torch.roofline.hlo_analysis import analyze_hlo, capture
from repro_torch.train.trainstep import make_loss_fn


def test_loop_flops_count_every_trip():
    """10 matmuls in a loop count 10 in the analyzer and in
    ``cost_analysis`` (an eager capture runs the body 10 times; XLA's
    ``cost_analysis`` would count 1)."""
    def looped(x, ws):
        c = x
        for w in ws:
            c = torch.tanh(c @ w)
        return c

    x = torch.randn(128, 256)
    ws = torch.randn(10, 256, 256)
    _, cap = capture(looped, x, ws)
    one_matmul = 2 * 128 * 256 * 256
    assert analyze_hlo(cap.trace)["flops"] == pytest.approx(
        10 * one_matmul, rel=0.01)
    assert cost_analysis(cap)["flops"] == pytest.approx(10 * one_matmul,
                                                        rel=0.01)


def test_single_dot_flops():
    a = torch.randn(64, 32, dtype=torch.bfloat16)
    b = torch.randn(32, 16, dtype=torch.bfloat16)
    _, cap = capture(lambda a, b: a @ b, a, b)
    assert analyze_hlo(cap.trace)["flops"] == 2 * 64 * 32 * 16


def test_slice_bytes_not_full_operand():
    """A loop that takes one row per step must charge slice-sized reads,
    not the full stacked array each iteration."""
    def looped(x, ws):
        c = x
        for j in range(ws.shape[0]):
            row = torch.index_select(ws, 0, torch.tensor([j]))
            c = c * 1.0 + torch.sum(row)
        return c

    with FakeTensorMode():
        x = torch.empty(8)
        ws = torch.empty(100, 1024, 1024)
        _, cap = capture(looped, x, ws)
    an = analyze_hlo(cap.trace)
    full = 100 * 1024 * 1024 * 4
    assert an["bytes_accessed"] < 4 * full
    assert an["bytes_accessed"] > 0.5 * full


def test_nested_loops_multiply():
    def nested(x, ws):
        c = x
        for outer in ws:
            for w in outer:
                c = torch.tanh(c @ w)
        return c

    x = torch.randn(32, 64)
    ws = torch.randn(5, 3, 64, 64)
    _, cap = capture(nested, x, ws)
    assert analyze_hlo(cap.trace)["flops"] == pytest.approx(
        15 * 2 * 32 * 64 * 64, rel=0.01)


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b",
                                  "mamba2-1.3b"])
def test_cost_analysis_agrees_with_analyzer(arch):
    """On a smoke model's forward and backward, ``FlopCounterMode``'s
    count (``cost_analysis``) equals the analyzer's dot FLOPs, and the
    memory terms are ordered: heavy ops' bytes below every op's."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))

    def step():
        loss, _ = make_loss_fn(model)({"tokens": tokens})
        return torch.autograd.grad(loss, list(model.parameters()))

    _, cap = capture(step)
    an = analyze_hlo(cap.trace)
    cost = cost_analysis(cap)
    assert an["flops"] > 0
    assert cost["flops"] == pytest.approx(an["flops"], rel=1e-9)
    assert cost["bytes accessed"] == an["bytes_upper"]
    assert 0 < an["bytes_accessed"] < an["bytes_upper"]
    assert cost["transcendentals"] > 0 and an["int_ops"] > 0


def test_model_flops_conventions():
    t = model_flops("llama3-8b", "train_4k")
    assert t == pytest.approx(6 * 8.03e9 * 256 * 4096, rel=0.02)
    d = model_flops("llama3-8b", "decode_32k")
    assert d == pytest.approx(2 * 8.03e9 * 128, rel=0.02)
    m = model_flops("mixtral-8x7b", "train_4k")     # active, not total
    assert m < 6 * 46.7e9 * 256 * 4096 * 0.5


RING_WORKER = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_shard_ctx
    from repro_torch.models.model import build_model, param_tree
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.roofline.hlo_analysis import Op, capture, _collective_wire
    from repro_torch.train.trainstep import make_train_step

    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    cfg = get_smoke_config("llama3-8b")
    model = build_model(cfg, device="cpu", ctx=make_shard_ctx(mesh)).init(
        torch.Generator().manual_seed(0))
    opt = make_optimizer("adamw", make_schedule("cosine", 1e-3, 10))
    params = param_tree(model)
    state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab_size, (8, 32),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": distribute_tensor(tokens, mesh,
                                         [Shard(0), Replicate()])}
    step = make_train_step(model, opt)
    _, cap = capture(step, params, state, batch, 3)
    wire, n = 0.0, 0
    for line in cap.trace.splitlines():
        if line.startswith("_c10d_functional.all_reduce") \\
                and line.endswith(" group=4"):
            op = Op(line)
            if not op.results[0][1]:
                continue                            # a scalar metric
            wire += _collective_wire(op)[1]
            n += 1
    grad_bytes = sum(p.to_local().numel() * 4 for p in model.parameters())
    print(json.dumps({"wire": wire, "grad_bytes": grad_bytes, "n": n,
                      "params": len(list(model.parameters()))}))
    dist.destroy_process_group()
""")


def test_ring_wire_bytes_of_data_parallel_grads(tmp_path):
    """The grads' all-reduce over the 4 data ranks moves 2 (dp - 1) / dp
    of the local grad bytes on the wire, one all-reduce per parameter."""
    for out in run_ranks(RING_WORKER, 8, tmp_path):
        r = json.loads(out.strip().splitlines()[-1])
        assert r["n"] == r["params"], r
        assert r["wire"] == pytest.approx(2 * 3 / 4 * r["grad_bytes"],
                                          rel=1e-12), r
