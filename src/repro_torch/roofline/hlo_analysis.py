"""Per-device cost analysis of a captured step: the port's counterpart of
the JAX package's HLO analyzer, with the same output.

The JAX package compiles a step and parses its post-SPMD HLO text
(per-device shapes), scaling while-loop bodies by their trip counts,
because XLA's own ``cost_analysis`` counts a loop body once.  The port
compiles nothing: a step runs eagerly, so every loop iteration, every
layer and every recomputation of a checkpointed block dispatches its ops
again.  So its "HLO" is an *op trace*: ``OpTrace``, a
``TorchDispatchMode``, records every aten op the step runs on this rank,
one op per line of plain text, with its result and operand shapes and
dtypes and, for a collective, its group size.  ``analyze_hlo(trace)``
turns a trace into the reference's keys, with the reference's
conventions:

  * dot FLOPs      2 * prod(result dims) * prod(lhs contracting dims), for
                   ``mm``, ``addmm``, ``bmm`` (every overload) and
                   ``baddbmm``
  * HBM bytes      ``bytes_accessed``: heavy ops only (products, gathers,
                   scatters, copies, sorts), the perfect-fusion floor; a
                   gather or index charges its slice (read and written), an
                   indexed or sliced ``copy_`` its update; ``bytes_upper``:
                   every op that moves data, operands plus results (eager
                   runs each op as its own kernel, so this is what it does)
  * elementwise    ``int_ops``: result elements of pointwise arithmetic
  * collectives    wire bytes by type, ring conventions

Per-device shapes: a ``DTensor`` op is not recorded (the mode returns
``NotImplemented`` for it, as ``CommDebugMode`` does); DTensor then runs
it as ops on local shards and functional collectives, which the mode
records.  Ops that DTensor runs on fake tensors of the global shapes to
propagate shardings are not recorded either (``sharding_propagation``
marks them).

``capture(fn, *args)`` runs ``fn`` under an ``OpTrace`` and returns a
``Captured``: the trace text, the FLOPs that ``FlopCounterMode``'s
formulas give for the same ops, and ``cost_analysis()``, the counterpart
of the compiled object's (``compat.cost_analysis``).
"""
from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}
for _name, _tag in (("float8_e4m3fn", "f8e4m3fn"), ("float8_e5m2", "f8e5m2"),
                    ("uint16", "u16"), ("uint32", "u32"), ("uint64", "u64")):
    if hasattr(torch, _name):
        _DTYPE_NAMES[getattr(torch, _name)] = _tag

# bytes per element of each dtype tag (the reference's table)
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1,
    "pred": 1, "c64": 8, "c128": 16,
}

# one tensor in a trace line: dtype[dims], with "~" when it is a view of
# only part of its storage (a slice)
_TENSOR_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\](~?)")

_DOT_OPS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1}  # -> lhs operand
_GATHER_OPS = {"index", "index_select", "gather", "embedding",
               "take_along_dim"}
_SCATTER_OPS = {"index_put", "index_copy", "index_add", "scatter",
                "scatter_add", "scatter_reduce", "index_fill",
                "masked_scatter", "embedding_dense_backward"}
# ops that are genuine memory traffic even under perfect fusion
_HEAVY_OPS = set(_DOT_OPS) | _GATHER_OPS | _SCATTER_OPS | {
    "copy", "clone", "sort", "convolution", "cat", "stack"}
# elementwise arithmetic, counted per result element
_VPU_OPS = {"add", "sub", "rsub", "mul", "div", "bitwise_and", "bitwise_or",
            "bitwise_xor", "bitwise_not", "__lshift__", "__rshift__",
            "bitwise_left_shift", "bitwise_right_shift", "where", "eq", "ne",
            "lt", "le", "gt", "ge", "maximum", "minimum", "clamp", "clamp_min",
            "clamp_max", "tanh", "exp", "neg", "_to_copy", "sigmoid", "silu",
            "rsqrt", "sqrt", "log", "pow", "square", "abs", "sin", "cos",
            "gelu", "softplus", "masked_fill", "fill"}
# transcendental functions, counted per result element (cost_analysis)
_TRANSCENDENTAL_OPS = {"exp", "log", "tanh", "sigmoid", "silu", "rsqrt",
                       "sqrt", "sin", "cos", "gelu", "softplus", "pow",
                       "_softmax", "_log_softmax", "logsumexp", "expm1",
                       "log1p", "erf"}
# ops that move no data: allocation and metadata
_NO_BYTES_OPS = {"empty", "empty_strided", "new_empty", "new_empty_strided",
                 "scalar_tensor", "lift_fresh", "lift_fresh_copy",
                 "wait_tensor", "_local_scalar_dense", "set_",
                 "resize_", "detach"}
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional.", "c10d.")


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``aten.bmm``'s FLOPs, any overload (``bmm.dtype`` passes its
    ``out_dtype`` after the operands)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def flop_counter(**kwargs) -> FlopCounterMode:
    """A ``FlopCounterMode`` whose ``bmm`` formula also takes
    ``aten.bmm.dtype`` (the card's f32-result score product), which the
    stock formula refuses."""
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.bmm: _bmm_flop}, **kwargs)


_propagating = [0]


def _marked(fn):
    def run(*args, **kwargs):
        _propagating[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _propagating[0] -= 1
    run._marks = fn
    return run


class sharding_propagation:
    """While held, ``in_sharding_propagation()`` is true inside DTensor's
    sharding propagator, whose output-metadata pass runs each new op on
    fake tensors of the global shapes, under whatever fake mode is
    active (so under a dry run's own)."""

    _NAMES = ("propagate_op_sharding_non_cached",
              "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        self._saved = []
        for name in self._NAMES:
            fn = ShardingPropagator.__dict__.get(name)
            if fn is not None and not hasattr(fn, "_marks"):
                self._saved.append((name, fn))
                setattr(ShardingPropagator, name, _marked(fn))
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        for name, fn in self._saved:
            setattr(ShardingPropagator, name, fn)
        return False


def in_sharding_propagation() -> bool:
    return _propagating[0] > 0


def _tensor_text(t: torch.Tensor) -> str:
    dims = ",".join(str(int(d)) for d in t.shape)
    part = ""
    try:
        if t.untyped_storage().nbytes() > t.numel() * t.element_size():
            part = "~"
    except (RuntimeError, NotImplementedError):
        pass
    return f"{_DTYPE_NAMES.get(t.dtype, 'u8')}[{dims}]{part}"


def _group_size(func, args) -> int:
    """The size of a collective's process group: a functional
    collective names its group, a c10d op passes it."""
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
        if isinstance(a, torch.ScriptObject):
            try:
                return torch.distributed.ProcessGroup.unbox(a).size()
            except (AttributeError, RuntimeError, TypeError):
                continue
    return 0


class OpTrace(TorchDispatchMode):
    """Records every aten op run on this rank's own tensors, one line
    each: ``op result... <- operand... [group=N]``.  ``flops`` sums
    ``FlopCounterMode``'s formulas over the same ops."""

    def __init__(self):
        super().__init__()
        self.lines: List[str] = []
        self.flops = 0
        self._counter = flop_counter()
        self._fake_on_entry = None

    def __enter__(self):
        self._fake_on_entry = active_fake_mode()
        self._prop = sharding_propagation().__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._prop.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = str(func)
        if name.startswith("prim.") or in_sharding_propagation() or \
                active_fake_mode() is not self._fake_on_entry:
            return out                      # DTensor's sharding propagation
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        res = [a for a in tree_leaves(out) if isinstance(a, torch.Tensor)]
        if func.is_view:
            # no data moves: only the name, for the record
            self.lines.append(f"{name} view")
            return out
        line = (f"{name} " + " ".join(_tensor_text(t) for t in res)
                + " <- " + " ".join(_tensor_text(t) for t in ins))
        if name.startswith(_COLLECTIVE_NAMESPACES):
            n = _group_size(func, tree_leaves((args, kwargs)))
            line += f" group={n}" if n else ""
        self.lines.append(line)
        packet = func.overloadpacket
        fn = self._counter.flop_registry.get(packet)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        return out

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


class Captured:
    """One step run under an ``OpTrace``: ``trace`` (its text), ``flops``
    (``FlopCounterMode``'s count) and ``cost_analysis()``."""

    def __init__(self, trace: str, flops: int):
        self.trace = trace
        self.flops = flops

    def cost_analysis(self) -> dict:
        """The compiled object's keys: ``flops`` (``FlopCounterMode``),
        ``bytes accessed`` (every op's operands and results: eager runs
        no fusion) and ``transcendentals`` (result elements of exp, log,
        tanh, rsqrt and the like).  XLA's ``optimal_seconds`` has no
        counterpart and is left out.  Unlike XLA's, which counts a loop
        body once, every run of every op counts."""
        an = _scan(self.trace)
        return {"flops": float(self.flops),
                "bytes accessed": an["bytes_upper"],
                "transcendentals": an["transcendentals"]}


def capture(fn, *args, **kwargs) -> Tuple[object, Captured]:
    """``fn(*args, **kwargs)`` run under an ``OpTrace``; returns its
    result and the ``Captured`` step."""
    rec = OpTrace()
    with rec:
        out = fn(*args, **kwargs)
    return out, Captured(rec.text(), rec.flops)


# --------------------------------------------------------------------------
# the analyzer
# --------------------------------------------------------------------------
class Op:
    __slots__ = ("op", "base", "results", "operands", "group", "line")

    def __init__(self, line: str):
        self.line = line
        head, _, rest = line.partition(" ")
        self.op = head
        name = head.split(".")
        # "aten.add_.Tensor" -> "add"; "c10d.allreduce_.default" keeps
        # its trailing underscore (the c10d names carry one)
        base = name[1] if len(name) > 1 else head
        self.base = base if head.startswith("c10d.") else base.rstrip("_")
        res, _, ops = rest.partition(" <- ")
        m = re.search(r" group=(\d+)$", ops)
        self.group = int(m.group(1)) if m else 0
        if m:
            ops = ops[:m.start()]
        self.results = _tensors(res)
        self.operands = _tensors(ops)


def _tensors(text: str) -> List[Tuple[int, List[int], bool, str]]:
    """(bytes per element, dims, is a slice, dtype tag) of each tensor."""
    out = []
    for dt, dims, part in _TENSOR_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        dl = [int(d) for d in dims.split(",")] if dims else []
        out.append((_DTYPE_BYTES[dt], dl, bool(part), dt))
    return out


def _nbytes(t) -> int:
    return t[0] * math.prod(t[1])


def _elems(ts) -> int:
    return sum(math.prod(t[1]) for t in ts)


def _dot_flops(i: Op) -> float:
    lhs = i.operands[_DOT_OPS[i.base]]
    return 2.0 * _elems(i.results) * lhs[1][-1]


def _collective_wire(i: Op) -> Tuple[str, float]:
    kind = _COLLECTIVE_KIND.get(i.base, "collective-permute")
    res_b = sum(_nbytes(t) for t in (i.results or i.operands))
    if i.group == 1:
        return kind, 0.0            # a group of one rank moves nothing
    n = max(i.group, 2)
    frac = (n - 1) / n
    if kind == "all-gather":
        return kind, frac * res_b
    if kind == "all-reduce":
        return kind, 2.0 * frac * res_b
    if kind == "reduce-scatter":
        return kind, frac * n * res_b
    if kind == "all-to-all":
        return kind, frac * res_b
    return kind, float(res_b)


def _heavy_bytes(i: Op) -> float:
    """Memory traffic of one heavy op: a gather charges its slice (read
    and written), not its operand; a scatter or a copy into a slice its
    update (read and written); a product or a whole copy its operands and
    result."""
    res_b = sum(_nbytes(t) for t in i.results)
    if i.base in _GATHER_OPS:
        return 2.0 * res_b
    if i.base in _SCATTER_OPS:
        # the update: the last operand of data (not an index)
        upd = [t for t in i.operands[1:] if t[3][0] in "fbc"]
        return 2.0 * (_nbytes(upd[-1]) if upd else res_b)
    if i.base == "copy" and i.operands and i.operands[0][2]:
        return 2.0 * _nbytes(i.operands[-1])
    return float(res_b + sum(_nbytes(t) for t in i.operands))


def analyze_hlo(trace: str, top_k: int = 12) -> dict:
    """The reference's analysis (its keys) of one captured step's op
    trace, every number per device.  ``n_computations`` counts the ops
    that ran (the reference counts HLO computations)."""
    out = _scan(trace, top_k)
    del out["transcendentals"]
    return out


def _scan(trace: str, top_k: int = 12) -> dict:
    flops = 0.0
    int_ops = 0.0
    transcendentals = 0.0
    bytes_upper = 0.0
    bytes_min = 0.0
    wire: Dict[str, float] = defaultdict(float)
    op_counts: Dict[str, float] = defaultdict(float)
    top_coll: list = []
    top_bytes: Dict[Tuple[str, str], List[float]] = {}
    n = 0
    for line in trace.splitlines():
        if not line or line.endswith(" view"):
            continue
        n += 1
        i = Op(line)
        if i.base in _DOT_OPS and i.op.startswith("aten."):
            flops += _dot_flops(i)
        if i.base in _VPU_OPS:
            int_ops += _elems(i.results)
        if i.base in _TRANSCENDENTAL_OPS:
            transcendentals += _elems(i.results)
        if i.op.startswith(_COLLECTIVE_NAMESPACES):
            if i.base not in _COLLECTIVE_KIND:
                continue                    # wait_tensor and the like
            op, w = _collective_wire(i)
            wire[op] += w
            op_counts[op] += 1
            top_coll.append((w, op, line.split(" <- ")[0][:64], 1,
                             f"group={i.group}"))
            continue
        if i.base in _HEAVY_OPS:
            hb = _heavy_bytes(i)
            bytes_min += hb
            key = (i.base, line.split(" <- ")[0].split(" ", 1)[-1][:48])
            acc = top_bytes.setdefault(key, [0.0, 0])
            acc[0] += hb
            acc[1] += 1
        if i.base in _NO_BYTES_OPS:
            continue
        bytes_upper += sum(_nbytes(t) for t in i.results) \
            + sum(_nbytes(t) for t in i.operands)
    top_coll.sort(key=lambda t: -t[0])
    tb = sorted(((b, op, r, m) for (op, r), (b, m) in top_bytes.items()),
                key=lambda t: -t[0])
    return {
        "flops": flops,
        "int_ops": int_ops,
        "transcendentals": transcendentals,
        "bytes_accessed": bytes_min,
        "bytes_upper": bytes_upper,
        "wire_bytes": dict(wire),
        "op_counts": {k: int(v) for k, v in op_counts.items()},
        "total_wire_bytes": float(sum(wire.values())),
        "n_computations": n,
        "top_collectives": [
            dict(wire_bytes=w, op=o, result=r, mult=mm, comp=c)
            for w, o, r, mm, c in top_coll[:top_k]],
        "top_bytes": [
            dict(bytes=b, op=o, result=r, mult=int(m), comp="step")
            for b, o, r, m in tb[:top_k]],
    }


def collective_bytes_from_hlo(trace: str) -> dict:
    a = analyze_hlo(trace)
    return {"wire_bytes": a["wire_bytes"],
            "op_counts": a["op_counts"],
            "total_wire_bytes": a["total_wire_bytes"]}
