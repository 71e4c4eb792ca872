"""Content-addressable checkpointing — the paper's technique as a
training-framework feature, over PyTorch state.

This is the paper's *checkpoint workload* (§4.3, Figure 11: successive
checkpoint images with 76-90% CDC similarity) as the framework's
checkpoint subsystem: every parameter and optimizer leaf is serialized
and written through the SAI into the content-addressable store, with its
hashing offloaded to the card.  Successive checkpoints of a slowly moving
training state dedup against each other, so an incremental checkpoint
costs its changed bytes, not the model size; restore verifies content
hashes and survives storage-node failures through replication.

State is a nested structure of dicts, lists and tuples whose leaves are
tensors (on any device), numpy arrays or Python scalars: a model's
``state_dict()``, an ``optimizer.state_dict()``.  Leaves are named and
ordered as the JAX package's checkpointer names them (its
``jax.tree_util`` walk): dict keys sorted (an ``OrderedDict`` keeps its
own order), sequence items as ``[i]``, namedtuple fields as ``.name``,
``None`` dropped; the path parts are joined by ``/``.  The manifest
records numpy's dtype name (``"bfloat16"`` for ``torch.bfloat16``, the
name ml_dtypes gives), so the two packages write byte-identical
manifests for the same state and restore each other's checkpoints.

``save`` streams every leaf through the SAI's async write pipeline in
one burst, so the offload engine fuses the per-leaf hash requests.  A
leaf on the card is copied to the host once, in ``save``.
``async_save`` snapshots the state to the host before it returns (so a
training step that updates tensors in place cannot race it) and saves in
a background thread.  ``restore`` returns CPU tensors.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compat import tree_map
from repro_torch.core.sai import SAI, WriteStats


def _walk(node, path: Tuple[str, ...], out: List[Tuple[str, Any]]):
    if node is None:
        return
    if isinstance(node, dict):
        keys = list(node) if isinstance(node, collections.OrderedDict) \
            else sorted(node)
        for k in keys:
            _walk(node[k], path + (str(k),), out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for name in node._fields:
            _walk(getattr(node, name), path + (f".{name}",), out)
    elif isinstance(node, (list, tuple)):
        for i, item in enumerate(node):
            _walk(item, path + (f"[{i}]",), out)
    else:
        out.append(("/".join(path), node))


def _dtype_name(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def _to_host(leaf, copy: bool = False):
    """A leaf as a host tensor or numpy array (a copy when ``copy``)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy)
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def host_copy(state):
    """``state`` with every leaf copied to the host, ``None`` kept."""
    return tree_map(lambda x: None if x is None else _to_host(x, copy=True),
                    state)


def _serialize(leaf) -> Tuple[bytes, List[int], str]:
    """(raw bytes, shape, dtype name) of a host leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return raw, list(t.shape), _dtype_name(t.dtype)
    arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _deserialize(raw: bytes, shape: List[int], dtype: str):
    """A CPU tensor (a numpy array for a dtype torch lacks)."""
    if dtype == "bfloat16":
        if not raw:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16) \
            .reshape(shape)
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    try:
        return torch.from_numpy(arr)
    except TypeError:
        return arr


class CACheckpointer:
    def __init__(self, sai: SAI, prefix: str = "ckpt"):
        self.sai = sai
        self.prefix = prefix
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self.history: List[dict] = []

    # ------------------------------------------------------------------
    def save(self, step: int, params, opt_state=None,
             extra: Optional[dict] = None) -> dict:
        t0 = time.perf_counter()
        state = {"params": params}
        if opt_state is not None:
            state["opt"] = opt_state
        leaves: List[Tuple[str, Any]] = []
        _walk(state, (), leaves)
        # submit the whole burst before gathering: the engine fuses the
        # queued per-leaf hash requests into batched launches, and the
        # pipeline overlaps chunk/hash of leaf i+1 with store of leaf i
        futs = []
        for key, leaf in leaves:
            raw, shape, dtype = _serialize(_to_host(leaf))
            path = f"{self.prefix}/{key}"
            futs.append((key, shape, dtype, path,
                         self.sai.write_async(path, raw)))
        manifest = {"step": int(step), "leaves": [], "extra": extra or {}}
        totals = WriteStats()
        for key, shape, dtype, path, fut in futs:
            st = fut.result()
            manifest["leaves"].append(
                {"key": key, "shape": shape, "dtype": dtype,
                 "version": self.sai.manager.num_versions(path) - 1})
            totals.total_bytes += st.total_bytes
            totals.new_bytes += st.new_bytes
            totals.new_blocks += st.new_blocks
            totals.dup_blocks += st.dup_blocks
        self.sai.write(f"{self.prefix}/MANIFEST",
                       json.dumps(manifest).encode())
        rec = {
            "step": int(step),
            "total_bytes": totals.total_bytes,
            "new_bytes": totals.new_bytes,
            "dedup_ratio": 1.0 - totals.new_bytes
            / max(totals.total_bytes, 1),
            "wall_s": time.perf_counter() - t0,
        }
        with self._lock:
            self.history.append(rec)
        return rec

    def async_save(self, step: int, params, opt_state=None,
                   extra: Optional[dict] = None) -> threading.Thread:
        """Non-blocking save: every leaf is copied to the host before this
        returns, then hashed and stored in a background thread."""
        snap_p, snap_o = host_copy(params), host_copy(opt_state)
        self.wait()
        t = threading.Thread(
            target=self.save, args=(step, snap_p, snap_o, extra),
            daemon=True, name=f"ca-ckpt-{step}")
        t.start()
        self._pending = t
        return t

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # ------------------------------------------------------------------
    def restore(self, version: int = -1):
        """Returns (step, state dict, extra) for the requested manifest
        version; the state's leaves are CPU tensors.

        Every leaf is read through the SAI's pipelined ``read_async``:
        all reads are submitted up front, so the verify stage of leaf i
        overlaps the fetch of leaf i+1 and the per-leaf verify requests
        coalesce into batched kernel launches."""
        raw = self.sai.read(f"{self.prefix}/MANIFEST", version=version)
        manifest = json.loads(raw.decode())
        futs = [(leaf, self.sai.read_async(f"{self.prefix}/{leaf['key']}",
                                           version=leaf["version"]))
                for leaf in manifest["leaves"]]
        flat: Dict[str, Any] = {}
        for leaf, fut in futs:
            flat[leaf["key"]] = _deserialize(fut.result(), leaf["shape"],
                                             leaf["dtype"])
        return manifest["step"], _unflatten(flat), manifest["extra"]


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = arr
    return root
