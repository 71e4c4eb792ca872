"""One run of one cell: set-up, the measured window, the reference check
and the metrics.

Everything a cell is made of is found by name: its configuration file
(``BENCHMARK.json``'s ``configs[].file``), its chunking rule's reference
and device work (``perfbench/chunkers/<ca>.py``, ``reference.chunker``),
its traffic mix (``perfbench/traffic/<traffic>.json``) and each metric's
reader (``perfbench/metrics/<name>.py``, else the file of the part of the
name before its first dot).  ``run_cell`` takes the device as an
argument, so the tests drive the same code on the CPU at small sizes.
"""
from __future__ import annotations

import copy
import gc
import importlib.util
import itertools
import json
import queue
import sys
import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import check, devtrace, reference, roofline
from perfbench import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = HERE / "out"                      # device traces of the windows
PATH = "/ckpt"
# a minute past the close for an answer that comes late
WAIT_S = 60.0


# ----------------------------------------------------------------------
# finding a cell's files
# ----------------------------------------------------------------------
def load_manifest(path: Path = ROOT / "BENCHMARK.json") -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(manifest: Dict, workload: str):
    """(cell, configuration, traffic) of the named workload."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_of(manifest: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def reader(name: str) -> Callable:
    """The ``read(run)`` function of a metric's reader file."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                "perfbench_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r}")


def merged(base: Dict, over: Optional[Dict]) -> Dict:
    """``base`` with the nested entries of ``over`` put in."""
    out = json.loads(json.dumps(base))
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = v
    return out


# ----------------------------------------------------------------------
# what the readers read
# ----------------------------------------------------------------------
@dataclass
class Run:
    """One run's record: the metric readers take everything from here."""
    op: str                             # 'write' | 'read'
    t0: float = 0.0                     # first timed submission
    t1: float = 0.0                     # last completion
    # (t0, t1) of each pause of the clock inside the window: the check
    # of a lap's stores between laps
    paused: List = field(default_factory=list)
    setup_s: float = 0.0
    ops_done: int = 0                   # operations that succeeded
    bytes_done: int = 0
    spans: List = field(default_factory=list)    # (name, t0, t1)
    # (name, t0, t1, parent, meta) of the same spans
    span_records: List = field(default_factory=list)
    counters: Dict = field(default_factory=dict)  # engine before/after
    device: Optional[devtrace.DeviceTrace] = None
    work: Dict = field(default_factory=dict)     # kernel -> (ops, bytes)
    gpu: Optional[Dict] = None          # sms, sm_clock_hz

    @property
    def paused_s(self) -> float:
        return sum(b - a for a, b in self.paused)

    @property
    def window_s(self) -> float:
        """The window's length less its pauses: what the program had."""
        return self.t1 - self.t0 - self.paused_s

    def mean_span_ms(self, name: str) -> Optional[float]:
        ds = [t1 - t0 for n, t0, t1 in self.spans if n == name]
        return 1e3 * sum(ds) / len(ds) if ds else None

    def roofline_pct(self, kernel: str, work: str) -> Optional[float]:
        """Least time of the window's ``work`` over the summed time of
        the device operations whose name holds ``kernel``."""
        if self.device is None or self.gpu is None or work not in self.work:
            return None
        spent = self.device.seconds_by_name(kernel)
        if spent <= 0:
            return None
        ops, nbytes = self.work[work]
        return 100.0 * roofline.least_seconds(
            ops, nbytes, self.gpu["sms"], self.gpu["sm_clock_hz"]) / spent


# ----------------------------------------------------------------------
# the program under test
# ----------------------------------------------------------------------
class Program:
    """The port's storage stack as a configuration states it."""

    def __init__(self, config: Dict, device: torch.device):
        from repro_torch.core import CrystalGPU
        self.config = config
        self.engine = CrystalGPU(devices=[device])

    def store(self):
        """A fresh store and an SAI over it: (sai, manager, nodes)."""
        from repro_torch.core import SAI, SAIConfig, make_store
        st = self.config["store"]
        mgr, nodes = make_store(st["nodes"], replication=st["replication"])
        return SAI(mgr, SAIConfig(**self.config["sai"]),
                   crystal=self.engine), mgr, nodes

    def stats(self) -> Dict:
        """A copy of the engine's whole ``snapshot_stats()``."""
        return copy.deepcopy(self.engine.snapshot_stats())

    def close(self):
        self.engine.shutdown()


def new_trace(i: int, name: str):
    from repro_torch.obs import Trace
    return Trace(i, name)


def block_map(mgr, version: int):
    fv = mgr.get_blockmap(PATH, version)
    if fv is None:
        return None
    return [(b.digest, b.length, tuple(b.nodes)) for b in fv.blocks]


def tally(counts: Counter, blame: Optional[str], fn: Callable, *args):
    """Add the counts ``fn(*args)`` returns; if it raises, the answer it
    checked is wrong: add one to ``blame`` (None: the task's record says
    so already)."""
    try:
        counts.update(fn(*args))
    except Exception as e:                   # the answer is wrong
        print(f"check {blame}: {e!r}", file=sys.stderr)
        if blame is not None:
            counts[blame] += 1


class Checker:
    """A thread that checks every read's bytes as it returns, while the
    window runs, so that the submitting thread does none of it.  Its
    queue is short, so a checker that falls behind holds the window back
    rather than filling the host's memory.  A task is ``tally``'s."""

    def __init__(self, depth: int = 2):
        self.tasks: queue.Queue = queue.Queue(maxsize=depth)
        self.counts: Counter = Counter()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="perfbench-check")
        self.thread.start()

    def put(self, blame: Optional[str], fn: Callable, *args):
        self.tasks.put((blame, fn, args))

    def _loop(self):
        while True:
            task = self.tasks.get()
            if task is None:
                return
            blame, fn, args = task
            tally(self.counts, blame, fn, *args)

    def close(self) -> Counter:
        """Wait for every task; the counts."""
        self.tasks.put(None)
        self.thread.join()
        return self.counts


def write_all(sai, series, versions, in_flight: int):
    """Set-up writes, ``in_flight`` at a time; raises on a failure."""
    pending = deque()
    for v in versions:
        if len(pending) >= in_flight:
            pending.popleft().result(timeout=WAIT_S * 5)
        pending.append(sai.write_async(PATH, series[v]))
    for f in pending:
        f.result(timeout=WAIT_S * 5)


# ----------------------------------------------------------------------
# the timed loops
# ----------------------------------------------------------------------
class Lap:
    """One lap's fresh store, and the records of its writes."""

    def __init__(self, index: int, prog: Program):
        self.index = index
        self.sai, self.mgr, self.nodes = prog.store()
        self.records: List[Dict] = []


def retire(lap: Lap, series, replication: int) -> Dict[str, int]:
    """Once a lap's writes are done: what the write check needs of its
    block maps into its records (``check.kept``: no collection in the
    rest of the window walks them), its SAI closed, every replica its
    maps name compared with the image, and the store dropped."""
    maps = {v: block_map(lap.mgr, v) for v in range(len(lap.records))}
    for rec in lap.records:
        if rec["counts"] is not None and maps[rec["version"]] is not None:
            rec["block_map"] = check.kept(maps[rec["version"]])
    lap.sai.close()
    nodes = lap.nodes
    faults = check.replicas(
        maps, series, replication,
        lambda nid, digest: _fetch_replica(nodes, nid, digest))
    lap.sai = lap.mgr = lap.nodes = None
    return {"replica_faults": faults}


def closed_loop(run: Run, seconds: float, in_flight: int,
                submit: Callable, finish: Callable,
                between: Optional[Callable] = None):
    """Keep ``in_flight`` operations going until ``seconds`` of the
    window have passed, then wait for the last: ``submit()`` starts one,
    ``finish(op, timeout)`` waits for it.  The window runs from the first
    submission to the last completion.  ``between()``, asked before each
    submission, returns work to do with the clock stopped, or None: the
    operations in flight are completed first, then the work runs and its
    interval goes into ``run.paused`` and onto the deadline, so the
    program still has ``seconds``.  Past the deadline it is left undone."""
    pending = deque()
    run.t0 = time.perf_counter()
    deadline = run.t0 + seconds
    run.t1 = run.t0

    def complete():
        finish(pending.popleft(),
               max(deadline - time.perf_counter(), 0) + WAIT_S)
        run.t1 = time.perf_counter()

    while True:
        while len(pending) < in_flight and time.perf_counter() < deadline:
            work = between() if between is not None else None
            if work is not None:
                while pending:
                    complete()
                if time.perf_counter() >= deadline:
                    break
                stop = time.perf_counter()
                work()
                start = time.perf_counter()
                run.paused.append((stop, start))
                deadline += start - stop
            pending.append(submit())
        if not pending:
            return
        complete()


def timed_writes(prog, series, traffic, seconds, trace, run,
                 replication: int):
    """The window's writes, each lap into a fresh store.  Each lap is
    checked (``retire``) between laps with the clock stopped, the last
    once the window has closed: the returned ``close_check()`` does that
    and gives the counts."""
    versions = traffic_mod.op_versions(traffic, 0)
    done: List[Dict] = []
    traces: List = []
    ids = itertools.count()
    found: Counter = Counter()
    state = {"lap": None, "laps": 0, "next": next(versions)}

    def check_lap():
        tally(found, "replica_faults", retire, state["lap"], series,
              replication)
        state["lap"] = None

    def between():
        """Before a lap's first write, the check of the lap before it."""
        return check_lap if state["next"] == 0 and state["lap"] else None

    def submit():
        v, state["next"] = state["next"], next(versions)
        if v == 0:
            state["lap"] = Lap(state["laps"], prog)
            state["laps"] += 1
        lap = state["lap"]
        tr = new_trace(next(ids), "write") if trace else None
        rec = {"lap": lap.index, "version": v, "counts": None,
               "block_map": None}
        lap.records.append(rec)
        return rec, lap.sai.write_async(PATH, series[v], trace=tr), tr

    def finish(op, timeout):
        rec, fut, tr = op
        try:
            st = fut.result(timeout=timeout)
            rec["counts"] = (st.new_blocks, st.dup_blocks, st.new_bytes,
                             st.total_bytes)
            run.ops_done += 1
            run.bytes_done += series[rec["version"]].size
        except Exception as e:               # counted as failed
            rec["error"] = repr(e)
        done.append(rec)
        traces.extend([tr] if tr is not None else [])

    def close_check() -> Counter:
        if state["lap"] is not None:
            check_lap()
        return found

    closed_loop(run, seconds, traffic["in_flight"], submit, finish,
                between)
    return done, traces, close_check


def compare_read(rec: Dict, data: bytes, image: np.ndarray):
    rec["same"] = check.same_bytes(data, image)
    return {}


def timed_reads(sai, series, traffic, seconds, trace, run, seed, checker):
    versions = traffic_mod.op_versions(traffic, seed)
    verify = bool(traffic["verify"])
    done: List[Dict] = []
    traces: List = []
    ids = itertools.count()

    def submit():
        v = next(versions)
        tr = new_trace(next(ids), "read") if trace else None
        return v, sai.read_async(PATH, version=v, verify=verify,
                                 trace=tr), tr

    def finish(op, timeout):
        v, fut, tr = op
        rec = {"version": v, "length": None, "same": False}
        try:
            data = fut.result(timeout=timeout)
            rec["length"] = len(data)
            run.ops_done += 1
            run.bytes_done += len(data)
            checker.put(None, compare_read, rec, data, series[v])
        except Exception as e:               # counted as failed
            rec["error"] = repr(e)
        done.append(rec)
        traces.extend([tr] if tr is not None else [])

    closed_loop(run, seconds, traffic["in_flight"], submit, finish)
    return done, traces


def corrupt_replicas(mgr, nodes, series_len: int, per_version: int, rng):
    """Flip one byte of one replica of ``per_version`` blocks of each
    version, the blocks, replicas and bytes drawn from the seed: bit rot
    that a verified read must catch and read around."""
    hit = set()
    for v in range(series_len):
        blocks = mgr.get_blockmap(PATH, v).blocks
        for b in rng.choice(len(blocks), size=min(per_version, len(blocks)),
                            replace=False):
            blk = blocks[int(b)]
            if blk.digest in hit:
                continue
            hit.add(blk.digest)
            nid = blk.nodes[int(rng.integers(0, len(blk.nodes)))]
            data = bytearray(nodes[nid].blocks[blk.digest])
            data[int(rng.integers(0, len(data)))] ^= 0xFF
            nodes[nid].blocks[blk.digest] = bytes(data)


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------
def run_cell(manifest: Dict, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             gpu: Optional[Dict] = None, control: Optional[Dict] = None,
             scale: Optional[Dict] = None) -> Dict:
    """Set up, measure for ``seconds``, check against the reference and
    return the result line's fields.  ``t_start`` is the process's start
    (set-up counts from there).  ``control`` changes the program's
    configuration or traffic only (the reference keeps the cell's);
    ``scale`` changes both (the tests' small sizes)."""
    _, config, traffic = cell_files(manifest, workload)
    config = merged(config, (scale or {}).get("config"))
    traffic = merged(traffic, (scale or {}).get("traffic"))
    prog_config = merged(config, (control or {}).get("config"))
    prog_traffic = merged(traffic, (control or {}).get("traffic"))
    cuda = device.type == "cuda"
    rng = np.random.default_rng([seed, 2])

    parts = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    series = traffic_mod.series_of(traffic, seed)
    parts["series_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prog = Program(prog_config, device)
    parts["engine_s"] = time.perf_counter() - t
    t = time.perf_counter()
    run = Run(op=traffic["op"])
    store = None
    warm = range(traffic["warmup_ops"])
    if traffic["op"] == "write":
        sai, _, _ = prog.store()
        write_all(sai, series, warm, traffic["in_flight"])
        sai.close()
    else:
        store = prog.store()
        write_all(store[0], series, range(len(series)), traffic["in_flight"])
        for v in warm:
            store[0].read_async(PATH, version=v,
                                verify=prog_traffic["verify"]).result(
                                    timeout=WAIT_S * 5)
        corrupt_replicas(store[1], store[2], len(series),
                         traffic["corrupt_blocks_per_version"], rng)
    if cuda:
        torch.cuda.synchronize(device)
    # what set-up made lives to the end: no collection in the window
    # walks it again
    gc.collect()
    gc.freeze()
    # the card is profiled in a traced window, and in any window on a
    # card whose metrics read the device trace
    profile = trace or cuda and any(
        m["source"] == "device_trace"
        for m in metrics_of(manifest, workload, False))
    recorder = devtrace.Recorder() if profile else None
    if recorder is not None:
        recorder.start()
    run.counters["before"] = prog.stats()
    run.setup_s = time.perf_counter() - t_start
    parts["warmup_s"] = time.perf_counter() - t

    replication = config["store"]["replication"]
    if traffic["op"] == "write":
        done, traces, close_check = timed_writes(
            prog, series, prog_traffic, seconds, trace, run, replication)
    else:
        checker = Checker()
        done, traces = timed_reads(store[0], series, prog_traffic, seconds,
                                   trace, run, seed, checker)
        close_check = checker.close
    run.counters["after"] = prog.stats()
    if recorder is not None:
        OUT.mkdir(parents=True, exist_ok=True)
        path = OUT / (f"trace-{workload}-{seed}.json" if trace
                      else f"window-{workload}.json")
        run.device = recorder.stop(str(path), run.t0, run.t1, run.paused)
        if not trace:                   # read: only a traced run keeps it
            path.unlink()
    spans = [s for tr in traces for s in tr.spans]
    run.spans = [(s.name, s.t0, s.t1) for s in spans]
    run.span_records = [(s.name, s.t0, s.t1, s.parent, dict(s.meta))
                        for s in spans]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t = time.perf_counter()
    found = close_check()
    parts["check_wait_s"] = time.perf_counter() - t
    parts["check_pause_s"] = run.paused_s
    parts["window_s"] = run.window_s
    if store is not None:
        store[0].close()
    prog.close()
    store = prog = None
    gc.unfreeze()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is gone
    t = time.perf_counter()
    used = sorted({d["version"] for d in done})
    # a write's dedup counts depend on every version before it in its lap
    need = range(max(used) + 1) if used and run.op == "write" else used
    bounds = {v: reference.chunk_bounds(series[v], config["sai"], device)
              for v in need}
    lens = {v: np.diff([0] + b).tolist() for v, b in bounds.items()}
    if run.op == "write":
        digests = {v: reference.block_digests(series[v], bounds[v])
                   for v in need}
        dedup = dict(zip(need, reference.dedup_counts(
            [digests[v] for v in need], [lens[v] for v in need])))
        numbers = check.writes(done, bounds, digests, dedup, series)
        numbers["replica_faults"] = found["replica_faults"]
    else:
        numbers = check.reads(done, series)
    correct = check.verdict(numbers, run.ops_done)
    parts["check_s"] = time.perf_counter() - t

    run.work = _work(done, lens, series, config["sai"], run.op)
    run.gpu = gpu
    metrics = {}
    for m in metrics_of(manifest, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(done),
              "failed": numbers["ops_failed"],
              "metrics": metrics,
              "device": {"memory_peak_bytes": int(peak)}}
    if trace and run.device is not None:
        result["device"]["busy_s"] = run.device.busy_s
        result["device"]["window_s"] = run.device.window_s
        result["breakdown"] = {
            "device_ops": run.device.top_ops(),
            "idle_gaps": run.device.idle_by_host(
                [s for s in run.spans if s[0].startswith("sai/")])}
    result["timings"] = parts
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


def _fetch_replica(nodes, nid: int, digest: bytes) -> Optional[bytes]:
    try:
        return nodes[nid].get(digest)
    except (KeyError, RuntimeError):          # missing, or node down
        return None


def _work(done, lens, series, sai: Dict, op: str) -> Dict:
    """Kernel -> (integer instructions, bytes) the window's successful
    operations asked of the card: every block's digest (written or
    verified), and for every image written what its chunking rule's
    ``work`` gives (``reference.chunker``)."""
    rule = reference.chunker(sai["ca"]) if op == "write" else None
    work: Dict[str, List[float]] = {"md5_direct": [0.0, 0.0]}
    for d in done:
        if "error" in d:
            continue
        v = d["version"]
        parts = [("md5_direct", roofline.md5_direct_work(lens[v]))]
        if rule is not None:
            parts += rule.work(series[v].size, sai).items()
        for name, (ops, nbytes) in parts:
            acc = work.setdefault(name, [0.0, 0.0])
            acc[0] += ops
            acc[1] += nbytes
    return {k: tuple(v) for k, v in work.items() if v[0] > 0 or v[1] > 0}
