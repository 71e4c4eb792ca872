"""Small runs of the benchmark's cells on the CPU for the tests: the same
harness, the program's plain kernels, kilobyte images and chunks."""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402

WRITE_CDC = "cas-cdc.ckpt-write"
WRITE_FIXED = "integrity-fixed.ckpt-write"
RESTORE = "integrity-fixed.ckpt-restore"
HERE_CONTROLS = ROOT / "perfbench" / "controls"
# sizes a CPU run holds: the plain MD5 takes about 2 ms per 64-byte step
SMALL = {"config": {"sai": {"avg_chunk": 2048, "min_chunk": 512,
                            "max_chunk": 8192, "block_size": 4096}},
         "traffic": {"series": {"image_bytes": 32768, "versions": 4},
                     "warmup_ops": 1}}




def manifest():
    """BENCHMARK.json with the entries kept out of it until their runs
    are steady enough for a bound, so that the harness's paths and their
    readers are tested through them: the verified-read cell and its
    metrics (``restore_cell.json``), and the write cells' host-clock rate
    and host stages (``host_path.json``)."""
    m = harness.load_manifest()
    for kept in ("restore_cell.json", "host_path.json"):
        with open(Path(__file__).with_name(kept)) as f:
            for key, entries in json.load(f).items():
                m[key] = m[key] + entries
    return m


def small_run(workload, seed=7, seconds=1.5, trace=False, control=None):
    return harness.run_cell(manifest(), workload, seed, seconds,
                            trace, torch.device("cpu"), time.perf_counter(),
                            control=control, scale=SMALL)
