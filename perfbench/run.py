"""The port's benchmark: one run of one cell on the card it starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control <name>]

The cells, metrics and bounds are in ``BENCHMARK.json`` at the root of
the checkout; ``harness.py`` finds each cell's files by name.  The last
line on standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared beside its
limit, which are also the last lines on standard error).  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones
from a profiled window.  ``--control <name>`` runs the program under
``perfbench/controls/<name>.json``, a change that breaks a guarantee of
the configuration; the check has to come out false.

It exits non-zero and prints no result when there is no CUDA card (or
fewer than the cell asks for), when the program cannot be imported, and
when JAX or the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# JAX, its bindings, flax and the JAX package, by whole top-level name
BANNED = ("jax", "jaxlib", "flax", "repro")
# kernel caches a library may keep, at fixed paths inside the checkout
# (the port's own kernel build lives in <checkout>/build/repro_torch)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "extensions",
          "CUDA_CACHE_PATH": "cuda"}


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def gpu_facts(torch):
    """Name, SMs, max SM clock and power limit of card 0."""
    props = torch.cuda.get_device_properties(0)
    facts = {"kind": torch.cuda.get_device_name(0),
             "sms": props.multi_processor_count}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    if out.returncode == 0:
        limit, clock = (x.strip() for x in out.stdout.split(","))
        facts["power_limit_w"] = float(limit)
        facts["sm_clock_hz"] = float(clock) * 1e6
    return facts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control")
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench-cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench import harness
    import repro_torch.core  # noqa: F401  (the program; fails without it)

    manifest = harness.load_manifest()
    cell, _, _ = harness.cell_files(manifest, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    facts = gpu_facts(torch)
    control = None
    if args.control:
        with open(HERE / "controls" / f"{args.control}.json") as f:
            control = json.load(f)
    gpu = {"sms": facts["sms"], "sm_clock_hz": facts["sm_clock_hz"]} \
        if "sm_clock_hz" in facts else None
    result = harness.run_cell(
        manifest, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START, gpu=gpu, control=control)
    found = banned_modules()
    if found:
        print(f"loaded in the run's process: {found}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": facts["kind"],
                        "count": cell["chips"], **result["device"],
                        **{k: facts[k] for k in ("power_limit_w",)
                           if k in facts}}
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
