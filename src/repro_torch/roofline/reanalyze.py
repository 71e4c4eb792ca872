"""Re-derive roofline fields of dry-run JSONs from their stored op traces
(no step is run again).

  PYTHONPATH=src python -m repro_torch.roofline.reanalyze [results_dir]

``results_dir`` (default ``results/torch``) holds ``dryrun/*.json`` and
``trace/*.trace.gz``, as ``launch/dryrun.py`` writes them.
"""
from __future__ import annotations

import gzip
import json
import os
import sys

from repro_torch.roofline.hlo_analysis import analyze_hlo


def reanalyze(base: str) -> int:
    """Rewrite every record under ``base`` that has a trace; returns how
    many were rewritten."""
    dr = os.path.join(base, "dryrun")
    trace_dir = os.path.join(base, "trace")
    n = 0
    for fn in sorted(os.listdir(dr)):
        if not fn.endswith(".json"):
            continue
        stem = fn[:-5]
        trace_path = os.path.join(trace_dir, stem + ".trace.gz")
        if not os.path.exists(trace_path):
            print(f"[skip] no trace for {stem}")
            continue
        with gzip.open(trace_path, "rt") as f:
            trace = f.read()
        an = analyze_hlo(trace)
        path = os.path.join(dr, fn)
        with open(path) as f:
            rec = json.load(f)
        rec["flops_scaled"] = an["flops"]
        rec["bytes_scaled"] = an["bytes_accessed"]
        rec["bytes_upper"] = an["bytes_upper"]
        rec["collectives"] = {"wire_bytes": an["wire_bytes"],
                              "op_counts": an["op_counts"],
                              "total_wire_bytes": an["total_wire_bytes"]}
        rec["top_collectives"] = an["top_collectives"]
        rec["top_bytes"] = an["top_bytes"]
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    return n


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    base = argv[0] if argv else os.path.join("results", "torch")
    print(f"reanalyzed {reanalyze(base)} records")


if __name__ == "__main__":
    main()
