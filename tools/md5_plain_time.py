#!/usr/bin/env python3
"""CPU time of the port's plain MD5 (``kernels.ref.md5_words_ref``, the
version ``kernels.md5.md5_plain`` runs for CPU tensors) on one message
of 4 KiB, the block size of the node runtime's scrub in the CPU tests.

Run from the root of a checkout:
``python3 tools/md5_plain_time.py [--baseline OLD_REF.py] [--repeats N]``.
It prints the median and the fastest of N calls (default 8) after a
warm-up call, each digest checked against ``hashlib``.  With
``--baseline`` it also times another version of ``ref.py`` (for
instance an earlier commit's, written with ``git show
<rev>:src/repro_torch/kernels/ref.py > build/ref_old.py``), the two
interleaved call by call so that a loaded host slows both alike.  Runs
on the CPU; needs no card.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

BLOCK_BYTES = 4096


def load(path: str):
    spec = importlib.util.spec_from_file_location("ref_baseline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--repeats", type=int, default=8)
    args = ap.parse_args(argv)
    block = np.random.default_rng(0).bytes(BLOCK_BYTES)
    words = torch.from_numpy(np.frombuffer(block, "<u4").view(np.int32)
                             .copy())[None]
    lens = torch.tensor([BLOCK_BYTES // 4])
    want = hashlib.md5(block).hexdigest()
    versions = {"ref.py": ref.md5_words_ref}
    if args.baseline:
        versions["baseline"] = load(args.baseline).md5_words_ref
    times = {name: [] for name in versions}
    for fn in versions.values():                      # warm-up, checked
        got = (fn(words, lens)[0] & 0xFFFFFFFF).numpy().astype("<u4")
        assert got.tobytes().hex() == want
    for _ in range(args.repeats):
        for name, fn in versions.items():
            t0 = time.perf_counter()
            fn(words, lens)
            times[name].append(time.perf_counter() - t0)
    print(f"plain MD5 of one {BLOCK_BYTES}-byte message on the CPU "
          f"(torch {torch.__version__}, {os.cpu_count()} CPUs, "
          f"{args.repeats} calls each, interleaved):")
    for name, ts in times.items():
        print(f"  {name}: median {statistics.median(ts):.4f} s, fastest "
              f"{min(ts):.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
