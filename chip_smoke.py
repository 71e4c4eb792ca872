#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
CUDA kernels from ``src/repro_torch/kernels/csrc`` and runs five phases,
each printing its results:

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build: build time, what ``ptxas -v`` reports (registers, spills) and
   each kernel's SASS opcode mix (``cuobjdump -sass``);
3. every kernel against its plain PyTorch version on the card, bit for
   bit, and against ``hashlib``;
4. the main path, the SAI content-addressable write/read path: a series
   of four 256 MiB checkpoint images written with ``write_async`` and read
   back with verification, under fixed 1 MiB blocks (``ca='fixed'``),
   sliding-window-MD5 content-defined chunking with the SAI's defaults
   (``ca='cdc'``, window 48, stride 4) and the same at stride 1 (the
   paper's byte-granular windows), with the kernels' launch counts over
   exactly that run and each configuration's similarities held to their
   known values; sliding hashes of one image against ``hashlib`` at both
   strides; then a refetch of a corrupted replica and a durable store
   reopened and read;
5. each kernel at the main path's shapes (the sliding kernel at both of
   its strides): its time with CUDA events beside its bound, and its
   plain version's time and result on the same inputs (bit for bit).

Any failed check raises, so the script exits non-zero.  The line before
the last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits with
code 2 and prints no result.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

MiB = 1 << 20
N_IMAGES = 4
IMAGE_BYTES = 256 * MiB
DURABLE_BYTES = 64 * MiB
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
# 32-bit integer results per clock per SM for compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput): 64 for
# add, logical op and shift, which run on the ALU pipe, and 64 for
# multiply-add (IMAD), which runs on the FMA pipe beside it.  An add can
# be issued as either, so an SM issues at most 128 integer instructions
# per clock, of which at most 64 on the ALU pipe.
ALU_LANES_PER_SM = 64
INT_LANES_PER_SM = 128
# ALU-only instructions per 64-byte MD5 compression: per round one LOP3
# (the round's boolean function) and one funnel shift (the rotation)
ALU_ONLY_PER_COMPRESSION = 64 * 2
# SASS opcodes of the ALU pipe and of the FMA pipe counted in phase 2
ALU_OPCODES = ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT",
               "IABS", "IMNMX", "MOV")
FMA_OPCODES = ("IMAD",)
# kernel name -> substrings of its SASS function name, mangled or not
# (the sliding kernel at the main path's window of 12 words)
SASS_FUNCTIONS = {"md5_direct": ("md5_direct_kernel",),
                  "sliding_md5": ("sliding_md5_kernelILi12E",
                                  "sliding_md5_kernel<12>")}
# WriteStats.similarity of the four versions of checkpoint_series(seed=0)
# per configuration, to 4 places.  At stride 4 a window is hashed only at
# offsets 0 mod 4, so an insert of k bytes with k % 4 != 0 moves the
# content off the grid and chunking does not resynchronise after it;
# byte-granular windows (stride 1) do
SIMILARITY = {"fixed": [0.0, 0.7773, 0.4141, 0.8086],
              "cdc": [0.0, 0.7582, 0.4124, 0.7732],
              "cdc-stride1": [0.0, 0.8678, 0.8533, 0.8486]}


def ops_per_compression(const_words: int = 0, final_adds: int = 4) -> int:
    """Integer instructions per 64-byte MD5 compression, the least Hopper
    can issue: per round one LOP3, two adds for f + a + K + M (one when
    message word M is a compile-time constant, since K + M folds), one
    funnel shift and one add; then the final adds.  Each of the
    ``const_words`` constant message words is read by 4 rounds."""
    return 64 * 5 - 4 * const_words + final_adds


def check(cond, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def run(cmd) -> str:
    return subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          check=True).stdout.strip()


def checkpoint_series(n_images: int, image_bytes: int,
                      change_frac: float = 0.15, seed: int = 0):
    """Synthetic BLCR-like checkpoint images: each successive image
    rewrites a contiguous region in place AND applies an insert/delete
    pair (heap growth shifts content — what makes fixed-block dedup fail
    in the paper: 21-23% fixed vs 76-90% CDC similarity)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, image_bytes, dtype=np.uint8)
    out = [img.tobytes()]
    for i in range(1, n_images):
        buf = bytearray(img.tobytes())
        span = int(image_bytes * change_frac)
        start = int(rng.integers(0, len(buf) - span))
        buf[start:start + span] = rng.integers(
            0, 256, span, dtype=np.uint8).tobytes()
        # insert/delete pair: shifts everything between the two points
        k = int(rng.integers(1, 4096))
        ins = int(rng.integers(0, len(buf)))
        buf[ins:ins] = rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        del_at = int(rng.integers(0, len(buf) - k))
        del buf[del_at:del_at + k]
        img = np.frombuffer(bytes(buf), dtype=np.uint8)
        out.append(bytes(buf))
    return out


def words_equal(a, b) -> bool:
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def max_abs_err(a, b) -> int:
    import torch
    diff = (a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) \
        - (b.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    return int(diff.abs().max()) if diff.numel() else 0


def time_cuda(fn, flush, repeats: int = 5, warmup: int = 1) -> float:
    """Median ms of ``fn`` between CUDA events, with the L2 cache flushed
    (a 256 MiB write) before every launch."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_env(torch):
    print("== phase 1: environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    from repro_torch.kernels import _build
    print(run([_build.nvcc_path(), "--version"]).splitlines()[-1])
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    clock = run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"]).splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    # SM-clocks per second over the whole card
    sm_clocks = props.multi_processor_count * float(clock) * 1e6
    print(f"device {torch.cuda.get_device_name(0)}  count "
          f"{torch.cuda.device_count()}  SMs {props.multi_processor_count}"
          f"  max SM clock {clock} MHz")
    print(f"integer peak {sm_clocks * INT_LANES_PER_SM / 1e12:.2f} TOP/s "
          f"(SMs x {INT_LANES_PER_SM} lanes x max SM clock: ALU pipe and "
          f"IMAD on the FMA pipe), of which ALU pipe "
          f"{sm_clocks * ALU_LANES_PER_SM / 1e12:.2f} TOP/s; HBM "
          f"{HBM_BYTES_PER_S / 1e12} TB/s (data sheet)")
    return smi, sm_clocks


def sass_mix(so_path: str, cuobjdump: str):
    """Opcode counts (modifiers dropped) of every kernel function in the
    SASS of the built library."""
    mix, fn = {}, None
    for line in run([cuobjdump, "-sass", so_path]).splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = mix.setdefault(line.split(":", 1)[1].strip(),
                                collections.Counter())
        elif fn is not None and line.startswith("/*") and "*/" in line:
            tok = line.split("*/", 1)[1].split()
            if tok and tok[0].startswith("@"):
                tok = tok[1:]
            if tok and not tok[0].startswith("/*"):
                fn[tok[0].split(".")[0]] += 1
    return mix


def phase_build():
    print("== phase 2: build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {lib.path} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.seconds:.2f} s)")
    for line in lib.log.splitlines():
        if line.startswith("==") or "registers" in line \
                or "spill" in line:
            print("  " + line.strip())
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    mix = sass_mix(str(lib.path), cuobjdump)
    pipes = {}
    for name, keys in SASS_FUNCTIONS.items():
        found = [m for fn, m in mix.items() if any(k in fn for k in keys)]
        check(len(found) == 1, f"one SASS function for {name}")
        m = found[0]
        pipes[name] = (sum(m[op] for op in ALU_OPCODES),
                       sum(m[op] for op in FMA_OPCODES))
        print(f"SASS {name}: {sum(m.values())} instructions, ALU pipe "
              f"{pipes[name][0]}, IMAD (FMA pipe) {pipes[name][1]}; "
              f"{dict(m.most_common(12))}")
    return pipes


def phase_kernels(torch, np, dev):
    print("== phase 3: kernels against their plain versions")
    from repro_torch.kernels import md5, ops, sliding_md5
    rng = np.random.default_rng(1)
    errs = {"md5_direct": 0, "sliding_md5": 0}
    # md5: ragged lens incl. lens == W, one word and zero words; B not a
    # multiple of 32; rows up to 64 KiB
    for B, W in [(45, 16384), (33, 1), (64, 257), (1, 4096)]:
        data = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint32)
        lens = rng.integers(0, W + 1, B).astype(np.int32)
        lens[0] = W
        if B > 2:
            lens[1], lens[2] = 1, 0
        words = torch.from_numpy(data).to(dev)
        got = md5.md5_words(words, torch.from_numpy(lens))
        torch.cuda.synchronize()
        want = md5.md5_plain(words, torch.from_numpy(lens).to(dev))
        check(words_equal(got, want), f"md5 kernel == plain at {B}x{W}")
        errs["md5_direct"] = max(errs["md5_direct"], max_abs_err(got, want))
        host = got.cpu().numpy()
        for i in range(B):
            ref = hashlib.md5(data[i, :lens[i]].astype("<u4").tobytes())
            check(host[i].astype("<u4").tobytes() == ref.digest(),
                  f"md5 kernel == hashlib, row {i} of {B}x{W}")
        print(f"md5_direct {B}x{W} words: bit-exact vs plain and hashlib")
    # sliding: strides 1/2/4 x windows 16/32/48 on a 16 MiB buffer
    buf = rng.integers(0, 256, 16 * MiB, dtype=np.uint8)
    words = torch.from_numpy(buf.view("<u4").copy()).to(dev)[None]
    for stride in (1, 2, 4):
        for window in (16, 32, 48):
            got = sliding_md5.sliding_md5_words(words, window // 4, stride)
            torch.cuda.synchronize()
            want = sliding_md5.sliding_plain(words, window // 4, stride)
            check(words_equal(got, want),
                  f"sliding kernel == plain, stride {stride} window "
                  f"{window}")
            errs["sliding_md5"] = max(errs["sliding_md5"],
                                      max_abs_err(got, want))
            phases = sliding_md5.phases_for(stride)
            n_off = (buf.size - window) // stride + 1
            hashes = ops.sliding_finish(got[0].cpu().numpy(), phases, n_off)
            for o in list(rng.integers(0, n_off, 200)) + [0, n_off - 1]:
                b0 = int(o) * stride
                ref = hashlib.md5(buf[b0:b0 + window].tobytes()).digest()
                check(int(hashes[o]) == int.from_bytes(ref[:4], "little"),
                      f"sliding == hashlib at offset {o}")
            print(f"sliding_md5 16 MiB stride {stride} window {window}: "
                  f"bit-exact vs plain and hashlib")
    short = ops.sliding_window_hash(b"shorter than a window", 48, 4,
                                    device=dev)
    check(short.shape == (0,), "input shorter than a window hashes empty")
    print("sliding_md5 input shorter than one window: empty")
    return errs


# name -> SAIConfig overrides of the main path's configurations
CONFIGS = {"fixed": {"ca": "fixed"}, "cdc": {"ca": "cdc"},
           "cdc-stride1": {"ca": "cdc", "stride": 1}}


def write_read(torch, np, eng, series, ca: str):
    from repro_torch.core import SAI, SAIConfig, make_store
    from repro_torch.core.sai import block_digest_cpu
    mgr, nodes = make_store(4, replication=2)
    sai = SAI(mgr, SAIConfig(**CONFIGS[ca]), crystal=eng)
    s0 = eng.snapshot_stats()
    total = sum(len(img) for img in series)
    t0 = time.perf_counter()
    futs = [sai.write_async("/ckpt", img) for img in series]
    stats = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = [sai.read("/ckpt", version=v) for v in range(len(series))]
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    s1 = eng.snapshot_stats()
    for v, (img, got) in enumerate(zip(series, back)):
        check(got == img, f"{ca}: version {v} reads back byte-identical")
    n_checked = 0
    for digest, locs in mgr.block_registry.items():
        for nid in locs:
            check(block_digest_cpu(nodes[nid].get(digest)) == digest,
                  f"{ca}: stored block {digest.hex()[:8]} on node {nid}")
            n_checked += 1
    out = {"write_mb_s": total / t_write / 1e6,
           "read_mb_s": total / t_read / 1e6,
           "similarity": [s.similarity for s in stats],
           "new_blocks": [s.new_blocks for s in stats],
           "dup_blocks": [s.dup_blocks for s in stats],
           "engine_jobs": s1["jobs"] - s0["jobs"],
           "engine_launches": s1["launches"] - s0["launches"],
           "blocks_checked": n_checked}
    check([round(x, 4) for x in out["similarity"]] == SIMILARITY[ca],
          f"{ca}: similarities {out['similarity']} match {SIMILARITY[ca]}")
    print(f"{ca}: write {out['write_mb_s']:.1f} MB/s, read (verified) "
          f"{out['read_mb_s']:.1f} MB/s over {N_IMAGES} x "
          f"{IMAGE_BYTES // MiB} MiB; similarity "
          f"{[round(x, 4) for x in out['similarity']]}; engine "
          f"{out['engine_launches']} launches / {out['engine_jobs']} jobs; "
          f"{n_checked} stored block copies match hashlib")
    return sai, mgr, nodes, out


def phase_main_path(torch, np, series):
    print("== phase 4: main path (SAI write/read through CrystalGPU)")
    from repro_torch.core import CrystalGPU
    from repro_torch.kernels import md5, sliding_md5
    eng = CrystalGPU()
    check([str(d) for d in eng.devices] == ["cuda:0"],
          f"engine on cuda:0, got {eng.devices}")
    counters = (md5.LAUNCHES, sliding_md5.LAUNCHES)
    kept = {}
    try:
        for c in counters:
            c.reset()
        per = {}
        for ca in CONFIGS:
            before = [c.value for c in counters]
            kept[ca] = write_read(torch, np, eng, series, ca)
            per[ca] = [c.value - b for c, b in zip(counters, before)]
            print(f"{ca}: kernel launches md5_direct {per[ca][0]}, "
                  f"sliding_md5 {per[ca][1]}")
        launches = {c.name: c.value for c in counters}
        print(f"main path kernel launches: {launches}")
        check(launches["md5"] > 0 and launches["sliding_md5"] > 0,
              "both kernels launched on the main path")
        check(per["fixed"][1] == 0 and per["cdc"][1] > 0
              and per["cdc-stride1"][1] > 0,
              "sliding kernel runs under ca='cdc' only")
        fixed, cdc1 = kept["fixed"][3], kept["cdc-stride1"][3]
        check(all(c > f for c, f in zip(cdc1["similarity"][1:],
                                        fixed["similarity"][1:])),
              "CDC (stride 1) similarity above fixed-block similarity, "
              "versions 2-4")

        # sliding hashes of one image against hashlib at sampled offsets,
        # at both strides of the main path
        img = np.frombuffer(series[1], np.uint8)
        rng = np.random.default_rng(2)
        for stride in (4, 1):
            hashes = eng.submit("sliding", img, {"window": 48,
                                                 "stride": stride}).wait()
            check(hashes.size == (img.size - 48) // stride + 1,
                  f"stride {stride}: one hash per window offset")
            offs = list(rng.integers(0, hashes.size, 1000)) \
                + [0, hashes.size - 1]
            for o in offs:
                b0 = int(o) * stride
                ref = hashlib.md5(img[b0:b0 + 48].tobytes()).digest()
                check(int(hashes[o]) == int.from_bytes(ref[:4], "little"),
                      f"image sliding hash == hashlib at offset {o}, "
                      f"stride {stride}")
            print(f"sliding hashes of image 2 at stride {stride} match "
                  f"hashlib at {len(offs)} sampled offsets")
            del hashes

        # corrupt one replica of one block: the read refetches
        sai, mgr, nodes, _ = kept["cdc"]
        fv, _ = mgr.get_read_plan("/ckpt", 0)
        digest = fv.blocks[0].digest
        nid = mgr.block_registry[digest][0]
        blk = nodes[nid].blocks[digest]
        nodes[nid].blocks[digest] = bytes([blk[0] ^ 0xFF]) + blk[1:]
        before = sai.read_stats["refetches"]
        check(sai.read("/ckpt", version=0) == series[0],
              "read after corrupting a replica returns the right bytes")
        check(sai.read_stats["refetches"] > before,
              "the corrupted replica was refetched")
        print(f"corrupted replica of block {digest.hex()[:8]} on node "
              f"{nid}: read refetched ({sai.read_stats['refetches']} "
              f"refetches)")
        for sai_, *_ in kept.values():
            sai_.close()

        phase_durable(eng, series[0][:DURABLE_BYTES])
    finally:
        eng.shutdown()
    return launches, kept


def phase_durable(eng, img: bytes):
    from repro_torch.core import SAI, SAIConfig, open_durable_store
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        mgr, _, _ = open_durable_store(d, n_nodes=4, replication=2)
        sai = SAI(mgr, SAIConfig(ca="fixed"), crystal=eng)
        sai.write("/durable", img)
        sai.close()
        mgr.close()
        mgr, _, report = open_durable_store(d, n_nodes=4, replication=2)
        sai = SAI(mgr, SAIConfig(ca="fixed"), crystal=eng)
        check(sai.read("/durable") == img, "durable store read after reopen")
        check(report.refcount_drift == 0, "recovery refcount drift is 0")
        sai.close()
        mgr.close()
    print(f"durable: {len(img) // MiB} MiB written, store reopened with "
          f"open_durable_store (snapshot seq {report.snapshot_seq}, "
          f"{report.replayed} records replayed), verified read matches")


def phase_times(torch, np, dev, sm_clocks, pipes, errs):
    print("== phase 5: kernels at the main path's shapes: times (CUDA "
          "events, L2 flushed) and checks against the plain versions")
    from repro_torch.kernels import md5, sliding_md5
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand_words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen).view(torch.uint32)

    def bound(n_comp, ops, nbytes):
        """Least time for ``n_comp`` compressions of ``ops`` integer
        instructions each, at most 128 per SM-clock of which at most 64
        on the ALU pipe, or for ``nbytes`` at the HBM rate."""
        t_ops = n_comp * max(ops / INT_LANES_PER_SM,
                             ALU_ONLY_PER_COMPRESSION / ALU_LANES_PER_SM) \
            / sm_clocks
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"

    def alu_ms(name, n_pass):
        """Time the ALU pipe alone needs for ``n_pass`` passes through
        the kernel's compiled SASS (one pass per message chunk or per
        window), were every pass to issue all its ALU instructions."""
        return n_pass * pipes[name][0] / (ALU_LANES_PER_SM * sm_clocks) \
            * 1e3

    def against_plain(name, got, plain):
        want = {}
        plain_ms = time_cuda(lambda: want.setdefault("v", plain()), flush,
                             repeats=1, warmup=0)
        check(words_equal(got, want["v"]), f"{name} kernel == plain at the "
              f"main path's shape")
        errs[name] = max(errs[name], max_abs_err(got, want["v"]))
        return plain_ms

    out = {}
    # md5: one launch as the SAI submits it — 64 messages of 1 MiB + 4 B
    # (262145 words) in 2 MiB staged rows
    B, W, n = 64, 2 * MiB // 4, MiB // 4 + 1
    words = rand_words(B, W)
    lens = torch.full((B,), n, dtype=torch.int32, device=dev)
    ms = time_cuda(lambda: md5.md5_words(words, lens), flush)
    got = md5.md5_words(words, lens)
    plain_ms = against_plain("md5_direct", got,
                             lambda: md5.md5_plain(words, lens))
    host, dig = words.cpu().numpy(), got.cpu().numpy()
    for b in range(0, B, 16):
        ref = hashlib.md5(host[b, :n].astype("<u4").tobytes()).digest()
        check(dig[b].astype("<u4").tobytes() == ref, f"md5 row {b} == hashlib")
    nchunks = (n + 18) // 16
    b_ms, b_by = bound(B * nchunks, ops_per_compression(),
                       B * n * 4 + B * 4 + B * 16)
    out["md5_direct"] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"{B} messages x {n} words in [{B}, {W}] uint32 rows"}
    print(f"md5_direct: {ms:.3f} ms at {out['md5_direct']['shape']}; "
          f"bound {b_ms:.4f} ms ({b_by}, {ops_per_compression()} integer "
          f"instructions per compression); plain {plain_ms:.1f} ms, "
          f"bit-exact; library: none (no PyTorch call computes MD5)")
    del words, got
    # sliding: one 256 MiB image, window 48, at stride 4 (the entry of
    # the kernels line) and at stride 1, each against the plain version
    L, ww = IMAGE_BYTES // 4, 12
    swords = rand_words(1, L)
    ops = ops_per_compression(16 - ww, 1)
    for stride in (4, 1):
        n_win = L * (4 // stride)
        ms = time_cuda(
            lambda: sliding_md5.sliding_md5_words(swords, ww, stride), flush)
        got = sliding_md5.sliding_md5_words(swords, ww, stride)
        plain_ms = against_plain(
            "sliding_md5", got,
            lambda: sliding_md5.sliding_plain(swords, ww, stride))
        del got
        b_ms, b_by = bound(n_win, ops, L * 4 + n_win * 4)
        shape = (f"[1, {L}] uint32 ({IMAGE_BYTES // MiB} MiB), window 48, "
                 f"stride {stride}")
        print(f"sliding_md5: {ms:.3f} ms at {shape}; bound {b_ms:.4f} ms "
              f"({b_by}, {ops} integer instructions per window); ALU pipe "
              f"alone for this SASS {alu_ms('sliding_md5', n_win):.4f} ms; "
              f"plain {plain_ms:.1f} ms, bit-exact; library: none (no "
              f"PyTorch call computes MD5)")
        if stride == 4:
            out["sliding_md5"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "shape": shape}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import numpy as np
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi, sm_clocks = phase_env(torch)
    pipes = phase_build()
    errs = phase_kernels(torch, np, dev)
    t0 = time.perf_counter()
    series = checkpoint_series(N_IMAGES, IMAGE_BYTES, 0.15, seed=0)
    print(f"checkpoint series: {N_IMAGES} x {IMAGE_BYTES // MiB} MiB "
          f"(seed 0, change_frac 0.15) made in "
          f"{time.perf_counter() - t0:.1f} s")
    launches, _ = phase_main_path(torch, np, series)
    del series
    times = phase_times(torch, np, dev, sm_clocks, pipes, errs)
    kernels = []
    for name, counter, source, replaces in [
            ("md5_direct", "md5", "src/repro_torch/kernels/csrc/md5.cu",
             "src/repro/kernels/md5.py:84"),
            ("sliding_md5", "sliding_md5",
             "src/repro_torch/kernels/csrc/sliding_md5.cu",
             "src/repro/kernels/sliding_md5.py:56")]:
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[counter],
                        "max_abs_err": errs[name], **times[name],
                        "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
