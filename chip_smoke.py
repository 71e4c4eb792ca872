#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
CUDA kernels from ``src/repro_torch/kernels/csrc`` and runs eleven phases,
each printing its results:

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build: build time, what ``ptxas -v`` reports (registers, spills,
   warnings; a spill in the sliding kernel fails the run), each kernel's
   SASS opcode mix (``cuobjdump -sass``) with its ALU-pipe and FMA-pipe
   (IMAD, VIADD) counts and the tensor-core (``HGMMA``) count of the bf16,
   f16 and f32 flash kernels, and a one-thread clock probe of the MD5
   round's dependent chain;
3. every kernel against its plain PyTorch version on the card: the
   hashing kernels bit for bit (and against ``hashlib``, or the CPU gear
   baseline at positions >= 31, and a sharded gear plan reassembled; the
   sliding kernel also at its edges: rows around its tile, shorter than
   a window, of one word, three per launch, every window at every
   stride), flash attention within 2e-5 in f32 (also on rows of 16384
   and 32768 keys) and within the bound derived from its rounding in
   bf16 and f16, which the plain version with one key tile dropped must
   fail, and the f32 kernel's TF32 pre-pass bit for bit; the boundary-
   candidate kernel index for index and count for count on a 256 MiB
   image's window hashes at strides 1 and 4 and on gear rows over stale
   bytes, under sparse and every-window rules, and its two-rule launch
   (FastCDC's strict and loose masks) on those gear rows and on one
   256 MiB image's gear hashes; the direct MD5's spans entry, every
   padding-edge length at every start residue mod 4, against its plain
   version and ``hashlib``;
4. the main path, the SAI content-addressable write/read path: a series
   of four 256 MiB checkpoint images written with ``write_async`` and read
   back with verification, under fixed 1 MiB blocks (``ca='fixed'``),
   sliding-window-MD5 content-defined chunking with the SAI's defaults
   (``ca='cdc'``, window 48, stride 4), the same at stride 1 (the paper's
   byte-granular windows), gear-hash CDC at the SAI's defaults
   (``ca='cdc-gear'``) and FastCDC at the benchmark's cas-gear settings
   (``ca='fastcdc'``), with the kernels' launch counts over exactly that
   run and each configuration's similarities held to their known values
   (FastCDC's, and every image's chunk ends, to those of the plain
   versions on the card); the spans entry's launches under every mode
   (each write hashes its chunks as spans of its image), and its digests
   of every image as FastCDC cuts it against ``hashlib`` (the first and
   the widest chunks also against its plain version);
   sliding hashes of one image against ``hashlib`` at both strides and
   gear chunk boundaries of one image against the CPU baseline, and the
   SAI's boundaries from the card's candidates against those selected
   from every hash (boundary-candidate launches: under every CDC mode,
   never under ``ca='fixed'``); then a
   refetch of a corrupted replica and a durable store reopened and read;
5. the checkpoint path: ``CACheckpointer`` saving two decoder layers of
   llama3-8b's published widths in bf16 from the card through
   ``ca='cdc-gear'``, three steps (all new, a frozen first layer, an
   identical re-save) with their dedup ratios checked, every step
   restored after a storage-node failure and compared tensor for tensor,
   and an ``async_save`` raced by an in-place update;
6. each kernel at its path's shapes (the sliding kernel at both of its
   strides, gear on one image and on phase 4's largest launch, the
   boundary-candidate compaction of that image's stride-1 hashes beside
   the host path it replaced, its two-rule call on one image's gear
   hashes, flash
   attention through its own entry point at llama3-8b's widths and
   context in bf16, f16 and f32): its time with CUDA events beside its
   bound (for ``md5_direct`` also the bound of its serial chain, from the
   probe; the spans entry on one 256 MiB image as the benchmark's LBFS
   rule cuts it, beside ``md5_direct`` on the same chunks' packed rows,
   bound by the work or by its longest chunk's chain; for the sliding
   kernel the count of only the rounds digest word
   a needs, beside the full count, and the time its SASS needs on the ALU
   and on the FMA pipe), its plain version's time and result on the same
   inputs, and for flash attention PyTorch's
   ``scaled_dot_product_attention`` timed beside it and the achieved
   TFLOP/s; the f32 path's TF32 pre-pass is also timed alone, and the f32
   bound is that of 3xTF32 on the tensor cores, the cheaper of the two
   ways to f32 accuracy;
7. the serving plane: a ``StorageGateway`` with no engine passed (so the
   default ``CrystalGPU`` on the card, adaptive fusion on), tenant auth,
   its node runtime and the HTTP health plane, behind a ``GatewayServer``
   on localhost; four tenant client processes (two interactive, two
   batch) each write four 48 MiB versions of their own checkpoint series
   with ``ca='cdc-gear'`` and read them back verified, compared byte for
   byte and against an in-process SAI's similarity, with the engine's
   cross-client coalescing, refused opens (wrong secret, expired token),
   ``/metrics`` and ``/health``; then one byte flipped in one replica of 8
   blocks, found by a scrub on the engine's scrub lane, repaired and
   scrubbed clean; the gateway's write latencies with the runtime paused
   and sweeping; and a durable gateway (``ca='cdc'``, stride 1) closed and
   reopened, its recovery suspects scrubbed on the card;
8. the engine mesh on one card: a ``CrystalGPU`` of four managers on
   ``cuda:0``, each with its own CUDA stream, writes the first two images
   of phase 4's series under ``fixed``, ``cdc-gear`` and ``cdc`` at stride
   1 with whale jobs sharded across the managers, every block map and
   digest equal to phase 4's one-manager engine, and the write MB/s of
   one manager and of four on the same images; four direct jobs of phase
   6's md5 shape at once on one manager and on four, digests equal, and
   their four ``md5_direct`` launches alone on one stream and on four; a
   50 ms delay on manager 0's launches, which must then take under a
   third of 30 paced jobs, and a crash of manager 0 (its batch fails,
   every other job is right, one restart, and it serves again); the read
   path on the mesh: a read cache that serves a second verified read of
   a 256 MiB version with no ``md5`` launch, a quarantined block fetched
   and verified again, and 16 seeded ``read_range`` requests (two at
   EOF) equal to slices of the full read, verified on the card and
   proved against the version's Merkle root; and each kind's seeded and
   regressed launch-cost model.  Phase 4 prints the regressed cost model
   of its writes and reads, the seeds of
   ``repro_torch.roofline.analysis``;
9. the LM serving path (``repro_torch.models``, ``repro_torch.serve``):
   the serving CLI ``repro_torch.launch.serve`` on llama3-8b at its
   published widths and depth with bf16 weights from a seed, a prefill
   of 4 prompts of 4096 tokens (two query blocks) and 32 greedy decode
   steps after a warm-up, prefill tok/s and the median decode step
   beside their bounds and the peak memory; a ``ContinuousBatcher`` of 4 slots
   serving 8 seeded requests (mean TTFT, steps).  Checks: decode against
   the full forward at full width in f32 compute, the batcher's logits
   against sequential decoding within a bound from bf16 rounding (tokens
   equal where the margin allows), the bf16 score products on the tensor
   cores (decode at llama3-8b's widths, training attention and its grads
   at minicpm-2b's) against the f32 products, the card against the CPU
   (llama3-8b's widths in 2 layers, f32), mamba2-1.3b at full width and
   mixtral-8x7b's widths in 2 layers (prefill, 8 decode steps, decode
   against forward),
   and every architecture's smoke config on the card against the CPU.
   It fails if it launched any of the ported kernels;
10. the training path (``repro_torch.optim``, ``repro_torch.train``,
   ``repro_torch.data``): the training CLI ``repro_torch.launch.train`` on
   minicpm-2b at its published widths and depth (f32 master weights, bf16
   compute, AdamW, the WSD schedule, remat), batch 4 x 2048 for 2 warm-up
   and 8 timed steps, the median step beside its FLOP bound, tokens/s, the
   peak memory and the issuing thread's CPU share, loss and grad norm per
   step (finite, falling; launches none of the ported kernels); one train
   step on the card against the CPU (minicpm-2b's widths in 2 layers, f32,
   and every architecture's smoke config): loss, grad norm and grads
   within 1e-4, and the card's optimiser fed the CPU's grads, its updated
   parameters within one ulp plus 1e-4 of the largest update; attention
   across query blocks and blocked cross-entropy across chunks under grad
   (each block and chunk checkpointed), card against CPU within 1e-4;
   then the CLI with the example's checkpoint run (llama3-8b ``100m``, 200 steps, a checkpoint every 50
   through ``ca='cdc-gear'`` on the card, a failure at step 120): one
   restart from the last checkpoint, every checkpoint restored tensor for
   tensor through a new engine, save and restore MB/s and dedup per
   checkpoint, with ``gear`` and ``md5_direct`` launched;
11. the distributed slice (``repro_torch.models.sharding``,
   ``repro_torch.launch.mesh``, ``repro_torch.optim.grad_compress``) on
   a one-card NCCL mesh: a DTensor train step under ``make_shard_ctx``
   (minicpm-2b's widths in 2 layers, f32) against the plain step from the
   same weights and batch, within phase 10's tolerances, both steps'
   times; ``quantize_int8`` on the card equal to the CPU bit for bit, and
   the int8 cross-pod sync over 20 steps within 0.05;
12. the dry-run slice (``repro_torch.launch.dryrun``,
   ``repro_torch.roofline.{hlo_analysis,reanalyze}``): (a) the dry-run CLI
   on llama3-8b ``train_4k`` over 256 and 512 placeholder ranks (records
   with every key of the JAX package's, per-device memory against the
   card's 80 GB, FLOPs against ``model_flops / n_devices``, wire bytes by
   collective, ``reanalyze`` reproducing them); (b) the estimator against
   the card: phase 10 (a)'s minicpm-2b step captured on a (1, 1) mesh,
   its FLOPs equal to ``FlopCounterMode`` on the same step run for real,
   its predicted peak memory beside the real one, its roofline step time
   beside the measured one; (c) the four remat policies at minicpm-2b's
   widths in 2 layers: step time, peak memory, loss and grads equal
   across them; (d) sharded serving on a one-card NCCL mesh (llama3-8b's
   and mamba2-1.3b's widths in 2 layers, f32; llama3-8b also in bf16):
   prefill and 16 decode steps against the plain model, tokens equal
   (in bf16 where the top-two margin allows), logits within the compute
   dtype's bound, decode ms per step of both.  The CLI runs and the capture run as
   subprocesses beside (b)-(d).

Any failed check raises, so the script exits non-zero.  The line before
the last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits with
code 2 and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

MiB = 1 << 20
N_IMAGES = 4
IMAGE_BYTES = 256 * MiB
DURABLE_BYTES = 64 * MiB
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
# the chunking rule's mean chunk of the benchmark's CDC writes
# (perfbench's cas-cdc configuration): one candidate per 8 KiB
BENCH_AVG_CHUNK = 8192
# FastCDC's settings as the benchmark's cas-gear configuration states
# them: NC-2 masks of 15 and 11 one-bits over the 32-bit gear hash,
# chunks of 2, 8 and 64 KiB
FASTCDC = {"ca": "fastcdc", "avg_chunk": 8192, "min_chunk": 2048,
           "max_chunk": 65536, "mask_s": 0xD641C0D7, "mask_l": 0xD9000353}
FASTCDC_RULE = (FASTCDC["mask_s"], 0, FASTCDC["mask_l"], 0)
# LBFS's settings as the benchmark's cas-cdc configuration states them:
# every 48-byte window (stride 1), chunks of 2, 8 and 64 KiB
CAS_CDC = {"ca": "cdc", "window": 48, "stride": 1,
           "avg_chunk": BENCH_AVG_CHUNK, "min_chunk": 2048,
           "max_chunk": 65536}
# chunks of phase 6's spans image that the plain version times
SPAN_PLAIN_TIMED = 1024
# dense peaks, H100 SXM data sheet: bf16 and TF32 on the tensor cores
# (the flash kernels' wgmma), and f32 on the CUDA cores (outside the
# tensor cores).  An f32-accurate product costs either one f32 FMA or
# three TF32 products (hi.hi + hi.lo + lo.hi, the f32 flash kernel's way)
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
TF32_PRODUCTS = 3
# integer instructions per byte the gear hash needs at the least: mix32
# of b + 1 (one add, three xor-shift pairs, two multiplies) and one
# shift-add of the recurrence h = (h << 1) + g
GEAR_OPS_PER_BYTE = 10
# llama3-8b's published widths (src/repro/configs/llama3_8b.py)
LLAMA_D_MODEL, LLAMA_HEADS, LLAMA_KV_HEADS, LLAMA_HEAD_DIM = 4096, 32, 8, 128
LLAMA_D_FF, LLAMA_CONTEXT = 14336, 8192
CKPT_LAYERS = 2                # of the model's 32, to keep within time
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
# rounds of a compression whose result reaches digest word a: a is a0 plus
# the b that round 60 (0-based) writes, so rounds 61-63 are dead for a
# sliding window, which keeps only word a
LIVE_ROUNDS = 61
# SASS opcodes of the ALU pipe and of the FMA pipe counted in phase 2
ALU_OPCODES = ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT",
               "IABS", "IMNMX", "MOV")
# VIADD (an add) issues beside IMAD, not on the ALU pipe: the sliding
# kernel's times in tools/sliding_ablation.py fit only that
FMA_OPCODES = ("IMAD", "VIADD")
# kernel name -> substrings of its SASS function name, mangled or not
# (the sliding kernel at the main path's window of 12 words, stride 4 and
# stride 1)
SASS_FUNCTIONS = {"md5_direct": ("17md5_direct_kernelE",
                                 "17md5_direct_kernelP",
                                 "md5_direct_kernel("),
                  "md5_direct_spans": ("23md5_direct_kernel_spansE",
                                       "23md5_direct_kernel_spansP",
                                       "md5_direct_kernel_spans("),
                  "sliding_md5": ("sliding_md5_kernelILi12ELi4EE",
                                  "sliding_md5_kernel<12, 4>"),
                  "sliding_md5 stride 1": ("sliding_md5_kernelILi12ELi1EE",
                                           "sliding_md5_kernel<12, 1>"),
                  "gear": ("gear_kernel",),
                  "flash_attn f32 hd128": ("flash_tf32_kernelILi128E",
                                           "flash_tf32_kernel<128>"),
                  "flash_tf32_split": ("tf32_split_kernel",),
                  "flash_attn bf16 hd128": ("flash_wgmma_kernelILi128ELb0E",
                                            "flash_wgmma_kernel<128, false>"),
                  "flash_attn f16 hd128": ("flash_wgmma_kernelILi128ELb1E",
                                           "flash_wgmma_kernel<128, true>")}
# SASS opcode of a warpgroup tensor-core product (wgmma)
TENSOR_OPCODE = "HGMMA"
# compressions of one message of md5_direct's launch in phase 6 (1 MiB +
# 4 B: 262145 words), the chain the probe times
MD5_PROBE_COMPRESSIONS = (MiB // 4 + 1 + 18) // 16
# WriteStats.similarity of the four versions of checkpoint_series(seed=0)
# per configuration, to 4 places (fastcdc's from its plain versions, see
# fastcdc_plain).  At stride 4 a window is hashed only at
# offsets 0 mod 4, so an insert of k bytes with k % 4 != 0 moves the
# content off the grid and chunking does not resynchronise after it;
# byte-granular windows (stride 1) and the gear hash (every byte) do
SIMILARITY = {"fixed": [0.0, 0.7773, 0.4141, 0.8086],
              "cdc": [0.0, 0.7582, 0.4124, 0.7732],
              "cdc-stride1": [0.0, 0.8678, 0.8533, 0.8486],
              "cdc-gear": [0.0, 0.8309, 0.8592, 0.8213]}
# phase 7: the serving plane.  Four tenant client processes (two
# interactive, two batch) each write four versions of their own
# checkpoint series (seed 1 + i) of 48 MiB, under the gateway's 64 MiB
# frame cap, then read every version back verified
GATEWAY_BYTES = 48 * MiB
GATEWAY_VERSIONS = 4
TENANTS = [(f"tenant{i}", "interactive" if i < 2 else "batch", 1 + i)
           for i in range(4)]
# stored blocks of node 1 whose copy there phase 7 corrupts
SCRUB_CORRUPT = 8
# phase 8: the engine mesh on one card, four managers on cuda:0, each with
# its own CUDA stream.  (a) the first two images of phase 4's series under
# three of its configurations (md5_direct, gear and sliding_md5 at stride
# 1); (b) four direct jobs of phase 6's md5 shape at once (64 messages of
# 1 MiB + 4 B); (c) paced single-row jobs with a launch delay on manager
# 0, then a crash of manager 0; (d) a read cache that holds a whole image,
# and seeded read_range requests
MESH_MANAGERS = 4
MESH_IMAGES = 2
MESH_CONFIGS = ("fixed", "cdc-gear", "cdc-stride1")
MESH_JOBS, MESH_ROWS, MESH_ROW_BYTES = 4, 64, MiB + 4
SLOW_JOBS, SLOW_DELAY_S, SLOW_PACE_S, ROW_BYTES = 30, 0.05, 0.01, 4096
CRASH_JOBS = 12
READ_CACHE_BYTES = 512 * MiB
N_RANGES = 16


def ops_per_compression(const_words: int = 0, final_adds: int = 4) -> int:
    """Integer instructions per 64-byte MD5 compression, the least Hopper
    can issue: per round one LOP3, two adds for f + a + K + M (one when
    message word M is a compile-time constant, since K + M folds), one
    funnel shift and one add; then the final adds.  Each of the
    ``const_words`` constant message words is read by 4 rounds."""
    return 64 * 5 - 4 * const_words + final_adds


def md5_g(i: int) -> int:
    """Message word read by MD5 round i (0-based)."""
    return i if i < 16 else (5 * i + 1) % 16 if i < 32 \
        else (3 * i + 5) % 16 if i < 48 else (7 * i) % 16


def sliding_ops(w_words: int):
    """Integer instructions per sliding window of ``w_words`` words, the
    least Hopper can issue for digest word a alone: ``(total,
    alu_only)``.  Only the LIVE_ROUNDS rounds that reach word a count.
    Each is one LOP3, two adds for f + a + K + M (one where message word
    M is a constant: the 0x80 padding, zeros or the length) and b +
    rotl(f, s) as one LEA.HI of f funnel-shifted onto itself (ptxas's
    own form); round 0's boolean function and a + K are constants of the
    initial value, and so is a + K in rounds 1-3; one final add, a0 + a.
    ALU-only: each live round's LOP3 but round 0's (b + rotl(f, s) also
    has an FMA-pipe form, lo(f 2^s) + (hi(f 2^s) + b) as two IMADs)."""
    total = 0
    for i in range(LIVE_ROUNDS):
        const_m = md5_g(i) >= w_words
        total += 4 - const_m
        if i == 0:
            total -= 2
        elif i < 4 and not const_m:
            total -= 1
    return total + 1, LIVE_ROUNDS - 1


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


# message lengths of phase 3's spans: MD5's padding edges (the 4-byte
# length word follows the word-padded data) and the widest CDC chunk
SPAN_EDGE_LENS = [1, 2, 3, 4, 5, 7, 8, 9, 51, 52, 53, 54, 55, 56, 57, 60,
                  61, 62, 63, 64, 65, 66, 67, 68, 4095, 4096, 4097, 65536]
# chunks of each image phase 4 also hashes with the plain spans version
SPAN_PLAIN_SAMPLE = 256


def spans_against_plain(torch, np, img, ends, dev, what: str,
                        sample=None) -> int:
    """``md5_spans`` over ``img`` cut at ``ends`` on the card: every
    digest against ``hashlib``, and those of ``sample`` chunk indices
    (all by default) against the plain version on the card.  Returns
    the largest word difference from the plain version."""
    from repro_torch.core.sai import block_digest_cpu
    from repro_torch.kernels import md5
    img = np.frombuffer(img, np.uint8) if isinstance(img, bytes) else img
    ends = np.asarray(ends, np.int64)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    lens = ends - starts
    padded = np.pad(img, (0, (-img.size) % 4))
    words = torch.from_numpy(padded.view("<u4").copy()).to(dev)
    got = md5.md5_spans(words, torch.from_numpy(starts),
                        torch.from_numpy(lens))
    torch.cuda.synchronize()
    host = got.view(torch.int32).cpu().numpy().astype("<u4")
    for i, (a, b) in enumerate(zip(starts, ends)):
        check(host[i].tobytes() == block_digest_cpu(img[a:b].tobytes()),
              f"{what}: spans digest {i} == hashlib")
    pick = np.arange(lens.size) if sample is None else np.asarray(sample)
    want = md5.md5_spans_plain(words, torch.from_numpy(starts[pick]),
                               torch.from_numpy(lens[pick]))
    # index as int32: CUDA has no uint32 indexing
    sub = got.view(torch.int32)[torch.from_numpy(pick).to(dev)]
    check(words_equal(sub, want), f"{what}: spans kernel == plain")
    return max_abs_err(sub, want)


# f32 flash against the plain version: the JAX package's 2e-5 (atol and
# rtol), for sums taken in another order.  bf16 and f16 round P to the type
# before P.V (as the reference does) and the output to the type, so they
# are held per element to flash_attn.flash_bf16_bound, derived from those
# two roundings: |got - want| <= u |want| + u (P |V|) / l + 3e-5, with u =
# 2**-8 for bf16 and 2**-11 for f16.
F32_TOL = 2e-5
# f32 flash rows longer than phase 6's, held to F32_TOL: the 3xTF32
# kernel's O is one chain of tensor-core products over all key tiles
LONG_ROWS = (16384, 32768)


def flash_close(got, q, k, v, want, what: str) -> float:
    """Check a flash output against the plain version's f32 result
    ``want`` on the same inputs, at 2e-5 in f32 and within the derived
    per-element bound in bf16 and f16; return the largest absolute
    error."""
    import torch
    from repro_torch.kernels import flash_attn
    g = got.float()
    check(bool(torch.isfinite(g).all()), f"{what}: finite output")
    err = (g - want).abs()
    if got.dtype == torch.float32:
        check(torch.allclose(g, want, atol=F32_TOL, rtol=F32_TOL),
              f"{what}: within {F32_TOL} of the plain version")
    else:
        bound = flash_attn.flash_bf16_bound(q, k, v, want)
        check(bool((err <= bound).all()), f"{what}: within the "
              f"{str(got.dtype)[6:]} bound (worst error "
              f"{float((err / bound).max()):.3f} of it)")
    return float(err.max())


def plain_dropping(q, k, v, lo: int, hi: int):
    """The plain version with keys [lo, hi) left out: what a kernel that
    lost that key tile would return (f32)."""
    import torch
    from repro_torch.kernels import flash_attn
    S, Sk, hd = q.shape[1], k.shape[1], q.shape[2]
    keep = torch.arange(Sk, device=q.device)[None, :] \
        <= torch.arange(S, device=q.device)[:, None]
    keep[:, lo:hi] = False
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    s = torch.where(keep[None], s, flash_attn.NEG)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v.float())


def split_matches(q, k, v, what: str) -> float:
    """Check the f32 flash kernel's TF32 pre-pass against its plain
    version bit for bit; return the largest absolute difference (0)."""
    import torch
    from repro_torch.kernels import flash_attn
    got = flash_attn.tf32_split(q, k, v)
    torch.cuda.synchronize()
    want = flash_attn.tf32_split_plain(q, k, v)
    for name, a, b in zip(("q_hi", "q_lo", "k_hi", "k_lo", "vt_hi", "vt_lo"),
                          got, want):
        check(a.shape == b.shape and words_equal(a, b),
              f"{what}: pre-pass {name} == plain bit for bit")
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


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
    print(f"float peaks (data sheet, dense): f32 outside the tensor cores "
          f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s, bf16 on the tensor cores "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, TF32 "
          f"{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s")
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


def phase_build(torch):
    print("== phase 2: build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {lib.path} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.seconds:.2f} s)")
    source = None
    for line in lib.log.splitlines():
        if line.startswith("=="):
            source = line[2:].strip()
        if line.startswith("==") or "registers" in line \
                or "spill" in line or "arning" in line:
            print("  " + line.strip())
        if source == "sliding_md5.cu" and "spill" in line:
            check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"no spill in the sliding kernel: {line.strip()}")
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
              f"{pipes[name][0]}, IMAD and VIADD (FMA pipe) "
              f"{pipes[name][1]}, "
              f"{TENSOR_OPCODE} (tensor cores) {m[TENSOR_OPCODE]}; "
              f"{dict(m.most_common(12))}")
        if name.startswith("flash_attn"):
            check(m[TENSOR_OPCODE] > 0,
                  f"{name} runs its products on the tensor cores")
    # one thread runs the MD5 round's chain (md5_compress, as md5.cu
    # does) over one message's compressions between two clock reads
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):          # the first call loads the module
        lib.check(lib.cdll.md5_chain_probe_launch(
            out.data_ptr(), MD5_PROBE_COMPRESSIONS, 7, stream), "md5 probe")
        torch.cuda.synchronize()
    cycles_per_round = int(out[0]) / (MD5_PROBE_COMPRESSIONS * 64)
    print(f"md5 chain probe: {int(out[0])} SM clocks for "
          f"{MD5_PROBE_COMPRESSIONS} compressions on one thread, "
          f"{cycles_per_round:.2f} per round")
    return pipes, cycles_per_round


def candidates_match(torch, np, dev) -> int:
    """The boundary-candidate kernel against its plain version, index for
    index and count for count, on the write path's window hashes: one
    256 MiB image at window 48, stride 1 ([1, 4, 64M]) and stride 4
    ([1, 1, 64M]), and gear's [B, 1, L] rows of ragged lengths over
    stale bytes past each row's end; under the benchmark's 8 KiB rule,
    the SAI's default rule, and a rule that every window meets, with each
    row's n_off also cut short of its plane.  The two-rule launch
    (FastCDC's strict and loose masks, codes 4 k + flags) on one 256 MiB
    image's gear hashes ([1, 1, 256M], the cas-gear cell's shape) and on
    the ragged gear rows, under FastCDC's masks and under two rules that
    every byte meets.  Returns the largest difference (0: every check is
    exact)."""
    from repro_torch.core import SAIConfig, chunking
    from repro_torch.kernels import candidates, gear, sliding_md5
    rules = {"8 KiB": chunking.boundary_rule(BENCH_AVG_CHUNK),
             "SAI default": chunking.boundary_rule(SAIConfig().avg_chunk),
             "every window": (0, 0)}
    two_rules = {"FastCDC NC-2": FASTCDC_RULE, "every byte, both": (0,) * 4}
    gen = torch.Generator(device=dev).manual_seed(4)

    def same(hashes, n_off, what, rules=rules):
        for rule, masks in rules.items():
            found, counts = candidates.boundary_candidates(hashes, n_off,
                                                           *masks)
            want, want_counts = candidates.candidates_plain(hashes, n_off,
                                                            *masks)
            check(torch.equal(found, want)
                  and counts.tolist() == want_counts.tolist(),
                  f"boundary_candidates == plain, {what}, rule {rule}")
            print(f"boundary_candidates {what}, n_off {list(n_off)}, rule "
                  f"{rule}: {found.numel()} candidates, counts "
                  f"{counts.tolist()}, exact vs plain")
            del found, want

    words = torch.randint(-2 ** 31, 2 ** 31, (1, IMAGE_BYTES // 4),
                          dtype=torch.int32, device=dev, generator=gen)
    for stride in (1, 4):
        hashes = sliding_md5.sliding_md5_words(words, 12, stride)
        n_off = (IMAGE_BYTES - 48) // stride + 1
        what = (f"{list(hashes.shape)} ({IMAGE_BYTES // MiB} MiB at "
                f"stride {stride})")
        same(hashes, [n_off], what)
        same(hashes, [n_off - 12345], what)
        del hashes
    del words
    # gear rows as the engine fuses them: the bytes past each row's
    # length are stale (random), not zero
    lens = [1, 31, 4097, 16 * MiB + 3]
    rows = torch.randint(0, 256, (len(lens), max(lens)), dtype=torch.uint8,
                         device=dev, generator=gen)
    hashes = gear.gear_bytes(rows)[:, None]
    same(hashes, lens, f"gear {list(hashes.shape)}")
    same(hashes, lens, f"gear {list(hashes.shape)}", two_rules)
    del hashes, rows
    # the two-rule launch at the cas-gear cell's shape
    img = torch.randint(0, 256, (1, IMAGE_BYTES), dtype=torch.uint8,
                        device=dev, generator=gen)
    hashes = gear.gear_bytes(img)[:, None]
    del img
    what = f"gear {list(hashes.shape)} ({IMAGE_BYTES // MiB} MiB)"
    same(hashes, [IMAGE_BYTES], what, two_rules)
    same(hashes, [IMAGE_BYTES - 12345], what, two_rules)
    del hashes
    return 0


def phase_kernels(torch, np, dev):
    print("== phase 3: kernels against their plain versions")
    from repro_torch.core.sai import _cpu_gear
    from repro_torch.kernels import flash_attn, gear, md5, ops, sliding_md5
    rng = np.random.default_rng(1)
    errs = {"md5_direct": 0, "md5_direct_spans": 0, "sliding_md5": 0,
            "gear": 0, "flash_attn": 0.0,
            "flash_attn_f16": 0.0, "flash_attn_f32": 0.0,
            "flash_tf32_split": 0.0}
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
    # md5 spans: every edge length starting at every residue mod 4,
    # neighbours sharing words, the image's last chunk ending off a word
    for residue in range(4):
        ends = residue + np.cumsum(SPAN_EDGE_LENS * 2)
        img = rng.integers(0, 256, int(ends[-1]) + 1, dtype=np.uint8)
        ends = np.concatenate([[residue] if residue else [], ends,
                               [img.size]])
        errs["md5_direct_spans"] = max(errs["md5_direct_spans"],
                                       spans_against_plain(
                                           torch, np, img, ends, dev,
                                           f"spans at residue {residue}"))
    print(f"md5_direct_spans: {len(SPAN_EDGE_LENS) * 2} edge lengths at "
          f"every start residue mod 4: bit-exact vs plain and hashlib")
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
    # the kernel's edges: rows around its tile T (T - 1, T, T + 1 and
    # T + w_words words), shorter than a window and of one word, three
    # rows of distinct content per launch, every window at every stride
    T = sliding_md5.TILE_WORDS
    n_edge = 0
    for stride in (1, 2, 4):
        R = 4 // stride
        for ww in range(1, 14):
            for L in (T - 1, T, T + 1, T + ww, max(ww - 1, 1), 1):
                data = rng.integers(0, 2 ** 32, (3, L), dtype=np.uint32)
                words = torch.from_numpy(data).to(dev)
                got = sliding_md5.sliding_md5_words(words, ww, stride)
                torch.cuda.synchronize()
                want = sliding_md5.sliding_plain(words, ww, stride)
                check(got.shape == (3, R, L) and words_equal(got, want),
                      f"sliding kernel == plain, [3, {L}] stride {stride} "
                      f"window {4 * ww}")
                errs["sliding_md5"] = max(errs["sliding_md5"],
                                          max_abs_err(got, want))
                host = got.cpu().numpy()
                for b in range(3):
                    row = data[b].astype("<u4").view(np.uint8)
                    for q in {0, L // 2, L - 1, max(L - ww, 0)}:
                        for i in range(R):
                            b0 = 4 * q + i * stride
                            chunk = row[b0:b0 + 4 * ww].tobytes()
                            chunk += bytes(4 * ww - len(chunk))
                            ref = hashlib.md5(chunk).digest()
                            check(int(host[b, i, q])
                                  == int.from_bytes(ref[:4], "little"),
                                  f"sliding == hashlib, [3, {L}] row {b} "
                                  f"phase {i} offset {q} window {4 * ww}")
                n_edge += 1
    print(f"sliding_md5 edges: {n_edge} launches of 3 rows (L = T - 1, T, "
          f"T + 1, T + w_words, < w_words, 1; T = {T}), every window of "
          f"1-13 words at strides 1, 2, 4: bit-exact vs plain and hashlib "
          f"at sampled offsets")
    short = ops.sliding_window_hash(b"shorter than a window", 48, 4,
                                    device=dev)
    check(short.shape == (0,), "input shorter than a window hashes empty")
    print("sliding_md5 input shorter than one window: empty")
    # gear: five ragged rows in one launch, zero-padded at the end —
    # lengths under one window and not multiples of 4, and 16 MiB + 3
    lens = [1, 31, 32, 33, 16 * MiB + 3]
    rows = np.zeros((len(lens), max(lens)), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    data = torch.from_numpy(rows).to(dev)
    got = gear.gear_bytes(data)
    torch.cuda.synchronize()
    want = gear.gear_plain(data)
    check(words_equal(got, want), f"gear kernel == plain, rows {lens}")
    errs["gear"] = max_abs_err(got, want)
    host = got.cpu().numpy()
    for i, n in enumerate(lens):
        row = rows[i, :n].tobytes()
        alone = ops.gear_hash(row, device=dev)
        check(np.array_equal(host[i, :n], alone),
              f"gear row of {n} B alone == in the padded launch")
        check(np.array_equal(alone[31:], _cpu_gear(row)[31:]),
              f"gear == _cpu_gear at positions >= 31, row of {n} B")
    print(f"gear rows of {lens} B in one launch: bit-exact vs plain, each "
          f"row equal alone, and equal to _cpu_gear at positions >= 31")
    plan = ops.stream_shard_plan(lens[-1], "gear", 3)
    check(plan is not None and len(plan) == 3, "gear shard plan of 3")
    parts = [ops.gear_hash(rows[-1, a:b].tobytes(), device=dev)[d:]
             for a, b, d in plan]
    check(np.array_equal(np.concatenate(parts), host[-1]),
          "sharded gear plan reassembles the unsharded output")
    print(f"gear shard plan {plan}: reassembled == unsharded")
    errs["boundary_candidates"] = candidates_match(torch, np, dev)
    # flash: hd 32, 64 and 128, S == Sk, both Sk != S and a ragged pair,
    # in f32, bf16 and f16; the plain version runs on the same (rounded)
    # inputs.  In bf16 and f16 the plain version with one key tile dropped
    # must fail the bound, so a lost or doubled tile cannot pass it.  In
    # f32 the TF32 pre-pass is checked bit for bit against its plain
    # version.
    gen = torch.Generator(device=dev).manual_seed(5)
    for BH, S, Sk, hd in [(4, 1024, 1024, 64), (4, 1024, 1024, 128),
                          (4, 512, 1536, 128), (4, 1536, 512, 64),
                          (4, 704, 320, 32)]:
        qkv = [torch.randn((BH, n, hd), generator=gen, device=dev)
               for n in (S, Sk, Sk)]
        for dtype, name in ((torch.float32, "flash_attn_f32"),
                            (torch.bfloat16, "flash_attn"),
                            (torch.float16, "flash_attn_f16")):
            q, k, v = (x.to(dtype) for x in qkv)
            got = flash_attn.flash_attention_fwd(q, k, v, bq=64, bk=64)
            torch.cuda.synchronize()
            what = f"flash {str(dtype)[6:]} BH {BH} S {S} Sk {Sk} hd {hd}"
            if dtype == torch.float32:
                errs["flash_tf32_split"] = max(errs["flash_tf32_split"],
                                               split_matches(q, k, v, what))
                print(f"{what}: TF32 pre-pass bit-exact vs plain")
            want = flash_attn.flash_plain(q, k, v)
            err = flash_close(got, q, k, v, want, what)
            errs[name] = max(errs[name], err)
            line = f"{what}: max abs err {err:.3g} vs plain"
            if dtype != torch.float32:
                bound = flash_attn.flash_bf16_bound(q, k, v, want)
                share = float(((got.float() - want).abs() / bound).max())
                lost = (plain_dropping(q, k, v, 128, 256) - want).abs()
                check(not bool((lost <= bound).all()),
                      f"{what}: the plain version without keys 128-255 "
                      f"fails the {str(dtype)[6:]} bound")
                line += (f", worst {share:.3f} of the bound; keys 128-255 "
                         f"dropped: {float((lost / bound).max()):.1f} x the "
                         f"bound")
            print(line)
    # f32 on rows longer than phase 6's, against the plain version in full
    # f32 (TF32 off), at the unchanged 2e-5
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain version's f32 products run without TF32")
    for S in LONG_ROWS:
        q, k, v = (torch.randn((1, S, LLAMA_HEAD_DIM), generator=gen,
                               device=dev) for _ in range(3))
        got = flash_attn.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        what = f"flash float32 BH 1 S = Sk = {S} hd {LLAMA_HEAD_DIM}"
        err = flash_close(got, q, k, v, flash_attn.flash_plain(q, k, v),
                          what)
        errs["flash_attn_f32"] = max(errs["flash_attn_f32"], err)
        print(f"{what}: max abs err {err:.3g} vs plain (check "
              f"{F32_TOL} atol and rtol)")
        del q, k, v, got
    return errs


# name -> SAIConfig overrides of the main path's configurations
CONFIGS = {"fixed": {"ca": "fixed"}, "cdc": {"ca": "cdc"},
           "cdc-stride1": {"ca": "cdc", "stride": 1},
           "cdc-gear": {"ca": "cdc-gear"}, "fastcdc": FASTCDC}


def fastcdc_plain(torch, np, series):
    """FastCDC's chunk ends of each image of ``series`` from the plain
    versions on the card (``gear_plain``, ``candidates_plain``) and the
    host's normalized walk, and each version's WriteStats.similarity
    from them: the share of its chunks whose bytes an earlier chunk of
    the series (this version's included) already held."""
    from repro_torch.core import chunking
    from repro_torch.kernels import candidates, gear
    sizes = {k: FASTCDC[k] for k in ("avg_chunk", "min_chunk", "max_chunk")}
    seen, bounds, sims = set(), [], []
    for img in series:
        x = torch.from_numpy(np.frombuffer(img, np.uint8).copy()).cuda()
        hashes = gear.gear_plain(x[None])[:, None]
        del x
        found, _ = candidates.candidates_plain(hashes, [len(img)],
                                               *FASTCDC_RULE)
        del hashes
        ends, _ = chunking.walk_normalized(found.cpu().numpy(), len(img),
                                           **sizes)
        dup = 0
        for a, b in zip([0] + ends[:-1], ends):
            digest = hashlib.md5(img[a:b]).digest()
            dup += digest in seen
            seen.add(digest)
        bounds.append(ends)
        sims.append(round(dup / len(ends), 4))
    return bounds, sims


def write_read(torch, np, eng, series, ca: str, similarity):
    from repro_torch.core import SAI, SAIConfig, make_store
    from repro_torch.core.sai import block_digest_cpu
    from repro_torch.kernels import md5
    mgr, nodes = make_store(4, replication=2)
    sai = SAI(mgr, SAIConfig(**CONFIGS[ca]), crystal=eng)
    s0 = eng.snapshot_stats()
    total = sum(len(img) for img in series)
    rows0 = md5.LAUNCHES.value
    t0 = time.perf_counter()
    futs = [sai.write_async("/ckpt", img) for img in series]
    stats = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    write_rows = md5.LAUNCHES.value - rows0
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
           "boundary_strict": s1["boundary_strict"]
           - s0["boundary_strict"],
           "span_jobs": s1["direct_span_jobs"] - s0["direct_span_jobs"],
           "write_row_launches": write_rows,
           "blocks_checked": n_checked}
    check([round(x, 4) for x in out["similarity"]] == similarity,
          f"{ca}: similarities {out['similarity']} match {similarity}")
    print(f"{ca}: write {out['write_mb_s']:.1f} MB/s, read (verified) "
          f"{out['read_mb_s']:.1f} MB/s over {N_IMAGES} x "
          f"{IMAGE_BYTES // MiB} MiB; similarity "
          f"{[round(x, 4) for x in out['similarity']]}; engine "
          f"{out['engine_launches']} launches / {out['engine_jobs']} jobs; "
          f"{n_checked} stored block copies match hashlib")
    return sai, mgr, nodes, out


def block_maps(mgr, n_versions: int):
    """Each version's block map of ``/ckpt``: (digest, length) per block."""
    return [[(b.digest, b.length) for b in mgr.get_blockmap("/ckpt", v).blocks]
            for v in range(n_versions)]


def phase_main_path(torch, np, series, smi: str):
    print("== phase 4: main path (SAI write/read through CrystalGPU)")
    from repro_torch.core import SAI, CrystalGPU, SAIConfig, chunking
    from repro_torch.kernels import candidates, gear, md5, sliding_md5
    eng = CrystalGPU()
    check([str(d) for d in eng.devices] == ["cuda:0"],
          f"engine on cuda:0, got {eng.devices}")
    counters = {"md5": md5.LAUNCHES, "md5_spans": md5.SPAN_LAUNCHES,
                "sliding_md5": sliding_md5.LAUNCHES,
                "gear": gear.LAUNCHES,
                "boundary_candidates": candidates.LAUNCHES}
    kept = {}
    t0 = time.perf_counter()
    plain_bounds, plain_sims = fastcdc_plain(torch, np, series)
    print(f"fastcdc from the plain versions: {[len(b) for b in plain_bounds]}"
          f" chunks, similarity {plain_sims} ({time.perf_counter() - t0:.1f}"
          f" s)")
    similarity = dict(SIMILARITY, fastcdc=plain_sims)
    try:
        for c in counters.values():
            c.reset()
        per = {}
        for ca in CONFIGS:
            before = {n: c.value for n, c in counters.items()}
            kept[ca] = write_read(torch, np, eng, series, ca, similarity[ca])
            per[ca] = {n: c.value - before[n] for n, c in counters.items()}
            print(f"{ca}: kernel launches {per[ca]}")
        launches = {n: c.value for n, c in counters.items()}
        # the engine's own launch cost per kind, regressed over these
        # writes and reads: the seeds of roofline.analysis.H100_LAUNCH_COST
        cost = eng.snapshot_stats()["cost_model"]
        print(f"cost model after phase 4's writes and reads [{smi}]: "
              + json.dumps({k: cost[k] for k in sorted(cost)}))
        largest = gear.LAUNCHES.largest_shape
        largest_bytes = gear.LAUNCHES.largest_bytes
        print(f"main path kernel launches: {launches}")
        print(f"largest gear launch: {largest[0]} rows x {largest[1]} B "
              f"({largest_bytes} B in, {4 * largest_bytes} B of hashes "
              f"out); fusion cap {eng.max_fused_bytes} B")
        check(all(n > 0 for n in launches.values()),
              "every hashing kernel launched on the main path")
        check(all(kept[ca][3]["span_jobs"] == N_IMAGES
                  and per[ca]["md5_spans"] > 0
                  and kept[ca][3]["write_row_launches"] == 0
                  for ca in CONFIGS),
              "every write hashes its chunks as one spans job over its "
              "image, and the writes launch no row kernel")
        check(per["fixed"]["sliding_md5"] == 0
              and per["cdc"]["sliding_md5"] > 0
              and per["cdc-stride1"]["sliding_md5"] > 0
              and per["cdc-gear"]["sliding_md5"] == 0,
              "sliding kernel runs under ca='cdc' only")
        gear_modes = ("cdc-gear", "fastcdc")
        check(all(per[ca]["gear"] > 0 and per[ca]["md5_spans"] > 0
                  for ca in gear_modes)
              and all(per[ca]["gear"] == 0 for ca in CONFIGS
                      if ca not in gear_modes),
              "gear kernel runs under ca='cdc-gear' and 'fastcdc' only, "
              "md5 beside it")
        check(kept["fastcdc"][3]["boundary_strict"] > 0
              and all(kept[ca][3]["boundary_strict"] == 0 for ca in CONFIGS
                      if ca != "fastcdc"),
              "strict-mask candidates are counted under ca='fastcdc' only")
        check(largest[0] == 1 or largest_bytes <= eng.max_fused_bytes,
              "the fusion byte cap bounds fused gear launches")
        check(per["fixed"]["boundary_candidates"] == 0
              and all(per[ca]["boundary_candidates"] > 0
                      for ca in ("cdc", "cdc-stride1", "cdc-gear",
                                 "fastcdc")),
              "boundary candidates are compacted on the card under every "
              "CDC mode, never under ca='fixed'")
        fixed = kept["fixed"][3]["similarity"]
        for ca in ("cdc-stride1", "cdc-gear", "fastcdc"):
            sim = kept[ca][3]["similarity"]
            check(all(c > f for c, f in zip(sim[1:], fixed[1:])),
                  f"{ca} similarity {sim} above fixed-block similarity "
                  f"{fixed}, versions 2-4")

        # gear chunk boundaries of one whole image: engine == CPU baseline
        gsai, gmgr = kept["cdc-gear"][0], kept["cdc-gear"][1]
        cpu_sai = SAI(gmgr, SAIConfig(ca="cdc-gear", hasher="cpu"),
                      crystal=eng)
        t0 = time.perf_counter()
        on_card = gsai._boundaries(series[1])
        t1 = time.perf_counter()
        on_cpu = cpu_sai._boundaries(series[1])
        t2 = time.perf_counter()
        cpu_sai.close()
        check(on_card == on_cpu, "gear chunk boundaries of image 2 from "
              "the engine == from _cpu_gear")
        print(f"gear chunk boundaries of image 2: {len(on_card)} chunks "
              f"over {len(series[1]) // MiB} MiB, engine ({t1 - t0:.2f} s) "
              f"== _cpu_gear ({t2 - t1:.2f} s)")
        # FastCDC's chunk ends of every image: engine == plain versions
        fsai = kept["fastcdc"][0]
        for v, img in enumerate(series):
            check(fsai._boundaries(img) == plain_bounds[v],
                  f"fastcdc chunk ends of image {v + 1} from the engine == "
                  f"from the plain versions")
        print(f"fastcdc chunk ends of all {len(series)} images from the "
              f"engine == from the plain versions")
        # the spans entry on each image as FastCDC cuts it: every digest
        # against hashlib, the first and the widest chunks against the
        # plain version
        spans_err = 0
        for v, img in enumerate(series):
            lens = np.diff(plain_bounds[v], prepend=0)
            sample = np.unique(np.concatenate([
                np.arange(min(SPAN_PLAIN_SAMPLE, lens.size)),
                np.argsort(lens)[-16:], [lens.size - 1]]))
            spans_err = max(spans_err, spans_against_plain(
                torch, np, img, plain_bounds[v], torch.device("cuda", 0),
                f"fastcdc image {v + 1}", sample))
        print(f"md5_direct_spans on all {len(series)} images as fastcdc "
              f"cuts them: every digest == hashlib, "
              f"{SPAN_PLAIN_SAMPLE} + 17 chunks an image == plain")

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
            # the SAI's boundaries come from candidates tested and
            # compacted on the card: the same as from every hash
            csai = kept["cdc" if stride == 4 else "cdc-stride1"][0]
            cfg = csai.cfg
            whole = chunking.select_boundaries(
                hashes, img.size, window=48, stride=stride,
                avg_chunk=cfg.avg_chunk, min_chunk=cfg.min_chunk,
                max_chunk=cfg.max_chunk)
            check(csai._boundaries(series[1]) == whole,
                  f"stride {stride}: boundaries from the engine's "
                  f"candidates == select_boundaries over every hash")
            print(f"stride {stride}: {len(whole)} chunk boundaries of "
                  f"image 2 from candidates == from every hash")
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
        maps = {ca: block_maps(kept[ca][1], MESH_IMAGES)
                for ca in MESH_CONFIGS}
        for sai_, *_ in kept.values():
            sai_.close()

        phase_durable(eng, series[0][:DURABLE_BYTES])
    finally:
        eng.shutdown()
    return launches, largest, maps, spans_err


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


def llama_layer(torch, dev, gen):
    """One decoder layer's weights at llama3-8b's published widths, bf16
    on the card ([out, in] as ``nn.Linear`` keeps them)."""
    d, kv, ff = LLAMA_D_MODEL, LLAMA_KV_HEADS * LLAMA_HEAD_DIM, LLAMA_D_FF

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02) \
            .to(torch.bfloat16)
    return {"attn_norm": torch.ones(d, dtype=torch.bfloat16, device=dev),
            "wq": w(d, d), "wk": w(kv, d), "wv": w(kv, d), "wo": w(d, d),
            "mlp_norm": torch.ones(d, dtype=torch.bfloat16, device=dev),
            "w_gate": w(ff, d), "w_up": w(ff, d), "w_down": w(d, ff)}


def phase_checkpoint(torch, np, dev):
    print("== phase 5: checkpoint path (CACheckpointer through "
          "ca='cdc-gear' on CrystalGPU)")
    from repro_torch.core import SAI, CrystalGPU, SAIConfig, make_store
    from repro_torch.kernels import gear, md5, sliding_md5
    from repro_torch.train import CACheckpointer
    gen = torch.Generator(device=dev).manual_seed(4)
    params = {"layers": {str(i): llama_layer(torch, dev, gen)
                         for i in range(CKPT_LAYERS)}}

    def flat():
        return {f"{i}/{n}": t for i, layer in params["layers"].items()
                for n, t in layer.items()}

    def snapshot():
        return {k: t.clone() for k, t in flat().items()}

    def equal(state, snap):
        got = {f"{i}/{n}": t for i, layer in state["params"]["layers"]
               .items() for n, t in layer.items()}
        return got.keys() == snap.keys() and all(
            got[k].dtype == torch.bfloat16 and got[k].device.type == "cpu"
            and torch.equal(got[k].to(dev), snap[k]) for k in snap)

    n_params = sum(t.numel() for t in flat().values())
    nbytes = sum(t.nbytes for t in flat().values())
    print(f"state: {CKPT_LAYERS} of llama3-8b's 32 decoder layers (d_model "
          f"{LLAMA_D_MODEL}, {LLAMA_HEADS} heads, {LLAMA_KV_HEADS} kv heads "
          f"of {LLAMA_HEAD_DIM}, d_ff {LLAMA_D_FF}), {n_params} parameters, "
          f"{nbytes} B in bf16 on {dev}")
    eng = CrystalGPU()
    mgr, _ = make_store(4, replication=2)
    sai = SAI(mgr, SAIConfig(ca="cdc-gear"), crystal=eng)
    ckpt = CACheckpointer(sai)
    counters = {"md5": md5.LAUNCHES, "md5_spans": md5.SPAN_LAUNCHES,
                "sliding_md5": sliding_md5.LAUNCHES, "gear": gear.LAUNCHES}
    try:
        for c in counters.values():
            c.reset()
        snaps, recs = [], []
        for step in range(3):
            if step == 1:           # a frozen trunk: only layer 1 changes
                for t in params["layers"]["1"].values():
                    t.copy_(torch.randn(t.shape, generator=gen, device=dev)
                            .to(t.dtype))
            snaps.append(snapshot())
            torch.cuda.synchronize()
            recs.append(ckpt.save(step, params))
        for r in recs:
            rate = r["total_bytes"] / r["wall_s"] / 1e6
            print(f"save step {r['step']}: {rate:.1f} MB/s, dedup "
                  f"{r['dedup_ratio']:.4f}, new {r['new_bytes']} B")
        check(recs[0]["dedup_ratio"] < 0.05, "step 0 is all new")
        check(recs[1]["dedup_ratio"] >= 0.45,
              f"step 1 (layer 0 unchanged) dedups >= 0.45: "
              f"{recs[1]['dedup_ratio']:.4f}")
        check(recs[2]["new_bytes"] == 0, "step 2 (identical) stores nothing")
        moved = mgr.handle_node_failure(0)
        print(f"storage node 0 failed: {moved} blocks re-replicated")
        for step in range(3):
            t0 = time.perf_counter()
            got_step, state, _ = ckpt.restore(version=step)
            wall = time.perf_counter() - t0
            check(got_step == step and equal(state, snaps[step]),
                  f"step {step} restores tensor-equal after node failure")
            print(f"restore step {step} (verified): {nbytes / wall / 1e6:.1f} "
                  f"MB/s, every tensor equal")
            del state
        before = snapshot()
        ckpt.async_save(3, params)
        for t in flat().values():   # the next training step, in place
            t.add_(1)
        ckpt.wait()
        got_step, state, _ = ckpt.restore(version=3)
        check(got_step == 3 and equal(state, before),
              "async_save stored the state as it was when called")
        print("async_save then an in-place update: the restore equals the "
              "state at the call")
        launches = {n: c.value for n, c in counters.items()}
        print(f"checkpoint path kernel launches: {launches}; engine "
              f"{eng.snapshot_stats()['launches']} launches / "
              f"{eng.snapshot_stats()['jobs']} jobs")
        check(launches["gear"] > 0 and launches["md5_spans"] > 0
              and launches["md5"] > 0 and launches["sliding_md5"] == 0,
              "the checkpoint path runs the gear kernel, md5's spans entry "
              "for the saves and its row entry for the verified restores")
    finally:
        sai.close()
        eng.shutdown()
    return launches


def time_split(flush, q, k, v, errs):
    """The f32 flash kernel's TF32 pre-pass alone at the entry point's
    shape: its time beside its byte bound (q, k, v read once, six planes
    written once) and its plain version's, checked bit for bit."""
    from repro_torch.kernels import flash_attn
    ms = time_cuda(lambda: flash_attn.tf32_split(q, k, v), flush)
    what = f"pre-pass at {list(q.shape)}"
    errs["flash_tf32_split"] = max(errs["flash_tf32_split"],
                                   split_matches(q, k, v, what))
    plain_ms = time_cuda(lambda: flash_attn.tf32_split_plain(q, k, v), flush,
                         repeats=1, warmup=0)
    planes = flash_attn.tf32_split(q, k, v)
    nbytes = q.nbytes + k.nbytes + v.nbytes + sum(p.nbytes for p in planes)
    del planes
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    desc = f"q, k, v {list(q.shape)} f32 to six TF32 planes"
    print(f"flash_tf32_split: {ms:.3f} ms at {desc}; bound {b_ms:.4f} ms "
          f"(bytes: {nbytes} B at 3.35 TB/s), {b_ms / ms:.1%} of it; plain "
          f"{plain_ms:.1f} ms, bit-exact; library: none (no one PyTorch "
          f"call splits into TF32 planes)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": "bytes", "shape": desc, "library_ms": None}


def time_two_rules(torch, flush, hashes):
    """The two-rule candidate call as a cas-gear write makes it (one
    256 MiB image's gear hashes, FastCDC's masks), the whole wrapper,
    beside its bound (the hashes read once) and against its plain
    version."""
    from repro_torch.kernels import candidates
    n = hashes.shape[-1]
    ms = time_cuda(lambda: candidates.boundary_candidates(
        hashes, [n], *FASTCDC_RULE), flush)
    found, counts = candidates.boundary_candidates(hashes, [n],
                                                   *FASTCDC_RULE)
    want = {}
    plain_ms = time_cuda(lambda: want.setdefault(
        "v", candidates.candidates_plain(hashes, [n], *FASTCDC_RULE)),
        flush, repeats=1, warmup=0)
    check(torch.equal(found, want["v"][0])
          and counts.tolist() == want["v"][1].tolist(),
          "two-rule boundary_candidates == plain at the cas-gear shape")
    strict = int((found & 1).sum())
    b_ms = 4 * n / HBM_BYTES_PER_S * 1e3
    print(f"boundary_candidates, two rules: {ms:.3f} ms at "
          f"{list(hashes.shape)} uint32 (gear hashes of {n // MiB} MiB), "
          f"{found.numel()} candidates ({strict} strict); bound "
          f"{b_ms:.4f} ms (bytes: {4 * n} B of hashes read once at "
          f"3.35 TB/s), {b_ms / ms:.1%} of it; plain {plain_ms:.1f} ms, "
          f"exact")


def time_spans(torch, np, dev, flush, bound, clock_hz, cycles_per_round,
               errs):
    """``md5_spans`` on one 256 MiB image as the benchmark's LBFS rule
    (cas-cdc) cuts it, in one launch, beside ``md5_words`` on the same
    chunks' ``pack_blocks`` rows (the write path before the spans
    entry), the plain version on its first ``SPAN_PLAIN_TIMED`` chunks,
    and the bound: the larger of the work's (instructions and bytes) and
    the chain of the longest chunk's dependent rounds."""
    from repro_torch.core import SAI, CrystalGPU, SAIConfig, make_store
    from repro_torch.core.sai import pack_blocks
    from repro_torch.kernels import md5
    img = np.random.default_rng(4).integers(0, 256, IMAGE_BYTES,
                                            dtype=np.uint8)
    eng = CrystalGPU(devices=[dev])
    try:
        ends = np.asarray(SAI(make_store(4, replication=2)[0],
                              SAIConfig(**CAS_CDC), crystal=eng)
                          ._boundaries(img.tobytes()), np.int64)
    finally:
        eng.shutdown()
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    lens = ends - starts
    n = lens.size
    image = torch.from_numpy(img.view("<u4")).to(dev)
    st, ln = torch.from_numpy(starts), torch.from_numpy(lens)
    ms = time_cuda(lambda: md5.md5_spans(image, st, ln), flush)
    got = md5.md5_spans(image, st, ln)
    errs["md5_direct_spans"] = max(errs["md5_direct_spans"],
                                   spans_against_plain(
                                       torch, np, img, ends, dev,
                                       "cas-cdc image",
                                       np.arange(SPAN_PLAIN_TIMED)))
    sel = torch.arange(SPAN_PLAIN_TIMED)
    plain_ms = time_cuda(lambda: md5.md5_spans_plain(image, st[sel],
                                                     ln[sel]),
                         flush, repeats=1, warmup=0)
    rows, row_lens = pack_blocks([img[a:b].tobytes()
                                  for a, b in zip(starts, ends)])
    dev_rows = torch.from_numpy(rows.view("<u4")).to(dev)
    lens_w = torch.from_numpy((row_lens // 4).astype(np.int32))
    del rows
    rows_ms = time_cuda(lambda: md5.md5_words(dev_rows, lens_w), flush)
    check(words_equal(md5.md5_words(dev_rows, lens_w), got),
          "md5_words on the packed rows == md5_spans on the image")
    comp = ((lens + 3) // 4 + 1 + 18) // 16
    b_ms, b_by = bound(int(comp.sum()), ops_per_compression(),
                       IMAGE_BYTES + 32 * n)
    chain_ms = int(comp.max()) * 64 * cycles_per_round / clock_hz * 1e3
    if chain_ms > b_ms:
        b_ms, b_by = chain_ms, "the longest chunk's chain"
    shape = (f"{IMAGE_BYTES // MiB} MiB cut by LBFS into {n} chunks "
             f"(mean {IMAGE_BYTES / n:.0f} B, widest {int(lens.max())} B)")
    print(f"md5_direct_spans: {ms:.3f} ms at {shape}; md5_words on the "
          f"same chunks' pack_blocks rows {tuple(dev_rows.shape)} "
          f"{rows_ms:.3f} ms ({4 * dev_rows.numel()} B); bound "
          f"{b_ms:.4f} ms ({b_by}; work {int(comp.sum())} compressions), "
          f"{b_ms / ms:.1%} of it; plain {plain_ms:.1f} ms on its first "
          f"{SPAN_PLAIN_TIMED} chunks, bit-exact; library: none")
    del dev_rows, image, got
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "shape": shape, "rows_ms": rows_ms,
            "library_ms": None}


def phase_times(torch, np, dev, sm_clocks, pipes, cycles_per_round, errs,
                gear_largest):
    print("== phase 6: kernels at their paths' shapes: times (CUDA "
          "events, L2 flushed) and checks against the plain versions")
    from repro_torch.core import chunking
    from repro_torch.kernels import (candidates, flash_attn, gear, md5,
                                     sliding_md5)
    from repro_torch.kernels.ops import sliding_finish
    flush = torch.empty(256 * MiB, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand_words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen).view(torch.uint32)

    def bound(n_comp, ops, nbytes, alu_only=ALU_ONLY_PER_COMPRESSION):
        """Least time for ``n_comp`` compressions of ``ops`` integer
        instructions each, at most 128 per SM-clock of which at most 64
        on the ALU pipe (``alu_only`` of them can run nowhere else), or
        for ``nbytes`` at the HBM rate."""
        t_ops = n_comp * max(ops / INT_LANES_PER_SM,
                             alu_only / ALU_LANES_PER_SM) / sm_clocks
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"

    def pipe_ms(name, n_pass):
        """Times the ALU pipe and the FMA pipe alone need for ``n_pass``
        passes through the kernel's compiled SASS (for the sliding kernel
        one pass per thread and phase: four windows), were every pass to
        issue all of the function's ALU and FMA-pipe instructions: an
        upper estimate, as the count is static and takes in code a pass
        skips (the sliding kernel's bounds-checked path for a row's last
        tile)."""
        return tuple(n_pass * n / (lanes * sm_clocks) * 1e3 for n, lanes
                     in zip(pipes[name], (ALU_LANES_PER_SM,
                                          INT_LANES_PER_SM
                                          - ALU_LANES_PER_SM)))

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
        "shape": f"{B} messages x {n} words in [{B}, {W}] uint32 rows",
        "library_ms": None}
    print(f"md5_direct: {ms:.3f} ms at {out['md5_direct']['shape']}; "
          f"bound {b_ms:.4f} ms ({b_by}, {ops_per_compression()} integer "
          f"instructions per compression); plain {plain_ms:.1f} ms, "
          f"bit-exact; library: none (no PyTorch call computes MD5)")
    # every message is one chain of dependent rounds: no launch ends
    # before its longest message's chain at the max SM clock
    check(nchunks == MD5_PROBE_COMPRESSIONS, "the probe times one message")
    clock_hz = sm_clocks / torch.cuda.get_device_properties(0) \
        .multi_processor_count
    chain_ms = nchunks * 64 * cycles_per_round / clock_hz * 1e3
    print(f"md5_direct: chain bound {chain_ms:.3f} ms ({nchunks * 64} "
          f"dependent rounds x {cycles_per_round:.2f} SM clocks per round "
          f"at {clock_hz / 1e6:.0f} MHz); the kernel takes "
          f"{ms / chain_ms:.2f} x it")
    del words, got
    out["md5_direct_spans"] = time_spans(torch, np, dev, flush, bound,
                                         clock_hz, cycles_per_round, errs)
    # sliding: one 256 MiB image, window 48, at stride 4 (the entry of
    # the kernels line) and at stride 1, each against the plain version
    L, ww = IMAGE_BYTES // 4, 12
    swords = rand_words(1, L)
    ops, alu_only = sliding_ops(ww)
    full = ops_per_compression(16 - ww, 1)
    print(f"sliding_md5 bound: {ops} integer instructions per window "
          f"({LIVE_ROUNDS} live rounds, b + rotl(f, s) as one LEA.HI, "
          f"initial-value constants folded; ALU-only {alu_only}), "
          f"recounted from {full} (64 rounds, the rotation and its add "
          f"apart; ALU-only {ALU_ONLY_PER_COMPRESSION})")
    for stride in (4, 1):
        n_win = L * (4 // stride)
        ms = time_cuda(
            lambda: sliding_md5.sliding_md5_words(swords, ww, stride), flush)
        got = sliding_md5.sliding_md5_words(swords, ww, stride)
        plain_ms = against_plain(
            "sliding_md5", got,
            lambda: sliding_md5.sliding_plain(swords, ww, stride))
        del got
        nbytes = L * 4 + n_win * 4
        b_ms, b_by = bound(n_win, ops, nbytes, alu_only)
        old_ms, _ = bound(n_win, full, nbytes)
        alu, fma = pipe_ms("sliding_md5" if stride == 4
                           else "sliding_md5 stride 1", n_win // 4)
        shape = (f"[1, {L}] uint32 ({IMAGE_BYTES // MiB} MiB), window 48, "
                 f"stride {stride}")
        print(f"sliding_md5: {ms:.3f} ms at {shape}; bound {b_ms:.4f} ms "
              f"({b_by}, {ops} integer instructions per window), "
              f"{b_ms / ms:.1%} of it ({old_ms:.4f} ms at {full}: "
              f"{old_ms / ms:.1%}); its SASS, counted statically, needs at "
              f"most {alu:.4f} ms on the ALU pipe and {fma:.4f} ms on the "
              f"FMA pipe; plain "
              f"{plain_ms:.1f} ms, bit-exact; library: none (no PyTorch "
              f"call computes MD5)")
        if stride == 4:
            out["sliding_md5"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "shape": shape, "library_ms": None}
    # boundary candidates of the same image's stride-1 hashes (1 GiB)
    # under the benchmark's 8 KiB rule: the whole wrapper (both passes and
    # the read of the total between them), against its plain version and
    # the host path it replaced (the hashes copied to pinned memory, the
    # phase interleave and the rule's scan); bound: the hashes read once
    hashes = sliding_md5.sliding_md5_words(swords, ww, 1)
    n_off = IMAGE_BYTES - 48 + 1
    mask, magic = chunking.boundary_rule(BENCH_AVG_CHUNK)
    ms = time_cuda(lambda: candidates.boundary_candidates(
        hashes, [n_off], mask, magic), flush)
    found, counts = candidates.boundary_candidates(hashes, [n_off], mask,
                                                   magic)
    want = {}
    plain_ms = time_cuda(lambda: want.setdefault(
        "v", candidates.candidates_plain(hashes, [n_off], mask, magic)),
        flush, repeats=1, warmup=0)
    check(torch.equal(found, want["v"][0])
          and counts.tolist() == want["v"][1].tolist(),
          "boundary_candidates == plain at the main path's shape")
    del want
    pinned = torch.empty(hashes.shape, dtype=torch.int32, pin_memory=True)

    def host_path():
        pinned.copy_(hashes.view(torch.int32))
        inter = sliding_finish(pinned[0].numpy().view(np.uint32),
                                   sliding_md5.phases_for(1), n_off)
        return np.nonzero((inter & mask) == magic)[0]

    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        on_host = host_path()
        host_s.append(time.perf_counter() - t0)
    check(np.array_equal(found.cpu().numpy(), on_host),
          "boundary_candidates == the host's interleave and scan")
    b_ms = 4 * n_off / HBM_BYTES_PER_S * 1e3
    shape = (f"[1, 4, {L}] uint32 (stride-1 hashes of "
             f"{IMAGE_BYTES // MiB} MiB), {found.numel()} candidates")
    print(f"boundary_candidates: {ms:.3f} ms at {shape}; bound "
          f"{b_ms:.4f} ms (bytes: {4 * n_off} B of hashes read once at "
          f"3.35 TB/s), {b_ms / ms:.1%} of it; plain {plain_ms:.1f} ms, "
          f"exact; the host path it replaced "
          f"{1e3 * statistics.median(host_s):.1f} ms; library: none (no "
          f"PyTorch call compacts a masked test in one pass)")
    out["boundary_candidates"] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes",
        "shape": shape, "library_ms": None}
    del hashes, found, pinned, on_host
    del swords
    # gear: one 256 MiB image, and phase 4's largest launch
    for label, shape in (("one image", (1, IMAGE_BYTES)),
                         ("phase 4's largest launch", gear_largest)):
        if label != "one image" and tuple(shape) == (1, IMAGE_BYTES):
            print(f"gear: phase 4's largest launch is {tuple(shape)}, the "
                  f"shape timed above")
            continue
        x = torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                          device=dev, generator=gen)
        ms = time_cuda(lambda: gear.gear_bytes(x), flush)
        got = gear.gear_bytes(x)
        plain_ms = against_plain("gear", got, lambda: gear.gear_plain(x))
        del got
        n = x.numel()
        t_bytes = 5 * n / HBM_BYTES_PER_S
        t_ops = GEAR_OPS_PER_BYTE * n / (INT_LANES_PER_SM * sm_clocks)
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        desc = f"[{shape[0]}, {shape[1]}] uint8 ({label})"
        print(f"gear: {ms:.3f} ms at {desc}; bound {b_ms:.4f} ms ({b_by}: "
              f"{5 * n} B at 3.35 TB/s, {GEAR_OPS_PER_BYTE} integer "
              f"instructions per byte {t_ops * 1e3:.4f} ms); plain "
              f"{plain_ms:.1f} ms, bit-exact; library: none (no PyTorch "
              f"call computes the gear hash)")
        if label == "one image":
            out["gear"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "shape": desc,
                           "library_ms": None}
            time_two_rules(torch, flush, gear.gear_bytes(x)[:, None])
        del x
    # flash attention at llama3-8b's widths and context: batch 1 x 32
    # query heads, each of the 8 kv heads broadcast to its 4 query heads
    BH, S, hd = LLAMA_HEADS, LLAMA_CONTEXT, LLAMA_HEAD_DIM
    group = LLAMA_HEADS // LLAMA_KV_HEADS
    q32 = torch.randn((BH, S, hd), generator=gen, device=dev)
    k32, v32 = (torch.randn((LLAMA_KV_HEADS, S, hd), generator=gen,
                            device=dev).repeat_interleave(group, 0)
                for _ in range(2))
    flops = 4 * BH * hd * sum(min(i + 1, S) for i in range(S))
    launches = {}
    for dtype, name in ((torch.bfloat16, "flash_attn"),
                        (torch.float16, "flash_attn_f16"),
                        (torch.float32, "flash_attn_f32")):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        f32 = dtype == torch.float32
        flash_attn.LAUNCHES.reset()         # the entry point's own path
        flash_attn.SPLIT_LAUNCHES.reset()
        first = flash_attn.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        launches[name] = flash_attn.LAUNCHES.value
        check(launches[name] == 1 and first.dtype == dtype
              and first.shape == q.shape, "flash_attention_fwd launched "
              "its kernel once and kept shape and dtype")
        check(flash_attn.SPLIT_LAUNCHES.value == int(f32),
              "the TF32 pre-pass ran once in f32 and not in bf16")
        if f32:
            launches["flash_tf32_split"] = flash_attn.SPLIT_LAUNCHES.value
            out["flash_tf32_split"] = time_split(flush, q, k, v, errs)
        del first
        ms = time_cuda(lambda: flash_attn.flash_attention_fwd(q, k, v),
                       flush)
        got = flash_attn.flash_attention_fwd(q, k, v)
        want = {}
        plain_ms = time_cuda(
            lambda: want.setdefault("v", flash_attn.flash_plain(q, k, v)),
            flush, repeats=1, warmup=0)
        err = flash_close(got, q, k, v, want.pop("v"),
                          f"flash {dtype} at BH {BH} S {S} hd {hd}")
        errs[name] = max(errs[name], err)
        del got
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q4, k4, v4 = (t.view(1, BH, S, hd) for t in (q, k, v))
        lib_ms = time_cuda(lambda: sdpa(q4, k4, v4, is_causal=True), flush)
        nbytes = 4 * q.nbytes
        t_bytes = nbytes / HBM_BYTES_PER_S
        if f32:     # the cheaper way to f32 accuracy: FMAs or 3xTF32
            t_fma = flops / FP32_FLOP_PER_S
            t_ops = TF32_PRODUCTS * flops / TF32_FLOP_PER_S
            how = (f"{TF32_PRODUCTS} x {flops:.4g} FLOP in TF32 at "
                   f"{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s, cheaper than f32 "
                   f"FMAs at {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s, "
                   f"{max(t_fma, t_bytes) * 1e3:.4f} ms")
        else:
            t_ops = flops / BF16_FLOP_PER_S     # bf16 and f16 alike
            how = f"{flops:.4g} FLOP at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s"
        b_ms = max(t_ops, t_bytes) * 1e3
        b_by = "operations" if t_ops >= t_bytes else "bytes"
        desc = f"q, k, v [{BH}, {S}, {hd}] {str(dtype)[6:]}, causal"
        print(f"{name}: {ms:.3f} ms at {desc} ({flops / ms / 1e9:.1f} "
              f"TFLOP/s useful); bound {b_ms:.4f} ms ({b_by}: {how}; "
              f"Q+K+V+O {nbytes} B), {b_ms / ms:.1%} of it; plain "
              f"{plain_ms:.1f} ms, max abs err {err:.3g}; library "
              f"scaled_dot_product_attention {lib_ms:.3f} ms "
              f"({flops / lib_ms / 1e9:.1f} TFLOP/s), the kernel "
              f"{lib_ms / ms:.2f} x its speed")
        if f32:
            split_ms = out["flash_tf32_split"]["ms"]
            print(f"{name}: of its {ms:.3f} ms the TF32 pre-pass takes "
                  f"{split_ms:.3f} ms ({split_ms / ms:.1%}) and the main "
                  f"kernel about {ms - split_ms:.3f} ms")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "shape": desc, "library_ms": lib_ms}
        del q, k, v, q4, k4, v4
    return out, launches


def tenant_client(spec: dict) -> int:
    """One tenant's client process of phase 7: write its checkpoint
    series through the gateway over TCP, read every version back
    verified, compare bytes here, and print what it saw as JSON."""
    from repro_torch.serve import GatewayClient
    series = checkpoint_series(spec["versions"], spec["image_bytes"], 0.15,
                               seed=spec["seed"])
    client = GatewayClient(spec["address"], spec["tenant"], qos=spec["qos"],
                           secret=spec["secret"].encode())
    total = sum(len(img) for img in series)
    t0 = time.perf_counter()
    writes = [client.write(spec["path"], img, timeout=600)
              for img in series]
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = [client.read(spec["path"], version=v, verify=True, timeout=600)
            for v in range(len(series))]
    t_read = time.perf_counter() - t0
    client.close()
    same = [got == img for got, img in zip(back, series)]
    print(json.dumps({
        "tenant": spec["tenant"], "qos": spec["qos"], "reads_equal": same,
        "write_mb_s": total / t_write / 1e6,
        "read_mb_s": total / t_read / 1e6,
        "new_blocks": [w["new_blocks"] for w in writes],
        "dup_blocks": [w["dup_blocks"] for w in writes],
        "similarity": [w["dup_blocks"] / (w["new_blocks"] + w["dup_blocks"])
                       for w in writes]}))
    return 0 if all(same) else 1


def hist_percentiles(before, after, ps=(50, 99)):
    """Count and percentiles (seconds) of the latencies a ``Histogram``
    recorded between two ``buckets()`` reads, by its own rule: bucket i
    holds [2**(i-1), 2**i) ns and reads as its geometric middle."""
    delta = [a - b for a, b in zip(after, before)]
    n = sum(delta)
    out = {}
    for p in ps:
        rank, cum = max(1, -(-n * p // 100)), 0
        for i, c in enumerate(delta):
            cum += c
            if cum >= rank:
                out[p] = 0.0 if i == 0 else 2.0 ** (i - 0.5) / 1e9
                break
    return n, out


def http_get(port: int, path: str):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def run_tenants(address: str, secrets, image_bytes: int, seed_offset: int,
                prefix: str, smi: str):
    """Run the four tenant client processes of phase 7 at once, tenant i
    on the series of seed ``seed_offset + i``, and return what each saw.
    Fails if a process fails or reads back other bytes; kills the others
    then."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = []
    try:
        for name, qos, seed in TENANTS:
            spec = {"address": address, "tenant": name, "qos": qos,
                    "secret": secrets[name].decode(),
                    "seed": seed_offset + seed, "versions": GATEWAY_VERSIONS,
                    "image_bytes": image_bytes, "path": f"{prefix}/{name}"}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--tenant-client", json.dumps(spec)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env))
        results = []
        for (name, _, _), p in zip(TENANTS, procs):
            out, err = p.communicate(timeout=900)
            check(p.returncode == 0, f"client process {name} exited "
                  f"{p.returncode}: {err.strip()[-2000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in results:
        check(all(r["reads_equal"]), f"{r['tenant']}: every version reads "
              f"back byte-identical over TCP")
        print(f"{r['tenant']} ({r['qos']}): write {r['write_mb_s']:.1f} "
              f"MB/s, read (verified) {r['read_mb_s']:.1f} MB/s over "
              f"{GATEWAY_VERSIONS} x {image_bytes // MiB} MiB; new blocks "
              f"{r['new_blocks']}, duplicate {r['dup_blocks']}; similarity "
              f"{[round(x, 4) for x in r['similarity']]} [{smi}]")
    return results


def phase_serving(torch, np, smi: str, image_bytes: int = GATEWAY_BYTES):
    """Phase 7: the serving plane on the card.  (a) an in-memory gateway
    with its default engine, tenant auth, the health plane and four
    tenant client processes over TCP; (b) scrub and repair by the
    gateway's node runtime on the engine's scrub lane; (c) a durable
    gateway reopened on its directory."""
    print("== phase 7: serving plane (GatewayClient -> TCP -> "
          "StorageGateway -> SAI -> CrystalGPU; node runtime)")
    from repro_torch.core import SAI, SAIConfig, make_store
    from repro_torch.core import crystal as crystal_mod
    from repro_torch.kernels import gear, md5, sliding_md5
    from repro_torch.serve import (AuthError, GatewayClient, GatewayConfig,
                                   GatewayServer, StorageGateway,
                                   TokenAuthenticator, mint_token)
    t_phase = time.perf_counter()
    counters = {"md5": md5.LAUNCHES, "md5_spans": md5.SPAN_LAUNCHES,
                "sliding_md5": sliding_md5.LAUNCHES, "gear": gear.LAUNCHES}
    secrets = {name: f"secret-{name}".encode() for name, _, _ in TENANTS}
    mgr, nodes = make_store(4, replication=2)
    gw = StorageGateway(mgr, config=GatewayConfig(
        sai=SAIConfig(ca="cdc-gear"), scrub=True, metrics_port=0,
        health=True, auth=TokenAuthenticator(secrets)))
    server = GatewayServer(gw, host="127.0.0.1", port=0)
    eng = gw.engine
    address = "%s:%d" % server.address
    try:
        check([str(d) for d in eng.devices] == ["cuda:0"]
              and eng is crystal_mod.default_engine()
              and eng.policy.adaptive,
              f"the gateway resolved the default engine on cuda:0 with "
              f"adaptive fusion, got {eng.devices}")
        hist = gw.metrics.histogram("request_s/write")

        # (a) four tenant client processes over TCP, the runtime paused
        gw.runtime.pause()
        for c in counters.values():
            c.reset()
        s0, h0 = eng.snapshot_stats(), hist.buckets()
        t0 = time.perf_counter()
        results = run_tenants(address, secrets, image_bytes, 0, "/ckpt", smi)
        t_burst = time.perf_counter() - t0
        s1, h1 = eng.snapshot_stats(), hist.buckets()
        launches = {n: c.value for n, c in counters.items()}
        jobs, fused = s1["jobs"] - s0["jobs"], s1["launches"] - s0["launches"]
        total = GATEWAY_VERSIONS * image_bytes * len(TENANTS)
        print(f"burst of {len(TENANTS)} client processes: {total // MiB} MiB "
              f"written and read back in {t_burst:.2f} s; engine {fused} "
              f"launches / {jobs} jobs; kernel launches {launches}")
        check(fused < jobs, f"cross-client coalescing: {fused} launches < "
              f"{jobs} jobs")
        check(launches["gear"] > 0 and launches["md5_spans"] > 0
              and launches["md5"] > 0,
              "the gateway's tenants ran the gear kernel, md5's spans "
              "entry on their writes and its row entry on their verified "
              "reads")
        n, paused = hist_percentiles(h0, h1)

        # each tenant's similarity == an in-process SAI's on the same
        # engine, the same configuration and the same series
        tenant_series = [checkpoint_series(GATEWAY_VERSIONS, image_bytes,
                                           0.15, seed=seed)
                         for _, _, seed in TENANTS]
        for (name, _, _), r, series in zip(TENANTS, results, tenant_series):
            sai = SAI(make_store(4, replication=2)[0],
                      SAIConfig(ca="cdc-gear"), crystal=eng)
            want = [round(sai.write("/ckpt", img).similarity, 4)
                    for img in series]
            sai.close()
            check([round(x, 4) for x in r["similarity"]] == want,
                  f"{name}: similarity {r['similarity']} == in-process SAI "
                  f"{want}")
        print("every tenant's similarity equals an in-process SAI's on the "
              "same series, to 4 places")

        # auth over TCP: a wrong secret and an expired token are refused
        for what, kw in (("wrong secret", {"secret": b"wrong"}),
                         ("expired token", {"token": mint_token(
                             "tenant0", secrets["tenant0"], ttl_s=-1)})):
            try:
                GatewayClient(address, "tenant0", **kw).close()
                refused = False
            except AuthError:
                refused = True
            check(refused, f"an open with a {what} raises AuthError")
        print("an open with a wrong secret and one with an expired token "
              "both raise AuthError over TCP")

        # the HTTP health plane
        code, body = http_get(gw.http.port, "/metrics")
        text = body.decode()
        check(code == 200 and "# TYPE repro_engine_launches counter" in text
              and "\nrepro_engine_launches " in text,
              "GET /metrics serves repro_engine_launches with # TYPE lines")
        deadline, health = time.monotonic() + 60, None
        while time.monotonic() < deadline:
            code, body = http_get(gw.http.port, "/health")
            health = json.loads(body)
            if code == 200 and health["status"] == "ok":
                break
            time.sleep(0.1)
        check(code == 200 and health["status"] == "ok",
              f"GET /health reaches 200 with status ok: {code} {health}")
        print(f"GET /metrics: {len(text.splitlines())} lines with # TYPE; "
              f"GET /health: 200, status ok")

        # (b) scrub and repair on the card.  pause() would also hold the
        # synchronous cycles below at the runtime's gate, so the
        # background loops are stopped instead and started again after
        rt = gw.runtime
        rt.stop()
        bad = sorted(d for d in nodes[1].healthy_digests()
                     if not d.startswith(b"raw!"))[:SCRUB_CORRUPT]
        check(len(bad) == SCRUB_CORRUPT, f"node 1 holds {SCRUB_CORRUPT} "
              f"blocks to corrupt")
        for d in bad:
            blk = nodes[1].blocks[d]
            nodes[1].blocks[d] = bytes([blk[0] ^ 0xFF]) + blk[1:]
        resident = sum(len(n.blocks[d]) for n in nodes
                       for d in n.healthy_digests())
        e0 = eng.snapshot_stats()
        t0 = time.perf_counter()
        first = rt.scrub_once()
        t_scrub = time.perf_counter() - t0
        placed = rt.repair_once()
        second = rt.scrub_once()
        e1 = eng.snapshot_stats()
        scrub_jobs = e1["scrub_jobs"] - e0["scrub_jobs"]
        scrub_launches = e1["scrub_launches"] - e0["scrub_launches"]
        check(first["corrupt"] == SCRUB_CORRUPT, f"the first scrub finds "
              f"exactly {SCRUB_CORRUPT} corrupt copies: {first}")
        for d in bad:
            healthy = [nid for nid in mgr.lookup_block(d)
                       if mgr.nodes[nid].has(d)]
            check(len(healthy) == 2, f"block {d.hex()[:8]} has 2 healthy "
                  f"replicas after repair: {healthy}")
        check(second["corrupt"] == 0, f"the second scrub finds 0: {second}")
        check(scrub_launches < scrub_jobs, f"fused scrub bursts: "
              f"{scrub_launches} scrub launches < {scrub_jobs} scrub jobs")
        print(f"scrub: {first['scanned']} block copies ({resident / MiB:.1f} "
              f"MiB) in {t_scrub:.3f} s = {resident / t_scrub / 1e6:.1f} MB/s "
              f"[{smi}], {first['corrupt']} corrupt; repair placed {placed} "
              f"copies; second scrub {second}; scrub lane {scrub_launches} "
              f"launches / {scrub_jobs} jobs")
        for (name, _, _), series in zip(TENANTS, tenant_series):
            c = GatewayClient(address, name, secret=secrets[name])
            for v, img in enumerate(series):
                check(c.read(f"/ckpt/{name}", version=v, verify=True,
                             timeout=600) == img,
                      f"{name} version {v} reads back after the repair")
            c.close()
        print("every tenant's versions read back byte-identical after the "
              "repair")

        # the same burst with the runtime sweeping, for the latency
        # percentiles beside the paused ones (fresh series, seeds 11-14)
        rt.start()
        del tenant_series
        print("the same burst again, series of seeds 11-14, with the "
              "runtime sweeping:")
        h2 = hist.buckets()
        sweeps0 = rt.snapshot_stats()["scrubbed_blocks"]
        run_tenants(address, secrets, image_bytes, 10, "/sweep", smi)
        h3 = hist.buckets()
        m, sweeping = hist_percentiles(h2, h3)
        print(f"gateway request_s/write over {n} writes, runtime paused: "
              f"p50 {paused[50]:.3f} s, p99 {paused[99]:.3f} s; over {m} "
              f"writes, runtime sweeping ("
              f"{rt.snapshot_stats()['scrubbed_blocks'] - sweeps0} blocks "
              f"scrubbed meanwhile): p50 {sweeping[50]:.3f} s, p99 "
              f"{sweeping[99]:.3f} s [{smi}]")
    finally:
        server.close()
        gw.close()

    # (c) a durable gateway at the paper's stride-1 CDC, reopened
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    series = checkpoint_series(2, image_bytes, 0.15, seed=1)
    with tempfile.TemporaryDirectory(dir=build) as d:
        cfg = GatewayConfig(data_dir=d, n_nodes=4, replication=2,
                            scrub=True, sai=SAIConfig(ca="cdc", stride=1))
        sliding_md5.LAUNCHES.reset()
        gw = StorageGateway(config=cfg)
        try:
            server = GatewayServer(gw, host="127.0.0.1", port=0)
            c = GatewayClient(server, "durable")
            t0 = time.perf_counter()
            stats = [c.write("/durable", img, timeout=600) for img in series]
            t_write = time.perf_counter() - t0
            c.close()
            server.close()
        finally:
            gw.close()
        slid = sliding_md5.LAUNCHES.value
        check(slid > 0, "the durable gateway's cdc stride-1 writes ran the "
              "sliding kernel")
        gw = StorageGateway(config=cfg)
        try:
            rep = gw.recovery_report
            suspects = sum(len(v) for v in rep.suspects.values())
            c = GatewayClient(gw, "durable")
            for v, img in enumerate(series):
                check(c.read("/durable", version=v, verify=True,
                             timeout=600) == img,
                      f"durable version {v} reads back after the reopen")
            c.close()
            check(rep.refcount_drift == 0 and not rep.lost_blocks,
                  f"recovery: drift {rep.refcount_drift}, lost "
                  f"{len(rep.lost_blocks)}")
        finally:
            gw.close()
    sim = [round(w["dup_blocks"] / (w["new_blocks"] + w["dup_blocks"]), 4)
           for w in stats]
    print(f"durable gateway (cdc, stride 1): 2 x {image_bytes // MiB} MiB "
          f"written at {2 * image_bytes / t_write / 1e6:.1f} MB/s [{smi}] "
          f"(similarity {sim}), {slid} sliding launches; reopened "
          f"(snapshot seq {rep.snapshot_seq}, {rep.replayed} records "
          f"replayed, {suspects} suspects scrubbed), both versions read "
          f"back verified")
    eng.shutdown()
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s")
    return launches


def overlap_ms(torch, dev, md5, rows, smi: str):
    """The kernels of phase 8 (b)'s jobs alone: one ``md5_direct`` launch
    per job on one stream and on a stream each, CUDA events around all of
    them (median of 3, in turns).  How many launches the card overlaps."""
    words = [torch.from_numpy(r).to(dev).view(torch.uint32) for r in rows]
    lens = torch.full((len(rows[0]),), words[0].shape[1], dtype=torch.int32,
                      device=dev)
    streams = [torch.cuda.Stream(dev) for _ in words]

    def run(n_streams):
        main = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(main)
        outs = []
        for i, w in enumerate(words):
            s = streams[i] if n_streams > 1 else main
            s.wait_stream(main)
            outs.append(md5.md5_words(w, lens, stream=s))
        for s in streams:
            main.wait_stream(s)
        end.record(main)
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end), outs

    times = {1: [], len(words): []}
    outs = {}
    for n in (1, len(words)) * 4:           # the first of each warms up
        ms, outs[n] = run(n)
        times[n].append(ms)
    for a, b in zip(outs[1], outs[len(words)]):
        check(words_equal(a, b), "md5 on one stream == on four")
    one, many = (statistics.median(times[n][1:]) for n in times)
    print(f"{len(words)} md5_direct launches of {len(rows[0])} messages x "
          f"{words[0].shape[1]} words, kernels alone: {one:.3f} ms on one "
          f"stream, {many:.3f} ms on {len(words)} streams ({one / many:.2f}"
          f"x) [{smi}]")


def phase_mesh(torch, np, images, maps, smi: str, dev=None):
    """Phase 8: the engine mesh (four managers and streams on one card)
    and the read path.  ``maps`` holds phase 4's block maps of ``images``
    under each of ``MESH_CONFIGS``.  Returns the hashing kernels' launches
    over (a)."""
    print("== phase 8: engine mesh (four managers, each with its own "
          "stream, on one card) and the read path")
    import threading
    from repro_torch.core import SAI, CrystalGPU, SAIConfig, make_store
    from repro_torch.core import integrity
    from repro_torch.core.sai import block_digest_cpu
    from repro_torch.kernels import gear, md5, sliding_md5
    from repro_torch.roofline.analysis import HASH_OPS_PER_BYTE, \
        hash_cost_seed
    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def md5_rows(rows):
        return np.stack([np.frombuffer(hashlib.md5(r.tobytes()).digest(),
                                       np.uint8) for r in rows])

    counters = {"md5_spans": md5.SPAN_LAUNCHES,
                "sliding_md5": sliding_md5.LAUNCHES, "gear": gear.LAUNCHES}
    one = CrystalGPU(devices=[dev])
    mesh = CrystalGPU(devices=[dev] * MESH_MANAGERS)
    try:
        # (a) whale sharding: each image's hash jobs split across the four
        # managers' streams; block maps and digests as one manager's
        for c in counters.values():
            c.reset()
        rows0 = md5.LAUNCHES.value
        total = sum(len(img) for img in images)
        for ca in MESH_CONFIGS:
            rates = {}
            for eng in (one, mesh):
                mgr, _ = make_store(4, replication=2)
                sai = SAI(mgr, SAIConfig(**CONFIGS[ca]), crystal=eng)
                s0 = eng.snapshot_stats()
                t0 = time.perf_counter()
                futs = [sai.write_async("/ckpt", img) for img in images]
                for f in futs:
                    f.result(timeout=900)
                sync()
                rates[len(eng.devices)] = total / (time.perf_counter()
                                                   - t0) / 1e6
                s1 = eng.snapshot_stats()
                sai.close()
                check(block_maps(mgr, len(images)) == maps[ca],
                      f"{ca}, {len(eng.devices)} manager(s): every block "
                      f"map and digest == phase 4's one-manager engine")
            sharded = s1["sharded_jobs"] - s0["sharded_jobs"]
            shards = s1["shards"] - s0["shards"]
            busy = [i for i, d in s1["per_device"].items()
                    if d["jobs"] > s0["per_device"][i]["jobs"]]
            check(sharded >= 1 and shards >= 2 and len(busy) >= 2,
                  f"{ca}: {sharded} sharded jobs, {shards} shards, "
                  f"managers with jobs {busy}")
            print(f"{ca}: {len(images)} x {len(images[0]) // MiB} MiB "
                  f"written at {rates[1]:.1f} MB/s on 1 manager, "
                  f"{rates[MESH_MANAGERS]:.1f} MB/s on {MESH_MANAGERS} "
                  f"[{smi}]; block maps identical; {sharded} sharded jobs "
                  f"in {shards} shards, managers with jobs {busy}")
        launches = {n: c.value for n, c in counters.items()}
        print(f"phase 8 (a) kernel launches: {launches}, md5 rows "
              f"{md5.LAUNCHES.value - rows0}")
        check(all(n > 0 for n in launches.values())
              and md5.LAUNCHES.value == rows0,
              "every hashing kernel the writes use launched in phase 8 (a), "
              "md5 as spans and never as rows")

        # (b) four independent direct jobs at once: one manager's stream
        # against four
        rng = np.random.default_rng(8)
        rows = [rng.integers(0, 256, (MESH_ROWS, MESH_ROW_BYTES), np.uint8)
                for _ in range(MESH_JOBS)]
        digests = {}
        for eng in (one, mesh):
            for timed in (False, True):        # the first fills staging
                s0 = eng.snapshot_stats()
                t0 = time.perf_counter()
                jobs = [eng.submit("direct", r, {}) for r in rows]
                got = [j.wait() for j in jobs]
                wall = time.perf_counter() - t0
            s1 = eng.snapshot_stats()
            digests[len(eng.devices)] = got
            print(f"{MESH_JOBS} direct jobs of {MESH_ROWS} x "
                  f"{MESH_ROW_BYTES} B at once on {len(eng.devices)} "
                  f"manager(s): {wall * 1e3:.1f} ms [{smi}], "
                  f"{s1['launches'] - s0['launches']} launches, "
                  f"{s1['shards'] - s0['shards']} shards")
        for a, b in zip(digests[1], digests[MESH_MANAGERS]):
            check(np.array_equal(a, b), "direct digests on 4 managers == "
                  "on 1 manager")
        for r, d in zip(rows, digests[1]):
            check(np.array_equal(d[:2], md5_rows(r[:2])),
                  "direct digests == hashlib")
        if dev.type == "cuda":
            overlap_ms(torch, dev, md5, rows, smi)
        del rows

        # (c) load-aware dispatch away from a slow manager, then a crash
        row = rng.integers(0, 256, (1, ROW_BYTES), np.uint8)
        want = md5_rows(row)
        slow = CrystalGPU(devices=[dev] * MESH_MANAGERS, coalesce=False)
        slow._launch_hook = lambda idx, batch: (
            time.sleep(SLOW_DELAY_S) if idx == 0 else None)
        try:
            jobs = []
            for _ in range(SLOW_JOBS):
                jobs.append(slow.submit("direct", row, {}))
                time.sleep(SLOW_PACE_S)
            for j in jobs:
                check(np.array_equal(j.wait(), want), "paced job digest")
            per = slow.snapshot_stats()["per_device"]
        finally:
            slow.shutdown()
        spread = {i: d["jobs"] for i, d in per.items()}
        check(sum(spread.values()) == SLOW_JOBS
              and spread[0] < SLOW_JOBS / 3,
              f"the slow manager 0 gets under a third of {SLOW_JOBS} "
              f"jobs: {spread}")
        print(f"load-aware dispatch, {SLOW_DELAY_S * 1e3:.0f} ms added to "
              f"manager 0's launches: jobs per manager {spread}")
        crash = CrystalGPU(devices=[dev] * MESH_MANAGERS, coalesce=False)
        fired = threading.Event()

        def fault(idx, batch):
            if idx == 0 and not fired.is_set():
                fired.set()
                raise RuntimeError("injected manager crash")

        crash._fault_hook = fault
        try:
            jobs = [crash.submit("direct", row, {})
                    for _ in range(CRASH_JOBS)]
            failed = 0
            for j in jobs:
                j.done.wait(timeout=600)
                if j.error is not None:
                    check("injected manager crash" in str(j.error),
                          f"a failed job carries the crash: {j.error!r}")
                    failed += 1
                else:
                    check(np.array_equal(j.result, want),
                          "every other job's digest is right")
            st = crash.snapshot_stats()
            check(fired.is_set() and failed >= 1,
                  f"the crashed batch failed ({failed} jobs)")
            check(st["manager_restarts"] == 1
                  and st["per_device"][0]["manager_restarts"] == 1,
                  f"one manager restart: {st['manager_restarts']}")
            served = None
            for _ in range(4 * MESH_MANAGERS):
                j = crash.submit("direct", row, {})
                check(np.array_equal(j.wait(), want), "job after restart")
                if j.device_index == 0:
                    served = j
                    break
            check(served is not None, "the restarted manager 0 serves a "
                  "further job")
            check(crash.queue_depth() == 0, "no job stranded")
        finally:
            crash.shutdown()
        print(f"crash of manager 0: {failed} job(s) of its batch failed, "
              f"{CRASH_JOBS - failed} right, manager_restarts "
              f"{st['manager_restarts']}, manager 0 served a job after it")

        # (d) the read path on the mesh: read cache, quarantine, ranges
        img = images[0]
        mgr, nodes = make_store(4, replication=2)
        sai = SAI(mgr, SAIConfig(ca="fixed",
                                 read_cache_bytes=READ_CACHE_BYTES),
                  crystal=mesh)
        sai.write("/ckpt", img)
        t0 = time.perf_counter()
        check(sai.read("/ckpt") == img, "first verified read")
        t_miss = time.perf_counter() - t0

        def gets():
            return sum(n.get_count for n in nodes)

        l0, j0, g0 = md5.LAUNCHES.value, mesh.stats["jobs"], gets()
        t0 = time.perf_counter()
        check(sai.read("/ckpt") == img, "cached verified read")
        t_hit = time.perf_counter() - t0
        check(md5.LAUNCHES.value == l0 and mesh.stats["jobs"] == j0
              and gets() == g0, "a cached re-read adds no md5 launch, job "
              "or node fetch")
        fv = mgr.get_blockmap("/ckpt")
        digest = fv.blocks[1].digest
        mgr.quarantine_block(digest, mgr.block_registry[digest][0])
        check(digest not in sai._cache, "quarantine evicts the block")
        l0, g0 = md5.LAUNCHES.value, gets()
        check(sai.read("/ckpt") == img, "read after the quarantine")
        check(gets() > g0 and digest in sai._cache
              and md5.LAUNCHES.value > l0,
              "the quarantined block is fetched and verified again")
        print(f"read cache {READ_CACHE_BYTES // MiB} MiB: verified read of "
              f"{len(img) // MiB} MiB {len(img) / t_miss / 1e6:.1f} MB/s, "
              f"cached {len(img) / t_hit / 1e6:.1f} MB/s [{smi}], no md5 "
              f"launch; quarantined block {digest.hex()[:8]} fetched and "
              f"verified again ({sai.read_stats['cache_invalidations']} "
              f"invalidation)")
        sai.close()
        # each range fetched and verified on the card (no cache), and its
        # covering blocks' hashlib digests proved against the root here
        plain = SAI(mgr, SAIConfig(ca="fixed"), crystal=mesh)
        leaves = [b.digest for b in fv.blocks]
        check(integrity.merkle_root(leaves) == fv.merkle_root,
              "the block map's root")
        starts = np.cumsum([0] + [b.length for b in fv.blocks])
        n = len(img)
        rr = np.random.default_rng(9)
        ranges = [(int(rr.integers(0, n)), int(rr.integers(1, 8 * MiB)))
                  for _ in range(N_RANGES - 2)]
        ranges += [(n - 12345, 12345), (n - 100, 8 * MiB)]   # EOF edges
        l0 = md5.LAUNCHES.value
        t0 = time.perf_counter()
        for off, ln in ranges:
            got = plain.read_range("/ckpt", off, ln)
            check(got == img[off:off + ln], f"read_range({off}, {ln})")
            first = int(np.searchsorted(starts, off, side="right")) - 1
            last = int(np.searchsorted(starts, min(off + ln, n),
                                       side="left"))
            for i in range(first, last):
                blk = img[starts[i]:starts[i + 1]]
                check(integrity.merkle_verify(
                    block_digest_cpu(blk), i,
                    integrity.merkle_proof(leaves, i), fv.merkle_root),
                    f"block {i} of read_range({off}, {ln}) proved "
                    f"against the root")
        t_ranges = time.perf_counter() - t0
        check(md5.LAUNCHES.value - l0 >= len(ranges),
              "every range verified on the card")
        check(plain.read_range("/ckpt", n, 10) == b"", "a range at EOF is "
              "empty")
        try:
            plain.read_range("/ckpt", n + 1, 10)
            check(False, "a range past EOF raises")
        except ValueError:
            pass
        plain.close()
        print(f"read_range: {len(ranges)} seeded ranges (two at EOF) equal "
              f"the full read, each verified on the card and its blocks "
              f"proved against FileVersion.merkle_root, in {t_ranges:.2f} "
              f"s; at EOF empty, past EOF ValueError")

        # (e) the cost model: the H100 seeds and the mesh's regression
        cost = mesh.snapshot_stats()["cost_model"]
        for kind in HASH_OPS_PER_BYTE:
            seed = hash_cost_seed(kind)
            now = cost.get(kind, {})
            print(f"cost model {kind}: seeded (overhead "
                  f"{seed['launch_overhead_s']:.4g} s, "
                  f"{seed['sec_per_byte']:.4g} s/B), regressed on the mesh "
                  f"(overhead {now.get('overhead_s', float('nan')):.4g} s, "
                  f"{now.get('sec_per_byte', float('nan')):.4g} s/B, "
                  f"{now.get('observations', 0)} launches) [{smi}]")
    finally:
        one.shutdown()
        mesh.shutdown()
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 9: LM serving.  (a) the serving CLI, python -m
# repro_torch.launch.serve with LM_ARGV: llama3-8b at its published widths
# and depth, bf16 weights from seed LM_SEED on the card, a prefill of 4
# prompts of 4096 tokens (two query blocks of 2048), then 32 greedy decode
# steps (33 new tokens, the first from the prefill); (b) a
# ContinuousBatcher of BATCHER_SLOTS slots serving BATCHER_REQUESTS seeded
# requests; (c) checks (see phase_lm)
LM_SEED = 0
LM_ARGV = ["--arch", "llama3-8b", "--preset", "full", "--batch", "4",
           "--prompt-len", "4096", "--new-tokens", "33", "--param-dtype",
           "bfloat16", "--seed", str(LM_SEED)]
BATCHER_SLOTS, BATCHER_REQUESTS = 4, 8
BATCHER_PROMPTS, BATCHER_NEW = (128, 2048), (8, 32)
# decode against the full forward: prefill(S) + decode(1) against
# forward(S + 1) at the last position, within DECODE_TOL x max|logit|
# (the reference's test_decode_matches_full_forward, 2e-3)
DECODE_S, DECODE_B, DECODE_TOL = 511, 2, 2e-3
# the card against the CPU: llama3-8b's widths cut to CARD_CPU_LAYERS
# layers, f32 on both, forward logits within CARD_CPU_TOL x max|logit|
CARD_CPU_LAYERS, CARD_CPU_S, CARD_CPU_TOL = 2, 64, 1e-4
# the other full-width paths: mamba2-1.3b at full depth (prompt a multiple
# of its chunk of 256), mixtral-8x7b at its widths cut to MIXTRAL_LAYERS
# layers; each a prefill and OTHER_DECODE decode steps
MAMBA_B, MAMBA_S = 2, 512
MIXTRAL_LAYERS, MIXTRAL_B, MIXTRAL_S = 2, 2, 512
OTHER_DECODE = 8
# bf16: a unit roundoff, relative, for the batcher-against-sequential bound
BF16_U = 2.0 ** -8


@contextlib.contextmanager
def lm_variant(model, cfg=None, cdt=None):
    """Run ``model`` with another config (same widths) or compute dtype
    on the same weights, restored after."""
    saved = model.cfg, model.cdt
    model.cfg = cfg or model.cfg
    model.cdt = cdt or model.cdt
    try:
        yield model
    finally:
        model.cfg, model.cdt = saved


def decode_vs_forward(torch, model, gen, B: int, S: int, what: str):
    """prefill(S) + decode(1) logits against forward(S + 1) at the last
    position, within DECODE_TOL x max|logit|."""
    dev = model.device
    toks = torch.randint(0, model.cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev)
    cache, _ = model.prefill(toks[:, :S], capacity=model.capacity_for(S + 1))
    _, lg = model.decode_step(cache, toks[:, S:], S)
    del cache
    with torch.inference_mode():
        full, _ = model.forward(toks)
    want = full[:, -1]
    err = float((lg - want).abs().max())
    scale = float(want.abs().max())
    print(f"{what}: decode against forward, prefill({S}) + decode(1) vs "
          f"forward({S + 1}), B {B}: max abs err {err:.3e}, max|logit| "
          f"{scale:.3e}, ratio {err / scale:.2e} (limit {DECODE_TOL})")
    check(err <= DECODE_TOL * scale, f"{what}: decode against forward")
    return err / scale


def served(torch, model, res, what: str):
    """Checks on ``launch.serve.serve``'s result: finite last logits of
    the vocabulary's width, tokens in the vocabulary."""
    B, n_new = res["tokens"].shape
    V = model.cfg.vocab_size
    check(bool(torch.isfinite(res["logits"]).all()),
          f"{what}: logits finite")
    check(res["logits"].shape == (B, V), f"{what}: logits shape")
    check(bool(((res["tokens"] >= 0) & (res["tokens"] < V)).all()),
          f"{what}: tokens in the vocabulary")
    check(len(res["step_s"]) == n_new - 1, f"{what}: one time per step")


def batcher_vs_sequential(torch, np, model, cb, rec, reqs, smi: str):
    """(c) The batcher's logits, teacher-forced, against decoding each
    request alone: its own prefill at the batcher's capacity, then its
    tokens one at a time, (1) at batch 1, as ``greedy_generate`` runs it,
    and (2) with the prefill's cache copied to the batcher's slot count,
    so that every product has the batcher's shapes.

    (1) The two run the same bf16 ops on the same values, but a product
    of another batch size may sum in another order, so a rounded output
    can land one bf16 ulp (relative u = 2**-8) apart.  The residual
    stream and the logits go through 2L + 1 rounded adds (the 2L sublayer
    outputs, the head); taken as independent, such differences add in
    quadrature, sqrt(2L + 1) u relative to the largest logit.  The bound
    is twice that, 2 sqrt(2L + 1) u max|logit|; tokens must be equal
    wherever the batch-1 top-2 margin exceeds twice the bound.
    (2) Rows of a product do not depend on each other, so at the same
    shapes the logits must be equal bit for bit, and every token too:
    batching, ragged positions and slot reuse add no error."""
    L = model.cfg.num_layers
    k_tol = 2 * math.sqrt(2 * L + 1) * BF16_U
    worst, below, steps, n_tok = 0.0, 0, 0, 0
    for req in reqs:
        prompt = torch.from_numpy(req.prompt).to(model.device)
        one, lg = model.prefill(prompt[None], capacity=cb.capacity)
        wide = {key: {name: t.repeat(1, cb.B, *([1] * (t.ndim - 2)))
                      for name, t in group.items()}
                for key, group in one.items()}
        seq, same = [lg[0]], [lg[0]]
        for i, t in enumerate(req.out_tokens[:-1]):
            tok = torch.tensor([[t]], device=model.device)
            pos = len(req.prompt) + i
            one, lg = model.decode_step(one, tok, pos)
            seq.append(lg[0])
            wide, lg = model.decode_step(wide, tok.expand(cb.B, 1), pos)
            same.append(lg[0])
        del one, wide
        got = rec[req.rid]
        check(len(got) == len(seq) == len(req.out_tokens),
              f"request {req.rid}: one logits row per token")
        for i, (b, s, w) in enumerate(zip(got, seq, same)):
            check(torch.equal(b, w), f"request {req.rid} token {i}: "
                  f"batcher logits == alone at the batcher's shapes")
            check(req.out_tokens[i] == int(torch.argmax(w)),
                  f"request {req.rid} token {i}: batcher token == alone")
            tol = k_tol * float(s.abs().max())
            err = float((b - s).abs().max())
            worst = max(worst, err / tol)
            check(err <= tol, f"request {req.rid} token {i}: batcher "
                  f"logits within {k_tol:.4f} max|logit| of batch 1 "
                  f"({err:.3e} > {tol:.3e})")
            top2 = torch.topk(s, 2).values
            steps += 1
            if float(top2[0] - top2[1]) > 2 * tol:
                n_tok += 1
                check(req.out_tokens[i] == int(torch.argmax(s)),
                      f"request {req.rid} token {i}: batcher token == "
                      f"batch-1 argmax")
            else:
                below += 1
    print(f"(c) batcher against each request alone [{smi}]: {steps} "
          f"logits rows of {len(reqs)} requests.  At the batcher's shapes "
          f"equal bit for bit, every token equal.  At batch 1 within "
          f"2 sqrt(2L+1) u max|logit| = {k_tol:.4f} max|logit| (worst at "
          f"{worst:.3f} of it, {worst * k_tol / BF16_U:.2f}u); tokens equal "
          f"at the {n_tok} steps whose top-2 margin exceeds twice that, "
          f"{below} steps below the margin")


def arch_smoke_on_card(torch, np, dev):
    """(c) Every architecture at its smoke config on the card against the
    same weights on the CPU (f32, forward logits and prefill + OTHER_DECODE
    decode steps teacher-forced with the card's tokens, within
    CARD_CPU_TOL x max|logit|), and decode against the full forward on
    the card; plus the SWA ring far past a 16-token window."""
    from repro_torch.configs import ARCH_NAMES, get_smoke_config
    from repro_torch.models.model import build_model
    cases = [(a, get_smoke_config(a)) for a in ARCH_NAMES]
    mix = get_smoke_config("mixtral-8x7b")
    cases.append(("mixtral-8x7b SWA ring 16", dataclasses.replace(
        mix, swa_window=16, moe=dataclasses.replace(
            mix.moe, capacity_factor=100.0))))
    for name, cfg in cases:
        cpu = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(LM_SEED))
        card = build_model(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        gen = torch.Generator().manual_seed(LM_SEED + 1)
        F = cfg.frontend_embeds
        B, S = 2, 40
        toks = torch.randint(0, cfg.vocab_size, (B, S - F), generator=gen)
        emb = torch.randn((B, F, cfg.d_model), generator=gen) if F else None
        errs = []
        with torch.inference_mode():
            want, _ = cpu.forward(toks, emb)
            got, _ = card.forward(toks.to(dev),
                                  None if emb is None else emb.to(dev))
        errs.append(float((got.cpu() - want).abs().max())
                    / float(want.abs().max()))
        cap = card.capacity_for(S + OTHER_DECODE)      # the ring: 16
        c_cpu, lg_cpu = cpu.prefill(toks, emb, capacity=cap)
        c_card, lg_card = card.prefill(
            toks.to(dev), None if emb is None else emb.to(dev),
            capacity=cap)
        errs.append(float((lg_card.cpu() - lg_cpu).abs().max())
                    / float(lg_cpu.abs().max()))
        for i in range(OTHER_DECODE):
            tok = torch.argmax(lg_card, -1)[:, None]
            c_card, lg_card = card.decode_step(c_card, tok, S + i)
            c_cpu, lg_cpu = cpu.decode_step(c_cpu, tok.cpu(), S + i)
            errs.append(float((lg_card.cpu() - lg_cpu).abs().max())
                        / float(lg_cpu.abs().max()))
        check(max(errs) <= CARD_CPU_TOL,
              f"{name} smoke: card against CPU, {max(errs):.2e}")
        dcfg = cfg
        if cfg.moe is not None:
            dcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=100.0))
        with lm_variant(card, cfg=dataclasses.replace(dcfg,
                                                      frontend_embeds=0)):
            rel = decode_vs_forward(torch, card, torch.Generator(
                dev).manual_seed(LM_SEED), 2, 32, f"{name} smoke")
        print(f"{name} smoke on the card: card against CPU worst "
              f"{max(errs):.2e} x max|logit| over forward, prefill and "
              f"{OTHER_DECODE} decode steps; decode against forward "
              f"{rel:.2e}")


def score_products_on_card(torch, dev, C: int):
    """(c) The bf16 score products on the tensor cores (``ScoresF32`` and
    the decode step's block-diagonal product, ``aten::bmm.dtype``) against
    the f32 products of the same bf16 values on the CUDA cores: decode
    attention at llama3-8b's widths against a cache of C slots, and
    ``gqa_attention`` forward and grads at minicpm-2b's widths over two
    checkpointed query blocks.  The two sum the same exact products in
    another order, so the f32 scores agree to f32 rounding and a bf16
    result moves by one rounding of itself or of a probability:
    within u (max|v| + max|out|) for decode (u = 2**-8), and within 2u of
    each result's largest for the training attention and its grads."""
    from repro_torch.models import layers
    gen = torch.Generator(dev).manual_seed(LM_SEED + 2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    def both(fn):
        got = fn()
        real = layers._tensor_core_scores
        layers._tensor_core_scores = lambda a, b: False
        try:
            want = fn()
        finally:
            layers._tensor_core_scores = real
        return got, want

    B, H, K, hd = 4, 32, 8, 128
    q, kc, vc = randn(B, 1, H, hd), randn(B, C, K, hd), randn(B, C, K, hd)
    cur = torch.tensor([C - 1, C // 2, 17, C - 1], device=dev)
    with torch.inference_mode():
        got, want = both(lambda: layers.decode_attention(
            q, kc, vc, torch.arange(C, device=dev), cur))
    err = float((got.float() - want.float()).abs().max())
    tol = BF16_U * (float(vc.float().abs().max())
                    + float(want.float().abs().max()))
    print(f"(c) decode attention, bf16, B {B}, cache {C} x {K} x {hd}, "
          f"{H} heads: tensor cores (cache read in place) against f32 "
          f"products, max abs err {err:.3e} (limit {tol:.3e})")
    check(got.dtype == torch.bfloat16 and err <= tol,
          "(c) decode attention on the tensor cores == f32 products")

    S, H, hd, qb = 1024, 36, 64, 512
    ins = [randn(1, S, H, hd) for _ in range(3)]
    w = torch.randn((1, S, H, hd), generator=gen, device=dev)
    pos = torch.arange(S, device=dev)

    def train_attention():
        x = [t.clone().requires_grad_() for t in ins]
        out = layers.gqa_attention(*x, pos, pos, q_block=qb)
        grads = torch.autograd.grad((out.float() * w).sum(), x)
        return [out.detach(), *grads]
    errs = {}
    for name, g, wt in zip(("out", "dq", "dk", "dv"), *both(train_attention)):
        check(g.dtype == torch.bfloat16, f"(c) {name} in bf16")
        errs[name] = float((g.float() - wt.float()).abs().max()) \
            / float(wt.float().abs().max())
    print(f"(c) gqa_attention under grad, bf16, S {S}, {H} heads of {hd}, "
          f"two query blocks of {qb}: tensor cores against f32 products, "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" of each one's largest (limit {2 * BF16_U:.2e})")
    check(max(errs.values()) <= 2 * BF16_U,
          "(c) training attention on the tensor cores == f32 products")


def phase_lm(torch, np, smi: str):
    """Phase 9: the LM serving path on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn, gear, md5, sliding_md5
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import build_model
    from repro_torch.roofline.analysis import (HW, decode_weight_bytes,
                                               prefill_flops)
    from repro_torch.serve.scheduler import ContinuousBatcher
    print("== phase 9: LM serving (llama3-8b at full width and depth, "
          "continuous batching, decode and card checks)")
    t_phase = time.perf_counter()
    check(torch.get_float32_matmul_precision() == "highest",
          "f32 matmuls in full f32 (no TF32)")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 off")
    counters = {"md5": md5.LAUNCHES, "md5_spans": md5.SPAN_LAUNCHES,
                "sliding_md5": sliding_md5.LAUNCHES,
                "gear": gear.LAUNCHES, "flash_attn": flash_attn.LAUNCHES,
                "flash_tf32_split": flash_attn.SPLIT_LAUNCHES}
    for c in counters.values():
        c.reset()
    hw = HW()
    # what else holds the host: decode is host-bound, so its time per step
    # moves with the threads left running and the host's load
    others = sorted(t.name for t in threading.enumerate()
                    if t is not threading.current_thread())
    print(f"phase 9 host: {len(others)} other Python threads alive "
          f"{others[:8]}, load average {os.getloadavg()}, "
          f"{os.cpu_count()} CPUs")

    # (a) the serving CLI: llama3-8b, bf16 weights at full width and depth
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    print(f"(a) python -m repro_torch.launch.serve {' '.join(LM_ARGV)}")
    model, res = serve_cli.main(LM_ARGV)
    cfg, dev = model.cfg, model.device
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"(a) {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}: {n_params} parameters ({n_bytes / 1e9:.2f} GB "
          f"{cfg.param_dtype}) on {dev}; built, initialised and served in "
          f"{time.perf_counter() - t0:.1f} s")
    served(torch, model, res, f"(a) {cfg.name}")
    B, n_new = res["tokens"].shape
    S = int(LM_ARGV[LM_ARGV.index("--prompt-len") + 1])
    t_prefill, steps = res["prefill_s"], res["step_s"]
    t_step = statistics.median(steps)
    flops = prefill_flops(cfg, B, S)
    wbytes = decode_weight_bytes(cfg, 2)
    kv_bytes = 2 * 2 * cfg.num_layers * B * (S + n_new) \
        * cfg.kv_heads * cfg.resolved_head_dim
    pre_bound = flops / hw.peak_flops
    dec_bound = wbytes / hw.hbm_bw
    print(f"(a) prefill [{smi}]: {B * S / t_prefill:.1f} tok/s, bound "
          f"{B * S / pre_bound:.1f} tok/s ({flops:.4e} FLOP at "
          f"{hw.peak_flops / 1e12:.0f} TFLOP/s, "
          f"repro_torch.roofline.analysis.prefill_flops: "
          f"{pre_bound * 1e3:.1f} ms), so {pre_bound / t_prefill:.1%} of it")
    print(f"(a) decode [{smi}]: median {t_step * 1e3:.3f} ms per step "
          f"(min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}, "
          f"{len(steps)} steps), bound {dec_bound * 1e3:.3f} "
          f"ms (every weight but the embedding, {wbytes / 1e9:.2f} GB at "
          f"{hw.hbm_bw / 1e12} TB/s), so {dec_bound / t_step:.1%} of it; "
          f"with the bf16 KV cache read once ({kv_bytes / 1e9:.2f} GB at "
          f"the last step) {(wbytes + kv_bytes) / hw.hbm_bw * 1e3:.3f} ms")
    print(f"(a) peak memory [{smi}]: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated)")
    del res
    gen = torch.Generator(dev).manual_seed(LM_SEED + 1)

    # (c) decode against the full forward, f32 compute on the bf16 weights
    with lm_variant(model, cdt=torch.float32):
        decode_vs_forward(torch, model, gen, DECODE_B, DECODE_S,
                          f"(c) {cfg.name} f32 compute, bf16 weights")

    # (c) the score products on the tensor cores against the f32 ones
    score_products_on_card(torch, dev, S + n_new)

    # (b) the continuous batcher on the same model
    rng = np.random.default_rng(LM_SEED)
    lo, hi = BATCHER_PROMPTS
    cb = ContinuousBatcher(model, batch_slots=BATCHER_SLOTS,
                           capacity=hi + BATCHER_NEW[1])
    rec = collections.defaultdict(list)
    prefill_one, decode = cb._prefill_one, cb._decode
    admitted = []

    def record_prefill(t):
        cache, logits = prefill_one(t)
        rec[admitted.pop(0)].append(logits[0].clone())
        return cache, logits

    def record_decode(cache, toks_, pos):
        cache, logits = decode(cache, toks_, pos)
        for slot, req in cb.active.items():
            rec[req.rid].append(logits[slot].clone())
        return cache, logits
    cb._prefill_one, cb._decode = record_prefill, record_decode
    reqs = [cb.submit(rng.integers(0, cfg.vocab_size,
                                   int(rng.integers(lo, hi + 1))),
                      int(rng.integers(BATCHER_NEW[0], BATCHER_NEW[1] + 1)))
            for _ in range(BATCHER_REQUESTS)]
    admitted.extend(r.rid for r in reqs)
    t0 = time.perf_counter()
    finished = cb.run_until_drained()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = cb.stats()
    check(len(finished) == BATCHER_REQUESTS and st["queued"] == 0
          and st["active"] == 0, "batcher drained every request")
    check(all(len(r.out_tokens) == r.max_new for r in finished),
          "each request got its tokens")
    n_out = sum(len(r.out_tokens) for r in finished)
    print(f"(b) ContinuousBatcher [{smi}]: {BATCHER_SLOTS} slots, "
          f"{BATCHER_REQUESTS} requests, prompts "
          f"{sorted(len(r.prompt) for r in reqs)}, new tokens "
          f"{[r.max_new for r in reqs]}: {st['steps']} steps, "
          f"{wall:.2f} s, {n_out / wall:.1f} tok/s, mean TTFT "
          f"{st['mean_ttft_s'] * 1e3:.1f} ms (all submitted at once)")
    batcher_vs_sequential(torch, np, model, cb, rec, reqs, smi)
    del model, cb, rec
    torch.cuda.empty_cache()

    # (c) the card against the CPU, llama3-8b's widths in 2 layers, f32
    c2 = dataclasses.replace(
        get_config("llama3-8b"), num_layers=CARD_CPU_LAYERS,
        param_dtype="float32", compute_dtype="float32")
    card = build_model(c2, device=dev).init(
        torch.Generator(dev).manual_seed(LM_SEED))
    cpu = build_model(c2, device="cpu")
    cpu.load_state_dict(card.state_dict())
    toks = torch.randint(0, c2.vocab_size, (1, CARD_CPU_S),
                         generator=torch.Generator().manual_seed(LM_SEED))
    with torch.inference_mode():
        want, _ = cpu.forward(toks)
        got, _ = card.forward(toks.to(dev))
    ratio = float((got.cpu() - want).abs().max()) / float(want.abs().max())
    c_cpu, lg_cpu = cpu.prefill(toks[:, :-1], capacity=CARD_CPU_S)
    c_card, lg_card = card.prefill(toks[:, :-1].to(dev),
                                   capacity=CARD_CPU_S)
    _, d_cpu = cpu.decode_step(c_cpu, toks[:, -1:], CARD_CPU_S - 1)
    _, d_card = card.decode_step(c_card, toks[:, -1:].to(dev),
                                 CARD_CPU_S - 1)
    ratio_d = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                  for a, b in ((lg_card, lg_cpu), (d_card, d_cpu)))
    print(f"(c) card against CPU: {c2.name} widths, {c2.num_layers} layers, "
          f"f32 (matmul precision "
          f"{torch.get_float32_matmul_precision()}), S {CARD_CPU_S}: "
          f"forward max abs err {ratio:.2e} x max|logit|, prefill and "
          f"decode {ratio_d:.2e} (limit {CARD_CPU_TOL})")
    check(max(ratio, ratio_d) <= CARD_CPU_TOL, "card against CPU")
    del card, cpu, c_cpu, c_card
    torch.cuda.empty_cache()

    # (c) mamba2-1.3b at full width and depth, mixtral-8x7b in 2 layers,
    # each through launch.serve.serve (prefill and OTHER_DECODE steps)
    mixcfg = dataclasses.replace(
        get_config("mixtral-8x7b"), num_layers=MIXTRAL_LAYERS,
        param_dtype="bfloat16")
    for ocfg, B_, S_ in ((get_config("mamba2-1.3b"), MAMBA_B, MAMBA_S),
                         (mixcfg, MIXTRAL_B, MIXTRAL_S)):
        om = build_model(ocfg, device=dev).init(
            torch.Generator(dev).manual_seed(LM_SEED))
        g = torch.Generator(dev).manual_seed(LM_SEED + 1)
        what = f"(c) {ocfg.name} ({ocfg.num_layers} layers, d " \
               f"{ocfg.d_model}, {ocfg.param_dtype} weights)"
        prompts = torch.randint(0, ocfg.vocab_size, (B_, S_), generator=g,
                                device=dev)
        res = serve_cli.serve(om, prompts, OTHER_DECODE + 1)
        served(torch, om, res, what)
        print(f"{what}: prefill B {B_} x S {S_} "
              f"{res['prefill_s'] * 1e3:.1f} ms "
              f"({B_ * S_ / res['prefill_s']:.0f} tok/s); decode median "
              f"{statistics.median(res['step_s']) * 1e3:.3f} ms per step "
              f"over {OTHER_DECODE} steps")
        dcfg = ocfg
        if ocfg.moe is not None:
            dcfg = dataclasses.replace(ocfg, moe=dataclasses.replace(
                ocfg.moe, capacity_factor=100.0))
        # mamba: the prefill runs S_ / 256 chunks, the forward one of S_ + 1
        s_dec = S_ if ocfg.ssm is not None else S_ - 1
        with lm_variant(om, cfg=dcfg, cdt=torch.float32):
            decode_vs_forward(torch, om, g, B_, s_dec, what + " f32 compute")
        del om, res
        torch.cuda.empty_cache()

    # (c) every architecture at its smoke config on the card
    arch_smoke_on_card(torch, np, dev)
    launches = {k: c.value for k, c in counters.items()}
    print(f"phase 9 kernel launches: {launches} (the LM path calls none of "
          f"the ported kernels: attention is the reference's plain "
          f"einsum and softmax)")
    check(not any(launches.values()),
          "phase 9 launches none of the ported kernels")
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")


# phase 10: training.  (a) the training CLI, python -m
# repro_torch.launch.train with TRAIN_ARGV: minicpm-2b at its published
# widths and depth, f32 master weights and bf16 compute from seed
# TRAIN_SEED, batch 4 x 2048, 10 steps of which the CLI's WARMUP_STEPS (2)
# are left out of the timing, no checkpoint; (b) one train step on the
# card against the CPU; (c) the CLI with examples/train_lm.py's arguments
# (CKPT_ARGV) and checkpoints on the card
TRAIN_SEED = 0
TRAIN_ARGV = ["--arch", "minicpm-2b", "--preset", "full", "--batch", "4",
              "--seq", "2048", "--steps", "10", "--ckpt-every", "0",
              "--seed", str(TRAIN_SEED)]
# peak device memory allowed in (a); past it the batch would have to halve
TRAIN_PEAK_BYTES = 72e9
# (b) minicpm-2b's widths cut to TRAIN_CPU_LAYERS layers, f32 compute on
# both, one step (step 1, past the schedule's warm-up) on a batch of
# TRAIN_CPU_B x TRAIN_CPU_S: loss and grad norm within TRAIN_TOL
# relative, every grad within TRAIN_TOL of its leaf's largest; then the
# optimiser on the card fed the CPU's grads, its updated parameters within
# TRAIN_TOL of the largest update beyond one ulp of the parameter (held
# on shared grads: AdamW's first update is about lr * g / (|g| + eps),
# which flips or swings where g is near 0, so grads that differ in their
# last bits move it far; and each f32 parameter rounds p - lr u to within
# half an ulp of p, so two equal updates may leave parameters one ulp
# apart)
TRAIN_CPU_LAYERS, TRAIN_CPU_B, TRAIN_CPU_S, TRAIN_TOL = 2, 1, 64, 1e-4
TRAIN_LR = 1e-3
# (b) the long-row paths at minicpm-2b's widths, f32, card against CPU
# within TRAIN_TOL of each output's largest: gqa_attention under grad over
# REMAT_Q_BLOCKS query blocks of REMAT_Q_BLOCK rows (each block
# checkpointed), and blocked_cross_entropy over REMAT_CE_CHUNKS chunks of
# trainstep.CE_CHUNK positions (each chunk checkpointed) against a head of
# REMAT_VOCAB columns
REMAT_Q_BLOCK, REMAT_Q_BLOCKS, REMAT_CE_CHUNKS, REMAT_VOCAB = 128, 4, 3, 8192
# (c) examples/train_lm.py: a checkpoint every 50 steps, a failure at 120
CKPT_ARGV = ["--arch", "llama3-8b", "--preset", "100m", "--steps", "200",
             "--batch", "2", "--seq", "128", "--ckpt-every", "50",
             "--fail-at", "120", "--ckpt-chunking", "cdc-gear", "--seed",
             str(TRAIN_SEED)]


def _argv_int(argv, flag: str) -> int:
    return int(argv[argv.index(flag) + 1])


class _GradRecorder:
    """An optimiser that keeps a stacked copy of the grads it is given."""

    def __init__(self, opt):
        self.opt, self.lr_fn = opt, opt.lr_fn

    def update(self, grads, state, params, step):
        from repro_torch.models import stacked
        self.grads = stacked.stack(grads)
        return self.opt.update(grads, state, params, step)


def step_against(torch, cfg, a, b, batches, what: str, label: str):
    """One train step (step 1) of model ``a`` and of model ``b``, the one
    held right, from the same weights; ``batches`` is (a's, b's), the
    same batch.  Loss and grad norm within TRAIN_TOL relative, every grad
    within TRAIN_TOL of its leaf's largest.  Then, from the same weights,
    ``a``'s optimiser fed ``b``'s grads: its updated parameters within
    one ulp plus TRAIN_TOL of ``b``'s step's largest update of ``b``'s.
    Grads and parameters are compared whole (a DTensor gathered) on
    ``b``'s device.  Returns the worst ratios, and each model's
    (optimiser, params, state, step function) after its step."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import stacked
    from repro_torch.models.model import param_tree
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train.trainstep import make_train_step

    def near(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).to(
            b.device)

    def optimizer():
        return _GradRecorder(make_optimizer(
            cfg.optimizer, make_schedule(cfg.lr_schedule, TRAIN_LR, 100)))
    start = stacked.map_leaves(lambda t: near(t).clone(),
                               stacked.stack(param_tree(b)))
    runs, res = [], []
    for m, batch in zip((a, b), batches):
        rec = optimizer()
        params = param_tree(m)
        state = rec.opt.init(params)
        step = make_train_step(m, rec)
        _, _, met = step(params, state, batch, 1)
        runs.append((rec, params, state, step))
        res.append(({k: float(v) for k, v in met.items()},
                    stacked.map_leaves(near, rec.grads)))
    (m_a, g_a), (m_b, g_b) = res
    rel = {k: abs(m_a[k] - m_b[k]) / max(abs(m_b[k]), 1e-30)
           for k in ("loss", "grad_norm")}
    g_worst = max(float((stacked.get(g_a, path) - g).abs().max())
                  / max(float(g.abs().max()), 1e-30)
                  for path, g in stacked.leaves(g_b))
    # a's optimiser on b's grads, from the starting weights
    want = dict(stacked.leaves(stacked.map_leaves(
        near, stacked.stack(runs[1][1]))))
    u_scale = max(float((w - stacked.get(start, path)).abs().max())
                  for path, w in want.items())
    params = runs[0][1]
    stacked.copy_into(params, start)
    rec = optimizer()
    rec.update(stacked.like(params, g_b), rec.opt.init(params), params, 1)
    u_worst = 0.0
    for path, got in stacked.leaves(stacked.stack(params)):
        got, ref = near(got), want[path]
        top = torch.maximum(got.abs(), ref.abs())
        ulp = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        excess = ((got - ref).abs() - ulp).clamp(min=0)
        u_worst = max(u_worst, float(excess.max()) / u_scale)
    B, S = batches[1]["tokens"].shape
    print(f"{what}: {label}, one train step (B {B}, S {S}): loss "
          f"{m_a['loss']:.6f} / {m_b['loss']:.6f} (rel {rel['loss']:.2e}),"
          f" grad_norm rel {rel['grad_norm']:.2e}, grads {g_worst:.2e} of "
          f"each leaf's largest; {cfg.optimizer} on the same grads: "
          f"parameters apart by {u_worst:.2e} of the largest update "
          f"{u_scale:.3e} beyond one ulp (limit {TRAIN_TOL})")
    check(max(rel.values()) <= TRAIN_TOL,
          f"{what}: loss and grad norm, {label}")
    check(g_worst <= TRAIN_TOL, f"{what}: grads, {label}")
    check(u_worst <= TRAIN_TOL, f"{what}: updates, {label}")
    check(all(math.isfinite(v) for v in m_a.values()),
          f"{what}: finite metrics")
    return (max(rel.values()), g_worst, u_worst), runs


def train_card_vs_cpu(torch, cfg, dev, B: int, S: int, what: str):
    """``step_against``: the card's step held against the CPU's.  Returns
    the worst ratios."""
    from repro_torch.data import make_pipeline
    from repro_torch.models.model import build_model
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(TRAIN_SEED))
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    batch = make_pipeline(cfg, S, B, seed=TRAIN_SEED).batch(0)
    worst, _ = step_against(torch, cfg, card, cpu, (batch, batch), what,
                            "card against CPU")
    return worst


def remat_card_vs_cpu(torch, cfg, dev, what: str):
    """gqa_attention across query blocks and blocked_cross_entropy
    across chunks, under grad, on the card and on the CPU from the same
    inputs: every output and grad within TRAIN_TOL of its largest."""
    from repro_torch.models.layers import gqa_attention
    from repro_torch.train.trainstep import CE_CHUNK, blocked_cross_entropy
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    S, Sc = REMAT_Q_BLOCK * REMAT_Q_BLOCKS, CE_CHUNK * REMAT_CE_CHUNKS
    H, K, hd, d = (cfg.num_heads, cfg.kv_heads, cfg.resolved_head_dim,
                   cfg.d_model)
    q, w = (torch.randn(1, S, H, hd, generator=gen) for _ in range(2))
    k, v = (torch.randn(1, S, K, hd, generator=gen) for _ in range(2))
    x = torch.randn(1, Sc, d, generator=gen)
    head = torch.randn(d, REMAT_VOCAB, generator=gen) * d ** -0.5
    labels = torch.randint(0, REMAT_VOCAB, (1, Sc), generator=gen)
    names = ("attention", "CE sum", "dq", "dk", "dv", "dx", "dhead")

    def run(device):
        ins = [t.to(device).requires_grad_() for t in (q, k, v, x, head)]
        pos = torch.arange(S, device=device)
        att = gqa_attention(*ins[:3], pos, pos, q_block=REMAT_Q_BLOCK)
        tot, cnt = blocked_cross_entropy(
            ins[3], ins[4], labels.to(device),
            torch.ones(1, Sc, device=device), cfg.logit_scale)
        grads = torch.autograd.grad((att * w.to(device)).sum() + tot / cnt,
                                    ins)
        return [t.detach().cpu() for t in (att, tot, *grads)]
    errs = {n: float((a - b).abs().max()) / float(b.abs().max())
            for n, a, b in zip(names, run(dev), run(torch.device("cpu")))}
    print(f"{what}: gqa_attention over {REMAT_Q_BLOCKS} query blocks of "
          f"{REMAT_Q_BLOCK} ({H}/{K} heads of {hd}) and blocked CE over "
          f"{REMAT_CE_CHUNKS} chunks of {CE_CHUNK} (d {d}, vocab "
          f"{REMAT_VOCAB}), each checkpointed, card against CPU: "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" of each one's largest (limit {TRAIN_TOL})")
    check(max(errs.values()) <= TRAIN_TOL,
          f"{what}: checkpointed query blocks and CE chunks on the card "
          f"== CPU")


def phase_train(torch, np, smi: str):
    """Phase 10: the training path on the card."""
    from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
    from repro_torch.core import CrystalGPU, SAI, SAIConfig
    from repro_torch.kernels import flash_attn, gear, md5, sliding_md5
    from repro_torch.launch import train as train_cli
    from repro_torch.roofline.analysis import HW, train_step_flops
    from repro_torch.train import checkpoint as ckpt_lib
    print("== phase 10: training (minicpm-2b at full width and depth, "
          "card against CPU, checkpoints and a restart on the card)")
    t_phase = time.perf_counter()
    counters = {"md5": md5.LAUNCHES, "md5_spans": md5.SPAN_LAUNCHES,
                "sliding_md5": sliding_md5.LAUNCHES,
                "gear": gear.LAUNCHES, "flash_attn": flash_attn.LAUNCHES,
                "flash_tf32_split": flash_attn.SPLIT_LAUNCHES}
    for c in counters.values():
        c.reset()
    hw = HW()

    # (a) the training CLI: minicpm-2b at full width and depth
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    print(f"(a) python -m repro_torch.launch.train {' '.join(TRAIN_ARGV)}")
    out = train_cli.main(TRAIN_ARGV)
    model, cfg = out["model"], out["cfg"]
    dev = model.device
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"(a) {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, tied {cfg.tie_embeddings}: {n_params} "
          f"parameters ({cfg.param_dtype} master, {cfg.compute_dtype} "
          f"compute, {cfg.optimizer}, {cfg.lr_schedule}, remat "
          f"{model.remat_policy}) on {model.device}; built, initialised "
          f"and trained in {time.perf_counter() - t0:.1f} s")
    B, S = _argv_int(TRAIN_ARGV, "--batch"), _argv_int(TRAIN_ARGV, "--seq")
    warmup = train_cli.WARMUP_STEPS
    steps = out["step_s"][warmup:]
    cpu_s = out["host_cpu_s"][warmup:]
    t_step = statistics.median(steps)
    flops = train_step_flops(cfg, B, S,
                             remat=model.remat_policy == "nothing_saveable")
    bound = flops / hw.peak_flops
    print(f"(a) train step [{smi}]: median {t_step * 1e3:.3f} ms (min "
          f"{min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}, {len(steps)} "
          f"steps after {warmup} warm-up, "
          f"{'CUDA events' if dev.type == 'cuda' else 'host clock'}), bound "
          f"{bound * 1e3:.1f} ms ({flops:.4e} FLOP at "
          f"{hw.peak_flops / 1e12:.0f} TFLOP/s, "
          f"repro_torch.roofline.analysis.train_step_flops), so "
          f"{bound / t_step:.1%} of it; {B * S / t_step:.1f} tok/s; this "
          f"thread on the CPU {statistics.median(cpu_s) * 1e3:.3f} ms a step "
          f"(median), {sum(cpu_s) / sum(steps):.1%} of the steps' time")
    print(f"(a) peak memory [{smi}]: {peak / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated; limit "
          f"{TRAIN_PEAK_BYTES / 1e9:.0f} GB)")
    for i, (loss, gn) in enumerate(zip(out["losses"], out["grad_norms"])):
        print(f"(a) step {i}: loss {loss:.5f}, grad_norm {gn:.5f}, "
              f"{out['step_s'][i] * 1e3:.3f} ms")
    check(all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]),
          "(a) finite loss and grad norm at every step")
    check(out["losses"][-1] < out["losses"][0], "(a) the loss fell")
    moved = [float((p.detach() - 1.0).abs().max())
             for p in [model.final_norm] + [b["pos0"]["norm1"]
                                            for b in model.blocks]]
    check(min(moved) > 0.0, "(a) every norm scale moved from its init")
    check(peak <= TRAIN_PEAK_BYTES, "(a) peak memory within the limit")
    launches = {k: c.value for k, c in counters.items()}
    check(not any(launches.values()),
          "(a) training launches none of the ported kernels")
    del out, model
    torch.cuda.empty_cache()

    # (b) the card against the CPU: minicpm-2b's widths in 2 layers, f32;
    # then every smoke config
    c2 = dataclasses.replace(get_config("minicpm-2b"),
                             num_layers=TRAIN_CPU_LAYERS,
                             param_dtype="float32", compute_dtype="float32")
    train_card_vs_cpu(torch, c2, dev, TRAIN_CPU_B, TRAIN_CPU_S,
                      f"(b) {c2.name} widths, {c2.num_layers} layers, f32")
    remat_card_vs_cpu(torch, c2, dev, f"(b) {c2.name} widths, f32")
    worst = [0.0, 0.0, 0.0]
    for arch in ARCH_NAMES:
        r = train_card_vs_cpu(torch, get_smoke_config(arch), dev, 2, 64,
                              f"(b) {arch} smoke")
        worst = [max(a, b) for a, b in zip(worst, r)]
    print(f"(b) every smoke config: loss/grad_norm {worst[0]:.2e}, grads "
          f"{worst[1]:.2e}, updates {worst[2]:.2e} (limit {TRAIN_TOL})")
    launches = {k: c.value for k, c in counters.items()}
    check(not any(launches.values()),
          "(b) training launches none of the ported kernels")
    torch.cuda.empty_cache()

    # (c) the example's checkpoint run through CrystalGPU on the card
    saved = []

    class Recording(ckpt_lib.CACheckpointer):
        """Keeps a host copy of every state it saves."""

        def save(self, step, params, opt_state=None, extra=None):
            saved.append((step, ckpt_lib.host_copy(
                {"params": params, "opt": opt_state})))
            return super().save(step, params, opt_state, extra)

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    print(f"(c) python -m repro_torch.launch.train {' '.join(CKPT_ARGV)}")
    real = train_cli.CACheckpointer
    train_cli.CACheckpointer = Recording
    try:
        out = train_cli.main(CKPT_ARGV)
    finally:
        train_cli.CACheckpointer = real
    sup, ckpt = out["supervisor"], out["checkpointer"]
    total = _argv_int(CKPT_ARGV, "--steps")
    every = _argv_int(CKPT_ARGV, "--ckpt-every")
    fail = _argv_int(CKPT_ARGV, "--fail-at")
    last = fail // every * every
    steps = [r["step"] for r in sup.log]
    losses = [r["loss"] for r in sup.log]
    print(f"(c) {out['cfg'].name} {out['cfg'].param_count() / 1e6:.1f}M "
          f"parameters: {len(steps)} steps in {out['wall_s']:.1f} s, "
          f"restarts {sup.restarts}, first loss {losses[0]:.4f}, last "
          f"{losses[-1]:.4f}")
    check(sup.restarts == 1, "(c) exactly one restart")
    check(all(steps.count(i) == 2 for i in range(last, fail))
          and steps.count(fail) == 1 and steps[-1] == total - 1
          and len(steps) == total + fail - last,
          f"(c) steps {last}..{fail - 1} re-run from the checkpoint at "
          f"{last}, then on to {total - 1}")
    check(losses[-1] < losses[0], "(c) the loss fell")
    check(len(ckpt.history) >= 3 and len(saved) == len(ckpt.history),
          "(c) at least three checkpoints")
    for r in ckpt.history:
        print(f"(c) checkpoint step {r['step']} [{smi}]: "
              f"{r['total_bytes'] / 1e6:.1f} MB, new "
              f"{r['new_bytes'] / 1e6:.1f} MB, dedup {r['dedup_ratio']:.4f}, "
              f"save {r['total_bytes'] / r['wall_s'] / 1e6:.1f} MB/s")
    eng = CrystalGPU(devices=[dev])
    try:
        reader = ckpt_lib.CACheckpointer(SAI(out["store"], SAIConfig(
            ca="cdc-gear", hasher="gpu"), crystal=eng))
        for v, (want_step, want) in enumerate(saved):
            t0 = time.perf_counter()
            step, state, _ = reader.restore(version=v)
            dt = time.perf_counter() - t0
            got_l, want_l = [], []
            ckpt_lib._walk(state, (), got_l)
            ckpt_lib._walk(want, (), want_l)
            nbytes = sum(t.numel() * t.element_size() for _, t in want_l)
            check(step == want_step and [k for k, _ in got_l]
                  == [k for k, _ in want_l] and all(
                      torch.equal(a, b) for (_, a), (_, b)
                      in zip(got_l, want_l)),
                  f"(c) checkpoint {v} (step {want_step}) restores tensor "
                  f"for tensor")
            print(f"(c) restore of checkpoint {v} (step {step}) [{smi}]: "
                  f"{len(got_l)} tensors, {nbytes / 1e6:.1f} MB, "
                  f"{nbytes / dt / 1e6:.1f} MB/s verified, every tensor equal")
    finally:
        eng.shutdown()
    launches = {k: c.value for k, c in counters.items()}
    print(f"phase 10 (c) kernel launches: {launches}")
    check(launches["gear"] > 0 and launches["md5_spans"] > 0
          and launches["md5"] > 0,
          "(c) gear, md5's spans entry (saves) and md5_direct (verified "
          "restores) launched by the checkpoints")
    del out, saved
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")


# phase 11: the distributed slice on one card.  NCCL puts one rank on a
# card, so the mesh is (1, 1) ('data', 'model') over one process; (a) a
# DTensor train step (make_shard_ctx) against the plain step from the same
# weights and batch, minicpm-2b's widths in TRAIN_CPU_LAYERS layers, f32,
# as phase 10 (b), within phase 10 (b)'s tolerances, and both steps'
# times: CUDA events, median of DIST_TIMED steps after one warm-up;
# (b) int8 cross-pod sync: quantize_int8 on the card == the CPU bit for
# bit, and make_cross_pod_sync on a (1, 1, 1) ('pod', 'data', 'model')
# mesh over 20 steps of the reference test's data within 0.05.  The batch
# is DIST_B x DIST_S, sharded over 'data': phase 10 (b)'s smoke batch (a
# batch of 1 is the reference's unsharded case)
DIST_B, DIST_S, DIST_TIMED = 2, 64, 5
SYNC_STEPS, SYNC_TOL = 20, 0.05


def dist_step_vs_plain(torch, cfg, ctx, dev, B: int, S: int, smi: str):
    """(a) ``step_against``: the sharded model's step held against the
    plain one's from the same weights and batch.  Then DIST_TIMED more
    steps of each, timed."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.data import make_pipeline
    from repro_torch.models import stacked
    from repro_torch.models.model import build_model, param_tree
    plain = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(TRAIN_SEED))
    sharded = build_model(cfg, device=dev, ctx=ctx)
    stacked.copy_into(param_tree(sharded), stacked.stack(param_tree(plain)))
    check(all(isinstance(t, DTensor) for t in sharded.parameters()),
          "(a) every parameter of the sharded model is a DTensor")
    tokens = torch.as_tensor(make_pipeline(cfg, S, B, seed=TRAIN_SEED)
                             .batch(0)["tokens"]).to(dev)
    batches = ({"tokens": distribute_tensor(tokens, ctx.mesh,
                                            [Shard(0), Replicate()])},
               {"tokens": tokens})
    _, runs = step_against(
        torch, cfg, sharded, plain, batches,
        f"(a) {cfg.name} widths, {cfg.num_layers} layers, f32",
        "sharded step (DTensor on the (1, 1) mesh) against the plain step "
        "on the card")
    times = {}
    for name, (_, params, state, step), batch in zip(
            ("sharded", "plain"), runs, batches):
        ms = []
        for i in range(DIST_TIMED + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step(params, state, batch, 2 + i)
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        times[name] = statistics.median(ms[1:])
    print(f"(a) train step [{smi}]: plain {times['plain']:.3f} ms, sharded "
          f"{times['sharded']:.3f} ms (median of {DIST_TIMED} after a "
          f"warm-up, CUDA events), so DTensor costs "
          f"{times['sharded'] - times['plain']:.3f} ms a step on one card")


def phase_dist(torch, np, smi: str):
    """Phase 11: the distributed slice on one card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn, gear, md5, sliding_md5
    from repro_torch.launch.mesh import make_shard_ctx
    from repro_torch.models.sharding import P
    from repro_torch.optim.grad_compress import (init_error_state,
                                                 make_cross_pod_sync,
                                                 quantize_int8)
    print("== phase 11: distributed slice (DTensor train step and int8 "
          "cross-pod sync on a one-card NCCL mesh)")
    t_phase = time.perf_counter()
    counters = {"md5": md5.LAUNCHES, "md5_spans": md5.SPAN_LAUNCHES,
                "sliding_md5": sliding_md5.LAUNCHES,
                "gear": gear.LAUNCHES, "flash_attn": flash_attn.LAUNCHES,
                "flash_tf32_split": flash_attn.SPLIT_LAUNCHES}
    for c in counters.values():
        c.reset()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            ctx = make_shard_ctx(mesh)
            c2 = dataclasses.replace(get_config("minicpm-2b"),
                                     num_layers=TRAIN_CPU_LAYERS,
                                     param_dtype="float32",
                                     compute_dtype="float32")
            dist_step_vs_plain(torch, c2, ctx, dev, DIST_B, DIST_S, smi)
            torch.cuda.empty_cache()

            # (b) quantisation on the card == the CPU, bit for bit
            rng = np.random.default_rng(0)
            for shape, s in (((8, 16), 1.0), ((2304, 5760), 1e-3),
                             ((4096,), 1e4)):
                g = (rng.standard_normal(shape) * s).astype(np.float32)
                q_card, s_card = quantize_int8(torch.from_numpy(g).to(dev))
                q_cpu, s_cpu = quantize_int8(torch.from_numpy(g))
                check(torch.equal(q_card.cpu(), q_cpu)
                      and torch.equal(s_card.cpu().view(torch.int32),
                                      s_cpu.view(torch.int32)),
                      f"(b) quantize_int8 {shape} on the card == CPU bit "
                      f"for bit")
            print("(b) quantize_int8 on the card == the CPU bit for bit at "
                  "(8, 16), (2304, 5760) and (4096,)")
            pods = init_device_mesh("cuda", (1, 1, 1),
                                    mesh_dim_names=("pod", "data", "model"))
            sync = make_cross_pod_sync(pods, {"w": P(None, None)})
            rng = np.random.default_rng(0)
            accum_true = np.zeros((8, 16), np.float32)
            accum_q = np.zeros((8, 16), np.float32)
            err = init_error_state({"w": torch.zeros(8, 16, device=dev)})
            for _ in range(SYNC_STEPS):
                g = rng.standard_normal((8, 16)).astype(np.float32)
                out, err = sync({"w": torch.from_numpy(g).to(dev)}, err)
                accum_true += g
                accum_q += out["w"].cpu().numpy()
            rel = float(np.abs(accum_q - accum_true).max()
                        / np.abs(accum_true).max())
            print(f"(b) make_cross_pod_sync on the (1, 1, 1) mesh, "
                  f"{SYNC_STEPS} steps: relative error {rel:.4e} "
                  f"(limit {SYNC_TOL})")
            check(rel < SYNC_TOL, "(b) cross-pod sync within its bound")
        finally:
            dist.destroy_process_group()
    launches = {k: c.value for k, c in counters.items()}
    check(not any(launches.values()),
          "phase 11 launches none of the ported kernels")
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


# (a) the dry-run CLI's cells, run as subprocesses beside (b)-(d)
DRYRUN_CELLS = (("llama3-8b", "train_4k", "single"),
                ("llama3-8b", "train_4k", "multi"))
DRYRUN_TIMEOUT_S = 600
# the placeholder tensors' device in (a) and (b) (a CPU rehearsal sets cpu)
DRYRUN_DEVICE = "cuda"
CARD_BYTES = 80e9
# (b) phase 10 (a)'s step (TRAIN_ARGV: minicpm-2b, 4 x 2048, f32 master,
# bf16 compute, remat) captured on a (1, 1) mesh and run for real; the
# captured FLOPs within FLOPS_TOL of FlopCounterMode on the real step, the
# predicted peak (the capture's arguments plus MemTracker's temporaries)
# within PEAK_TOL of torch.cuda.max_memory_allocated (PERF.md, PR 22)
FLOPS_TOL, PEAK_TOL = 1e-3, 0.25
# (c) minicpm-2b's widths in REMAT_LAYERS layers, REMAT_B x REMAT_S
REMAT_LAYERS, REMAT_B, REMAT_S = 2, 4, 2048
REMAT_RUNS = ("nothing_saveable", "everything_saveable", "dots_saveable",
              "dots_with_no_batch_dims_saveable")
REMAT_TOL = 1e-6
# (d) SERVE_B prompts of SERVE_S tokens, SERVE_N decode steps, the
# sharded model against the plain one: in f32 compute the logits within
# SERVE_TOL_F32 of the largest and the greedy tokens equal; llama3-8b also
# in bf16 compute (the tensor cores' score products, C17), the logits
# within SERVE_TOL_BF16 (a few bf16 ulps, u = 2**-8: the two paths round
# the attention's probabilities apart) and the tokens equal wherever the
# plain step's top-two margin exceeds twice that bound (random weights
# leave near-ties that one ulp flips)
SERVE_B, SERVE_S, SERVE_N = 2, 512, 16
SERVE_TOL_F32, SERVE_TOL_BF16 = 1e-5, 2 ** -6

CAPTURE_CODE = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
B, S = int(sys.argv[1]), int(sys.argv[2])
rec = dryrun.run_cell("minicpm-2b", ShapeSpec(f"train_{S}", S, B, "train"),
                      "single", dp=1, tp=1, device=sys.argv[3])
print(json.dumps(rec))
"""


def _dryrun_procs():
    """Start the dry-run CLI on DRYRUN_CELLS and the capture of (b), each
    a subprocess with its own time limit; returns {name: (Popen, t0)}."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        path = os.path.join(ROOT, "results", "torch", "dryrun",
                            f"{arch}__{shape}__{mesh}.json")
        if os.path.exists(path):
            os.remove(path)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--device",
               DRYRUN_DEVICE]
        procs[mesh] = (subprocess.Popen(cmd, cwd=ROOT, env=env,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       time.perf_counter(), " ".join(cmd[1:]))
    B, S = _argv_int(TRAIN_ARGV, "--batch"), _argv_int(TRAIN_ARGV, "--seq")
    procs["capture"] = (subprocess.Popen(
        [sys.executable, "-c", CAPTURE_CODE, str(B), str(S),
         DRYRUN_DEVICE], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        time.perf_counter(), "dryrun.run_cell(minicpm-2b, (1, 1))")
    return procs


def _finish(proc, t0, what: str) -> str:
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"{what} exits 0 ({err[-2000:]})")
    print(f"(a/b) {what}: {time.perf_counter() - t0:.1f} s")
    return out


def remat_policies_on_card(torch, dev, smi: str):
    """(c) one forward and backward under each remat policy from the same
    weights and batch: step ms and peak memory each, loss and grads
    against ``nothing_saveable``'s."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models.model import build_model
    from repro_torch.train.trainstep import make_loss_fn
    cfg = dataclasses.replace(get_config("minicpm-2b"),
                              num_layers=REMAT_LAYERS)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in make_pipeline(
        cfg, REMAT_S, REMAT_B, seed=TRAIN_SEED).batch(0).items()}
    base = None
    for policy in REMAT_RUNS:
        model = build_model(cfg, device=dev, remat_policy=policy).init(
            torch.Generator(dev).manual_seed(TRAIN_SEED))
        prms = list(model.parameters())
        loss_fn = make_loss_fn(model)
        ms = []
        for i in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss, _ = loss_fn(batch)
            grads = torch.autograd.grad(loss, prms)
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        peak = torch.cuda.max_memory_allocated()
        loss = float(loss.detach())
        if base is None:
            base = (loss, grads)
            rel, g_err, same = 0.0, 0.0, True
        else:
            rel = abs(loss - base[0]) / abs(base[0])
            g_err = max(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(grads, base[1]))
            same = loss == base[0] and all(torch.equal(a, b) for a, b in
                                           zip(grads, base[1]))
        print(f"(c) {policy} [{smi}]: step {ms[-1]:.1f} ms (forward and "
              f"backward, the second of two), peak {peak / 1e9:.2f} GB; "
              f"loss {loss:.6f} (rel {rel:.1e}), grads {g_err:.1e} of each "
              f"leaf's largest against nothing_saveable "
              f"({'bit for bit' if same else 'not bit for bit'}, limit "
              f"{REMAT_TOL})")
        check(rel <= REMAT_TOL and g_err <= REMAT_TOL,
              f"(c) {policy}: loss and grads equal nothing_saveable's")
        del model, grads, prms
        torch.cuda.empty_cache()


def serving_sharded_vs_plain(torch, cfg, ctx, dev, smi: str):
    """(d) prefill SERVE_B x SERVE_S and SERVE_N decode steps of the plain
    model and of the sharded one from the same weights, each fed the
    plain model's tokens: logits within the compute dtype's bound of the
    plain one's largest, the same greedy tokens (in bf16 where the top-two
    margin allows); decode ms per step of both."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import stacked
    from repro_torch.models.model import build_model, param_tree
    from repro_torch.models.sharding import placements
    f32 = cfg.compute_dtype == "float32"
    tol = SERVE_TOL_F32 if f32 else SERVE_TOL_BF16
    plain = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(LM_SEED))
    sharded = build_model(cfg, device=dev, ctx=ctx)
    stacked.copy_into(param_tree(sharded), stacked.stack(param_tree(plain)))
    mesh = ctx.mesh
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)

    def rows(t):
        return distribute_tensor(t, mesh, [Shard(0), Replicate()])
    errs, tokens = [], [0, 0]                # compared, equal

    def compare(got, want):
        top = float(want.abs().max())
        errs.append(float((got - want).abs().max()) / top)
        two = torch.topk(want, 2, dim=-1).values
        clear = (two[:, 0] - two[:, 1]) > 2 * tol * top
        if f32:
            clear = torch.ones_like(clear)
        same = torch.argmax(got, -1) == torch.argmax(want, -1)
        tokens[0] += int(clear.sum())
        tokens[1] += int((same & clear).sum())
    cap = SERVE_S + SERVE_N
    c1, l1 = plain.prefill(prompt, capacity=cap)
    c2, l2 = sharded.prefill(rows(prompt), capacity=cap)
    specs = sharded.cache_pspecs(SERVE_B)
    check(all(tuple(t.placements) == placements(specs[k][n], mesh)
              for k, layer in c2.items() for n, t in layer.items()),
          f"(d) {cfg.name}: the prefill leaves its cache in cache_pspecs")
    compare(l2.full_tensor(), l1)
    tok = torch.argmax(l1, -1)[:, None]
    times = {"plain": [], "sharded": []}
    for i in range(SERVE_N):
        outs = {}
        for name, model, cache, t in (("plain", plain, c1, tok),
                                      ("sharded", sharded, c2, rows(tok))):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, lg = model.decode_step(cache, t, SERVE_S + i)
            ev[1].record()
            ev[1].synchronize()
            times[name].append(ev[0].elapsed_time(ev[1]))
            outs[name] = lg.full_tensor() if name == "sharded" else lg
        compare(outs["sharded"], outs["plain"])
        tok = torch.argmax(outs["plain"], -1)[:, None]
    med = {k: statistics.median(v[1:]) for k, v in times.items()}
    total = SERVE_B * (SERVE_N + 1)
    print(f"(d) {cfg.name} widths, {cfg.num_layers} layers, "
          f"{cfg.compute_dtype} [{smi}]: prefill {SERVE_B} x {SERVE_S} and "
          f"{SERVE_N} decode steps, sharded against plain: logits "
          f"{max(errs):.2e} of the largest (limit {tol:.2e}); greedy tokens "
          f"equal at {tokens[1]} of {tokens[0]} compared positions "
          f"({total - tokens[0]} within twice the bound of a tie, not "
          f"compared); decode median {med['plain']:.3f} ms plain, "
          f"{med['sharded']:.3f} ms sharded (CUDA events, steps "
          f"2-{SERVE_N})")
    check(max(errs) <= tol, f"(d) {cfg.name}: logits within bound")
    check(tokens[1] == tokens[0] and (not f32 or tokens[0] == total),
          f"(d) {cfg.name}: greedy tokens equal")
    del plain, sharded, c1, c2
    torch.cuda.empty_cache()


def phase_dryrun(torch, np, smi: str):
    """Phase 12: the dry-run slice, the remat policies and sharded serving
    on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import flash_attn, gear, md5, sliding_md5
    from repro_torch.launch.mesh import make_shard_ctx
    from repro_torch.models.model import build_model, param_tree
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.roofline import hlo_analysis
    from repro_torch.roofline.analysis import (HW, load_records,
                                               model_flops,
                                               train_step_flops)
    from repro_torch.train.trainstep import make_train_step
    print("== phase 12: dry-run slice (the dry-run CLI over 256 and 512 "
          "placeholder ranks, the estimator against the card, remat "
          "policies, sharded serving)")
    t_phase = time.perf_counter()
    counters = {"md5": md5.LAUNCHES, "md5_spans": md5.SPAN_LAUNCHES,
                "sliding_md5": sliding_md5.LAUNCHES,
                "gear": gear.LAUNCHES, "flash_attn": flash_attn.LAUNCHES,
                "flash_tf32_split": flash_attn.SPLIT_LAUNCHES}
    for c in counters.values():
        c.reset()
    dev = torch.device("cuda", 0)
    hw = HW()
    procs = _dryrun_procs()

    # (b) phase 10 (a)'s step for real: FLOPs, peak memory, time
    cfg = get_config("minicpm-2b")
    B, S = _argv_int(TRAIN_ARGV, "--batch"), _argv_int(TRAIN_ARGV, "--seq")
    model = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(TRAIN_SEED))
    opt = make_optimizer(cfg.optimizer,
                         make_schedule(cfg.lr_schedule, TRAIN_LR, 100))
    params = param_tree(model)
    state = opt.init(params)
    batch = make_pipeline(cfg, S, B, seed=TRAIN_SEED).batch(0)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with hlo_analysis.flop_counter() as fc:
        step(params, state, batch, 1)
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated()
    real_flops = fc.get_total_flops()
    ms = []
    for i in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step(params, state, batch, 2 + i)
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    step_ms = min(ms)
    del model, params, state, step, opt
    torch.cuda.empty_cache()

    # (c) the remat policies
    remat_policies_on_card(torch, dev, smi)

    # (d) sharded serving on a one-card NCCL mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            ctx = make_shard_ctx(init_device_mesh(
                "cuda", (1, 1), mesh_dim_names=("data", "model")))
            for arch, cdt in (("llama3-8b", "float32"),
                              ("mamba2-1.3b", "float32"),
                              ("llama3-8b", "bfloat16")):
                serving_sharded_vs_plain(torch, dataclasses.replace(
                    get_config(arch), num_layers=2, compute_dtype=cdt),
                    ctx, dev, smi)
        finally:
            dist.destroy_process_group()

    # (b), captured: the same step on a (1, 1) mesh of one fake rank
    rec = json.loads(_finish(*procs["capture"]).strip().splitlines()[-1])
    pred_peak = rec["memory"]["argument_size_in_bytes"] \
        + rec["memory"]["temp_size_in_bytes"]
    flops_err = abs(rec["flops_scaled"] - real_flops) / real_flops
    peak_err = (pred_peak - real_peak) / real_peak
    terms = {"compute": rec["flops_scaled"] / hw.peak_flops,
             "memory": rec["bytes_scaled"] / hw.hbm_bw,
             "collective": rec["collectives"]["total_wire_bytes"]
             / hw.link_bw}
    bound = max(terms, key=terms.get)
    print(f"(b) {cfg.name} {B} x {S}, f32 master, bf16 compute, remat "
          f"[{smi}]: captured flops_scaled {rec['flops_scaled']:.6e}, "
          f"FlopCounterMode on the real step {real_flops:.6e} (apart "
          f"{flops_err:.2e}, limit {FLOPS_TOL}), "
          f"roofline.analysis.train_step_flops "
          f"{train_step_flops(cfg, B, S):.6e}")
    print(f"(b) predicted peak {pred_peak / 1e9:.3f} GB (arguments "
          f"{rec['memory']['argument_size_in_bytes'] / 1e9:.3f} + MemTracker "
          f"temporaries {rec['memory']['temp_size_in_bytes'] / 1e9:.3f}), "
          f"torch.cuda.max_memory_allocated of the real step "
          f"{real_peak / 1e9:.3f} GB: error {peak_err:+.1%} (limit "
          f"{PEAK_TOL:.0%})")
    print(f"(b) roofline step {max(terms.values()) * 1e3:.1f} ms ({bound}-"
          f"bound: compute {terms['compute'] * 1e3:.1f}, memory "
          f"{terms['memory'] * 1e3:.1f}, collective "
          f"{terms['collective'] * 1e3:.1f} ms), measured {step_ms:.1f} ms "
          f"(CUDA events, the faster of two steps), so "
          f"{max(terms.values()) * 1e3 / step_ms:.1%} of it")
    check(flops_err <= FLOPS_TOL, "(b) captured FLOPs equal the real step's")
    check(abs(peak_err) <= PEAK_TOL, "(b) predicted peak within its bound")

    # (a) the dry-run CLI's records
    for mesh in ("single", "multi"):
        _finish(*procs[mesh])
    base = os.path.join(ROOT, "results", "torch")
    recs = load_records(os.path.join(base, "dryrun"))
    keys = {"arch", "shape", "mesh", "zero1", "remat", "kind", "n_devices",
            "seq_len", "global_batch", "lower_s", "compile_s", "memory",
            "cost", "collectives", "flops_scaled", "bytes_scaled",
            "bytes_upper", "top_collectives", "top_bytes", "params",
            "active_params", "hlo_bytes"}
    for arch, shape, mesh in DRYRUN_CELLS:
        r = recs[f"{arch}__{shape}__{mesh}"]
        check(keys <= set(r), f"(a) {mesh}: every key of the reference's "
                              f"record ({sorted(keys - set(r))} missing)")
        m = r["memory"]
        per_dev = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
        useful = model_flops(arch, shape) / r["n_devices"] / r["flops_scaled"]
        wire = ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in
                         sorted(r["collectives"]["wire_bytes"].items()))
        print(f"(a) {arch} {shape} {mesh}, {r['n_devices']} ranks [{smi}]: "
              f"per-device memory {per_dev / 1e9:.2f} GB (arguments "
              f"{m['argument_size_in_bytes'] / 1e9:.2f} + temporaries "
              f"{m['temp_size_in_bytes'] / 1e9:.2f}) against the card's "
              f"{CARD_BYTES / 1e9:.0f} GB; flops_scaled "
              f"{r['flops_scaled']:.4e} against model_flops / n_devices "
              f"{model_flops(arch, shape) / r['n_devices']:.4e} (useful "
              f"{useful:.3f}); wire bytes per device: {wire}; captured in "
              f"{r['compile_s']} s")
        check(math.isfinite(per_dev) and per_dev > 0,
              f"(a) {mesh}: per-device memory")
    before = {k: json.dumps(v, sort_keys=True) for k, v in recs.items()}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.reanalyze", base],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, check=True,
        timeout=DRYRUN_TIMEOUT_S).stdout
    after = load_records(os.path.join(base, "dryrun"))
    check(all(json.dumps(after[k], sort_keys=True) == v
              for k, v in before.items()),
          "(a) reanalyze reproduces the records' fields exactly")
    print(f"(a) {out.strip()}: every field reproduced")
    launches = {k: c.value for k, c in counters.items()}
    check(not any(launches.values()),
          "phase 12 launches none of the ported kernels")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import numpy as np
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi, sm_clocks = phase_env(torch)
    pipes, cycles_per_round = phase_build(torch)
    errs = phase_kernels(torch, np, dev)
    t0 = time.perf_counter()
    series = checkpoint_series(N_IMAGES, IMAGE_BYTES, 0.15, seed=0)
    print(f"checkpoint series: {N_IMAGES} x {IMAGE_BYTES // MiB} MiB "
          f"(seed 0, change_frac 0.15) made in "
          f"{time.perf_counter() - t0:.1f} s")
    launches, gear_largest, maps, spans_err = phase_main_path(torch, np,
                                                              series, smi)
    errs["md5_direct_spans"] = max(errs["md5_direct_spans"], spans_err)
    mesh_images = series[:MESH_IMAGES]
    del series
    phase_checkpoint(torch, np, dev)
    times, flash_launches = phase_times(torch, np, dev, sm_clocks, pipes,
                                        cycles_per_round, errs, gear_largest)
    launches.update(flash_launches)
    serving_launches = phase_serving(torch, np, smi)
    print(f"phase 7 kernel launches: {serving_launches}")
    mesh_launches = phase_mesh(torch, np, mesh_images, maps, smi)
    print(f"phase 8 kernel launches: {mesh_launches}")
    del mesh_images, maps
    torch.cuda.empty_cache()
    phase_lm(torch, np, smi)
    phase_train(torch, np, smi)
    phase_dist(torch, np, smi)
    phase_dryrun(torch, np, smi)
    kernels = []
    for name, counter, source, replaces in [
            ("md5_direct", "md5", "src/repro_torch/kernels/csrc/md5.cu",
             "src/repro/kernels/md5.py:84"),
            ("md5_direct_spans", "md5_spans",
             "src/repro_torch/kernels/csrc/md5.cu",
             "src/repro/kernels/md5.py:84"),
            ("sliding_md5", "sliding_md5",
             "src/repro_torch/kernels/csrc/sliding_md5.cu",
             "src/repro/kernels/sliding_md5.py:56"),
            ("gear", "gear", "src/repro_torch/kernels/csrc/gear.cu",
             "src/repro/kernels/gear.py:134"),
            ("boundary_candidates", "boundary_candidates",
             "src/repro_torch/kernels/csrc/candidates.cu", "none"),
            ("flash_attn", "flash_attn",
             "src/repro_torch/kernels/csrc/flash_attn_wgmma.cu",
             "src/repro/kernels/flash_attn.py:74"),
            ("flash_attn_f16", "flash_attn_f16",
             "src/repro_torch/kernels/csrc/flash_attn_wgmma.cu",
             "src/repro/kernels/flash_attn.py:74"),
            ("flash_attn_f32", "flash_attn_f32",
             "src/repro_torch/kernels/csrc/flash_attn_tf32.cu",
             "src/repro/kernels/flash_attn.py:74"),
            ("flash_tf32_split", "flash_tf32_split",
             "src/repro_torch/kernels/csrc/flash_attn_tf32.cu",
             "src/repro/kernels/flash_attn.py:74")]:
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[counter],
                        "max_abs_err": errs[name], **times[name]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--tenant-client":
        sys.exit(tenant_client(json.loads(sys.argv[2])))
    sys.exit(main())
