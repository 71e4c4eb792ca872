#!/usr/bin/env python3
"""Where the bf16 flash-attention kernel spends its time, on one NVIDIA
H100: the kernel of ``src/repro_torch/kernels/csrc/flash_attn_wgmma.cu``
against variants of its own source, each built beside it with ``nvcc``.

Run from the root of a checkout on a machine with a card and ``nvcc``:
``python3 tools/flash_ablation.py``.  It prints:

1. what ``ptxas -v`` reports (registers, spills, serialisation warnings)
   for the hd-128 kernel compiled for blocks of 256 threads (as it
   ships), 288 and 384 threads (the block a producer warp or a producer
   warpgroup would add), and 384 threads with ``setmaxnreg.inc 240`` at
   the consumers' start;
2. median times (CUDA events, L2 flushed, 5 repeats) at BH 32, S = Sk =
   8192, hd 128 and 64, causal, of the kernel and of variants that each
   take one thing away, run in the order A B C ... C B A, beside
   ``scaled_dot_product_attention``:
   - ``no_pingpong``: the warpgroups issue their products without taking
     turns;
   - ``two_stage``: a two-stage K/V ring instead of three;
   - ``no_softmax``: the softmax is skipped (P is the raw scores), which
     leaves the products and the loads;
   - ``no_kv_waits``: after the first stages nothing is refilled or
     waited for, so the kernel reads stale K and V: the products and the
     softmax without the loads.
   Only the kernel and the first two variants compute attention; each of
   them is checked against ``flash_attn.flash_plain`` within
   ``flash_attn.flash_bf16_bound`` on two heads.

Each variant is a text substitution in the source, asserted to apply, so
an edit of the kernel that breaks one fails here rather than timing the
wrong code.  Needs one card; without one it exits with code 2.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/csrc/flash_attn_wgmma.cu")
ENTRY = "flash_attn_wgmma_launch"

SOFTMAX_CALLS = (
    "  softmax_tile(s, rows, 0, masked(0), r0, cq, Sk, scale_log2);\n",
    "    softmax_tile(s, rows, t * kBK, masked(t * kBK), r0, cq, Sk, "
    "scale_log2);\n")


def substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"variant does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str):
    """name -> (source, computes attention)"""
    threads = "constexpr int kThreads = 32 * kWarps;"
    consumer = "  const int wg = warp >> 2;\n"
    return {
        "base": (src, True),
        "no_pingpong": (substitute(src, [
            ('asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");',
             ""),
            ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");',
             "")]), True),
        "two_stage": (substitute(src, [
            ("constexpr int kStages = 3;", "constexpr int kStages = 2;")]),
            True),
        "no_softmax": (substitute(src, [(c, "") for c in SOFTMAX_CALLS]),
                       False),
        "no_kv_waits": (substitute(src, [
            ("    mbar_wait(bar_k + 8 * st, (t / kStages) & 1);\n"
             "    mbar_wait(bar_v + 8 * pst, ((t - 1) / kStages) & 1);\n",
             "    if (t < kStages) mbar_wait(bar_k + 8 * st, 0);\n"
             "    if (t <= kStages) mbar_wait(bar_v + 8 * pst, 0);\n"),
            ("  mbar_wait(bar_v + 8 * (last % kStages), (last / kStages) "
             "& 1);",
             "  if (last < kStages) mbar_wait(bar_v + 8 * last, 0);"),
            ("  const bool refiller = threadIdx.x == kRefiller;",
             "  const bool refiller = false;")]), False),
        # compile only: the register cap of larger blocks
        "threads288": (substitute(src, [
            (threads, "constexpr int kThreads = 32 * kWarps + 32;")]), None),
        "threads384": (substitute(src, [
            (threads, "constexpr int kThreads = 32 * kWarps + 128;")]),
            None),
        "threads384_setmaxnreg240": (substitute(src, [
            (threads, "constexpr int kThreads = 32 * kWarps + 128;"),
            (consumer, consumer + "  asm volatile(\"setmaxnreg.inc.sync."
             "aligned.u32 240;\\n\" ::: \"memory\");\n")]), None),
    }


def build(name, src, out_dir, nvcc, arch):
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src.replace(ENTRY, f"fa_{name}"))
    so = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.run(
        [nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
         "-Xptxas", "-v", cu, "-o", so],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    # the hd-128 bf16 kernel's lines (template <128, false>): its entry,
    # then registers and spills
    lines, cur = [], None
    for line in proc.stdout.splitlines():
        m = re.search(r"(Compiling entry function|Function properties for) "
                      r"'?(\S+?)'?( for|$)", line)
        if m:
            cur = m.group(2)
        if cur and "ILi128ELb0E" in cur and ("Used" in line
                                             or "spill" in line
                                             or "(C75" in line):
            lines.append(line.split(":", 1)[-1].strip()[:110])
    return name, so, lines


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, flash_attn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    print(smi)
    with open(SOURCE) as f:
        table = variants(f.read())
    fns, real = {}, {}
    with tempfile.TemporaryDirectory() as out_dir:
        nvcc = _build.nvcc_path()
        with concurrent.futures.ThreadPoolExecutor(len(table)) as ex:
            jobs = [ex.submit(build, name, src, out_dir, nvcc, _build.ARCH)
                    for name, (src, _) in table.items()]
            for job in jobs:
                name, so, lines = job.result()
                print(f"ptxas, hd 128, {name}: " + "; ".join(lines))
                if table[name][1] is None:
                    continue
                fn = getattr(ctypes.CDLL(so), f"fa_{name}")
                fn.argtypes = _build.SIGNATURES[ENTRY]
                fn.restype = ctypes.c_int
                fns[name], real[name] = fn, table[name][1]
        dev = torch.device("cuda", 0)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(fn, q, k, v):
            out = torch.empty_like(q)
            BH, S, hd = q.shape
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), BH, S, k.shape[1], hd, hd ** -0.5,
                     stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")
            return out

        def time_ms(call):
            call()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            return statistics.median(times)

        sdpa = torch.nn.functional.scaled_dot_product_attention
        for BH, S, hd in [(32, 8192, 128), (32, 8192, 64)]:
            gen = torch.Generator(device=dev).manual_seed(3)
            q, k, v = (torch.randn((BH, S, hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(3))
            flops = 4 * BH * hd * sum(min(i + 1, S) for i in range(S))
            order = list(fns) + list(reversed(list(fns)))
            ms = {name: [] for name in fns}
            for name in order:
                ms[name].append(time_ms(lambda: launch(fns[name], q, k, v)))
            lib = [time_ms(lambda: sdpa(*(t.view(1, BH, S, hd)
                                          for t in (q, k, v)),
                                        is_causal=True)) for _ in range(2)]
            print(f"BH {BH} S = Sk = {S} hd {hd}, causal, {flops:.4g} FLOP:"
                  f" scaled_dot_product_attention {lib[0]:.4f} / "
                  f"{lib[1]:.4f} ms")
            head = [t[:2].contiguous() for t in (q, k, v)]
            want = flash_attn.flash_plain(*head)
            bound = flash_attn.flash_bf16_bound(*head, want)
            for name, t in ms.items():
                note = ""
                if real[name]:
                    got = launch(fns[name], *head).float()
                    ok = bool(((got - want).abs() <= bound).all())
                    note = f", within the bf16 bound on 2 heads: {ok}"
                print(f"  {name}: {t[0]:.4f} / {t[1]:.4f} ms "
                      f"({flops / min(t) / 1e9:.1f} TFLOP/s){note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
