#!/usr/bin/env python3
"""Where the sliding-window MD5 kernel spends its issue slots, on one
NVIDIA H100: the kernel of ``src/repro_torch/kernels/csrc/sliding_md5.cu``
against variants of its own source, each built beside it with ``nvcc``.

Run from the root of a checkout on a machine with a card and ``nvcc``:
``python3 tools/sliding_ablation.py [--baseline OTHER.cu]``.  It prints,
for the window of 48 bytes (12 words) at stride 4 and at stride 1:

1. each variant's registers and spills (``ptxas -v``) and its SASS opcode
   mix (``cuobjdump -sass``), split into the ALU pipe and the FMA pipe
   (IMAD, VIADD) as ``chip_smoke.py`` splits it;
2. median times (CUDA events, L2 flushed, 5 repeats) on one 256 MiB image
   of random words, run in the order A B C ... C B A.  The kernel adds
   f's terms on the ALU pipe in every third round and on the FMA pipe in
   the others; the variants:
   - ``alu_every2``, ``alu_every4``: on the ALU pipe in every second or
     every fourth round;
   - ``alu_adds``: on the ALU pipe in every round (an IADD3 and an IMAD);
   - ``fma_adds``: on the FMA pipe in every round;
   - ``imad_hi``: b + rotl(f, s) as two IMADs, lo(f 2^s) + (hi(f 2^s) +
     b), in place of one LEA.HI on the ALU pipe;
   - ``compiler``: every round written plainly, so ptxas alone picks the
     instructions and pipes;
   - ``baseline`` (with ``--baseline``): another version of the source,
     for instance an earlier commit's, with the same C entry point.

Every variant's output is checked bit for bit against the kernel's, and
the kernel's against ``sliding_md5.sliding_plain`` on the first 4 MiB.
Each variant is a text substitution in the source, asserted to apply, so
an edit of the kernel that breaks one fails here rather than timing the
wrong code.  Needs one card; without one it exits with code 2.
"""
from __future__ import annotations

import argparse
import collections
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
CSRC = os.path.join(ROOT, "src/repro_torch/kernels/csrc")
SOURCE = os.path.join(CSRC, "sliding_md5.cu")
ENTRY = "sliding_md5_launch"
WW, IMAGE_WORDS = 12, 1 << 26
ALU_OPCODES = ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT",
               "IABS", "IMNMX", "MOV")
# VIADD (an add) issues beside IMAD, not on the ALU pipe: the sliding
# kernel's times in tools/sliding_ablation.py fit only that
FMA_OPCODES = ("IMAD", "VIADD")

EVERY = "constexpr int kAluAddEvery = 3;"
ROTATE = "    x[ia][k] = b + rotl(f, s);                      // LEA.HI"
MUL_FIELDS = ("  uint32_t one;\n};",
              "  uint32_t one;\n  uint32_t pow2[16];\n};")
MUL_FILL = ("  mul.one = 1u;",
            "  mul.one = 1u;\n  for (int j = 0; j < 16; ++j)\n"
            "    mul.pow2[j] = 1u << md5_s(16 * (j / 4) + j % 4);")
IMAD_HI = ("    const uint32_t p = mul.pow2[4 * (I / 16) + I % 4];\n"
           "    uint32_t h;\n"
           '    asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(h) : "r"(f), '
           '"r"(p), "r"(b));\n'
           "    x[ia][k] = mad_lo(f, p, h);")
ALU_ADD = "      f = mad_lo(fb, mul.one, a + kv + m);          // IADD3, IMAD"


def substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"variant does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str, baseline: str | None):
    def every(n):
        return (EVERY, f"constexpr int kAluAddEvery = {n};")
    out = {"kernel": src,
           "alu_every2": substitute(src, [every(2)]),
           "alu_every4": substitute(src, [every(4)]),
           "alu_adds": substitute(src, [every(1)]),
           "fma_adds": substitute(src, [every("1 << 20")]),
           "imad_hi": substitute(src, [MUL_FIELDS, MUL_FILL,
                                       (ROTATE, IMAD_HI)]),
           "compiler": substitute(src, [
               every(1), (ALU_ADD, "      f = fb + a + kv + m;")])}
    if baseline:
        with open(baseline) as f:
            out["baseline"] = f.read()
    return out


def build(name, src, out_dir, nvcc, arch):
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src.replace(ENTRY, f"sl_{name}"))
    so = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.run(
        [nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
         "-I", CSRC, "-Xptxas", "-v", cu, "-o", so],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    # the window-12 kernels' lines: their entries, registers and spills
    lines, cur = [], None
    for line in proc.stdout.splitlines():
        m = re.search(r"(Compiling entry function|Function properties for) "
                      r"'?(\S+?)'?( for|$)", line)
        if m:
            cur = m.group(2)
        if cur and "ILi12E" in cur and ("Used" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip()[:80])
    return name, so, lines


def sass_mix(so: str, cuobjdump: str):
    """Opcode counts of each window-12 kernel function in the library."""
    out = subprocess.run([cuobjdump, "-sass", so], stdout=subprocess.PIPE,
                         text=True, check=True).stdout
    mix, fn = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            fn = mix.setdefault(name, collections.Counter()) \
                if "ILi12E" in name or "<12" in name else None
        elif fn is not None and line.startswith("/*") and "*/" in line:
            tok = line.split("*/", 1)[1].split()
            if tok and tok[0].startswith("@"):
                tok = tok[1:]
            if tok and not tok[0].startswith("/*"):
                fn[tok[0].split(".")[0]] += 1
    return mix


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="another sliding_md5.cu to time "
                    "beside the kernel (same C entry point)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sliding_ablation: no CUDA device; nothing run",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, sliding_md5
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    print(smi)
    with open(SOURCE) as f:
        table = variants(f.read(), args.baseline)
    nvcc = _build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    fns = {}
    with tempfile.TemporaryDirectory() as out_dir:
        with concurrent.futures.ThreadPoolExecutor(len(table)) as ex:
            jobs = [ex.submit(build, name, src, out_dir, nvcc, _build.ARCH)
                    for name, src in table.items()]
            for job in jobs:
                name, so, lines = job.result()
                print(f"ptxas, window 12, {name}: " + "; ".join(lines))
                for fn, m in sorted(sass_mix(so, cuobjdump).items()):
                    alu = sum(m[op] for op in ALU_OPCODES)
                    fma = sum(m[op] for op in FMA_OPCODES)
                    stride = re.search(r"ILi12ELi(\d)E", fn)
                    label = f"stride {stride.group(1)}" if stride else fn
                    print(f"  SASS {label}: {sum(m.values())} "
                          f"instructions, ALU pipe {alu}, FMA pipe {fma}; "
                          f"{dict(m.most_common(10))}")
                fn = getattr(ctypes.CDLL(so), f"sl_{name}")
                fn.argtypes = _build.SIGNATURES[ENTRY]
                fn.restype = ctypes.c_int
                fns[name] = fn
        dev = torch.device("cuda", 0)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator(device=dev).manual_seed(3)
        words = torch.randint(-2 ** 31, 2 ** 31, (1, IMAGE_WORDS),
                              dtype=torch.int32, device=dev, generator=gen)

        def launch(fn, stride):
            out = torch.empty((1, 4 // stride, IMAGE_WORDS),
                              dtype=torch.int32, device=dev)
            err = fn(words.data_ptr(), out.data_ptr(), 1, IMAGE_WORDS, WW,
                     stride, stream)
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

        for stride in (4, 1):
            want = launch(fns["kernel"], stride)
            head = words[:, :1 << 20]
            plain = sliding_md5.sliding_plain(head, WW, stride) \
                .view(torch.int32)
            got = launch(fns["kernel"], stride)[:, :, :1 << 20]
            # the plain version's last windows read zeros past the head
            ok = torch.equal(got[:, :, :-16], plain[:, :, :-16])
            print(f"stride {stride}, window 48, [1, {IMAGE_WORDS}] words: "
                  f"kernel == plain on the first 4 MiB: {ok}")
            order = list(fns) + list(reversed(list(fns)))
            ms = {name: [] for name in fns}
            for name in order:
                ms[name].append(time_ms(lambda: launch(fns[name], stride)))
            for name, t in ms.items():
                same = torch.equal(launch(fns[name], stride), want)
                print(f"  {name}: {t[0]:.4f} / {t[1]:.4f} ms, "
                      f"== kernel: {same}")
            del want, plain, got
    return 0


if __name__ == "__main__":
    sys.exit(main())
