"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` compiles (one ``nvcc`` process per source, all
started together) for ``sm_90a`` into an object file, and the objects
link into one shared library with a plain C interface.  Nothing includes
PyTorch's headers, so a build takes seconds.  The library lands in
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``) under a name derived from the sources and flags, so an
edited source never loads a stale library.  Building happens on first use
— never at import — and only on a machine with ``nvcc``.

Each kernel wrapper counts its launches in a :class:`LaunchCounter`, so a
run can show that the main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "md5_direct_launch": [_c_void_p, _c_void_p, _c_void_p, _c_int, _c_ll,
                          _c_void_p],
    "sliding_md5_launch": [_c_void_p, _c_void_p, _c_ll, _c_ll, _c_int,
                           _c_int, _c_void_p],
}


class LaunchCounter:
    """Plain integer count of one kernel's launches (thread-safe: the
    engine's manager threads launch concurrently)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def inc(self):
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self):
        with self._lock:
            self._n = 0


class _Library:
    """The loaded kernel library plus what its build printed."""

    def __init__(self, cdll: ctypes.CDLL, log: str, seconds: float,
                 path: Path):
        self.cdll = cdll
        self.log = log              # nvcc output, incl. -Xptxas -v lines
        self.seconds = seconds      # 0.0 when an existing build was loaded
        self.path = path
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        cdll.kernel_error_string.argtypes = [ctypes.c_int]
        cdll.kernel_error_string.restype = ctypes.c_char_p

    def check(self, err: int, what: str):
        if err:
            msg = self.cdll.kernel_error_string(err).decode()
            raise RuntimeError(f"{what} launch failed: {msg} ({err})")


_LIB: Optional[_Library] = None
_LIB_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _fingerprint() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    nvcc = nvcc_path()
    procs: Dict[Path, subprocess.Popen] = {}
    for src in _sources():              # one nvcc per source, in parallel
        obj = out_dir / (src.stem + ".o")
        procs[src] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs, failed = [], []
    for src, proc in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    objs = [str(out_dir / (s.stem + ".o")) for s in _sources()]
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", *objs, "-o", str(out_dir / "lib.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    return log + link.stdout


def library() -> _Library:
    """The kernel library, built from ``csrc/`` on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        target = BUILD_DIR / f"kernels-{_fingerprint()}"
        so = target / "lib.so"
        log, seconds = "", 0.0
        if not so.exists():
            tmp = BUILD_DIR / f"tmp-{os.getpid()}-{time.time_ns()}"
            tmp.mkdir(parents=True)
            t0 = time.perf_counter()
            log = _compile(tmp)
            seconds = time.perf_counter() - t0
            (tmp / "build.log").write_text(log)
            try:
                tmp.rename(target)      # atomic: concurrent builders race
            except OSError:             # another process won; use its build
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            log_file = target / "build.log"
            log = log_file.read_text() if log_file.exists() else ""
        _LIB = _Library(ctypes.CDLL(str(so)), log, seconds, so)
        return _LIB
