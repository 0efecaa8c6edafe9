"""Build and load the hand-written CUDA kernels (``tpurt_torch/csrc``).

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes. The build runs at first use, never at
import, into ``tpurt_torch/build/`` under a name keyed by the sources'
hash, so an edited source rebuilds and a stale library is never loaded.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 -fmad=false``. No
``--use_fast_math``: the kernels keep IEEE division (``1/det``,
``tn/scale``) and no multiply-add contraction, because the quantized
far-break key must stay a lower bound of the true entry distance and the
kernels are held bit for bit against their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("entries.cu", "tileloop.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelLibrary:
    """The loaded library plus what its build printed and cost."""

    def __init__(self, lib: ctypes.CDLL, path: str, log: str,
                 seconds: float):
        self.lib = lib
        self.path = path
        self.log = log  # nvcc's output (ptxas register/spill report)
        self.seconds = seconds  # 0.0 when an up-to-date build was reused
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tpurt_entries.argtypes = [p, p, p, p, p, i, i, i,
                                      ctypes.c_float, p, p]
        lib.tpurt_entries.restype = i
        lib.tpurt_tileloop.argtypes = [p, p, p, p, p, p, p, i, i,
                                       ctypes.c_float, i, p, p, p, p, p]
        lib.tpurt_tileloop.restype = i


_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build tpurt_torch's kernels")


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    if key in _LOADED:
        return _LOADED[key]
    out = os.path.join(BUILD, f"libtpurt_kernels_{key}.so")
    log, seconds = "", 0.0
    if not os.path.exists(out):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    lib = KernelLibrary(ctypes.CDLL(out), out, log, seconds)
    _LOADED[key] = lib
    return lib
