"""Build and load the hand-written CUDA kernels (``tpurt_torch/csrc``).

Each source compiles with its own nvcc process (all started together),
then one link makes a shared library with a plain C interface, loaded
with ctypes. The build runs at first use, never at import, into
``tpurt_torch/build/`` under a name keyed by the sources' hash, so an
edited source rebuilds in the next process and a stale library is never
loaded; nvcc's output (the registers and spills of every kernel) is kept
beside the library, so a process that reuses it can still report them.

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
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("entries.cu", "tileloop.cu", "pairwave.cu", "packet.cu",
           "shade.cu", "raysort.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the argument types of every C entry point (each returns a cudaError as
# int); the stream comes last where there is one
SIGNATURES = {
    "tpurt_entries": [_p, _p, _p, _p, _p, _i, _i, _i, _f, _p, _p],
    "tpurt_exact_mask": [_p, _p, _p, _p, _p, _i, _i, _i, _p, _p, _p],
    "tpurt_slab_rays": [_p, _p],
    "tpurt_slab_rays_reset": [_p],
    "tpurt_pair_test": [_p] * 7 + [ctypes.c_long] + [_p] * 5,
    "tpurt_tileloop": [_p] * 8 + [_i, _i, _f, _i] + [_p] * 9,
    "tpurt_tilegrid": [_p] * 6 + [_i, _i, _i] + [_p] * 8,
    "tpurt_packet": [_p, _i, _p, _p, _p, _p, ctypes.c_long, _i] + [_p] * 6,
    "tpurt_shade": ([_p] * 14 + [_i, _p, _i, _p, _p, _i, _f, _f, _f, _p,
                                 _p, _p, _i, _i, _i, _f, _f, ctypes.c_long]
                    + [_p] * 14 + [_i, _p]),
    "tpurt_raysort_temp_bytes": [_i, ctypes.POINTER(ctypes.c_size_t)],
    "tpurt_raysort": [_p] * 5 + [_i] + [_p] * 5 + [ctypes.c_size_t, _p],
    "tpurt_raygather": [_p] * 4 + [_i, _i] + [_p] * 5,
    "tpurt_rayrestore": [_p, _i, _i] + [_p] * 11,
}


class KernelLibrary:
    """The loaded library plus what its build printed and cost."""

    def __init__(self, lib: ctypes.CDLL, path: str, log: str,
                 seconds: float):
        self.lib = lib
        self.path = path
        self.log = log  # nvcc's output (ptxas register/spill report)
        self.seconds = seconds  # 0.0 when an up-to-date build was reused
        for name, argtypes in SIGNATURES.items():
            # another checkout's library (k1_paired.py) may hold fewer
            entry = getattr(lib, name, None)
            if entry is not None:
                entry.argtypes, entry.restype = argtypes, _i


_LOADED: list = []  # the process's library once loaded


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


def _build(srcs, out: str) -> str:
    """Compile every source in its own nvcc process, all at once, then
    link ``out``; returns the compilers' output."""
    nvcc = _nvcc()
    objs = [f"{out}.{os.path.basename(s)}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    log, failed = "", []
    for s, proc in zip(srcs, procs):
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(os.path.basename(s))
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", out, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append("link")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    return log


def build_library(src_dir: str, out: str) -> KernelLibrary:
    """Build the kernel library of the sources in ``src_dir`` (csrc/ or a
    copy of it, for example another checkout's, which may lack some of
    SOURCES) into ``out`` and load it, without making it the process's
    library: ``activate`` does that."""
    t0 = time.perf_counter()
    srcs = [os.path.join(src_dir, s) for s in SOURCES]
    log = _build([s for s in srcs if os.path.exists(s)], out)
    return KernelLibrary(ctypes.CDLL(out), out, log, time.perf_counter() - t0)


def activate(lib: KernelLibrary) -> None:
    """Make ``lib`` the library that every later launch in this process
    uses."""
    _LOADED[:] = [lib]


def constant(name: str, source: str = "tileloop.cu") -> int:
    """The value V of ``constexpr int name = V;`` in a source of csrc/."""
    with open(os.path.join(CSRC, source)) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    if len(found) != 1:
        raise ValueError(f"{source}: no single constant {name}")
    return int(found[0])


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library. Every launch asks
    for it, so the sources are hashed once per process: later calls
    return the loaded library without reading them."""
    if _LOADED:
        return _LOADED[0]
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    out = os.path.join(BUILD, f"libtpurt_kernels_{key}.so")
    seconds = 0.0
    if not os.path.exists(out):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        log = _build(srcs, tmp)
        seconds = time.perf_counter() - t0
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", f"{out}.log")
        os.replace(tmp, out)
    with open(f"{out}.log") as f:
        log = f.read()
    lib = KernelLibrary(ctypes.CDLL(out), out, log, seconds)
    _LOADED.append(lib)
    return lib
