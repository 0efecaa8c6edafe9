"""ctypes binding to the C++ host library — port of ``tpurt.utils.native``.

The host library (``native/tpurt_native.cpp``, shared with the reference
and unchanged) holds three host paths: the PNG encoder, the OBJ geometry
parser and the packet BVH's median-split tree build. Each has a Python
twin in this package that gives the same result; the callers take the
twin when the library is not there.

A second host library, the port's own (``tpurt_torch/csrc/cluster_order.cpp``),
holds the pair-cluster accel's kd-SAH triangle order
(``cluster_order``); its twin is the numpy recursion in
``bvh.paircluster``.

Each library is compiled from its source with g++ at first use, and again
when the source is newer, into ``tpurt_torch/build/`` (never at import).
``TPURT_NO_NATIVE=1`` (read on every call) forces the Python twins, and
so does a failed build; ``build_error()`` then returns the compiler's
message (``order_build_error()`` for the order library).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "native", "tpurt_native.cpp")
SO = os.path.join(_PKG, "build", "libtpurt_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error = ""


def _compile(src: str, so: str, flags) -> str:
    """Compile ``src`` into the shared library ``so``: "" on success, else
    the compiler's message. The output lands under a temporary name and is
    renamed into place, so a concurrent process never loads half a
    file."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp,
             *flags],
            check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, so)
        return ""
    except subprocess.CalledProcessError as e:
        error = (e.stderr or e.stdout or str(e)).strip()
    except (OSError, subprocess.SubprocessError) as e:
        error = repr(e)
    if os.path.exists(tmp):
        os.remove(tmp)
    return error or "build failed"


def _build() -> bool:
    """Compile the shared host library."""
    global _error
    _error = _compile(SRC, SO, ["-lz"])
    return not _error


def build_error() -> str:
    """Why the library did not load ("" when it did or was not tried)."""
    return _error


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None under TPURT_NO_NATIVE=1
    or when it cannot be built or loaded (callers take the Python
    twins)."""
    global _lib, _tried, _error
    if os.environ.get("TPURT_NO_NATIVE") == "1":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(SRC):
            _error = f"{SRC} not found"
            return None
        stale = (not os.path.exists(SO)
                 or os.path.getmtime(SRC) > os.path.getmtime(SO))
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(SO)
        except OSError as e:
            _error = repr(e)
            return None

        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        lib.tpurt_png_write.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                        ctypes.c_int32, u8p]
        lib.tpurt_png_write.restype = ctypes.c_int
        lib.tpurt_obj_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int, i32p, i32p, i32p, f32p, f32p,
            i32p, i32p, i32p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.tpurt_obj_parse.restype = ctypes.c_int
        lib.tpurt_bvh_build.argtypes = [ctypes.c_int32, f32p, f32p, f32p,
                                        f32p, i32p, i32p, i32p]
        lib.tpurt_bvh_build.restype = ctypes.c_int32
        _lib = lib
        return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def png_write(path: str, image_u8: np.ndarray) -> bool:
    """Native RGB8 PNG encode; False if the library is not there (the
    caller encodes in Python)."""
    lib = get_lib()
    if lib is None:
        return False
    img = np.ascontiguousarray(image_u8)
    h, w, _ = img.shape
    rc = lib.tpurt_png_write(
        path.encode(), w, h, img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return rc == 0


def obj_parse(path: str):
    """Native OBJ geometry parse: (verts (V, 3) f32, normals (N, 3) f32,
    tri_v (T, 3) i32, tri_n (T, 3) i32 with -1 for none, face_mat (T,) i32
    usemtl slot, mtl_names list[str], mtllib str), or None if the library
    is not there."""
    lib = get_lib()
    if lib is None:
        return None
    nv, nn, nt = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    null_f = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    null_i = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    rc = lib.tpurt_obj_parse(
        path.encode(), 1, ctypes.byref(nv), ctypes.byref(nn),
        ctypes.byref(nt), null_f, null_f, null_i, null_i, null_i,
        None, 0, None, 0)
    if rc != 0:
        return None
    verts = np.empty((nv.value, 3), np.float32)
    normals = np.empty((nn.value, 3), np.float32)
    tri_v = np.empty((nt.value, 3), np.int32)
    tri_n = np.empty((nt.value, 3), np.int32)
    face_mat = np.empty((nt.value,), np.int32)
    names = ctypes.create_string_buffer(1 << 16)
    mtllib = ctypes.create_string_buffer(4096)
    rc = lib.tpurt_obj_parse(
        path.encode(), 0, ctypes.byref(nv), ctypes.byref(nn),
        ctypes.byref(nt), _fp(verts), _fp(normals), _ip(tri_v), _ip(tri_n),
        _ip(face_mat), names, len(names), mtllib, len(mtllib))
    if rc != 0:
        return None
    name_list = names.value.decode(errors="replace")
    return (verts, normals, tri_v, tri_n, face_mat,
            name_list.split("\n") if name_list else [],
            mtllib.value.decode(errors="replace"))


def bvh_build(bmin: np.ndarray, bmax: np.ndarray):
    """Native median-split tree over item boxes: (bmin (M, 3), bmax (M, 3),
    first (M,), count (M,), skip (M,)) with M = 2n - 1 preorder nodes,
    the contract of ``bvh.cluster._median_split_tree``; None if the
    library is not there."""
    lib = get_lib()
    if lib is None:
        return None
    n = bmin.shape[0]
    cap = max(2 * n - 1, 1)
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    o_bmin = np.empty((cap, 3), np.float32)
    o_bmax = np.empty((cap, 3), np.float32)
    o_first = np.empty(cap, np.int32)
    o_count = np.empty(cap, np.int32)
    o_skip = np.empty(cap, np.int32)
    m = lib.tpurt_bvh_build(n, _fp(bmin), _fp(bmax), _fp(o_bmin),
                            _fp(o_bmax), _ip(o_first), _ip(o_count),
                            _ip(o_skip))
    if m <= 0:
        return None
    return o_bmin[:m], o_bmax[:m], o_first[:m], o_count[:m], o_skip[:m]


# --- the port's own host library: the kd-SAH cluster order ----------------

ORDER_SRC = os.path.join(_PKG, "csrc", "cluster_order.cpp")
ORDER_SO = os.path.join(_PKG, "build", "libtpurt_order.so")
_order = {"lib": None, "tried": False, "error": ""}


def order_build_error() -> str:
    """Why the order library did not load ("" when it did or was not
    tried)."""
    return _order["error"]


def get_order_lib() -> Optional[ctypes.CDLL]:
    """The order library, built if needed; None under TPURT_NO_NATIVE=1
    or when it cannot be built or loaded."""
    if os.environ.get("TPURT_NO_NATIVE") == "1":
        return None
    with _lock:
        if _order["tried"]:
            return _order["lib"]
        _order["tried"] = True
        stale = (not os.path.exists(ORDER_SO) or os.path.getmtime(ORDER_SRC)
                 > os.path.getmtime(ORDER_SO))
        if stale:
            # no fused multiply-adds: the SAH costs round as numpy's do
            _order["error"] = _compile(ORDER_SRC, ORDER_SO,
                                       ["-ffp-contract=off", "-pthread"])
            if _order["error"]:
                return None
        try:
            lib = ctypes.CDLL(ORDER_SO)
        except OSError as e:
            _order["error"] = repr(e)
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.tpurt_cluster_order.argtypes = [
            ctypes.c_int64, f32p, f32p, f32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
        lib.tpurt_cluster_order.restype = ctypes.c_int
        _order["lib"] = lib
        return lib


def host_threads() -> int:
    """Cores this process may run on (at most 16)."""
    try:
        return max(1, min(16, len(os.sched_getaffinity(0))))
    except (AttributeError, OSError):
        return max(1, min(16, os.cpu_count() or 1))


def cluster_order(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                  size: int, parent: int = 0) -> Optional[np.ndarray]:
    """The kd-SAH cluster order of float32 (n, 3) corners, natively:
    ``bvh.paircluster``'s ``kd_cluster_order(size, sah=True)`` where
    ``parent`` is 0, ``hier_cluster_order(size, parent)`` otherwise, byte-
    equal to that twin. None where the library is not there, the corners
    are not float32 or there are none (the caller takes the twin)."""
    n = v0.shape[0]
    if n == 0 or any(v.dtype != np.float32 for v in (v0, v1, v2)):
        return None
    lib = get_order_lib()
    if lib is None:
        return None
    v0, v1, v2 = (np.ascontiguousarray(v) for v in (v0, v1, v2))
    out = np.empty(n, np.int64)
    rc = lib.tpurt_cluster_order(
        n, _fp(v0), _fp(v1), _fp(v2), int(size), int(parent),
        host_threads(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out if rc == 0 else None
