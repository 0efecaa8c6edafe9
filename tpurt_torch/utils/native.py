"""ctypes binding to the C++ host library — port of ``tpurt.utils.native``.

The host library (``native/tpurt_native.cpp``, shared with the reference
and unchanged) holds three host paths: the PNG encoder, the OBJ geometry
parser and the packet BVH's median-split tree build. Each has a Python
twin in this package that gives the same result; the callers take the
twin when the library is not there.

The library is compiled from that source with g++ at first use, and again
when the source is newer, into ``tpurt_torch/build/`` (never at import).
``TPURT_NO_NATIVE=1`` (read on every call) forces the Python twins, and
so does a failed build; ``build_error()`` then returns the compiler's
message.
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


def _build() -> bool:
    """Compile the library; the output lands under a temporary name and
    is renamed into place, so a concurrent process never loads half a
    file."""
    global _error
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", SRC, "-o", tmp,
             "-lz"],
            check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, SO)
        return True
    except subprocess.CalledProcessError as e:
        _error = (e.stderr or e.stdout or str(e)).strip()
    except (OSError, subprocess.SubprocessError) as e:
        _error = repr(e)
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


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
