"""ctypes bridge to the native runtime library (native/libgoblin_native.so).

Native components (C++): binned-SAH BVH builder with skip-link layout,
Morton triangle ordering, OBJ parser. Python fallbacks exist for each
(accel/bvh.py, geometry/mesh.py); the native path is preferred when the
library builds. It is compiled from native/*.cpp at first use (or by
`make -C native`) and never committed.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _build(path: str) -> bool:
    """Compile the library from native/*.cpp into `path`. The compiler
    writes a name of this process's own and the result is renamed into
    place, so concurrent first uses (test workers) never load a
    half-written file."""
    import subprocess

    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-C", os.path.dirname(path),
             f"LIB={os.path.basename(tmp)}"],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native", "libgoblin_native.so",
    )
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.goblin_build_bvh.argtypes = [
        f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, i32p, i32p,
    ]
    lib.goblin_build_bvh.restype = ctypes.c_int
    lib.goblin_morton_order.argtypes = [
        f32p, f32p, f32p, ctypes.c_int, u32p, i32p,
    ]
    lib.goblin_morton_order.restype = None
    lib.goblin_obj_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.goblin_obj_parse.restype = ctypes.c_int64
    lib.goblin_obj_fill.argtypes = [ctypes.c_int64, f32p, f32p, f32p, i32p]
    lib.goblin_obj_fill.restype = None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def build_bvh(v0, v1, v2, max_leaf=4, n_bins=16):
    """Native BVH build. Returns (bounds, meta, order) or None."""
    lib = _lib()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    T = v0.shape[0]
    cap = 2 * T + 1
    bounds = np.empty((cap, 6), np.float32)
    meta = np.empty((cap, 3), np.int32)
    order = np.empty(T, np.int32)
    n = lib.goblin_build_bvh(v0, v1, v2, T, max_leaf, n_bins, bounds, meta,
                             order)
    if n <= 0:
        return None
    return bounds[:n].copy(), meta[:n].copy(), order


def morton_order(v0, v1, v2):
    """Native Morton ordering. Returns (codes, order) or None."""
    lib = _lib()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    T = v0.shape[0]
    codes = np.empty(T, np.uint32)
    order = np.empty(T, np.int32)
    lib.goblin_morton_order(v0, v1, v2, T, codes, order)
    return codes, order


def load_obj(path: str):
    """Native OBJ parse -> TriangleMesh, or None."""
    lib = _lib()
    if lib is None:
        return None
    nv = ctypes.c_int()
    nf = ctypes.c_int()
    hn = ctypes.c_int()
    hu = ctypes.c_int()
    h = lib.goblin_obj_parse(path.encode(), ctypes.byref(nv),
                             ctypes.byref(nf), ctypes.byref(hn),
                             ctypes.byref(hu))
    if h == 0:
        return None
    V, F = nv.value, nf.value
    pos = np.empty((V, 3), np.float32)
    nrm = np.empty((V, 3), np.float32)
    uv = np.empty((V, 2), np.float32)
    faces = np.empty((F, 3), np.int32)
    lib.goblin_obj_fill(h, pos, nrm, uv, faces)
    from .geometry.mesh import TriangleMesh

    return TriangleMesh(
        positions=pos,
        normals=nrm if hn.value else None,
        uvs=uv if hu.value else None,
        faces=faces,
    )
