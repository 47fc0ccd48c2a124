"""ctypes bindings of the port's host C++ (csrc/host/*.cpp): the OBJ/PLY
mesh loaders and the binned-SAH threaded-BVH builder (counterpart of
mitsuba_tpu/native/__init__.py).

The shared library is built with g++ at first use (ops/cuda_build.py:
build_host), never at import time.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from .ops import cuda_build

SOURCES = ("mesh_io.cpp", "bvh.cpp")

_fp = ctypes.POINTER(ctypes.c_float)
_ip = ctypes.POINTER(ctypes.c_int)


@functools.cache
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build_host("mtpu_native", SOURCES).path))
    fpp, ipp = ctypes.POINTER(_fp), ctypes.POINTER(_ip)
    for name in ("mtpu_load_obj", "mtpu_load_ply"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, fpp, _ip, ipp, _ip, fpp, _ip, fpp, _ip]
    lib.mtpu_build_bvh_wide.restype = ctypes.c_int
    lib.mtpu_build_bvh_wide.argtypes = [_fp, ctypes.c_int, ctypes.c_int, fpp, _ip, ipp]
    lib.mtpu_free.restype = None
    lib.mtpu_free.argtypes = [ctypes.c_void_p]
    return lib


def _take(lib, ptr, count):
    """Copy `count` values out of a buffer the library allocated, then free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(count,)).copy()
    lib.mtpu_free(ctypes.cast(ptr, ctypes.c_void_p))
    return arr


def _load_mesh(fn_name, path):
    lib = get_lib()
    verts, normals, uvs = _fp(), _fp(), _fp()
    faces = _ip()
    nv, nf, has_n, has_uv = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, fn_name)(
        str(path).encode(), ctypes.byref(verts), ctypes.byref(nv),
        ctypes.byref(faces), ctypes.byref(nf), ctypes.byref(normals),
        ctypes.byref(has_n), ctypes.byref(uvs), ctypes.byref(has_uv),
    )
    if rc != 0:
        raise IOError(f"{fn_name}({path!r}) failed with code {rc}")
    out = {
        "vertices": _take(lib, verts, nv.value * 3).reshape(-1, 3),
        "faces": _take(lib, faces, nf.value * 3).reshape(-1, 3),
    }
    if has_n.value:
        out["normals"] = _take(lib, normals, nv.value * 3).reshape(-1, 3)
    if has_uv.value:
        out["uvs"] = _take(lib, uvs, nv.value * 2).reshape(-1, 2)
    return out


def load_obj(path):
    """Wavefront OBJ: {vertices [V,3] f32, faces [F,3] i32, normals and uvs
    when the file has one per vertex} (reference: src/shapes/obj.cpp)."""
    return _load_mesh("mtpu_load_obj", path)


def load_ply(path):
    """PLY, ascii or binary_little_endian; the same dict as load_obj
    (reference: src/shapes/ply.cpp)."""
    return _load_mesh("mtpu_load_ply", path)


def build_bvh_wide(tris, max_leaf=64):
    """Wide-leaf binned-SAH threaded BVH over [T, 9] (v0 | e1 | e2)
    triangles.

    Returns (nodes [M, 8] float32, prim_order [T] int32). A node is its box
    (lo in columns 0-2, hi in 3-5), then two int32 stored bitwise in the
    float columns: 6 the skip link (the node after this subtree, -1 at the
    end), 7 the leaf payload (start << 8 | count, count <= max_leaf) or 0
    for an internal node. Leaf ranges index the triangles in prim_order."""
    lib = get_lib()
    tris = np.ascontiguousarray(tris, np.float32)
    if tris.ndim != 2 or tris.shape[1] != 9:
        raise ValueError(f"build_bvh_wide: triangles must be [T, 9], got {tris.shape}")
    nodes, order = _fp(), _ip()
    n_nodes = ctypes.c_int()
    rc = lib.mtpu_build_bvh_wide(
        tris.ctypes.data_as(_fp), tris.shape[0], int(max_leaf), ctypes.byref(nodes),
        ctypes.byref(n_nodes), ctypes.byref(order),
    )
    if rc != 0:
        raise RuntimeError(f"mtpu_build_bvh_wide failed with code {rc}")
    return _take(lib, nodes, n_nodes.value * 8).reshape(-1, 8), _take(lib, order, tris.shape[0])
