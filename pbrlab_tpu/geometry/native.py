"""ctypes bindings to the native scene-build kernels (native/builder.cpp).

Compiled lazily with the system compiler on first use, next to its source
(the built library is not committed); every entry point falls back to the
numpy implementations in geometry.bvh when the toolchain or the build is
unavailable, so the native path is a pure accelerator, never a
requirement.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "builder.cpp")


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so_path = os.path.join(os.path.dirname(_SRC), "libpbrlab_native.so")
        try:
            if (not os.path.exists(so_path)
                    or os.path.getmtime(so_path) < os.path.getmtime(_SRC)):
                # build beside the target and rename: processes that build
                # at once (test workers) never load a half-written library
                tmp = f"{so_path}.{os.getpid()}.tmp"
                subprocess.run(
                    ["c++", "-O3", "-march=native", "-shared", "-fPIC",
                     _SRC, "-o", tmp],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
            lib.pbrlab_morton_order.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32)]
            lib.pbrlab_bvh_build.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
            lib.pbrlab_bvh_build.restype = ctypes.c_int64
            lib.pbrlab_bvh_read.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def morton_order(points: np.ndarray) -> Optional[np.ndarray]:
    """Morton order of [n,3] points, or None if native is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty((pts.shape[0],), np.int32)
    lib.pbrlab_morton_order(_fptr(pts), pts.shape[0], _iptr(out))
    return out


def build_bvh_native(prim_bmin: np.ndarray, prim_bmax: np.ndarray,
                     leaf_size: int):
    """Native threaded-BVH build; returns a geometry.bvh.BVH or None."""
    lib = _lib()
    if lib is None:
        return None
    from .bvh import BVH

    bmin = np.ascontiguousarray(prim_bmin, np.float32)
    bmax = np.ascontiguousarray(prim_bmax, np.float32)
    n_slots = ctypes.c_int64(0)
    n_nodes = lib.pbrlab_bvh_build(_fptr(bmin), _fptr(bmax), bmin.shape[0],
                                   leaf_size, ctypes.byref(n_slots))
    node_bmin = np.empty((n_nodes, 3), np.float32)
    node_bmax = np.empty((n_nodes, 3), np.float32)
    skip = np.empty((n_nodes,), np.int32)
    prim_offset = np.empty((n_nodes,), np.int32)
    prim_ids = np.empty((n_slots.value,), np.int32)
    lib.pbrlab_bvh_read(_fptr(node_bmin), _fptr(node_bmax), _iptr(skip),
                        _iptr(prim_offset), _iptr(prim_ids))
    lib.pbrlab_bvh_free()
    return BVH(aabb_min=node_bmin, aabb_max=node_bmax, skip=skip,
               prim_offset=prim_offset, prim_ids=prim_ids)
