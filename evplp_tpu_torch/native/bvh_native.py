"""ctypes binding of the C++ BVH builder (`native/bvh_builder.cpp`),
compiled with g++ at first use by `native/build.py`."""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from evplp_tpu_torch.native.build import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "bvh_builder.cpp")
_lock = threading.Lock()
_lib = None


def load_library():
    """Build (at first use) and load the builder library."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_library("bvh", [_SRC], ["g++", "-O3", "-std=c++17",
                                                 "-shared", "-fPIC"])
            lib = ctypes.CDLL(path)
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.evplp_build_bvh.restype = ctypes.c_int
            lib.evplp_build_bvh.argtypes = [fp] * 3 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                fp, fp, ip, ip, ip, ip]
            _lib = lib
    return _lib


def build(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int):
    """-> (node_min, node_max, skip, first, count, perm) host arrays."""
    lib = load_library()
    num_tris = int(v0.shape[0])
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    # the builder returns -needed when max_nodes is too small; one retry
    # with the exact size always fits
    max_nodes = max(8, 4 * num_tris // max(leaf_size, 1) + 64)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    for _ in range(2):
        node_min = np.empty((max_nodes, 3), np.float32)
        node_max = np.empty((max_nodes, 3), np.float32)
        skip = np.empty((max_nodes,), np.int32)
        first = np.empty((max_nodes,), np.int32)
        count = np.empty((max_nodes,), np.int32)
        perm = np.empty((num_tris,), np.int32)
        n = lib.evplp_build_bvh(
            v0.ctypes.data_as(fp), v1.ctypes.data_as(fp),
            v2.ctypes.data_as(fp), num_tris, leaf_size, max_nodes,
            node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
            skip.ctypes.data_as(ip), first.ctypes.data_as(ip),
            count.ctypes.data_as(ip), perm.ctypes.data_as(ip))
        if n >= 0:
            return (node_min[:n], node_max[:n], skip[:n], first[:n],
                    count[:n], perm.astype(np.int64))
        max_nodes = -n
    raise RuntimeError("native BVH build failed to allocate")
