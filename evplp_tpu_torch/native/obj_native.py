"""ctypes binding of the native OBJ/MTL loader (`native/obj_loader.cpp`),
compiled with g++ at first use by `native/build.py` into
`build/evplp_tpu_torch/`.  `load()` returns the same (meshes, materials)
as the Python loop of `scene/objloader.py:load_obj`."""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from evplp_tpu_torch.native.build import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "obj_loader.cpp")
_lock = threading.Lock()
_lib = None
# bytes of each material name / texture path buffer
_MAP_CAP = 4096


def load_library():
    """Build (at first use) and load the loader library."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_library("obj", [_SRC], ["g++", "-O3", "-std=c++17",
                                                 "-shared", "-fPIC"])
            lib = ctypes.CDLL(path)
            vp, fp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
            ip, cp = ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p
            lib.evplp_obj_parse.restype = vp
            lib.evplp_obj_parse.argtypes = [cp]
            lib.evplp_obj_free.argtypes = [vp]
            lib.evplp_obj_num_meshes.restype = ctypes.c_int
            lib.evplp_obj_num_meshes.argtypes = [vp]
            lib.evplp_obj_num_materials.restype = ctypes.c_int
            lib.evplp_obj_num_materials.argtypes = [vp]
            lib.evplp_obj_mesh_info.argtypes = [vp, ctypes.c_int, ip]
            lib.evplp_obj_mesh_fill.argtypes = [vp, ctypes.c_int, fp, fp, ip]
            lib.evplp_obj_material.argtypes = [
                vp, ctypes.c_int, fp, cp, ctypes.c_int, cp, cp, cp,
                ctypes.c_int]
            _lib = lib
    return _lib


def load(path: str):
    """-> (meshes: list[ObjMesh], materials: list[ObjMaterial]).  Raises
    FileNotFoundError if the file cannot be opened."""
    from evplp_tpu_torch.scene.objloader import ObjMaterial, ObjMesh

    lib = load_library()
    h = lib.evplp_obj_parse(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    try:
        materials = []
        scal = (ctypes.c_float * 7)()
        name, mk, ms, mn = (ctypes.create_string_buffer(_MAP_CAP)
                            for _ in range(4))
        for i in range(lib.evplp_obj_num_materials(h)):
            lib.evplp_obj_material(h, i, scal, name, _MAP_CAP, mk, ms, mn,
                                   _MAP_CAP)
            materials.append(ObjMaterial(
                name=name.value.decode("utf-8", errors="replace"),
                kd=np.asarray(scal[0:3], np.float32),
                ks=np.asarray(scal[3:6], np.float32), ns=float(scal[6]),
                map_kd=mk.value.decode() or None,
                map_ks=ms.value.decode() or None,
                map_ns=mn.value.decode() or None))
        meshes = []
        info = (ctypes.c_int32 * 3)()
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        for i in range(lib.evplp_obj_num_meshes(h)):
            lib.evplp_obj_mesh_info(h, i, info)
            mat, nv, nt = int(info[0]), int(info[1]), int(info[2])
            pos = np.empty((nv, 3), np.float32)
            tex = np.empty((nv, 2), np.float32)
            idx = np.empty((nt, 3), np.int32)
            lib.evplp_obj_mesh_fill(h, i, pos.ctypes.data_as(fp),
                                    tex.ctypes.data_as(fp),
                                    idx.ctypes.data_as(ip))
            meshes.append(ObjMesh(material=mat, positions=pos,
                                  texcoords=tex, indices=idx))
        return meshes, materials
    finally:
        lib.evplp_obj_free(h)
