"""Wavefront OBJ + MTL loading, host side (counterpart of the JAX
package's `scene/objloader.py`).

Fan triangulation, one mesh per usemtl run, vertices de-indexed per
(position, texcoord) pair, constant Ns divided by 4 (the Assimp shininess
fixup the reference bakes in), map_Kd / map_Ks / map_Ns paths kept in the
material, and a black default material in slot 0.  The parse runs in the
native C++ loader (`native/obj_native.py`) unless asked not to; this
module's Python loop is the fallback and the reference for it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ObjMaterial:
    name: str
    kd: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    ks: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    ns: float = 0.0
    map_kd: str | None = None
    map_ks: str | None = None
    map_ns: str | None = None


@dataclass
class ObjMesh:
    """One material run of triangles."""
    material: int
    positions: np.ndarray  # (V, 3)
    texcoords: np.ndarray  # (V, 2)
    indices: np.ndarray    # (T, 3) into positions / texcoords


def parse_mtl(path: str) -> dict[str, ObjMaterial]:
    mats: dict[str, ObjMaterial] = {}
    cur: ObjMaterial | None = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = ObjMaterial(name=parts[1] if len(parts) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur.kd = np.asarray([float(v) for v in parts[1:4]], np.float32)
            elif key == "Ks":
                cur.ks = np.asarray([float(v) for v in parts[1:4]], np.float32)
            elif key == "Ns":
                cur.ns = float(parts[1]) / 4.0
            elif key == "map_Kd":
                cur.map_kd = parts[-1]
            elif key == "map_Ks":
                cur.map_ks = parts[-1]
            elif key == "map_Ns":
                cur.map_ns = parts[-1]
    return mats


def load_obj(path: str, native: str = "auto"):
    """Returns (meshes: list[ObjMesh], materials: list[ObjMaterial]).
    Vertices are de-indexed per (position, texcoord) pair per mesh, as the
    reference's importer does, so vertex order matches it.

    native: "auto" parses with the native loader and falls back to the
    Python loop if it cannot be built or loaded; "1" requires the native
    loader (its failure raises); "0" runs the Python loop.  A missing file
    raises FileNotFoundError either way."""
    if native != "0":
        try:
            from evplp_tpu_torch.native import obj_native
            return obj_native.load(path)
        except FileNotFoundError:
            raise
        except Exception:
            if native == "1":
                raise
    positions: list[list[float]] = []
    texcoords: list[list[float]] = []
    materials: list[ObjMaterial] = [ObjMaterial(name="__default__")]
    mat_index: dict[str, int] = {}
    runs: list[tuple[int, list]] = []
    cur_mat = 0
    cur_faces: list = []

    def flush():
        nonlocal cur_faces
        if cur_faces:
            runs.append((cur_mat, cur_faces))
            cur_faces = []

    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(v) for v in parts[1:4]])
            elif key == "vt":
                texcoords.append([float(v) for v in parts[1:3]])
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(parts[1:]))
                if os.path.exists(mtl_path):
                    for name, mat in parse_mtl(mtl_path).items():
                        mat_index[name] = len(materials)
                        materials.append(mat)
            elif key == "usemtl":
                flush()
                cur_mat = mat_index.get(parts[1] if len(parts) > 1 else "", 0)
            elif key == "f":
                verts = []
                for token in parts[1:]:
                    comps = token.split("/")
                    vi = int(comps[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = -1
                    if len(comps) > 1 and comps[1]:
                        t = int(comps[1])
                        ti = t - 1 if t > 0 else len(texcoords) + t
                    verts.append((vi, ti))
                for k in range(1, len(verts) - 1):
                    cur_faces.append((verts[0], verts[k], verts[k + 1]))
    flush()

    pos_arr = np.asarray(positions, np.float32).reshape(-1, 3)
    tex_arr = np.asarray(texcoords, np.float32).reshape(-1, 2)
    meshes: list[ObjMesh] = []
    for mat, faces in runs:
        vert_map: dict[tuple[int, int], int] = {}
        mesh_pos: list = []
        mesh_tex: list = []
        tris = np.zeros((len(faces), 3), np.int32)
        for fi, face in enumerate(faces):
            for ci, vk in enumerate(face):
                idx = vert_map.get(vk)
                if idx is None:
                    idx = len(mesh_pos)
                    vert_map[vk] = idx
                    mesh_pos.append(pos_arr[vk[0]])
                    mesh_tex.append(tex_arr[vk[1]] if vk[1] >= 0
                                    else np.zeros(2, np.float32))
                tris[fi, ci] = idx
        meshes.append(ObjMesh(
            material=mat,
            positions=np.asarray(mesh_pos, np.float32).reshape(-1, 3),
            texcoords=np.asarray(mesh_tex, np.float32).reshape(-1, 2),
            indices=tris))
    return meshes, materials
