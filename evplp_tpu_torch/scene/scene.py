"""Device scene (counterpart of the JAX package's `scene/scene.py`).

Triangles in BVH order (slot order above 2048 triangles), one packed
shading row per triangle, per-corner texture coordinates, the texture
pool, the flattened BVH and the single area light, as tensors on one
device.  `scene_arrays` / `scene_from_arrays` convert to and
from a dict of numpy arrays, which is how the tests hand the JAX package's
scene to the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from evplp_tpu_torch.accel.bvh import (BVH, NODE_KEYS, PACKED_KEYS, build_bvh,
                                      bvh_from_arrays)
from evplp_tpu_torch.core.light import (AreaLight, area_light_from_arrays,
                                        light_arrays)
from evplp_tpu_torch.scene.camera import Camera

# scenes above this many triangles get 42-triangle leaves (3 slot rows)
# and are marked fused_nodes, as the JAX package builds them
BIG_SCENE_TRIS = 280_000


@dataclass(frozen=True)
class Triangles:
    """v0: (T, 3); e1 = v1 - v0; e2 = v2 - v0; n: (T, 3) unit geometric
    normal normalize(cross(e1, e2))."""
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n: torch.Tensor


@dataclass(frozen=True)
class SceneData:
    tris: Triangles
    bvh: BVH
    # packed per-triangle shading row [kd3, ks3, ns, is_light, n3, kd_layer,
    # ks_layer, ns_layer, 0, 0]; a layer of -1 is the constant
    tri_shade: torch.Tensor   # (T, 16) f32
    tri_uv0: torch.Tensor     # (T, 2) texcoords of the three corners
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tex_data: torch.Tensor    # (L, TH, TW, 3) texture pool (scene/textures)
    tex_size: torch.Tensor    # (L, 2) int32 per-layer (h, w)
    light: AreaLight
    camera: Camera
    bounding_radius: float    # half bbox diagonal
    total_area: float         # sum of all triangle areas

    @property
    def num_triangles(self) -> int:
        return self.tris.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tris.v0.device


_TRI_KEYS = ("v0", "e1", "e2", "n")
_UV_KEYS = ("tri_uv0", "tri_uv1", "tri_uv2")
_LIGHT_KEYS = ("v0", "v1", "v2", "cdf", "area", "intensity")


def scene_from_arrays(arrays: dict, device="cuda") -> SceneData:
    """SceneData from numpy arrays keyed as `scene_arrays` writes them:
    v0/e1/e2/n, tri_shade, tri_uv0/1/2, tex_data, tex_size, the node_* and
    pk_* arrays, bvh_rpl, bvh_fused_nodes, light_<field>, and the
    camera (cam_origin, cam_look_at, cam_up, cam_fovy, cam_aspect) plus
    bounding_radius and total_area.  Without texture keys the scene has
    zero texcoords and the empty pool (one 1x1 black layer)."""
    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    num_tris = np.asarray(arrays["v0"]).shape[0]
    uv = {k: np.asarray(arrays.get(k, np.zeros((num_tris, 2))), np.float32)
          for k in _UV_KEYS}
    tex_data = np.asarray(arrays.get("tex_data", np.zeros((1, 1, 1, 3))),
                          np.float32)
    tex_size = np.asarray(arrays.get("tex_size", np.ones((1, 2))), np.int32)

    camera = Camera(
        origin=tuple(float(v) for v in arrays["cam_origin"]),
        look_at=tuple(float(v) for v in arrays["cam_look_at"]),
        up=tuple(float(v) for v in arrays["cam_up"]),
        fovy=float(arrays["cam_fovy"]), aspect=float(arrays["cam_aspect"]))
    return SceneData(
        tris=Triangles(*(t(np.asarray(arrays[k], np.float32))
                         for k in _TRI_KEYS)),
        bvh=bvh_from_arrays(arrays, device),
        tri_shade=t(np.asarray(arrays["tri_shade"], np.float32)),
        **{k: t(v) for k, v in uv.items()},
        tex_data=t(tex_data), tex_size=t(tex_size),
        light=area_light_from_arrays(
            {k: arrays["light_" + k] for k in _LIGHT_KEYS}, device),
        camera=camera,
        bounding_radius=float(arrays["bounding_radius"]),
        total_area=float(arrays["total_area"]))


def scene_arrays(scene: SceneData) -> dict:
    """The inverse of scene_from_arrays."""
    out = {k: getattr(scene.tris, k).cpu().numpy() for k in _TRI_KEYS}
    out.update({k: getattr(scene.bvh, k).cpu().numpy()
                for k in NODE_KEYS + PACKED_KEYS})
    out.update(bvh_rpl=scene.bvh.rpl, bvh_fused_nodes=scene.bvh.fused_nodes)
    out["tri_shade"] = scene.tri_shade.cpu().numpy()
    out.update({k: getattr(scene, k).cpu().numpy()
                for k in _UV_KEYS + ("tex_data", "tex_size")})
    out.update({"light_" + k: getattr(scene.light, k).cpu().numpy()
                for k in _LIGHT_KEYS})
    cam = scene.camera
    out.update(cam_origin=np.asarray(cam.origin), cam_look_at=np.asarray(
        cam.look_at), cam_up=np.asarray(cam.up), cam_fovy=cam.fovy,
        cam_aspect=cam.aspect, bounding_radius=scene.bounding_radius,
        total_area=scene.total_area)
    return out


def build_scene(positions_list, indices_list, kd_list, ks_list, ns_list,
                light_positions, light_indices, light_intensity,
                camera: Camera, device="cuda", uv_list=None,
                kd_layer_list=None, ks_layer_list=None, ns_layer_list=None,
                tex_data=None, tex_size=None) -> SceneData:
    """Assemble a SceneData from per-mesh host arrays.  Mesh i has the
    constant material (kd, ks, ns), per-vertex texcoords uv_list[i] (zeros
    if absent) and texture layers kd/ks/ns_layer_list[i] into the pool
    (tex_data, tex_size) (-1: the constant; no pool: the empty one).  The
    light mesh is appended with black material and is_light set: it blocks
    rays like any geometry, and its area counts in total_area and the
    bounding radius, as in the reference."""
    v0s, v1s, v2s, kds, kss, nss, lights = [], [], [], [], [], [], []
    uvs, layer_rows = ([], [], []), []

    def add_mesh(pos, idx, kd, ks, ns, is_light, uv=None, layers=(-1,) * 3):
        pos = np.asarray(pos, np.float32).reshape(-1, 3)
        idx = np.asarray(idx, np.int64).reshape(-1, 3)
        t = idx.shape[0]
        v0s.append(pos[idx[:, 0]])
        v1s.append(pos[idx[:, 1]])
        v2s.append(pos[idx[:, 2]])
        kds.append(np.broadcast_to(np.asarray(kd, np.float32), (t, 3)))
        kss.append(np.broadcast_to(np.asarray(ks, np.float32), (t, 3)))
        nss.append(np.full((t,), ns, np.float32))
        lights.append(np.full((t,), is_light, bool))
        if uv is None:
            uv = np.zeros((pos.shape[0], 2), np.float32)
        uv = np.asarray(uv, np.float32).reshape(-1, 2)
        for c in range(3):
            uvs[c].append(uv[idx[:, c]])
        layer_rows.append(np.broadcast_to(np.asarray(layers, np.int32),
                                          (t, 3)))

    def per_mesh(values, i, default):
        return default if values is None else values[i]

    for i, (pos, idx) in enumerate(zip(positions_list, indices_list)):
        add_mesh(pos, idx, kd_list[i], ks_list[i], ns_list[i], False,
                 per_mesh(uv_list, i, None),
                 tuple(per_mesh(x, i, -1) for x in (
                     kd_layer_list, ks_layer_list, ns_layer_list)))
    add_mesh(light_positions, light_indices, np.zeros(3), np.zeros(3), 0.0,
             True)
    v0, v1, v2 = (np.concatenate(x) for x in (v0s, v1s, v2s))
    kd, ks, ns = (np.concatenate(x) for x in (kds, kss, nss))
    is_light = np.concatenate(lights)
    uv0, uv1, uv2 = (np.concatenate(x) for x in uvs)
    layers = np.concatenate(layer_rows)

    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total_area = float(areas.sum())
    bb_min = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    bb_max = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
    bounding_radius = float(np.linalg.norm(bb_max - bb_min) * 0.5)

    big = v0.shape[0] > BIG_SCENE_TRIS
    node_arrays, order = build_bvh(v0, v1, v2, leaf_size=42 if big else 14,
                                   fused_nodes=big)
    valid = order >= 0
    oi = np.maximum(order, 0)

    def take(x, pad=0.0):
        y = np.array(x[oi])
        y[~valid] = pad
        return y

    v0, v1, v2 = take(v0), take(v1), take(v2)
    kd, ks, ns = take(kd), take(ks), take(ns)
    is_light = take(is_light, False)
    uv0, uv1, uv2 = take(uv0), take(uv1), take(uv2)
    layers = take(layers, -1)
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)

    shade = np.zeros((v0.shape[0], 16), np.float32)
    shade[:, 0:3] = kd
    shade[:, 3:6] = ks
    shade[:, 6] = ns
    shade[:, 7] = is_light.astype(np.float32)
    shade[:, 8:11] = n
    shade[:, 11:14] = layers
    if tex_data is None:
        tex_data = np.zeros((1, 1, 1, 3), np.float32)
        tex_size = np.ones((1, 2), np.int32)

    light = light_arrays(np.asarray(light_positions, np.float32),
                         np.asarray(light_indices, np.int64),
                         np.asarray(light_intensity, np.float32))
    arrays = dict(v0=v0, e1=e1, e2=e2, n=n.astype(np.float32),
                  tri_shade=shade, tri_uv0=uv0, tri_uv1=uv1, tri_uv2=uv2,
                  tex_data=tex_data, tex_size=tex_size, **node_arrays,
                  **{"light_" + k: v for k, v in light.items()},
                  cam_origin=camera.origin, cam_look_at=camera.look_at,
                  cam_up=camera.up, cam_fovy=camera.fovy,
                  cam_aspect=camera.aspect,
                  bounding_radius=bounding_radius, total_area=total_area)
    return scene_from_arrays(arrays, device)

