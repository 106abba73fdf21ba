"""Device scene (counterpart of the JAX package's `scene/scene.py`).

Triangles in BVH order (slot order above 2048 triangles), one packed
shading row per triangle, the flattened BVH and the single area light, as
tensors on one device.  `scene_arrays` / `scene_from_arrays` convert to and
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
    # ks_layer, ns_layer, 0, 0]; layers are -1 (no textures yet)
    tri_shade: torch.Tensor   # (T, 16) f32
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
_LIGHT_KEYS = ("v0", "v1", "v2", "cdf", "area", "intensity")


def scene_from_arrays(arrays: dict, device="cuda") -> SceneData:
    """SceneData from numpy arrays keyed as `scene_arrays` writes them:
    v0/e1/e2/n, tri_shade, the node_* and pk_* arrays, bvh_rpl,
    bvh_fused_nodes, light_<field>, and the
    camera (cam_origin, cam_look_at, cam_up, cam_fovy, cam_aspect) plus
    bounding_radius and total_area."""
    def t(x):
        return torch.as_tensor(np.array(x), device=device)

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
                camera: Camera, device="cuda") -> SceneData:
    """Assemble a SceneData from per-mesh host arrays.  Mesh i has the
    constant material (kd, ks, ns).  The light mesh is appended with black
    material and is_light set: it blocks rays like any geometry, and its
    area counts in total_area and the bounding radius, as in the reference."""
    v0s, v1s, v2s, kds, kss, nss, lights = [], [], [], [], [], [], []

    def add_mesh(pos, idx, kd, ks, ns, is_light):
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

    for pos, idx, kd, ks, ns in zip(positions_list, indices_list, kd_list,
                                    ks_list, ns_list):
        add_mesh(pos, idx, kd, ks, ns, False)
    add_mesh(light_positions, light_indices, np.zeros(3), np.zeros(3), 0.0,
             True)
    v0, v1, v2 = (np.concatenate(x) for x in (v0s, v1s, v2s))
    kd, ks, ns = (np.concatenate(x) for x in (kds, kss, nss))
    is_light = np.concatenate(lights)

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
    shade[:, 11:14] = -1.0

    light = light_arrays(np.asarray(light_positions, np.float32),
                         np.asarray(light_indices, np.int64),
                         np.asarray(light_intensity, np.float32))
    arrays = dict(v0=v0, e1=e1, e2=e2, n=n.astype(np.float32),
                  tri_shade=shade, **node_arrays,
                  **{"light_" + k: v for k, v in light.items()},
                  cam_origin=camera.origin, cam_look_at=camera.look_at,
                  cam_up=camera.up, cam_fovy=camera.fovy,
                  cam_aspect=camera.aspect,
                  bounding_radius=bounding_radius, total_area=total_area)
    return scene_from_arrays(arrays, device)


def fetch_hit_shading(scene: SceneData, prim: torch.Tensor):
    """(kd, ks, ns, normal, is_light) of the hit triangles, from one gather
    of the shading rows."""
    row = scene.tri_shade[prim]
    return (row[:, 0:3], row[:, 3:6], row[:, 6], row[:, 8:11],
            row[:, 7] > 0.5)
