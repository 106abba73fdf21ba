"""Texture support (counterpart of the JAX package's `scene/textures.py`).

map_Kd / map_Ks / map_Ns images are loaded 8-bit, flipped vertically (row
0 = v = 0), used linearly, deduplicated by path, and sampled bilinearly
at texel centres with REPEAT wrap.  All layers are padded to the pool's
largest extent in one (L, TH, TW, 3) float32 tensor beside their true
(h, w).  PNGs are decoded by `utils/png.py` (zlib only).
"""
from __future__ import annotations

import numpy as np
import torch

from evplp_tpu_torch.utils.png import read_png_rgb


class TexturePoolBuilder:
    """Host-side accumulation of texture layers, deduplicated by path."""

    def __init__(self):
        self.images: list[np.ndarray] = []
        self.by_path: dict[str, int] = {}

    def add_file(self, path: str) -> int:
        if path not in self.by_path:
            img = read_png_rgb(path).astype(np.float32) / 255.0
            # vertical flip: row 0 = v = 0 (bottom)
            self.by_path[path] = self.add_image(img[::-1])
        return self.by_path[path]

    def add_image(self, img: np.ndarray) -> int:
        self.images.append(np.ascontiguousarray(img, dtype=np.float32))
        return len(self.images) - 1

    def build(self):
        """-> (data (L, TH, TW, 3) f32, sizes (L, 2) i32 as (h, w)); the
        empty pool is one 1x1 black layer."""
        if not self.images:
            return (np.zeros((1, 1, 1, 3), np.float32),
                    np.ones((1, 2), np.int32))
        th = max(i.shape[0] for i in self.images)
        tw = max(i.shape[1] for i in self.images)
        data = np.zeros((len(self.images), th, tw, 3), np.float32)
        sizes = np.zeros((len(self.images), 2), np.int32)
        for l, img in enumerate(self.images):
            h, w = img.shape[:2]
            data[l, :h, :w] = img
            sizes[l] = (h, w)
        return data, sizes


def sample_bilinear(tex_data: torch.Tensor, tex_size: torch.Tensor,
                    layer: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup at texel centres with REPEAT wrap, batched.

    tex_data: (L, TH, TW, 3); tex_size: (L, 2) (h, w); layer: (R,) int
    (>= 0); uv: (R, 2) normalized, v up (the flipped storage)."""
    h = tex_size[layer, 0].to(torch.float32)
    w = tex_size[layer, 1].to(torch.float32)
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def wrap(i, n):
        return torch.remainder(i.to(torch.int32),
                               torch.clamp_min(n.to(torch.int32), 1)).long()

    layer = layer.long()
    x0i, x1i = wrap(x0, w), wrap(x0 + 1, w)
    y0i, y1i = wrap(y0, h), wrap(y0 + 1, h)
    c00 = tex_data[layer, y0i, x0i]
    c10 = tex_data[layer, y0i, x1i]
    c01 = tex_data[layer, y1i, x0i]
    c11 = tex_data[layer, y1i, x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def hit_uv(scene, prim, bary_u, bary_v):
    """Texture coordinates of hits on triangles prim at barycentrics
    (bary_u, bary_v): (R, 2)."""
    uv0 = scene.tri_uv0[prim]
    return (uv0 + bary_u[:, None] * (scene.tri_uv1[prim] - uv0)
            + bary_v[:, None] * (scene.tri_uv2[prim] - uv0))


def _no_textures(scene) -> bool:
    return scene.tex_data.shape[0] == 1 and scene.tex_data.shape[1] == 1


def _pick(scene, layer, const, uv, scalar=False):
    """The texture of layer where layer >= 0, else const."""
    tex = sample_bilinear(scene.tex_data, scene.tex_size,
                          torch.clamp_min(layer, 0), uv)
    if scalar:
        return torch.where(layer >= 0, tex[:, 0], const)
    return torch.where((layer >= 0)[:, None], tex, const)


def fetch_kd(scene, prim, bary_u, bary_v) -> torch.Tensor:
    """Lambert reflectance at a hit: the map_Kd texture where the triangle
    has one, its constant kd elsewhere.  prim: (R,) clamped triangle ids;
    bary_u / bary_v: Moller-Trumbore barycentrics (weights of e1 / e2)."""
    row = scene.tri_shade[prim]
    if _no_textures(scene):
        return row[:, 0:3]
    return _pick(scene, row[:, 11].to(torch.int32), row[:, 0:3],
                 hit_uv(scene, prim, bary_u, bary_v))


def fetch_hit_shading(scene, prim, bary_u, bary_v):
    """(kd, ks, ns, normal, is_light) at a hit batch, from one gather of
    the shading rows; the map_Kd / map_Ks / map_Ns textures overlay the
    constants (map_Ns through its red channel).  With no texture in the
    scene the texture gathers are skipped."""
    row = scene.tri_shade[prim]
    kd, ks, ns = row[:, 0:3], row[:, 3:6], row[:, 6]
    normal, is_light = row[:, 8:11], row[:, 7] > 0.5
    if _no_textures(scene):
        return kd, ks, ns, normal, is_light
    uv = hit_uv(scene, prim, bary_u, bary_v)
    layers = row[:, 11:14].to(torch.int32)
    return (_pick(scene, layers[:, 0], kd, uv),
            _pick(scene, layers[:, 1], ks, uv),
            _pick(scene, layers[:, 2], ns, uv, scalar=True), normal,
            is_light)


def fetch_material(scene, prim, bary_u, bary_v):
    """(kd, ks, ns) at a hit; see fetch_hit_shading."""
    return fetch_hit_shading(scene, prim, bary_u, bary_v)[:3]
