"""Pinhole camera (counterpart of the JAX package's `scene/camera.py`).

JSON "direction" is the look-at POINT.  fovx converts to fovy through
2 atan(tan(fovx/2)/aspect).  Film convention: row 0 is the image top.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from evplp_tpu_torch.core import mathutil as mu


@dataclass(frozen=True)
class Camera:
    origin: tuple
    look_at: tuple
    up: tuple
    fovy: float      # radians
    aspect: float    # width / height

    @staticmethod
    def from_json(json_cam: dict, aspect: float) -> "Camera":
        if "fovy" in json_cam:
            fovy = math.radians(float(json_cam["fovy"]))
        elif "fovx" in json_cam:
            fovx = math.radians(float(json_cam["fovx"]))
            fovy = 2.0 * math.atan2(math.tan(fovx * 0.5), aspect)
        else:
            raise ValueError("camera needs fovy or fovx")
        return Camera(
            origin=tuple(float(v) for v in json_cam["origin"]),
            look_at=tuple(float(v) for v in json_cam["direction"]),
            up=tuple(float(v) for v in json_cam["up"]),
            fovy=fovy, aspect=aspect)

    def basis(self, device):
        """(origin, fwd, right, up) float32 tensors; fwd faces the scene."""
        f32 = dict(dtype=torch.float32, device=device)
        origin = torch.tensor(self.origin, **f32)
        fwd = mu.normalize(torch.tensor(self.look_at, **f32) - origin)
        right = mu.normalize(mu.cross(fwd, torch.tensor(self.up, **f32)))
        upv = mu.cross(right, fwd)
        return origin, fwd, right, upv

    def generate_rays(self, width: int, height: int, jitter_ndc=None,
                      device="cuda"):
        """Primary rays through pixel centres, shifted by the optional (2,)
        NDC jitter.  Returns (origins (H*W, 3), directions (H*W, 3))."""
        origin, fwd, right, upv = self.basis(device)
        tan_half_fovy = math.tan(self.fovy * 0.5)
        tan_half_fovx = tan_half_fovy * self.aspect
        f32 = dict(dtype=torch.float32, device=device)
        xs = (torch.arange(width, **f32) + 0.5) / width * 2.0 - 1.0
        ys = 1.0 - (torch.arange(height, **f32) + 0.5) / height * 2.0
        ndc_x = xs.repeat(height)
        ndc_y = ys.repeat_interleave(width)
        if jitter_ndc is not None:
            ndc_x = ndc_x - jitter_ndc[0]
            ndc_y = ndc_y - jitter_ndc[1]
        d = (fwd[None, :]
             + (ndc_x * tan_half_fovx)[:, None] * right[None, :]
             + (ndc_y * tan_half_fovy)[:, None] * upv[None, :])
        d = mu.normalize(d)
        return origin.expand_as(d), d
