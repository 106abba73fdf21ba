"""Pinhole camera and its linear animation (counterpart of the JAX
package's `scene/camera.py`).

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
                      device="cuda", row_start: int = 0,
                      row_count: int | None = None):
        """Primary rays through pixel centres, shifted by the optional (2,)
        NDC jitter, for the film or its band of rows [row_start,
        row_start + row_count).  Returns (origins (R*W, 3), directions
        (R*W, 3)), R = row_count (default height)."""
        origin, fwd, right, upv = self.basis(device)
        tan_half_fovy = math.tan(self.fovy * 0.5)
        tan_half_fovx = tan_half_fovy * self.aspect
        f32 = dict(dtype=torch.float32, device=device)
        xs = (torch.arange(width, **f32) + 0.5) / width * 2.0 - 1.0
        rows = height if row_count is None else row_count
        ys = 1.0 - (torch.arange(row_start, row_start + rows, **f32)
                    + 0.5) / height * 2.0
        ndc_x = xs.repeat(rows)
        ndc_y = ys.repeat_interleave(width)
        if jitter_ndc is not None:
            ndc_x = ndc_x - jitter_ndc[0]
            ndc_y = ndc_y - jitter_ndc[1]
        d = (fwd[None, :]
             + (ndc_x * tan_half_fovx)[:, None] * right[None, :]
             + (ndc_y * tan_half_fovy)[:, None] * upv[None, :])
        d = mu.normalize(d)
        return origin.expand_as(d), d


@dataclass(frozen=True)
class AnimationCamera:
    """Linear interpolation between two cameras (the JAX package's
    AnimationCamera; reference: RtAnimationCamera, rtcommon.h:600-629,
    present in the reference but unused by its main).

    at(time_ms) returns the Camera lerped at time_ms / total_time_ms,
    clamped to [0, 1]; fovy is lerped, the start camera's aspect kept."""
    start: Camera
    end: Camera
    total_time_ms: float

    def at(self, time_ms: float) -> Camera:
        s = min(max(time_ms / self.total_time_ms, 0.0), 1.0)

        def lerp(a, b):
            return tuple(av * (1 - s) + bv * s for av, bv in zip(a, b))

        return Camera(
            origin=lerp(self.start.origin, self.end.origin),
            look_at=lerp(self.start.look_at, self.end.look_at),
            up=lerp(self.start.up, self.end.up),
            fovy=self.start.fovy * (1 - s) + self.end.fovy * s,
            aspect=self.start.aspect)
