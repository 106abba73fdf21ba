"""Area-light sampling (counterpart of the JAX package's `core/light.py`).

One mesh area light per scene.  Intensity RGB is premultiplied by pi at
load; intensity.w is the emitter's power-cosine exponent.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.core.sampling import sample_cdf


@dataclass(frozen=True)
class AreaLight:
    """v0/v1/v2: (T, 3) vertices; cdf: (T,) inclusive normalized area CDF;
    area: () total area; intensity: (4,) pi-premultiplied RGB + exponent."""
    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    cdf: torch.Tensor
    area: torch.Tensor
    intensity: torch.Tensor


def light_arrays(vertices: np.ndarray, indices: np.ndarray,
                 intensity_rgb_exp) -> dict:
    """Host-side light construction: per-triangle area CDF + pi-premultiply,
    as numpy arrays keyed like AreaLight's fields."""
    v0 = vertices[indices[:, 0]].astype(np.float32)
    v1 = vertices[indices[:, 1]].astype(np.float32)
    v2 = vertices[indices[:, 2]].astype(np.float32)
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    total = float(areas.sum())
    cdf = np.cumsum(areas) / total
    cdf[-1] = 1.0
    premult = np.asarray(intensity_rgb_exp, dtype=np.float32).copy()
    premult[:3] *= np.pi
    return dict(v0=v0, v1=v1, v2=v2, cdf=cdf.astype(np.float32),
                area=np.asarray(total, np.float32), intensity=premult)


def area_light_from_arrays(arrays: dict, device) -> AreaLight:
    return AreaLight(**{k: torch.as_tensor(np.array(arrays[k]),
                                           device=device)
                        for k in ("v0", "v1", "v2", "cdf", "area",
                                  "intensity")})


def light_sample(light: AreaLight, u3: torch.Tensor):
    """Uniform-area position sample.  u3: (..., 3) uniforms.  Returns
    (position, normal, pdf_a, emitted = intensity_rgb * area)."""
    tri = sample_cdf(light.cdf, u3[..., 0])
    p0, p1, p2 = light.v0[tri], light.v1[tri], light.v2[tri]
    beta, gamma = mu.square_to_barycentric(u3[..., 1:3])
    position = (p0 * beta[..., None] + p1 * gamma[..., None]
                + p2 * (1.0 - beta - gamma)[..., None])
    normal = mu.normalize(mu.cross(p1 - p0, p2 - p0))
    pdf_a = torch.broadcast_to(1.0 / light.area, tri.shape)
    emitted = torch.broadcast_to(light.intensity[:3] * light.area,
                                 position.shape)
    return position, normal, pdf_a, emitted


def light_pdf_a(light: AreaLight) -> torch.Tensor:
    """Uniform-area pdf 1/area."""
    return 1.0 / light.area
