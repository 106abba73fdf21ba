"""Primary visibility pass (counterpart of the JAX package's
`integrators/gbuffer.py`).

One closest-hit ray per pixel fills the reference's deferred G-buffer
channels (position + stencil, geometric normal, kd, ks + exponent) and the
emitter-visibility channel: the primary hit is on the light mesh.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from evplp_tpu_torch.scene.scene import SceneData, fetch_hit_shading
from evplp_tpu_torch.trace.intersect import intersect_closest


@dataclass(frozen=True)
class GBuffer:
    """Flat per-pixel SoA of length H*W (row 0 = image top)."""
    position: torch.Tensor   # (N, 3)
    normal: torch.Tensor     # (N, 3)
    kd: torch.Tensor         # (N, 3)
    ks: torch.Tensor         # (N, 3)
    ns: torch.Tensor         # (N,)
    stencil: torch.Tensor    # (N,) 1.0 where any geometry (incl. emitter)
    hit_light: torch.Tensor  # (N,) bool, the primary hit is the emitter


def trace_gbuffer(scene: SceneData, width: int, height: int,
                  jitter_ndc=None) -> GBuffer:
    """Trace the primary rays and gather shading data.  The emitter carries
    black material, so downstream estimators give zero there."""
    o, d = scene.camera.generate_rays(width, height, jitter_ndc,
                                      device=scene.device)
    hit = intersect_closest(scene.tris, scene.bvh, o, d, t_min=1e-4)
    valid = hit.valid
    prim = torch.clamp_min(hit.prim, 0).long()
    position = o + hit.t[:, None] * d
    kd, ks, ns, normal, is_light = fetch_hit_shading(scene, prim)
    v3 = valid[:, None]
    return GBuffer(
        position=torch.where(v3, position, 0.0),
        normal=torch.where(v3, normal, 0.0),
        kd=torch.where(v3, kd, 0.0),
        ks=torch.where(v3, ks, 0.0),
        ns=torch.where(valid, ns, 0.0),
        stencil=valid.to(torch.float32),
        hit_light=is_light & valid)


def zero_gbuffer(n: int, device="cuda") -> GBuffer:
    """The never-rendered G-buffer (run.deferredShading off): stencil 0
    everywhere, so every estimator gives black."""
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
    z1 = torch.zeros((n,), dtype=torch.float32, device=device)
    return GBuffer(position=z3, normal=z3, kd=z3, ks=z3, ns=z1, stencil=z1,
                   hit_light=torch.zeros((n,), dtype=torch.bool,
                                         device=device))


def light_image(scene: SceneData, gbuf: GBuffer) -> torch.Tensor:
    """Emitter pass: the unpremultiplied intensity where the emitter is
    directly visible."""
    raw_rgb = scene.light.intensity[:3] / torch.pi
    return torch.where(gbuf.hit_light[:, None], raw_rgb[None, :], 0.0)
