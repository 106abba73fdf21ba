"""LVC (light vertex cache) VPL gather (counterpart of the JAX package's
`integrators/lvc.py`).

Unlike the plain VPL gather, each pixel draws a random window start into
the whole light-path pool and gathers numVplLightPaths consecutive paths
(mod numLightPaths) from there, so every step of the gather reads
per-pixel records and casts one shadow segment a pixel from a different
light vertex: traffic that is incoherent across a warp.  The steps run
path-major, record-minor, accumulating in that order.
"""
from __future__ import annotations

import torch

from evplp_tpu_torch.core import brdf, rng
from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.integrators.gbuffer import GBuffer
from evplp_tpu_torch.integrators.light_trace import FLAG_VPL, PhotonMap
from evplp_tpu_torch.scene.scene import SceneData
from evplp_tpu_torch.trace.intersect import occluded_segment

RECORD_FIELDS = ("pos", "normal", "flux", "flux_dir", "kd", "ks", "ns",
                 "p_select", "flags")
_HEURISTICS = {1: mu.balance_heuristic, 2: mu.max_heuristic,
               3: mu.power_heuristic2}


def _lvc_pre(gbuf: GBuffer, rec: dict) -> torch.Tensor:
    """The pairs worth a shadow segment: facing each other, on geometry,
    with a usable record."""
    v12 = rec["pos"] - gbuf.position
    ucos1 = torch.clamp_min(mu.dot(gbuf.normal, v12), 0.0)
    ucos2 = torch.clamp_min(-mu.dot(rec["normal"], v12), 0.0)
    usable = (rec["flags"] & FLAG_VPL) != 0
    return ((ucos1 * ucos2) > 0.0) & (gbuf.stencil > 0.0) & usable


def _lvc_contribution(scene: SceneData, gbuf: GBuffer, rec: dict,
                      mis_mode: int, pdf_mc, clamping_value,
                      wi10) -> torch.Tensor:
    """The VPL splat with per-pixel records (every rec field is (N, ...)):
    (N, 3).  Culled pairs cast no shadow segment."""
    v12 = rec["pos"] - gbuf.position
    ucos1 = torch.clamp_min(mu.dot(gbuf.normal, v12), 0.0)
    ucos2 = torch.clamp_min(-mu.dot(rec["normal"], v12), 0.0)
    pre = _lvc_pre(gbuf, rec)
    occ = occluded_segment(scene.tris, scene.bvh, rec["pos"], gbuf.position,
                           eps=1e-4, live=pre)

    d2 = torch.clamp_min(mu.dot(v12, v12), 1e-20)
    wi12 = v12 * torch.rsqrt(d2)[:, None]
    f2 = (rec["kd"] * mu.INV_PI
          + rec["ks"] * brdf.phong_eval_f(-wi12, rec["flux_dir"],
                                          rec["normal"], rec["ns"])[:, None])
    f1 = (gbuf.kd * mu.INV_PI
          + gbuf.ks * brdf.phong_eval_f(wi10, wi12, gbuf.normal,
                                        gbuf.ns)[:, None])
    g21 = ucos1 * ucos2 / (d2 * d2)
    flux = rec["flux"]

    if mis_mode == 0:
        out = flux * f1 * f2 * g21[:, None]
    elif mis_mode in _HEURISTICS:
        pdf_de = (
            brdf.lambert_pdf_a(rec["normal"], gbuf.normal, -v12)
            * rec["p_select"]
            + brdf.phong_pdf_a(rec["normal"], gbuf.normal, -v12,
                               rec["flux_dir"], rec["ks"], rec["ns"])
            * (1.0 - rec["p_select"]))
        out = (_HEURISTICS[mis_mode](pdf_mc, pdf_de)[:, None] * flux * f1
               * f2 * g21[:, None])
    elif mis_mode == 4:
        out = flux * torch.minimum(g21, clamping_value)[:, None] * f1 * f2
    elif mis_mode == 5:
        out = flux * torch.minimum(g21[:, None] * f1 * f2, clamping_value)
    else:
        raise ValueError(f"unknown misMode {mis_mode}")
    return torch.where((pre & ~occ)[:, None], out, 0.0)


def lvc_offsets(key: torch.Tensor, n: int, num_paths: int) -> torch.Tensor:
    """Each pixel's window start into the path pool: (n,) int64."""
    u = torch.clamp_max(rng.uniform(key, (n,)), 0.999999)
    return (u * num_paths).to(torch.int32).long()


def lvc_gather(scene: SceneData, gbuf: GBuffer, pm: PhotonMap,
               key: torch.Tensor, mis_mode: int, pdf_mc, clamping_value,
               num_vpl_paths: int, offsets=None) -> torch.Tensor:
    """The frame's LVC image (N, 3), divided by num_vpl_paths: at step
    (i, j) pixel p gathers record j of path (offsets[p] + i) mod
    numLightPaths, the window starts drawn from key (lvc_offsets) unless
    given (a shard passes its rows' slice of the whole film's starts).
    pdf_mc and clamping_value are 0-d float32 tensors."""
    n = gbuf.position.shape[0]
    num_paths, num_records = pm.pos.shape[:2]
    cam = torch.tensor(scene.camera.origin, dtype=torch.float32,
                       device=gbuf.position.device)
    wi10 = mu.normalize(cam[None, :] - gbuf.position)
    if offsets is None:
        offsets = lvc_offsets(key.to(gbuf.position.device), n, num_paths)
    flat = pm.map(lambda x: x.reshape((-1,) + x.shape[2:]))
    acc = torch.zeros_like(gbuf.position)
    for i in range(num_vpl_paths):
        first = ((offsets + i) % num_paths) * num_records
        for j in range(num_records):
            rec = {k: getattr(flat, k)[first + j] for k in RECORD_FIELDS}
            acc = acc + _lvc_contribution(scene, gbuf, rec, mis_mode, pdf_mc,
                                          clamping_value, wi10)
    return acc / float(num_vpl_paths)
