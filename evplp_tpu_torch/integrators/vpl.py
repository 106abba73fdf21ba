"""VPL gather (counterpart of the JAX package's `integrators/vpl.py`).

Every usable VPL record is gathered at every pixel, with one shadow segment
per (record, pixel) pair; pairs that face away, hit the sky or use an
unusable record are culled before tracing.  Records are processed in chunks
so that at most SEGMENTS_PER_CHUNK segments exist at once.

misMode: 0 one (unweighted), 1 balance / 2 max / 3 power2 against the
photon-mapping density pdf_mc, 4 geometryClamp min(G, b), 5
geometryBrdfClamp min(G f1 f2, b).  Modes 4/5 are the clamped estimators
whose missing energy the photon splat adds back.
"""
from __future__ import annotations

import torch

from evplp_tpu_torch.core import brdf
from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.integrators.gbuffer import GBuffer
from evplp_tpu_torch.integrators.light_trace import FLAG_VPL, PhotonMap
from evplp_tpu_torch.scene.scene import SceneData
from evplp_tpu_torch.trace.intersect import occluded_segment

SEGMENTS_PER_CHUNK = 1 << 24
_HEURISTICS = {1: mu.balance_heuristic, 2: mu.max_heuristic,
               3: mu.power_heuristic2}


def vpl_chunk_contribution(scene: SceneData, gbuf: GBuffer, rec: dict,
                           mis_mode: int, pdf_mc, clamping_value, wi10):
    """Contribution of a chunk of C records to every pixel: (N, 3).
    rec fields are (C, 3) / (C,) tensors."""
    n = gbuf.position.shape[0]
    c = rec["pos"].shape[0]
    pos_px = gbuf.position[:, None, :]          # (N, 1, 3)
    n_px = gbuf.normal[:, None, :]
    v12 = rec["pos"][None, :, :] - pos_px       # (N, C, 3)
    ucos1 = torch.clamp_min(mu.dot(n_px, v12), 0.0)
    ucos2 = torch.clamp_min(-mu.dot(rec["normal"][None, :, :], v12), 0.0)
    cull = (ucos1 * ucos2) > 0.0

    # record-major segments (each run shares one origin); culled pairs are
    # never traced
    usable = ((rec["flags"] & FLAG_VPL) != 0)[None, :]
    pretest = cull & (gbuf.stencil > 0.0)[:, None] & usable       # (N, C)
    seg_from = rec["pos"][:, None, :].expand(c, n, 3).reshape(-1, 3)
    seg_to = gbuf.position[None, :, :].expand(c, n, 3).reshape(-1, 3)
    occ = occluded_segment(scene.tris, scene.bvh, seg_from, seg_to,
                           eps=1e-4, live=pretest.T.reshape(-1))
    occ = occ.reshape(c, n).T

    d2 = torch.clamp_min(mu.dot(v12, v12), 1e-20)
    wi12 = v12 * torch.rsqrt(d2)[..., None]
    # dual BRDF evals; the Lambert kernel is the unconditional 1/pi
    f2 = (rec["kd"][None, :, :] * mu.INV_PI
          + rec["ks"][None, :, :]
          * brdf.phong_eval_f(-wi12, rec["flux_dir"][None, :, :],
                              rec["normal"][None, :, :],
                              rec["ns"][None, :])[..., None])
    f1 = (gbuf.kd[:, None, :] * mu.INV_PI
          + gbuf.ks[:, None, :]
          * brdf.phong_eval_f(wi10[:, None, :], wi12, n_px,
                              gbuf.ns[:, None])[..., None])
    g21 = ucos1 * ucos2 / (d2 * d2)
    flux = rec["flux"][None, :, :]

    if mis_mode == 0:
        out = flux * f1 * f2 * g21[..., None]
    elif mis_mode in _HEURISTICS:
        pdf_de = (
            brdf.lambert_pdf_a(rec["normal"][None, :, :], n_px, -v12)
            * rec["p_select"][None, :]
            + brdf.phong_pdf_a(rec["normal"][None, :, :], n_px, -v12,
                               rec["flux_dir"][None, :, :],
                               rec["ks"][None, :, :], rec["ns"][None, :])
            * (1.0 - rec["p_select"][None, :]))
        w = _HEURISTICS[mis_mode](pdf_mc, pdf_de)
        out = w[..., None] * flux * f1 * f2 * g21[..., None]
    elif mis_mode == 4:
        out = flux * torch.minimum(g21, clamping_value)[..., None] * f1 * f2
    elif mis_mode == 5:
        out = flux * torch.minimum(g21[..., None] * f1 * f2, clamping_value)
    else:
        raise ValueError(f"unknown misMode {mis_mode}")

    keep = pretest & ~occ
    return torch.sum(torch.where(keep[..., None], out, 0.0), dim=1)


def vpl_gather(scene: SceneData, gbuf: GBuffer, pm: PhotonMap, mis_mode: int,
               pdf_mc, clamping_value, num_vpl_paths: int,
               chunk: int | None = None) -> torch.Tensor:
    """Gather the first num_vpl_paths light paths' records over all pixels.
    Returns the frame's VPL image (N, 3), divided by num_vpl_paths.
    pdf_mc and clamping_value are 0-d float32 tensors."""
    flat = pm.map(lambda x: x[:num_vpl_paths].reshape((-1,) + x.shape[2:]))
    n = gbuf.position.shape[0]
    if chunk is None:
        chunk = max(1, SEGMENTS_PER_CHUNK // max(n, 1))
    cam = torch.tensor(scene.camera.origin, dtype=torch.float32,
                       device=gbuf.position.device)
    wi10 = mu.normalize(cam[None, :] - gbuf.position)
    acc = torch.zeros_like(gbuf.position)
    num_recs = flat.pos.shape[0]
    for s in range(0, num_recs, chunk):
        rec = {k: getattr(flat, k)[s:s + chunk]
               for k in ("pos", "normal", "flux", "flux_dir", "kd", "ks",
                         "ns", "p_select", "flags")}
        acc = acc + vpl_chunk_contribution(scene, gbuf, rec, mis_mode, pdf_mc,
                                           clamping_value, wi10)
    return acc / float(num_vpl_paths)
