"""Virtual Spherical Lights gather (counterpart of the JAX package's
`integrators/vsl.py`; reference lighttracing.cu:382-722, enabled by
forceVsl + vslRadiusPercentage).

Per (pixel, VSL record) pair: one shadow segment, then a Monte Carlo
integral over the cone the sphere of radius vsl_radius subtends, with
3-strategy MIS (uniform cone, eye-side BRDF, light-side BRDF) and the
reference's adaptive sample count numSamples = int(halfCone*200/pi) + 1.

Records go in groups of TRACE_GROUP: one record-major shadow trace per
group, then the group's sample loops in one call of
`vsl_kernel.vsl_sample_group` (the Hopper kernel on CUDA tensors, its plain
version on CPU tensors).  The sample draws are pcg4d counters on
(pixel_id ^ seed0, rec_id, s ^ seed1, tag): a pure function of global ids,
so every pixel order and grouping draws the same numbers.

Reference quirks kept for estimator parity:
  * MIS weights use the CUDA LambertPdfW *without* the 1/pi factor
    (rtmaterial.cuh:40-44),
  * pdfBrdf2's lambert term is weighted by the *shading point's*
    pSelectLambert, and in sampleCone/sampleBrdf1 the phong term of pdfBrdf2
    is NOT multiplied by (1 - pSelect) (lighttracing.cu:440-441,515-516).
"""
from __future__ import annotations

import torch

from evplp_tpu_torch.core import brdf, rng
from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.integrators import vsl_kernel
from evplp_tpu_torch.integrators.gbuffer import GBuffer
from evplp_tpu_torch.integrators.light_trace import FLAG_VPL, PhotonMap
from evplp_tpu_torch.scene.scene import SceneData
from evplp_tpu_torch.trace.intersect import occluded_segment

TRACE_GROUP = 8          # records per record-major shadow trace and kernel call
RECORD_FIELDS = ("pos", "normal", "flux", "flux_dir", "kd", "ks", "ns",
                 "p_select", "flags")


def _combined_eval_f(out, inc, n, kd, ks, ns):
    return (kd * mu.INV_PI
            + ks * brdf.phong_eval_f(out, inc, n, ns)[..., None])


def _pdf_brdf1(n, wi12, wi10, ks, ns, p_l):
    return (brdf.lambert_pdf_w_nopi(n, wi12) * p_l
            + brdf.phong_pdf_w(n, wi12, wi10, ks, ns) * (1.0 - p_l))


def _pdf_brdf2(rec, wi12, p_l_shading):
    """lighttracing.cu:440-441: the lambert term uses the SHADING point's
    pSelectLambert; the phong term is unweighted (reference quirk)."""
    return (brdf.lambert_pdf_w_nopi(rec["normal"], -wi12) * p_l_shading
            + brdf.phong_pdf_w(rec["normal"], -wi12, rec["flux_dir"],
                               rec["ks"], rec["ns"]))


def _group_occlusion(scene: SceneData, screen_pos, screen_normal,
                     screen_stencil, recs) -> torch.Tensor:
    """Gates (G, N) = pre-cull & ~occluded for a group of G records.

    The pre-cull is the reference's cos1*cos2 > 1e-9 on normalized cosines,
    written on the unnormalized products (ucos1*ucos2 = cos1*cos2*d2); the
    surviving pairs go through one record-major shadow trace (each run of N
    segments shares one origin)."""
    g, n = recs["pos"].shape[0], screen_pos.shape[0]
    v12 = recs["pos"][:, None, :] - screen_pos[None, :, :]        # (G, N, 3)
    ucos1 = torch.clamp_min(mu.dot(screen_normal[None], v12), 0.0)
    ucos2 = torch.clamp_min(-mu.dot(recs["normal"][:, None, :], v12), 0.0)
    d2 = torch.clamp_min(mu.dot(v12, v12), 1e-20)
    pre = (((ucos1 * ucos2) > 1e-9 * d2)
           & (screen_stencil > 0.0)[None, :]
           & ((recs["flags"] & FLAG_VPL) != 0)[:, None])
    seg_from = recs["pos"][:, None, :].expand(g, n, 3).reshape(-1, 3)
    seg_to = screen_pos[None].expand(g, n, 3).reshape(-1, 3)
    occ = occluded_segment(scene.tris, scene.bvh, seg_from, seg_to,
                           eps=1e-4, live=pre.reshape(-1)).reshape(g, n)
    return pre & ~occ


def _record_ctx(pix: dict, rec_pos, cos_half, num_samples, gate, wi10) -> dict:
    """Per-(record, pixel) sampling quantities.  pix holds the pixels'
    pos, n, kd, ks (N, 3) and ns (N,); rec_pos is (3,) or (G, 1, 3), and
    cos_half, num_samples, gate are (N,) or (G, N) accordingly."""
    v12 = rec_pos - pix["pos"]
    d2 = torch.clamp_min(mu.dot(v12, v12), 1e-20)
    dist = torch.sqrt(d2)
    solid_angle = 2.0 * torch.pi * (1.0 - cos_half)
    return dict(pix,
                nv12=v12 / dist[..., None],
                gate=gate,
                cos_half=cos_half,
                solid_angle=solid_angle,
                inv_sa=1.0 / torch.clamp_min(solid_angle, 1e-12),
                num_samples=num_samples,
                p_l=brdf.p_select_lambert(pix["kd"], pix["ks"]),
                black1=brdf.is_black(pix["kd"], pix["ks"]),
                wi10=wi10)


def _sample_step(rec, ctx, rng_ctx, flux, black2, acc, s: int,
                 observe=None):
    """One MC sample of the 3-strategy MIS estimator over the pixels.

    rng_ctx = (seed0, seed1, pixel_ids, rec_id): the 8 uniforms of this
    sample are two pcg4d draws on (pixel_id ^ seed0, rec_id, s ^ seed1,
    tag).  rec fields are (3,)/() for one record or (G, 1, 3)/(G, 1) for a
    group, broadcasting against the ctx's (N, ...) or (G, N, ...).
    observe, if given, is called with the sample's boolean masks: `live`
    (a gated pair's sample within its count), each strategy's guard
    (`cone`, `eye_brdf`, `light_brdf`) and the lobe each BRDF strategy
    chose (`eye_lambert`, `light_lambert`)."""
    nv12 = ctx["nv12"]
    cos_half = ctx["cos_half"]
    solid_angle = ctx["solid_angle"]
    inv_sa = ctx["inv_sa"]
    p_l = ctx["p_l"]
    black1 = ctx["black1"]
    wi10 = ctx["wi10"]
    n, kd, ks, ns = ctx["n"], ctx["kd"], ctx["ks"], ctx["ns"]
    rn, rdir = rec["normal"], rec["flux_dir"]

    seed0, seed1, pixel_ids, rec_id = rng_ctx
    c0 = pixel_ids.to(torch.int64) ^ seed0
    c2 = s ^ seed1
    u0, u1, u2, u3 = rng.uniform4(c0, rec_id, c2, 0)
    u4, u5, u6, u7 = rng.uniform4(c0, rec_id, c2, 1)

    # ---- strategy 1: uniform cone (lighttracing.cu:395-446) ----
    local = mu.square_to_cone(torch.stack([u0, u1], dim=-1), cos_half)
    w12c = mu.normalize(mu.from_local(local, nv12))
    cc = (torch.clamp_min(mu.dot(n, w12c), 0.0)
          * torch.clamp_min(-mu.dot(rn, w12c), 0.0))
    f2 = _combined_eval_f(-w12c, rdir, rn, rec["kd"], rec["ks"], rec["ns"])
    f1 = _combined_eval_f(wi10, w12c, n, kd, ks, ns)
    pdf_b1 = _pdf_brdf1(n, w12c, wi10, ks, ns, p_l)
    pdf_b2 = _pdf_brdf2(rec, w12c, p_l)
    w_cone = inv_sa / torch.clamp_min(pdf_b1 + pdf_b2 + inv_sa, 1e-20)
    c_cone = flux * (cc * solid_angle)[..., None] * f1 * f2
    cone = (cc > 1e-9) & ~black1
    c_cone = torch.where(cone[..., None], w_cone[..., None] * c_cone, 0.0)

    # ---- strategy 2: eye-side BRDF sampling (:448-521) ----
    w12b, _, lobe_w1, eye_lambert = brdf.sample_combined(
        torch.clamp_max(u2, 0.999999), torch.stack([u3, u4], dim=-1), wi10,
        n, n, kd, ks, ns)
    in_cone1 = mu.dot(w12b, nv12) > cos_half
    cos1b = torch.clamp_min(mu.dot(n, w12b), 0.0)
    cos2b = torch.clamp_min(-mu.dot(rn, w12b), 0.0)
    f2b = _combined_eval_f(-w12b, rdir, rn, rec["kd"], rec["ks"], rec["ns"])
    pdf_b1b = _pdf_brdf1(n, w12b, wi10, ks, ns, p_l)
    pdf_b2b = _pdf_brdf2(rec, w12b, p_l)
    w_b1 = pdf_b1b / torch.clamp_min(pdf_b1b + pdf_b2b + inv_sa, 1e-20)
    c_b1 = flux * cos2b[..., None] * lobe_w1 * f2b
    eye_brdf = in_cone1 & (cos1b > 1e-9) & ~black1
    c_b1 = torch.where(eye_brdf[..., None], w_b1[..., None] * c_b1, 0.0)

    # ---- strategy 3: light-side BRDF sampling (:523-594) ----
    w21, _, lobe_w2, light_lambert = brdf.sample_combined(
        torch.clamp_max(u5, 0.999999), torch.stack([u6, u7], dim=-1), rdir,
        rn, rn, rec["kd"], rec["ks"], rec["ns"])
    in_cone2 = -mu.dot(w21, nv12) > cos_half
    cos2c = torch.clamp_min(mu.dot(rn, w21), 0.0)
    f1c = _combined_eval_f(wi10, -w21, n, kd, ks, ns)
    pdf_b1c = _pdf_brdf1(n, -w21, wi10, ks, ns, p_l)
    # sampleBrdf2's weight block uses the shading-point pSelect again and
    # the unweighted phong term, the same quirk (:584-589)
    pdf_b2c = (brdf.lambert_pdf_w_nopi(rn, w21) * p_l
               + brdf.phong_pdf_w(rn, w21, rdir, rec["ks"], rec["ns"]))
    w_b2 = pdf_b2c / torch.clamp_min(pdf_b1c + pdf_b2c + inv_sa, 1e-20)
    c_b2 = flux * cos2c[..., None] * lobe_w2 * f1c
    light_brdf = in_cone2 & (cos2c > 1e-8) & ~black1 & ~black2
    c_b2 = torch.where(light_brdf[..., None], w_b2[..., None] * c_b2, 0.0)

    use = s < ctx["num_samples"]
    if observe is not None:
        observe(live=use & ctx["gate"], cone=cone, eye_brdf=eye_brdf,
                light_brdf=light_brdf, eye_lambert=eye_lambert,
                light_lambert=light_lambert)
    return acc + torch.where(use[..., None], c_cone + c_b1 + c_b2, 0.0)


def _sample_loop(rec, ctx, rng_ctx, flux, black2,
                 observe=None) -> torch.Tensor:
    """The sample loop to the largest gated count, each pixel masked by its
    own count; returns the gated estimates divided by each count.  observe:
    see _sample_step."""
    num = ctx["num_samples"]
    s_needed = min(int(torch.where(ctx["gate"], num, 0).max()),
                   vsl_kernel.MAX_VSL_SAMPLES)
    acc = torch.zeros(num.shape + (3,), dtype=torch.float32,
                      device=num.device)
    for s in range(s_needed):
        acc = _sample_step(rec, ctx, rng_ctx, flux, black2, acc, s, observe)
    out = acc / torch.clamp_min(num.to(torch.float32), 1.0)[..., None]
    return torch.where(ctx["gate"][..., None], out, 0.0)


def _sample_record(gbuf: GBuffer, rec: dict, gate, rng_ctx, vsl_radius,
                   vsl_inv_pi_r2, wi10) -> torch.Tensor:
    """Sampling of one VSL record against all pixels: (N, 3).

    rng_ctx = (seed0, seed1, pixel_ids, rec_id) with the seeds as uint32
    ints.  vsl_radius and vsl_inv_pi_r2 are 0-d float32 tensors."""
    pix = dict(pos=gbuf.position, n=gbuf.normal, kd=gbuf.kd, ks=gbuf.ks,
               ns=gbuf.ns)
    cos_half, num = vsl_kernel.ctx_planes(gbuf.position, rec["pos"][None],
                                          vsl_radius)
    ctx = _record_ctx(pix, rec["pos"], cos_half[0], num[0], gate, wi10)
    flux = rec["flux"] * vsl_inv_pi_r2
    black2 = brdf.is_black(rec["kd"], rec["ks"])
    return _sample_loop(rec, ctx, rng_ctx, flux, black2)


def _records_of(pm: PhotonMap, num_vsl_paths: int) -> dict:
    """The first num_vsl_paths paths' records, flattened path-major."""
    return {k: getattr(pm, k)[:num_vsl_paths].reshape(
        (-1,) + getattr(pm, k).shape[2:]) for k in RECORD_FIELDS}


def vsl_gather(scene: SceneData, gbuf: GBuffer, pm: PhotonMap, key,
               vsl_radius, num_vsl_paths: int,
               pixel_offset: int = 0) -> torch.Tensor:
    """VSL pass over the first num_vsl_paths paths (splatSplotch:689-722).
    Returns the frame's VSL image (N, 3), divided by num_vsl_paths.

    key: the pass's threefry key (its words seed the draws); pixel_offset:
    global id of gbuf's first pixel."""
    dev = gbuf.position.device
    n = gbuf.position.shape[0]
    records = _records_of(pm, num_vsl_paths)
    r = torch.as_tensor(vsl_radius, dtype=torch.float32, device=dev)
    inv_pi_r2 = torch.tensor(mu.INV_PI, dtype=torch.float32,
                             device=dev) / (r * r)
    seed0, seed1 = (int(x) for x in rng.seeds_from_key(key))
    pixel_ids = pixel_offset + torch.arange(n, dtype=torch.int32, device=dev)
    cam = torch.tensor(scene.camera.origin, dtype=torch.float32, device=dev)
    wi10 = mu.normalize(cam[None, :] - gbuf.position)
    pix = vsl_kernel.pack_pixels(gbuf.position, gbuf.normal, gbuf.kd,
                                 gbuf.ks, gbuf.ns, wi10)

    # pad to a whole number of groups: flags-0 records gate to zero
    m = records["pos"].shape[0]
    pad = (-m) % TRACE_GROUP
    if pad:
        records = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                   for k, v in records.items()}
    shifts = torch.arange(TRACE_GROUP, dtype=torch.int32, device=dev)[:, None]
    acc = torch.zeros_like(gbuf.position)
    for g0 in range(0, m + pad, TRACE_GROUP):
        recs = {k: v[g0:g0 + TRACE_GROUP] for k, v in records.items()}
        gates = _group_occlusion(scene, gbuf.position, gbuf.normal,
                                 gbuf.stencil, recs)
        mask = torch.sum(gates.to(torch.int32) << shifts, dim=0,
                         dtype=torch.int32)
        cos_half, num = vsl_kernel.ctx_planes(gbuf.position, recs["pos"], r)
        acc = acc + vsl_kernel.vsl_sample_group(
            pix, pixel_ids, mask, cos_half, num,
            vsl_kernel.pack_records(recs, inv_pi_r2), seed0, seed1, g0)
    return acc / float(num_vsl_paths)
