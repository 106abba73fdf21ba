"""Path tracing with MIS next-event estimation (counterpart of the JAX
package's `integrators/pt.py`).

One frame: the primary hits come from the G-buffer pass, then `num_bounces`
wavefront steps over all pixels with masked lanes.  At every vertex:

  * next-event estimation of the area light with balance-heuristic MIS
    between the light-area and the BRDF strategies, traced as one any-hit
    shadow segment (lanes whose unoccluded contribution is exactly zero are
    not traced);
  * one extension ray (closest hit) along a lobe-selected BRDF sample;
  * emitter hits of the extension ray weighted by MIS against NEE;
  * Russian roulette from vertex 1 on, with the reference's 0.98 floor.

Directly visible emission is not added here: the composite overlays the
light image.  Vertex 0 is peeled (no roulette); its shadow segment runs
from the light sample to the surface, as the JAX package's frame loop
traces it; from vertex 1 on the extension ray and the segment share the
vertex as origin (`closest_and_segment`).

RNG: all of vertex v's decisions are counter draws on (global pixel id ^
seed0, PT tag, v ^ seed1), a pure function of global ids, so any split of
the pixels draws the same numbers (`pixel_offset`).
"""
from __future__ import annotations

import torch

from evplp_tpu_torch.core import brdf
from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.core import rng
from evplp_tpu_torch.core.light import light_pdf_a, light_sample
from evplp_tpu_torch.core.sampling import uniform_not_one
from evplp_tpu_torch.integrators.gbuffer import GBuffer
from evplp_tpu_torch.scene.scene import SceneData
from evplp_tpu_torch.scene.textures import fetch_hit_shading
from evplp_tpu_torch.trace.intersect import (Hit, closest_and_segment,
                                             intersect_closest,
                                             occluded_segment)

PT_TAG = 0x50545052      # 'PTPR' stream tag
# extension rays: t in (EXT_T_MIN, EXT_T_MAX) while the path is alive
EXT_T_MIN = 1e-5
EXT_T_MAX = 3.0e38


def _emit_profile(light_n, to_prev, exponent):
    """Emitter directional term (exp + 2) / (2 pi) cos^exp."""
    return brdf.phong_eval_f(light_n, to_prev, light_n, exponent)


def _nee_terms(scene: SceneData, position, normal, inc, kd, ks, ns,
               attenuation, chose_l, p_l, l_pos, l_n, l_pdf, l_val):
    """Unoccluded NEE contribution of the sampled light point, computed
    before the shadow trace so that lanes with a zero contribution are not
    traced.  The lobe choice (chose_l) picks the BRDF and its 1/p factor."""
    to_light = l_pos - position
    to_light_n = mu.normalize(to_light)

    g = mu.geometry_term(normal, l_n, to_light)
    emit = _emit_profile(l_n, -to_light_n, scene.light.intensity[3])

    w_l = mu.balance_heuristic(l_pdf, brdf.lambert_pdf_a(normal, l_n,
                                                         to_light))
    f_l = kd * brdf.lambert_eval_f(to_light_n, inc, normal)
    c_l = (w_l * g * emit / torch.clamp_min(p_l, 1e-8))[:, None] * l_val * f_l

    w_p = mu.balance_heuristic(
        l_pdf, brdf.phong_pdf_a(normal, l_n, to_light, inc, ks, ns))
    f_p = brdf.phong_eval(to_light_n, inc, normal, ks, ns)
    c_p = (w_p * g * emit / torch.clamp_min(1.0 - p_l, 1e-8))[:, None] \
        * l_val * f_p

    return torch.where(chose_l[:, None], c_l, c_p) * attenuation


def _ext_t_max(ext_active):
    return torch.where(ext_active, EXT_T_MAX, 0.0).to(torch.float32)


def _process_hit(scene, prev_position, direction, brdf_pdf_w, attenuation,
                 active, hit: Hit, result):
    """Shade the closest hits of an extension batch: MIS-weighted emission
    into `result`, plus the next vertex's surface state."""
    prim = torch.clamp_min(hit.prim, 0).long()
    hit_ok = active & hit.valid
    next_position = prev_position + hit.t[:, None] * direction
    kd, ks, ns, geom_n, is_light_row = fetch_hit_shading(
        scene, prim, hit.u, hit.v)

    backface = mu.dot(geom_n, direction) > 0.0
    hit_ok = hit_ok & ~backface

    is_light = is_light_row & hit_ok
    to_prev = mu.normalize(prev_position - next_position)
    v = next_position - prev_position
    pdf_w2a = torch.clamp_min(-mu.dot(geom_n, mu.normalize(v)), 0.0) / \
        torch.clamp_min(mu.dot(v, v), 1e-20)
    w_emit = mu.balance_heuristic(brdf_pdf_w * pdf_w2a,
                                  light_pdf_a(scene.light))
    emission = (w_emit * _emit_profile(geom_n, to_prev,
                                       scene.light.intensity[3]))[:, None] \
        * attenuation * scene.light.intensity[None, :3]
    result = result + torch.where(is_light[:, None], emission, 0.0)

    surface = hit_ok & ~is_light & ~brdf.is_black(kd, ks)
    return result, next_position, geom_n, to_prev, kd, ks, ns, surface


def _pt_vertex_draws(c0, s1, vert: int):
    """The 7 per-pixel uniforms of vertex `vert`: lobe select, 3 NEE light
    draws, 2 BRDF-lobe draws, roulette; two pcg4d calls."""
    c2 = vert ^ s1
    u_sel, n0, n1, n2 = rng.uniform4(c0, PT_TAG, c2, 0)
    l0, l1, u_rr, _ = rng.uniform4(c0, PT_TAG, c2, 1)
    return (u_sel, torch.stack([n0, n1, n2], dim=-1),
            torch.stack([l0, l1], dim=-1), u_rr)


def render_pt_frame(scene: SceneData, gbuf: GBuffer, key: torch.Tensor,
                    num_bounces: int, pixel_offset: int = 0) -> torch.Tensor:
    """One 1-spp path-traced frame over all pixels; returns (N, 3) radiance
    without directly visible emission.  key is the sample's threefry key;
    pixel_offset is the global id of gbuf's first pixel."""
    n = gbuf.position.shape[0]
    dev = gbuf.position.device
    cam_pos = torch.tensor(scene.camera.origin, dtype=torch.float32,
                           device=dev)
    s0, s1 = rng.seeds_from_key(key.to(dev))
    pix = (torch.arange(n, dtype=torch.int64, device=dev)
           + pixel_offset) & rng.MASK32
    c0 = pix ^ s0

    result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    position, normal = gbuf.position, gbuf.normal
    inc = mu.normalize(cam_pos[None, :] - position)
    active = (gbuf.stencil > 0.0) & ~brdf.is_black(gbuf.kd, gbuf.ks)

    # ---- vertex 0 (peeled: no roulette) ----
    u_sel, u3, u_lobe, _ = _pt_vertex_draws(c0, s1, 0)
    p_l = brdf.p_select_lambert(gbuf.kd, gbuf.ks)
    u_sel = uniform_not_one(u_sel)
    chose_l = u_sel < p_l
    l_pos, l_n, l_pdf, l_val = light_sample(scene.light, u3)
    direction, brdf_pdf_w, attenuation, _ = brdf.sample_combined(
        u_sel, u_lobe, inc, normal, normal, gbuf.kd, gbuf.ks, gbuf.ns)
    contrib = _nee_terms(scene, position, normal, inc, gbuf.kd, gbuf.ks,
                         gbuf.ns, torch.ones_like(position), chose_l, p_l,
                         l_pos, l_n, l_pdf, l_val)
    nee_live = active & torch.any(contrib != 0.0, dim=1)
    hit = intersect_closest(scene.tris, scene.bvh, position, direction,
                            t_min=EXT_T_MIN, t_max=_ext_t_max(active))
    occluded = occluded_segment(scene.tris, scene.bvh, l_pos, position,
                                eps=1e-4, live=nee_live)
    result = result + torch.where((nee_live & ~occluded)[:, None], contrib,
                                  0.0)

    # ---- vertices 1 .. num_bounces - 1: shade the hit, then NEE and the
    # extension ray from the new vertex ----
    prev_position = position
    for vert in range(1, num_bounces):
        result, position, geom_n, inc, kd, ks, ns, surface = _process_hit(
            scene, prev_position, direction, brdf_pdf_w, attenuation, active,
            hit, result)
        u_sel, u3, u_lobe, u_rr = _pt_vertex_draws(c0, s1, vert)
        p_l = brdf.p_select_lambert(kd, ks)
        u_sel = uniform_not_one(u_sel)
        chose_l = u_sel < p_l
        l_pos, l_n, l_pdf, l_val = light_sample(scene.light, u3)
        new_dir, new_pdf, lobe_w, _ = brdf.sample_combined(
            u_sel, u_lobe, inc, geom_n, geom_n, kd, ks, ns)
        attenuation_new = attenuation * lobe_w
        russian = brdf.russian_prob_path(attenuation_new)
        ext_active = surface & (u_rr < russian)

        contrib = _nee_terms(scene, position, geom_n, inc, kd, ks, ns,
                             attenuation, chose_l, p_l, l_pos, l_n, l_pdf,
                             l_val)
        nee_live = surface & torch.any(contrib != 0.0, dim=1)
        attenuation = torch.where(
            ext_active[:, None],
            attenuation_new / torch.clamp_min(russian, 1e-8)[:, None],
            attenuation)
        hit, occluded = closest_and_segment(
            scene.tris, scene.bvh, position, new_dir, EXT_T_MIN,
            _ext_t_max(ext_active), l_pos, seg_eps=1e-5, seg_live=nee_live)
        result = result + torch.where((nee_live & ~occluded)[:, None],
                                      contrib, 0.0)
        direction = torch.where(ext_active[:, None], new_dir, direction)
        brdf_pdf_w = torch.where(ext_active, new_pdf, brdf_pdf_w)
        prev_position = torch.where(ext_active[:, None], position,
                                    prev_position)
        active = ext_active

    # ---- final vertex: emission only ----
    result, *_ = _process_hit(scene, prev_position, direction, brdf_pdf_w,
                              attenuation, active, hit, result)
    return result
