"""Lambert + modified-Phong BRDF: eval / pdf / sample, batched over lanes
(counterpart of the JAX package's `core/brdf.py`).

Conventions: "inc" points toward the previous vertex or viewer, "out"
toward the next vertex.  Modified Phong is f = rho_s (n+2)/(2pi) cos^n
around the mirror reflection of inc, sampled with (n+1)/(2pi) cos^n.  A lobe
is "black" below EPS_REFL, and the Phong black-lobe test reads only the red
channel of ks, as the reference does.
"""
from __future__ import annotations

import torch

from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.core.mathutil import (EPS_COS, EPS_REFL, INV_PI, dot,
                                           normalize, reflect)


def lambert_eval_f(out, inc, n):
    """Scalar Lambert kernel 1/pi (no hemisphere check)."""
    del out, inc, n
    return INV_PI


def lambert_eval_checked(w_out, w_in, n):
    """1/pi only when both directions are above the surface, else 0."""
    above = (dot(w_out, n) > 0.0) & (dot(w_in, n) > 0.0)
    return torch.where(above, INV_PI, 0.0)


def lambert_pdf_w(n, v):
    """Cosine-hemisphere pdfW = max(cos, 0)/pi."""
    return torch.clamp_min(dot(n, normalize(v)), 0.0) * INV_PI


def lambert_pdf_w_nopi(n, v):
    """max(cos, 0) without the 1/pi: the reference's CUDA LambertPdfW omits
    it, and the VSL MIS weights keep that quirk."""
    return torch.clamp_min(dot(n, normalize(v)), 0.0)


def lambert_pdf_a(n1, n2, v12):
    """Area-domain cosine pdf with unnormalized v12: cos1 cos2 / d2 / pi."""
    cos1_u = torch.clamp_min(dot(n1, v12), 0.0)
    cos2_u = torch.clamp_min(-dot(n2, v12), 0.0)
    d2 = torch.clamp_min(dot(v12, v12), 1e-20)
    return cos1_u * cos2_u / (d2 * d2) * INV_PI


def lambert_sample(u2, inc, n, kd):
    """Cosine-weighted sample -> (direction, pdf_w, weight = kd)."""
    local = mu.square_to_cosine_hemisphere(u2)
    direction = mu.from_local(local, n)
    pdf_w = torch.clamp_min(dot(direction, n), 0.0) * INV_PI
    return direction, pdf_w, kd


def phong_eval(out, inc, n, ks, ns):
    """rho_s (n+2)/(2pi) cos^n around reflect(inc); zero when cos <= EPS or
    ks.x <= EPS."""
    r = reflect(-inc, n)
    c = torch.clamp_min(dot(out, r), 0.0)
    val = ks * ((ns + 2.0) * torch.pow(c, ns) * (0.5 * INV_PI))[..., None]
    ok = (c > EPS_COS) & (ks[..., 0] > EPS_REFL)
    return torch.where(ok[..., None], val, 0.0)


def phong_eval_f(out, inc, n, ns):
    """Scalar Phong kernel (n+2)/(2pi) cos^n."""
    r = reflect(-inc, n)
    c = torch.clamp_min(dot(out, r), 0.0)
    val = (ns + 2.0) * torch.pow(c, ns) * (0.5 * INV_PI)
    return torch.where(c > EPS_COS, val, 0.0)


def phong_pdf_w(n1, v12, inc, ks, ns):
    """Solid-angle pdf (n+1)/(2pi) cos^n; zero on black ks.x."""
    w12 = normalize(v12)
    r = normalize(reflect(-inc, n1))
    c = torch.clamp_min(dot(w12, r), 0.0)
    val = (ns + 1.0) * (0.5 * INV_PI) * torch.pow(c, ns)
    ok = (c > EPS_COS) & (ks[..., 0] > EPS_REFL)
    return torch.where(ok, val, 0.0)


def phong_pdf_a(n1, n2, v12, inc, ks, ns):
    """Area-domain Phong pdf: pdfW cos2 / d2."""
    w12 = normalize(v12)
    r = normalize(reflect(-inc, n1))
    c = torch.clamp_min(dot(w12, r), 0.0)
    pdf_w = (ns + 1.0) * (0.5 * INV_PI) * torch.pow(c, ns)
    cos2 = torch.clamp_min(-dot(n2, w12), 0.0)
    d2 = torch.clamp_min(dot(v12, v12), 1e-20)
    ok = (c > EPS_COS) & (ks[..., 0] > EPS_REFL)
    return torch.where(ok, pdf_w * cos2 / d2, 0.0)


def phong_sample(u2, inc, n, ks, ns):
    """Power-cosine sample around reflect(inc) -> (direction, pdf_w, weight)
    with weight = (n+2)/(n+1) max(cos_n, 0) ks; pdf zero below the surface."""
    r = reflect(-inc, n)
    local = mu.square_to_power_cosine(u2, ns)
    direction = mu.from_local(local, r)
    cos_n_unsafe = dot(direction, n)
    cos_n = torch.clamp_min(cos_n_unsafe, 0.0)
    cos_r = torch.clamp_min(dot(direction, r), 0.0)
    pdf_w = torch.where(cos_n_unsafe > 0.0,
                        (ns + 1.0) * (0.5 * INV_PI) * torch.pow(cos_r, ns),
                        0.0)
    weight = ((ns + 2.0) / (ns + 1.0) * cos_n)[..., None] * ks
    return direction, pdf_w, weight


def p_select_lambert(kd, ks):
    """Lobe-selection probability maxL/(maxL+maxP)."""
    max_l = mu.max_color(kd)
    max_p = mu.max_color(ks)
    return max_l / torch.clamp_min(max_l + max_p, 1e-20)


def is_black(kd, ks):
    """True when both lobes vanish (the reference's absorb test)."""
    return mu.max_color(kd) + mu.max_color(ks) <= EPS_REFL


def sample_combined(u_select, u2, inc, n_shading, n_geom, kd, ks, ns):
    """Lobe-select-then-sample.  Lambert is sampled around the shading
    normal, Phong around the geometric one.  Returns (direction, pdf_w,
    weight including 1/p_select, chose_lambert)."""
    p_l = p_select_lambert(kd, ks)
    chose_l = u_select < p_l
    dir_l, pdf_l, w_l = lambert_sample(u2, inc, n_shading, kd)
    dir_p, pdf_p, w_p = phong_sample(u2, inc, n_geom, ks, ns)
    direction = torch.where(chose_l[..., None], dir_l, dir_p)
    pdf_w = torch.where(chose_l, pdf_l, pdf_p)
    inv_prob = torch.where(chose_l,
                           1.0 / torch.clamp_min(p_l, 1e-8),
                           1.0 / torch.clamp_min(1.0 - p_l, 1e-8))
    weight = torch.where(chose_l[..., None], w_l, w_p) * inv_prob[..., None]
    return direction, pdf_w, weight, chose_l


def russian_prob_light(throughput):
    """Light-tracer RR: min(maxColor, 0.98)."""
    return torch.clamp_max(mu.max_color(throughput), 0.98)


def russian_prob_path(throughput):
    """Path-tracer RR: max(max(t.x, 0.98), max(t.y, t.z)), the reference's
    0.98 floor, kept for parity."""
    return torch.maximum(torch.clamp_min(throughput[..., 0], 0.98),
                         torch.maximum(throughput[..., 1], throughput[..., 2]))
