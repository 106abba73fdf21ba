"""Light / photon tracing (counterpart of the JAX package's
`integrators/light_trace.py`).

Traces `num_paths` light subpaths of `num_records` vertices each
(numMaxBounces + 1) into a (P, B) photon map:

  vertex 0        = sample on the emitter (usable as VPL only),
  vertices 1..B-2 = surface hits (usable as VPL and photon),
  vertex  B-1     = last surface hit (usable as photon only),
  flags == 0      = the path ended before this vertex.

The flux stored at a vertex is the flux arriving there, before Russian
roulette and the local BRDF.  Random numbers are the JAX package's threefry
draws, keyed per global path id and draw site, so both packages trace the
same paths.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from evplp_tpu_torch.core import brdf, rng
from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.core.light import light_sample
from evplp_tpu_torch.core.sampling import uniform_not_one
from evplp_tpu_torch.scene.scene import SceneData
from evplp_tpu_torch.scene.textures import fetch_hit_shading
from evplp_tpu_torch.trace.intersect import intersect_closest

FLAG_VPL = 1
FLAG_PHOTON = 2
FLAG_LAMBERT_ONLY = 4
FLAG_PHONG_ONLY = 8


@dataclass(frozen=True)
class PhotonMap:
    """(P, B) SoA of light-path vertex records."""
    pos: torch.Tensor        # (P, B, 3)
    normal: torch.Tensor     # (P, B, 3)
    flux: torch.Tensor       # (P, B, 3) arriving flux
    flux_dir: torch.Tensor   # (P, B, 3) direction the flux arrived FROM
    kd: torch.Tensor         # (P, B, 3)
    ks: torch.Tensor         # (P, B, 3)
    ns: torch.Tensor         # (P, B)
    p_select: torch.Tensor   # (P, B) lambert-lobe selection probability
    flags: torch.Tensor      # (P, B) int32

    def map(self, fn) -> "PhotonMap":
        """Apply fn to every field."""
        return PhotonMap(*(fn(getattr(self, f.name)) for f in fields(self)))


def zero_photon_map(num_paths: int, num_records: int, device="cuda") -> PhotonMap:
    """All-flags-zero map (run.lightTracing off): no usable record."""
    f32 = dict(dtype=torch.float32, device=device)
    z3 = torch.zeros((num_paths, num_records, 3), **f32)
    z1 = torch.zeros((num_paths, num_records), **f32)
    return PhotonMap(pos=z3, normal=z3, flux=z3, flux_dir=z3, kd=z3, ks=z3,
                     ns=z1, p_select=z1,
                     flags=torch.zeros((num_paths, num_records),
                                       dtype=torch.int32, device=device))


def trace_light_paths(scene: SceneData, key: torch.Tensor, num_paths: int,
                      num_records: int, path_offset: int = 0) -> PhotonMap:
    """Trace the light subpaths (num_records >= 2) of global ids
    path_offset .. path_offset + num_paths - 1.  Path i draws from
    fold_in(key, i), then one fold_in per draw site, so any split of the
    ids into blocks (one a shard) traces the same paths."""
    p = num_paths
    dev = scene.device
    exp = scene.light.intensity[3]
    ids = torch.arange(path_offset, path_offset + p, dtype=torch.int64,
                       device=dev)
    pkeys = rng.fold_in(key.to(dev), ids)

    def pdraw(tag: int, width: int | None = None):
        shape = () if width is None else (width,)
        return rng.uniform(rng.fold_in(pkeys, tag), shape)

    pos0, n0, _, flux0 = light_sample(scene.light, pdraw(0, 3))
    # emission through PhongSample(in=normal, n=normal, ks=1, exp=w): a
    # power-cosine lobe around the normal
    ones3 = torch.ones((p, 3), dtype=torch.float32, device=dev)
    direction, _, att = brdf.phong_sample(pdraw(1, 2), n0, n0, ones3, exp)
    flux = flux0 * att
    position = pos0
    active = torch.ones((p,), dtype=torch.bool, device=dev)

    recs = []
    for b in range(1, num_records):
        last = b == num_records - 1
        # dead paths get an empty interval and are never traced
        hit = intersect_closest(scene.tris, scene.bvh, position, direction,
                                t_min=1e-4,
                                t_max=torch.where(active, 3.0e38, 0.0))
        prim = torch.clamp_min(hit.prim, 0).long()
        next_pos = position + hit.t[:, None] * direction
        kd, ks, ns, geom_n, is_light = fetch_hit_shading(
            scene, prim, hit.u, hit.v)

        # rejections: backface, emitter, black material
        ok = active & hit.valid
        ok = ok & (mu.dot(geom_n, direction) <= 0.0)
        ok = ok & ~is_light
        ok = ok & ~brdf.is_black(kd, ks)

        p_l = brdf.p_select_lambert(kd, ks)
        u_sel = uniform_not_one(pdraw(3 * b))
        chose_l = u_sel < p_l
        base_flag = FLAG_PHOTON if last else FLAG_VPL | FLAG_PHOTON

        # RR on the arriving flux; the lobe bit is set whenever RR survives,
        # also on the last vertex, whose sampled direction is never traced
        russian = brdf.russian_prob_light(flux)
        survive = pdraw(3 * b + 2) < russian
        lobe_flag = torch.where(chose_l, FLAG_LAMBERT_ONLY, FLAG_PHONG_ONLY)
        flags = torch.where(ok, torch.where(survive, base_flag | lobe_flag,
                                            base_flag), 0).to(torch.int32)
        okc = ok[:, None]
        recs.append(dict(
            pos=torch.where(okc, next_pos, 0.0),
            normal=torch.where(okc, geom_n, 0.0),
            flux=torch.where(okc, flux, 0.0),
            flux_dir=torch.where(okc, -direction, 0.0),
            kd=torch.where(okc, kd, 0.0),
            ks=torch.where(okc, ks, 0.0),
            ns=torch.where(ok, ns, 0.0),
            p_select=torch.where(ok, p_l, 0.0),
            flags=flags))

        flux_rr = flux / torch.clamp_min(russian, 1e-8)[:, None]
        new_dir, _, lobe_w, _ = brdf.sample_combined(
            u_sel, pdraw(3 * b + 1, 2), -direction, geom_n, geom_n, kd, ks, ns)
        new_active = ok & survive & (not last)
        na = new_active[:, None]
        flux = torch.where(na, flux_rr * lobe_w, flux)
        direction = torch.where(na, new_dir, direction)
        position = torch.where(na, next_pos, position)
        active = new_active

    def with_v0(first, name):
        return torch.stack([first] + [r[name] for r in recs], dim=1)

    f32 = dict(dtype=torch.float32, device=dev)
    return PhotonMap(
        pos=with_v0(pos0, "pos"),
        normal=with_v0(n0, "normal"),
        flux=with_v0(flux0, "flux"),
        flux_dir=with_v0(n0, "flux_dir"),
        kd=with_v0(torch.zeros((p, 3), **f32), "kd"),
        ks=with_v0(ones3, "ks"),
        ns=with_v0(exp.expand(p), "ns"),
        p_select=with_v0(torch.zeros((p,), **f32), "p_select"),
        flags=with_v0(torch.full((p,), FLAG_VPL, dtype=torch.int32,
                                 device=dev), "flags"))
