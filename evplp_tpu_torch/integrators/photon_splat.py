"""Image-space photon splatting, the EVPLP energy-compensation pass
(counterpart of the JAX package's `integrators/photon_splat.py`).

Each photon adds a disc-kernel KDE, 1/(pi r^2), to every shading point
within its radius, weighted per misMode; modes 4/5 add back exactly the
energy the VPL pass clamped away.  Photon record j pairs with its
predecessor j-1 on the same path for the incident pdf and BRDF.

`photon_splat_dense` (every photon against every pixel) is the oracle.
`photon_splat_binned` computes the same function for the frame: photons are
projected to the screen, every (photon, 16x16 screen tile) pair that the
photon's footprint touches is listed, the pairs are sorted by tile, and
chunks of pairs are evaluated densely against their tile's pixels.  No pair
is dropped, so its `dropped` count is 0.
"""
from __future__ import annotations

import math

import torch

from evplp_tpu_torch.core import brdf
from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.integrators.gbuffer import GBuffer
from evplp_tpu_torch.integrators.light_trace import FLAG_PHOTON, PhotonMap
from evplp_tpu_torch.scene.scene import SceneData

# (pairs x tile pixels) evaluated at once by the binned splat, and
# (photons x pixels) by the dense oracle
SPLAT_BLOCK_ELEMS = 1 << 22


def _photon_major(pm: PhotonMap, mis_mode: int, pdf_mc) -> dict:
    """Per-photon, pixel-independent quantities over the (P, B-1) photon
    records, flattened."""
    cur = pm.map(lambda x: x[:, 1:].reshape((-1,) + x.shape[2:]))
    prev = pm.map(lambda x: x[:, :-1].reshape((-1,) + x.shape[2:]))
    pos, n1 = cur.pos, cur.normal
    usable = (cur.flags & FLAG_PHOTON) != 0

    v12 = prev.pos - pos                      # toward the previous vertex
    d2 = torch.clamp_min(mu.dot(v12, v12), 1e-20)
    w12 = v12 * torch.rsqrt(d2)[:, None]
    # incident pdf mixture at the previous vertex
    mix_pdf_w = (brdf.lambert_pdf_w(prev.normal, -w12) * prev.p_select
                 + brdf.phong_pdf_w(prev.normal, -w12, prev.flux_dir,
                                    prev.ks, prev.ns) * (1.0 - prev.p_select))
    mix_pdf_a = mix_pdf_w * torch.clamp_min(mu.dot(n1, w12), 0.0) / d2
    # previous-vertex BRDF toward the photon
    brdf2 = (prev.kd * brdf.lambert_eval_checked(-w12, prev.flux_dir,
                                                 prev.normal)[:, None]
             + brdf.phong_eval(-w12, prev.flux_dir, prev.normal, prev.ks,
                               prev.ns))
    if mis_mode == 1:
        w = mu.balance_heuristic(mix_pdf_a, pdf_mc)
    elif mis_mode == 2:
        w = mu.max_heuristic(mix_pdf_a, pdf_mc)
    elif mis_mode == 3:
        w = mu.power_heuristic2(mix_pdf_a, pdf_mc)
    else:
        w = torch.ones_like(mix_pdf_a)
    return {"pos": pos, "flux": cur.flux, "w12": w12, "d2": d2,
            "prev_n": prev.normal, "brdf2": brdf2, "weight": w,
            "gate": usable & (mix_pdf_w > 0.0)}


def _splat_eval(ph, px_pos, px_n, px_kd, px_ks, px_ns, px_w10, px_stencil,
                r2, kde, mis_mode: int, clamping_value):
    """Per-(photon, pixel) contribution; photon and pixel fields broadcast
    against each other."""
    diff = ph["pos"] - px_pos
    inside = mu.dot(diff, diff) <= r2
    w12 = ph["w12"]
    brdf1 = (px_kd * brdf.lambert_eval_checked(px_w10, w12, px_n)[..., None]
             + brdf.phong_eval(px_w10, w12, px_n, px_ks, px_ns))
    base = ph["flux"] * kde  # flux * 1/(pi r^2) * 1/numLightPaths
    if mis_mode in (0, 1, 2, 3):
        out = brdf1 * base * ph["weight"][..., None]
    else:
        cos_cos = (torch.clamp_min(mu.dot(px_n, w12), 0.0)
                   * torch.clamp_min(-mu.dot(ph["prev_n"], w12), 0.0))
        g = cos_cos / ph["d2"]
        if mis_mode == 4:
            resid = (torch.clamp_min(g - clamping_value, 0.0)
                     / torch.clamp_min(g, 1e-20))
            out = brdf1 * base * resid[..., None]
        elif mis_mode == 5:
            num = torch.clamp_min(brdf1 * ph["brdf2"] * g[..., None]
                                  - clamping_value, 0.0)
            den = g[..., None] * ph["brdf2"]
            out = base * torch.where(den > 1e-20,
                                     num / torch.clamp_min(den, 1e-20), 0.0)
        else:
            raise ValueError(f"unknown misMode {mis_mode}")
        out = torch.where((cos_cos > 0.0)[..., None], out, 0.0)
    keep = inside & ph["gate"] & (px_stencil > 0.0)
    return torch.where(keep[..., None], out, 0.0)


def _camera_dir(scene: SceneData, gbuf: GBuffer) -> torch.Tensor:
    cam = torch.tensor(scene.camera.origin, dtype=torch.float32,
                       device=gbuf.position.device)
    return mu.normalize(cam[None, :] - gbuf.position)


def photon_splat_dense(scene: SceneData, gbuf: GBuffer, pm: PhotonMap,
                       radius, mis_mode: int, pdf_mc, clamping_value,
                       inv_num_light_paths) -> torch.Tensor:
    """The oracle: every photon against every pixel, in photon chunks."""
    ph = _photon_major(pm, mis_mode, pdf_mc)
    w10 = _camera_dir(scene, gbuf)
    r2 = radius * radius
    kde = mu.INV_PI / r2 * inv_num_light_paths
    n = gbuf.position.shape[0]
    m = ph["pos"].shape[0]
    step = max(1, SPLAT_BLOCK_ELEMS // max(n, 1))
    acc = torch.zeros_like(gbuf.position)
    for s in range(0, m, step):
        rec = {k: v[s:s + step, None] for k, v in ph.items()}
        c = _splat_eval(rec, gbuf.position, gbuf.normal, gbuf.kd, gbuf.ks,
                        gbuf.ns, w10, gbuf.stencil, r2, kde, mis_mode,
                        clamping_value)
        acc = acc + torch.sum(c, dim=0)
    return acc


def _project(scene: SceneData, pos, width: int, height: int, jitter_ndc):
    """World -> pixel coordinates, depth, in-front mask and the pixels per
    (unit offset / depth) along x and y."""
    cam = scene.camera
    origin, fwd, right, upv = cam.basis(pos.device)
    thy = math.tan(cam.fovy * 0.5)
    thx = thy * cam.aspect
    rel = pos - origin[None, :]
    z = mu.dot(rel, fwd)
    x = mu.dot(rel, right)
    y = mu.dot(rel, upv)
    zs = torch.clamp_min(z, 1e-6)
    ndc_x = x / (zs * thx)
    ndc_y = y / (zs * thy)
    if jitter_ndc is not None:
        ndc_x = ndc_x + jitter_ndc[0]
        ndc_y = ndc_y + jitter_ndc[1]
    px = (ndc_x + 1.0) * 0.5 * width
    py = (1.0 - ndc_y) * 0.5 * height
    return px, py, zs, z > 1e-6, width / (2.0 * thx), height / (2.0 * thy)


def _blockify(x: torch.Tensor, width: int, height: int, tile: int):
    """(H*W, ...) pixel field -> (tiles, tile*tile, ...), zero-padded."""
    txn, tyn = -(-width // tile), -(-height // tile)
    rest = x.shape[1:]
    x = x.reshape((height, width) + rest)
    pad = [0, 0] * len(rest) + [0, txn * tile - width, 0, tyn * tile - height]
    x = torch.nn.functional.pad(x, pad)
    x = x.reshape((tyn, tile, txn, tile) + rest).transpose(1, 2)
    return x.reshape((txn * tyn, tile * tile) + rest)


def photon_splat_binned(scene: SceneData, gbuf: GBuffer, pm: PhotonMap,
                        radius, mis_mode: int, pdf_mc, clamping_value,
                        inv_num_light_paths, width: int, height: int,
                        jitter_ndc=None, tile: int = 16):
    """Tile-binned splat of the frame.  Returns (image (N, 3), dropped),
    where dropped counts pairs left unevaluated (always 0).

    A photon's footprint is the screen box of half-size radius/z + 1 pixel
    around its projection; photons behind the camera or off screen are
    skipped, as in the JAX package's tiled splat."""
    dev = gbuf.position.device
    ph = _photon_major(pm, mis_mode, pdf_mc)
    m = ph["pos"].shape[0]
    txn, tyn = -(-width // tile), -(-height // tile)

    px, py, z, in_front, sx, sy = _project(scene, ph["pos"], width, height,
                                           jitter_ndc)
    r_px_x = radius / z * sx + 1.0
    r_px_y = radius / z * sy + 1.0
    tx0 = torch.floor((px - r_px_x) / tile).to(torch.int64)
    tx1 = torch.floor((px + r_px_x) / tile).to(torch.int64)
    ty0 = torch.floor((py - r_px_y) / tile).to(torch.int64)
    ty1 = torch.floor((py + r_px_y) / tile).to(torch.int64)
    on_screen = (tx1 >= 0) & (tx0 <= txn - 1) & (ty1 >= 0) & (ty0 <= tyn - 1)
    tx0, tx1 = tx0.clamp(0, txn - 1), tx1.clamp(0, txn - 1)
    ty0, ty1 = ty0.clamp(0, tyn - 1), ty1.clamp(0, tyn - 1)
    gate = ph["gate"] & in_front & on_screen

    # one pair per (photon, tile) of its footprint, sorted by tile
    ntx = tx1 - tx0 + 1
    per_photon = torch.where(gate, ntx * (ty1 - ty0 + 1), 0)
    pair_photon = torch.repeat_interleave(
        torch.arange(m, device=dev), per_photon)
    starts = torch.cumsum(per_photon, 0) - per_photon
    k = torch.arange(pair_photon.shape[0], device=dev) - starts[pair_photon]
    tx = tx0[pair_photon] + k % ntx[pair_photon]
    ty = ty0[pair_photon] + k // ntx[pair_photon]
    tid = ty * txn + tx
    order = torch.argsort(tid, stable=True)
    tid, pair_photon = tid[order], pair_photon[order]

    w10 = _camera_dir(scene, gbuf)
    blocks = [_blockify(x, width, height, tile) for x in (
        gbuf.position, gbuf.normal, gbuf.kd, gbuf.ks, gbuf.ns, w10,
        gbuf.stencil)]
    r2 = radius * radius
    kde = mu.INV_PI / r2 * inv_num_light_paths
    acc = torch.zeros((txn * tyn, tile * tile, 3), dtype=torch.float32,
                      device=dev)
    n_pairs = tid.shape[0]
    step = max(1, SPLAT_BLOCK_ELEMS // (tile * tile))
    evaluated = 0
    for s in range(0, n_pairs, step):
        t_ids = tid[s:s + step]
        rec = {key: v[pair_photon[s:s + step]][:, None]
               for key, v in ph.items()}
        contrib = _splat_eval(rec, *(b[t_ids] for b in blocks), r2, kde,
                              mis_mode, clamping_value)
        acc.index_add_(0, t_ids, contrib)
        evaluated += t_ids.shape[0]
    img = acc.reshape(tyn, txn, tile, tile, 3).transpose(1, 2)
    img = img.reshape(tyn * tile, txn * tile, 3)[:height, :width]
    dropped = torch.tensor(n_pairs - evaluated, dtype=torch.int32, device=dev)
    return img.reshape(-1, 3), dropped
