"""Multi-device execution: pixel-row-sharded film and ring-rotated light
blocks (counterpart of the JAX package's `parallel/shard.py`).

One controlling process drives a list of devices, as JAX's shard_map does
over a mesh; each shard's work is enqueued on its own device.  The design
shards the renderer's two big axes:

  * film rows    -> one band of height / n rows a shard;
  * light paths  -> one block of numLightPaths / n paths a shard, traced
    with the per-global-path-id RNG of `trace_light_paths(path_offset=)`,
    so the union of the blocks is the single-device path set.  The photon
    splat, which needs every path, sees every block by rotating the blocks
    around the ring of shards (a `.to(next_device, non_blocking=True)` of
    each block a step);
  * the VPL / VSL gather reads only the first numVplLightPaths paths, a
    small working set that every shard traces itself;
  * LVC needs random access into the whole pool, so every shard
    concatenates all blocks (`torch.cat`) and gathers with its rows' slice
    of the whole film's window starts;
  * framebuffers need no reduction: a shard shades only its rows; the
    `dropped` counts are summed.

So the sharded frame computes the single-device frame's estimator; only
the order of float sums differs.  A mesh may name one device more than
once (the counterpart of XLA's virtual CPU devices): four shards on one
card run the ring with every copy a no-op.  Not torch.distributed: NCCL
refuses two ranks on one GPU, so one card could only run a world of one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from evplp_tpu_torch.core import rng
from evplp_tpu_torch.integrators.gbuffer import (light_image, trace_gbuffer,
                                                 zero_gbuffer)
from evplp_tpu_torch.integrators.light_trace import PhotonMap, trace_light_paths
from evplp_tpu_torch.integrators.lvc import lvc_gather, lvc_offsets
from evplp_tpu_torch.integrators.photon_fam import FrameState, PhotonFamConfig
from evplp_tpu_torch.integrators.photon_splat import photon_splat_binned
from evplp_tpu_torch.integrators.pt import render_pt_frame
from evplp_tpu_torch.integrators.vpl import vpl_gather
from evplp_tpu_torch.integrators.vsl import vsl_gather
from evplp_tpu_torch.scene.scene import SceneData


@dataclass(frozen=True)
class Mesh:
    """The shards' devices, in ring order; a device may repeat."""
    devices: tuple

    def __init__(self, devices):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The first n_devices CUDA devices (all of them by default), raising
    if fewer are visible; for device "cpu", n_devices shards of the host
    (default 1)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    if kind != "cuda":
        raise ValueError(f"no mesh of {kind!r} devices")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if n < 1 or n > count:
        raise RuntimeError(f"a mesh of {n} CUDA devices was asked for, "
                           f"{count} are visible")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def _check_mesh(mesh: Mesh):
    """Refuse a mesh that names a CUDA device this process cannot use."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for dev in mesh.devices:
        if dev.type == "cuda" and (dev.index or 0) >= count:
            raise RuntimeError(f"mesh device {dev} requested but only "
                               f"{count} CUDA devices are available")


def _local_rows(height: int, n: int) -> int:
    assert height % n == 0, f"height {height} must divide device count {n}"
    return height // n


def to_device(obj, device):
    """A copy of a (nested) dataclass of tensors with every tensor on
    device; tensors already there are kept."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=True)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def _scenes(scene: SceneData, mesh: Mesh) -> list:
    """The scene on each shard's device (one copy a distinct device)."""
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = (scene if dev == scene.device
                           else to_device(scene, dev))
    return [copies[dev] for dev in mesh.devices]


def _pm_to(pm: PhotonMap, device) -> PhotonMap:
    return pm.map(lambda x: x.to(device, non_blocking=True))


def _jitter(key, width: int, height: int, device):
    u = rng.uniform(rng.fold_in(key.to(device), 999), (2,))
    return (2.0 * u - 1.0) / torch.tensor([width, height],
                                          dtype=torch.float32, device=device)


def sharded_photon_fam_frame(scene: SceneData, cfg: PhotonFamConfig,
                             mesh: Mesh, state: FrameState, key,
                             radius, clamping_value, pdf_mc,
                             vsl_radius=0.0) -> FrameState:
    """One EVPLP / LVC frame over the mesh; equals the single-device
    photon_fam_frame up to the order of float sums.

    state is row-sharded (shard_state): its three images are tuples of
    one (rows * width, 3) tensor a shard, on the shard's device, and
    dropped lies on the first device.  cfg.num_light_paths is the global
    count; each shard traces one block of it."""
    _check_mesh(mesh)
    n = mesh.size
    rows = _local_rows(cfg.height, n)
    assert cfg.num_light_paths % n == 0, \
        f"numLightPaths {cfg.num_light_paths} must divide device count {n}"
    paths_blk = cfg.num_light_paths // n
    n_vpl = cfg.num_vpl_light_paths
    assert n_vpl <= cfg.num_light_paths
    n_local = rows * cfg.width
    devs = mesh.devices
    scenes = _scenes(scene, mesh)
    keys = [key.to(dev) for dev in devs]

    def f32(x, dev):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    jitters = [_jitter(k, cfg.width, cfg.height, dev) if cfg.use_jitter
               else None for k, dev in zip(keys, devs)]
    gbufs = [trace_gbuffer(sc, cfg.width, cfg.height, j, row_start=d * rows,
                           row_count=rows) if cfg.do_deferred
             else zero_gbuffer(n_local, dev)
             for d, (sc, j, dev) in enumerate(zip(scenes, jitters, devs))]

    vpl_acc, photon_acc = list(state.vpl_acc), list(state.photon_acc)
    dropped = state.dropped
    if cfg.do_light_tracing:
        key_lt = [rng.fold_in(k, 1) for k in keys]
        blocks = [trace_light_paths(sc, k, paths_blk, cfg.num_records,
                                    path_offset=d * paths_blk)
                  for d, (sc, k) in enumerate(zip(scenes, key_lt))]

        if cfg.do_vpl and n_vpl:
            if cfg.lvc:
                offsets = lvc_offsets(rng.fold_in(keys[0], 3),
                                      cfg.width * cfg.height,
                                      cfg.num_light_paths)
            imgs = []
            for d, (sc, gbuf, k, dev) in enumerate(zip(scenes, gbufs, keys,
                                                       devs)):
                pdf, clamp = f32(pdf_mc, dev), f32(clamping_value, dev)
                if cfg.lvc:
                    pool = PhotonMap(*(torch.cat([
                        getattr(b, f.name).to(dev, non_blocking=True)
                        for b in blocks]) for f in dataclasses.fields(
                            PhotonMap)))
                    off = offsets[d * n_local:(d + 1) * n_local].to(dev)
                    imgs.append(lvc_gather(sc, gbuf, pool,
                                           rng.fold_in(k, 3), cfg.mis_mode,
                                           pdf, clamp, n_vpl, offsets=off))
                    continue
                pm_vpl = trace_light_paths(sc, key_lt[d], n_vpl,
                                           cfg.num_records)
                if cfg.force_vsl:
                    imgs.append(vsl_gather(sc, gbuf, pm_vpl,
                                           rng.fold_in(k, 2), vsl_radius,
                                           n_vpl, pixel_offset=d * n_local))
                else:
                    imgs.append(vpl_gather(sc, gbuf, pm_vpl, cfg.mis_mode,
                                           pdf, clamp, n_vpl))
            vpl_acc = [a + i if cfg.accumulate else i
                       for a, i in zip(vpl_acc, imgs)]

        if cfg.do_photon:
            photon = [None] * n
            for step in range(n):
                for d, (sc, gbuf, j, dev) in enumerate(zip(
                        scenes, gbufs, jitters, devs)):
                    img, drop = photon_splat_binned(
                        sc, gbuf, blocks[d], f32(radius, dev), cfg.mis_mode,
                        f32(pdf_mc, dev), f32(clamping_value, dev),
                        1.0 / cfg.num_light_paths, cfg.width, rows, j,
                        row_offset=float(d * rows), full_height=cfg.height)
                    photon[d] = img if step == 0 else photon[d] + img
                    dropped = dropped + drop.to(dropped.device)
                if step != n - 1:
                    # shard d takes the block shard d - 1 held
                    blocks = [_pm_to(blocks[(d - 1) % n], devs[d])
                              for d in range(n)]
            photon_acc = [a + i if cfg.accumulate else i
                          for a, i in zip(photon_acc, photon)]

    light = (tuple(light_image(sc, g) for sc, g in zip(scenes, gbufs))
             if cfg.do_light_render else state.light_img)
    return FrameState(vpl_acc=tuple(vpl_acc), photon_acc=tuple(photon_acc),
                      light_img=light, dropped=dropped)


def sharded_pt_frame(scene: SceneData, mesh: Mesh, width: int, height: int,
                     key, num_bounces: int, use_jitter: bool = True,
                     jitter=None):
    """A pixel-row-sharded path-tracing frame: each shard renders its rows
    with render_pt_frame's counter draws on global pixel ids, so the image
    equals the single-device frame.  jitter (2,) may be given to share the
    caller's camera jitter; otherwise it derives from the frame key.
    Returns (image, emitter image), each (H * W, 3) on the first device."""
    _check_mesh(mesh)
    n = mesh.size
    rows = _local_rows(height, n)
    devs = mesh.devices
    if use_jitter and jitter is None:
        jitter = _jitter(key, width, height, devs[0])
    imgs, lights = [], []
    for d, (sc, dev) in enumerate(zip(_scenes(scene, mesh), devs)):
        gbuf = trace_gbuffer(sc, width, height,
                             jitter.to(dev) if use_jitter else None,
                             row_start=d * rows, row_count=rows)
        imgs.append(render_pt_frame(sc, gbuf, key.to(dev), num_bounces,
                                    pixel_offset=d * rows * width))
        lights.append(light_image(sc, gbuf))
    return (torch.cat([i.to(devs[0], non_blocking=True) for i in imgs]),
            torch.cat([i.to(devs[0], non_blocking=True) for i in lights]))


def shard_state(state: FrameState, mesh: Mesh) -> FrameState:
    """Split the accumulation buffers into row bands, one a shard on its
    device; dropped goes to the first device."""
    per = state.vpl_acc.shape[0] // mesh.size

    def split(x):
        return tuple(x[d * per:(d + 1) * per].to(dev)
                     for d, dev in enumerate(mesh.devices))
    return FrameState(vpl_acc=split(state.vpl_acc),
                      photon_acc=split(state.photon_acc),
                      light_img=split(state.light_img),
                      dropped=state.dropped.to(mesh.devices[0]))


def unshard_state(state: FrameState) -> FrameState:
    """The whole-film FrameState of a sharded one, on the first shard's
    device."""
    dev = state.dropped.device

    def cat(xs):
        return torch.cat([x.to(dev) for x in xs])
    return FrameState(vpl_acc=cat(state.vpl_acc),
                      photon_acc=cat(state.photon_acc),
                      light_img=cat(state.light_img), dropped=state.dropped)
