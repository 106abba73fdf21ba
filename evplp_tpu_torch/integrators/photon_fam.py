"""EVPLP technique family, one frame (counterpart of the JAX package's
`integrators/photon_fam.py`).

One frame = G-buffer -> light tracing -> VPL gather (or, with forceVsl,
the VSL gather; with lvc, the LVC gather) -> photon splat -> emitter
image, accumulated into a FrameState.  The progressive-mode scalars
(photon radius, clamping value, pdf_mc, VSL radius) are arguments, so the
schedule can change them every frame.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from evplp_tpu_torch.core import rng
from evplp_tpu_torch.integrators.gbuffer import (light_image, trace_gbuffer,
                                                 zero_gbuffer)
from evplp_tpu_torch.integrators.light_trace import (trace_light_paths,
                                                     zero_photon_map)
from evplp_tpu_torch.integrators.lvc import lvc_gather
from evplp_tpu_torch.integrators.photon_splat import photon_splat_binned
from evplp_tpu_torch.integrators.vpl import vpl_gather
from evplp_tpu_torch.integrators.vsl import vsl_gather
from evplp_tpu_torch.runtime.profiling import PassTimer
from evplp_tpu_torch.scene.scene import SceneData


@dataclass(frozen=True)
class PhotonFamConfig:
    """Frame configuration."""
    width: int
    height: int
    num_light_paths: int
    num_vpl_light_paths: int
    num_records: int            # numMaxBounces + 1
    mis_mode: int
    accumulate: bool            # frameMode == accumulate
    use_jitter: bool
    do_deferred: bool = True
    do_light_tracing: bool = True
    do_vpl: bool = True
    do_photon: bool = True
    do_light_render: bool = True
    force_vsl: bool = False
    lvc: bool = False


@dataclass(frozen=True)
class FrameState:
    vpl_acc: torch.Tensor      # (N, 3)
    photon_acc: torch.Tensor   # (N, 3)
    light_img: torch.Tensor    # (N, 3) latest emitter image (not accumulated)
    dropped: torch.Tensor      # () int32, splat pairs left unevaluated


def init_state(cfg: PhotonFamConfig, device="cuda") -> FrameState:
    n = cfg.width * cfg.height
    z = torch.zeros((n, 3), dtype=torch.float32, device=device)
    return FrameState(vpl_acc=z, photon_acc=z, light_img=z,
                      dropped=torch.zeros((), dtype=torch.int32,
                                          device=device))


def state_from_arrays(vpl_acc, photon_acc, light_img, dropped,
                      device="cuda") -> FrameState:
    """FrameState from numpy arrays (e.g. the JAX package's FrameState
    fields)."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)
    return FrameState(vpl_acc=t(vpl_acc, torch.float32),
                      photon_acc=t(photon_acc, torch.float32),
                      light_img=t(light_img, torch.float32),
                      dropped=t(dropped, torch.int32))


def photon_fam_frame(scene: SceneData, cfg: PhotonFamConfig,
                     state: FrameState, key: torch.Tensor, radius: float,
                     clamping_value: float, pdf_mc: float,
                     vsl_radius: float = 0.0,
                     timer: PassTimer | None = None) -> FrameState:
    """Advance one iteration.  key is the frame's threefry key; timer
    (runtime/profiling.PassTimer) times the passes gbuffer, light_trace,
    vsl_gather / lvc_gather / vpl_gather and photon_splat."""
    if timer is None:
        timer = PassTimer(enabled=False)
    dev = scene.device
    key = key.to(dev)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    radius, clamping_value, pdf_mc = (f32(radius), f32(clamping_value),
                                      f32(pdf_mc))
    jitter = None
    if cfg.use_jitter:
        u = rng.uniform(rng.fold_in(key, 999), (2,))
        jitter = (2.0 * u - 1.0) / f32([cfg.width, cfg.height])

    n = cfg.width * cfg.height
    gbuf = (timer.time_call("gbuffer", trace_gbuffer, scene, cfg.width,
                            cfg.height, jitter)
            if cfg.do_deferred else zero_gbuffer(n, dev))
    pm = (timer.time_call("light_trace", trace_light_paths, scene,
                          rng.fold_in(key, 1), cfg.num_light_paths,
                          cfg.num_records)
          if cfg.do_light_tracing
          else zero_photon_map(cfg.num_light_paths, cfg.num_records, dev))

    vpl_acc = state.vpl_acc
    if cfg.do_vpl and cfg.num_vpl_light_paths > 0:
        if cfg.force_vsl:
            img = timer.time_call("vsl_gather", vsl_gather, scene, gbuf, pm,
                                  rng.fold_in(key, 2), vsl_radius,
                                  cfg.num_vpl_light_paths)
        elif cfg.lvc:
            img = timer.time_call("lvc_gather", lvc_gather, scene, gbuf, pm,
                                  rng.fold_in(key, 3), cfg.mis_mode, pdf_mc,
                                  clamping_value, cfg.num_vpl_light_paths)
        else:
            img = timer.time_call("vpl_gather", vpl_gather, scene, gbuf, pm,
                                  cfg.mis_mode, pdf_mc, clamping_value,
                                  cfg.num_vpl_light_paths)
        vpl_acc = vpl_acc + img if cfg.accumulate else img

    photon_acc = state.photon_acc
    dropped = state.dropped
    if cfg.do_photon:
        img, d = timer.time_call(
            "photon_splat", photon_splat_binned, scene, gbuf, pm, radius,
            cfg.mis_mode, pdf_mc, clamping_value, 1.0 / cfg.num_light_paths,
            cfg.width, cfg.height, jitter)
        photon_acc = photon_acc + img if cfg.accumulate else img
        dropped = dropped + d

    light_img = (light_image(scene, gbuf) if cfg.do_light_render
                 else state.light_img)
    return FrameState(vpl_acc=vpl_acc, photon_acc=photon_acc,
                      light_img=light_img, dropped=dropped)
