"""Headless frame loop: stop conditions, progressive schedule, dumps and
stats (counterpart of `run_photon_fam` in the JAX package's
`runtime/loop.py`, without checkpoints, profiling or multi-device runs).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from evplp_tpu_torch.core.sampling import iteration_key
from evplp_tpu_torch.integrators.photon_fam import (
    FrameState, PhotonFamConfig, init_state, photon_fam_frame)
from evplp_tpu_torch.runtime import film
from evplp_tpu_torch.scene.config import RenderJob
from evplp_tpu_torch.utils import image as im

# frames between host fences when far from the time budget
SYNC_EVERY = 25


@dataclass
class RunResult:
    images: dict            # name -> (H, W, 3) numpy
    num_iterations: int
    time_ms: float
    stats: dict = field(default_factory=dict)


def _out_path(configured: str, output_dir: str | None) -> str | None:
    if not configured:
        return None
    if output_dir is None:
        return configured
    return os.path.join(output_dir,
                        os.path.basename(configured.replace("\\", "/")))


def _write_stat(params, time_ms: float, iters: int, output_dir: str | None):
    if params.use_stat and params.stat_filename:
        path = _out_path(params.stat_filename, output_dir)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"time": time_ms, "numIterations": iters}, f, indent=4)


class ProgressiveSchedule:
    """Knaus-Zwicker radius / clamp schedule of the reference."""

    def __init__(self, radius0, clamp0, alpha, num_vpl, num_lp):
        self.radius = radius0
        self.clamp_start = clamp0
        self.clamp = clamp0
        self.alpha = alpha
        self.num_vpl = num_vpl
        self.num_lp = num_lp
        self.pdf_mc = self._pdf_mc()

    def _pdf_mc(self):
        if self.num_lp == 0:
            return 0.0
        return (self.num_vpl / self.num_lp) / np.pi / (self.radius * self.radius)

    def update(self, num_iterations: int):
        """Call after incrementing the iteration counter."""
        ratio = (num_iterations + self.alpha) / (num_iterations + 1.0)
        self.radius *= float(np.sqrt(ratio))
        self.clamp = self.clamp_start * float(num_iterations) ** self.alpha
        self.pdf_mc = self._pdf_mc()


class BudgetPacer:
    """Equal-time stop condition.  Host fences cost a device round trip, so
    they run every SYNC_EVERY frames far from the budget and every frame
    near it; the overshoot past the budget stays about one frame."""

    def __init__(self, time_limit_ms: float, t0: float):
        self.time_limit_ms = time_limit_ms
        self.t0 = t0
        self.next_sync = 1
        self.last_now = 0.0
        self.last_iters = 0

    def should_stop(self, iters: int, sync_value: torch.Tensor) -> bool:
        """Call once per frame with a device value to fence on."""
        if iters < self.next_sync:
            return False
        sync_value.item()
        now = (time.perf_counter() - self.t0) * 1000.0
        if self.time_limit_ms > 0 and now >= self.time_limit_ms:
            return True
        frame_ms = (now - self.last_now) / max(iters - self.last_iters, 1)
        self.last_now, self.last_iters = now, iters
        if self.time_limit_ms > 0:
            remaining = self.time_limit_ms - now
            step = int(remaining / max(frame_ms, 1e-3) * 0.5)
            self.next_sync = iters + max(1, min(SYNC_EVERY, step))
        else:
            self.next_sync = iters + SYNC_EVERY
        return False


def _frame_config(job: RenderJob) -> PhotonFamConfig:
    p = job.params
    return PhotonFamConfig(
        width=job.width, height=job.height,
        num_light_paths=p.num_light_paths,
        num_vpl_light_paths=p.num_vpl_light_paths,
        num_records=p.num_max_bounces + 1,
        mis_mode=p.mis_mode,
        accumulate=(p.frame_mode == "accumulate"),
        use_jitter=p.use_jitter,
        do_deferred=p.run_passes["deferredShading"],
        do_light_tracing=p.run_passes["lightTracing"],
        do_vpl=p.run_passes["vplSplat"],
        do_photon=p.run_passes["photonSplat"],
        do_light_render=p.run_passes["lightRender"],
        force_vsl=p.force_vsl,
        lvc=(p.technique == "lvcphotonfam"))


def run_photon_fam(job: RenderJob, output_dir: str | None = None,
                   max_wall_s: float | None = None,
                   progress_every: int = 20) -> RunResult:
    """A photonfam run following the reference renderer's loop, on the
    device the job's scene lives on.  The first frame is a warm-up outside the clock
    (it builds the kernels), as the reference's clock excludes its setup."""
    p = job.params
    scene = job.scene
    dev = scene.device
    radius0 = max(scene.bounding_radius * p.radius_percentage, 1e-6)
    clamp0 = (1.0 / scene.total_area if p.clamping_coeff is None
              else p.clamping_coeff)
    sched = ProgressiveSchedule(radius0, clamp0, p.alpha_progressive,
                                p.num_vpl_light_paths, p.num_light_paths)
    cfg = _frame_config(job)
    state = init_state(cfg, dev)

    def frame(st, iteration):
        return photon_fam_frame(scene, cfg, st,
                                iteration_key(0, iteration, dev),
                                sched.radius, sched.clamp, sched.pdf_mc)

    frame(state, p.rng_offset).dropped.item()
    t0 = time.perf_counter()
    prev_ms = 0.0
    pacer = BudgetPacer(p.time_limit_ms, t0)
    iters = 0

    def elapsed_ms():
        return (time.perf_counter() - t0) * 1000.0

    while iters != p.num_max_iteration:
        state = frame(state, iters + p.rng_offset)
        iters += 1
        if iters % progress_every == 0:
            state.dropped.item()
            now = elapsed_ms()
            frame_ms = (now - prev_ms) / progress_every
            prev_ms = now
            print(f"numIter: {iters} | radius: {sched.radius:.6g} | "
                  f"clamping: {sched.clamp:.6g} | time: {now:.1f}ms "
                  f"| {frame_ms:.1f}ms/frame")
        if p.do_progressive:
            sched.update(iters)
        if p.write_every_frame:
            path = _out_path(p.weighted_photon_filename, output_dir)
            if path:
                stem, ext = os.path.splitext(path)
                im.save(f"{stem}_{iters}{ext}",
                        finalize(state, cfg, iters, job)["combined"])
        if pacer.should_stop(iters, state.dropped):
            break
        if max_wall_s is not None and elapsed_ms() >= max_wall_s * 1000.0:
            break

    state.dropped.item()
    time_ms = elapsed_ms()
    imgs = finalize(state, cfg, iters, job)
    for name, fname in (("combined", p.combined_filename),
                        ("weighted_vpl", p.weighted_vpl_filename),
                        ("weighted_photon", p.weighted_photon_filename)):
        path = _out_path(fname, output_dir)
        if path:
            im.save(path, imgs[name])
    _write_stat(p, time_ms, iters, output_dir)
    return RunResult(images=imgs, num_iterations=iters, time_ms=time_ms,
                     stats={"dropped_splat_pairs": int(state.dropped)})


def finalize(state: FrameState, cfg: PhotonFamConfig, iters: int,
             job: RenderJob) -> dict:
    """The three-way output split: combined, weighted_vpl (light + VPL),
    weighted_photon, plus the emitter image.  GI terms are zeroed where the
    emitter is directly visible, as the reference's final pass does."""
    param = 1.0 if not cfg.accumulate else 1.0 / max(iters, 1)
    light = film.to_image(state.light_img, job.width, job.height)
    vpl = film.to_image(state.vpl_acc, job.width, job.height) * param
    photon = film.to_image(state.photon_acc, job.width, job.height) * param
    gi_mask = (light[:, :, 0:1] <= 0.0).astype(np.float32)
    vpl = gi_mask * vpl
    photon = gi_mask * photon
    return {"combined": light + vpl + photon, "weighted_vpl": light + vpl,
            "weighted_photon": photon, "light": light}
