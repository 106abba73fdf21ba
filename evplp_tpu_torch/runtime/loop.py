"""Headless frame loops: stop conditions, progressive schedule, dumps,
stats, checkpoints, per-pass profiling, multi-device runs and the display
gamma (counterpart of `run_photon_fam` and `run_pt` in the JAX package's
`runtime/loop.py`).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from evplp_tpu_torch.core import rng
from evplp_tpu_torch.core.sampling import iteration_key
from evplp_tpu_torch.integrators.gbuffer import light_image, trace_gbuffer
from evplp_tpu_torch.integrators.photon_fam import (
    FrameState, PhotonFamConfig, init_state, photon_fam_frame)
from evplp_tpu_torch.integrators.pt import render_pt_frame
from evplp_tpu_torch.runtime import film
from evplp_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from evplp_tpu_torch.runtime.profiling import PassTimer
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
    """Knaus-Zwicker radius / clamp schedule of the reference; the VSL
    radius (0 when VSL is off) shrinks with the photon radius, down to
    0.008."""

    def __init__(self, radius0, clamp0, alpha, num_vpl, num_lp, vsl_radius0):
        self.radius = radius0
        self.clamp_start = clamp0
        self.clamp = clamp0
        self.alpha = alpha
        self.num_vpl = num_vpl
        self.num_lp = num_lp
        self.vsl_radius = vsl_radius0
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
        if self.vsl_radius > 0.0:
            self.vsl_radius = max(self.vsl_radius * float(np.sqrt(ratio)),
                                  0.008)


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


def light_path_suggestion(params, frame_ms: float) -> str | None:
    """The log line suggesting light-path counts that would make a frame
    take targetRenderingTime ms, given the measured frame_ms (None when
    no target is set)."""
    if params.target_rendering_time <= 0 or frame_ms <= 0:
        return None
    factor = params.target_rendering_time / frame_ms
    if params.num_vpl_light_paths:
        new_vpl = int(params.num_vpl_light_paths * factor)
        ratio = params.num_light_paths // max(params.num_vpl_light_paths, 1)
        return (f"change number of samples: {factor:.3f} | "
                f"Nb light paths: {new_vpl * ratio} | "
                f"Nb VPL paths: {new_vpl}")
    return f"Nb light paths: {int(params.num_light_paths * factor)}"


def initial_schedule(job: RenderJob) -> ProgressiveSchedule:
    """The schedule a photonfam run starts from: photon radius
    radiusPercentage of the bounding radius (at least 1e-6), clamping
    value clampingCoeff or 1 / total area, VSL radius
    vslRadiusPercentage of the bounding radius (at least 0.008) with
    forceVsl, else 0."""
    p, scene = job.params, job.scene
    vsl_radius0 = 0.0
    if p.force_vsl:
        vsl_radius0 = max(scene.bounding_radius * p.vsl_radius_percentage,
                          0.008)
    return ProgressiveSchedule(
        max(scene.bounding_radius * p.radius_percentage, 1e-6),
        1.0 / scene.total_area if p.clamping_coeff is None
        else p.clamping_coeff, p.alpha_progressive, p.num_vpl_light_paths,
        p.num_light_paths, vsl_radius0)


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
                   progress_every: int = 20,
                   checkpoint_path: str | None = None,
                   checkpoint_every: int | None = None,
                   resume_from: str | None = None,
                   profile: bool | None = None, mesh=None,
                   display_gamma: bool = False) -> RunResult:
    """A photonfam / lvcphotonfam run following the reference renderer's
    loop, on the device the job's scene lives on.  The first frame is a
    warm-up outside the clock (it builds the kernels), as the reference's
    clock excludes its setup.

    checkpoint_path / checkpoint_every: write the progressive state there
    every that many frames and at the end (runtime/checkpoint.py);
    resume_from: start from such a checkpoint (either package's).
    profile: per-pass timing of the timed frames (runtime/profiling.py)
    into RunResult.stats["passes"] (None: the EVPLP_PROFILE variable).
    mesh: a parallel/shard.Mesh; every frame, the warm-up included, runs
    pixel-row-sharded over it (the passes are then not timed).
    display_gamma: pow 1/2.2 on the saved outputs (the dumps are linear
    otherwise)."""
    p = job.params
    scene = job.scene
    dev = scene.device
    sched = initial_schedule(job)
    cfg = _frame_config(job)
    timer = PassTimer(enabled=profile)
    state = init_state(cfg, dev)
    iters = 0
    if resume_from:
        state, iters, fields = load_checkpoint(resume_from, dev)
        for k in ("radius", "clamp", "clamp_start", "vsl_radius", "pdf_mc"):
            setattr(sched, k, fields[k])
    if mesh is not None:
        from evplp_tpu_torch.parallel.shard import (
            shard_state, sharded_photon_fam_frame, unshard_state)
        state = shard_state(state, mesh)

    def frame(st, iteration, frame_timer=None):
        key = iteration_key(0, iteration, dev)
        if mesh is not None:
            return sharded_photon_fam_frame(
                scene, cfg, mesh, st, key, sched.radius, sched.clamp,
                sched.pdf_mc, sched.vsl_radius)
        return photon_fam_frame(scene, cfg, st, key, sched.radius,
                                sched.clamp, sched.pdf_mc, sched.vsl_radius,
                                timer=frame_timer)

    def whole(st):
        return st if mesh is None else unshard_state(st)

    frame(state, p.rng_offset).dropped.item()
    t0 = time.perf_counter()
    prev_ms = 0.0
    pacer = BudgetPacer(p.time_limit_ms, t0)

    def elapsed_ms():
        return (time.perf_counter() - t0) * 1000.0

    while iters != p.num_max_iteration:
        state = frame(state, iters + p.rng_offset, timer)
        iters += 1
        if iters % progress_every == 0:
            state.dropped.item()
            now = elapsed_ms()
            frame_ms = (now - prev_ms) / progress_every
            prev_ms = now
            print(f"numIter: {iters} | radius: {sched.radius:.6g} | "
                  f"clamping: {sched.clamp:.6g} | time: {now:.1f}ms "
                  f"| {frame_ms:.1f}ms/frame")
            suggestion = light_path_suggestion(p, frame_ms)
            if suggestion:
                print(suggestion)
        if p.do_progressive:
            sched.update(iters)
        if checkpoint_path and checkpoint_every and \
                iters % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, whole(state), iters, sched)
        if p.write_every_frame:
            path = _out_path(p.weighted_photon_filename, output_dir)
            if path:
                stem, ext = os.path.splitext(path)
                im.save(f"{stem}_{iters}{ext}",
                        finalize(whole(state), cfg, iters, job)["combined"])
        if pacer.should_stop(iters, state.dropped):
            break
        if max_wall_s is not None and elapsed_ms() >= max_wall_s * 1000.0:
            break

    state.dropped.item()
    time_ms = elapsed_ms()
    state = whole(state)
    imgs = finalize(state, cfg, iters, job, gamma=display_gamma)
    for name, fname in (("combined", p.combined_filename),
                        ("weighted_vpl", p.weighted_vpl_filename),
                        ("weighted_photon", p.weighted_photon_filename)):
        path = _out_path(fname, output_dir)
        if path:
            im.save(path, imgs[name])
    _write_stat(p, time_ms, iters, output_dir)
    if checkpoint_path and checkpoint_every:
        save_checkpoint(checkpoint_path, state, iters, sched)
    stats = {"dropped_splat_pairs": int(state.dropped)}
    if timer.enabled:
        stats["passes"] = timer.report()
    return RunResult(images=imgs, num_iterations=iters, time_ms=time_ms,
                     stats=stats)


def finalize(state: FrameState, cfg: PhotonFamConfig, iters: int,
             job: RenderJob, gamma: bool = False) -> dict:
    """The three-way output split: combined, weighted_vpl (light + VPL),
    weighted_photon, plus the emitter image.  GI terms are zeroed where the
    emitter is directly visible, as the reference's final pass does.
    gamma: the display transform pow(max(x, 0), 1/2.2) on the three
    outputs."""
    param = 1.0 if not cfg.accumulate else 1.0 / max(iters, 1)
    light = film.to_image(state.light_img, job.width, job.height)
    vpl = film.to_image(state.vpl_acc, job.width, job.height) * param
    photon = film.to_image(state.photon_acc, job.width, job.height) * param
    gi_mask = (light[:, :, 0:1] <= 0.0).astype(np.float32)
    vpl = gi_mask * vpl
    photon = gi_mask * photon
    out = {"combined": light + vpl + photon, "weighted_vpl": light + vpl,
           "weighted_photon": photon, "light": light}
    if gamma:
        for k in ("combined", "weighted_vpl", "weighted_photon"):
            out[k] = np.power(np.maximum(out[k], 0.0), 1.0 / 2.2)
    return out


def run_pt(job: RenderJob, output_dir: str | None = None,
           max_wall_s: float | None = None,
           display_gamma: bool = False, mesh=None) -> RunResult:
    """A path-tracing run following the reference renderer's loop, on the
    device the job's scene lives on.  Each frame draws one camera jitter
    from fold_in(key, 999), traces the G-buffer, and averages
    numSamplePerPixel frames of render_pt_frame with keys fold_in(key, s).
    The first frame is a warm-up outside the clock.  mesh: a
    parallel/shard.Mesh; every frame's pixel rows are then sharded over it
    (sharded_pt_frame), the accumulation on its first device.  Images:
    "output" (the composite with the emitter image; with display_gamma,
    pow 1/2.2 of it), "pt" and "light"."""
    p = job.params
    scene = job.scene
    dev = scene.device
    w, h = job.width, job.height
    n = w * h
    accumulate = p.frame_mode == "accumulate"

    if mesh is not None:
        from evplp_tpu_torch.parallel.shard import sharded_pt_frame
        dev = mesh.devices[0]

    def frame(acc, key):
        jitter = None
        if p.use_jitter:
            u = rng.uniform(rng.fold_in(key, 999), (2,))
            jitter = (2.0 * u - 1.0) / torch.tensor(
                [w, h], dtype=torch.float32, device=dev)
        result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        if mesh is not None:
            for s in range(p.num_sample_per_pixel):
                img, light = sharded_pt_frame(
                    scene, mesh, w, h, rng.fold_in(key, s),
                    p.num_max_bounces, use_jitter=p.use_jitter,
                    jitter=jitter)
                result += img
        else:
            gbuf = trace_gbuffer(scene, w, h, jitter)
            for s in range(p.num_sample_per_pixel):
                result += render_pt_frame(scene, gbuf, rng.fold_in(key, s),
                                          p.num_max_bounces)
            light = light_image(scene, gbuf)
        result /= p.num_sample_per_pixel
        return (acc + result if accumulate else result), light

    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    light = torch.zeros_like(acc)
    frame(acc, iteration_key(0, p.rng_offset, dev))[0][0, 0].item()
    t0 = time.perf_counter()
    pacer = BudgetPacer(p.time_limit_ms, t0)
    iters = 0
    path = _out_path(p.output_filename, output_dir)
    while iters != p.num_max_iteration:
        acc, light = frame(acc, iteration_key(0, iters + p.rng_offset, dev))
        iters += 1
        if p.write_every_frame and path:
            param = 1.0 / iters if accumulate else 1.0
            snap = film.composite(acc, torch.zeros_like(acc), light,
                                  vpl_scale=param, photon_scale=0.0)
            stem, ext = os.path.splitext(path)
            im.save(f"{stem}_{iters}{ext}", film.to_image(snap, w, h))
        if pacer.should_stop(iters, acc[0, 0]):
            break
        if max_wall_s is not None and \
                time.perf_counter() - t0 >= max_wall_s:
            break

    acc[0, 0].item()
    time_ms = (time.perf_counter() - t0) * 1000.0
    param = 1.0 / max(iters, 1) if accumulate else 1.0
    final = film.composite(acc, torch.zeros_like(acc), light,
                           vpl_scale=param, photon_scale=0.0,
                           gamma=display_gamma)
    imgs = {"output": film.to_image(final, w, h),
            "pt": film.to_image(acc * param, w, h),
            "light": film.to_image(light, w, h)}
    if path:
        im.save(path, imgs["output"])
    _write_stat(p, time_ms, iters, output_dir)
    return RunResult(images=imgs, num_iterations=iters, time_ms=time_ms)
