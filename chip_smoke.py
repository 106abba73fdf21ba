#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card.  It
builds the port's kernels from the sources, holds each kernel against its
plain PyTorch version on samples of the main path's rays, renders the
EVPLP "ours" photonfam config `configs/box_field/box_field_ours.json` at
its full size (1280x720, 300k light paths, 30 VPL paths, 4 records) for two
frames through the port's CLI, and checks the outputs; then it times each
pass of that frame and renders small references on the card (the Cornell
goldens, and a 64x36 box_field frame against the same frame on the CPU).
Each phase prints one line; any failure raises and exits non-zero.  The line before the last
is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the port's package
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "box_field", "box_field_ours.json")
SAMPLE_RAYS = 65_536
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float operations of the kernel's inner steps, counted from
# csrc/traverse.cu: one slab test (6 sub, 6 mul, 10 min/max, 3 compares)
# and one Moller-Trumbore test (53 add/mul/div/compare)
SLAB_OPS = 25
TRI_OPS = 53
# bytes a ray moves: o, d, t_min, t_max in; t, prim, u, v out
RAY_BYTES = 48


def phase(name: str, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def closest_matches(k, p) -> bool:
    """Kernel and plain closest hits agree: same hit/miss, t at rtol 1e-4,
    and equal prims or a t-tie at rtol 1e-4 (coplanar duplicates)."""
    import torch
    tk, pk, _, _ = k
    tp, pp, _, _ = p
    hit_match = bool(((pk >= 0) == (pp >= 0)).all())
    m = (pk >= 0) & (pp >= 0)
    t_close = torch.isclose(tk[m], tp[m], rtol=1e-4, atol=0.0)
    prim_ok = (pk[m] == pp[m]) | t_close
    return hit_match and bool(t_close.all()) and bool(prim_ok.all())


def ray_sets(scene, width, height, torch):
    """Three 65,536-ray sets from the scene: coherent primary rays,
    cosine-distributed bounce rays from surface points, and shadow segments
    from surface points to the light with about half the lanes dead."""
    from evplp_tpu_torch.core import mathutil as mu
    from evplp_tpu_torch.core.light import light_sample
    from evplp_tpu_torch.trace.traverse import BIG, traverse_cuda

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    o, d = scene.camera.generate_rays(width, height, device=dev)
    o, d = o.contiguous(), d.contiguous()
    mid = (o.shape[0] - SAMPLE_RAYS) // 2
    prim_o = o[mid:mid + SAMPLE_RAYS].contiguous()
    prim_d = d[mid:mid + SAMPLE_RAYS].contiguous()
    n = SAMPLE_RAYS

    def full(x):
        return torch.full((n,), x, dtype=torch.float32, device=dev)

    sets = {"primary_closest": (prim_o, prim_d, full(1e-4), full(BIG), False)}
    # surface points: primary hits over the whole film, first n that hit
    lo_all = torch.full((o.shape[0],), 1e-4, dtype=torch.float32, device=dev)
    t, prim, _, _ = traverse_cuda(scene.tris, scene.bvh, o, d, lo_all,
                                  torch.full_like(lo_all, BIG), False)
    keep = torch.nonzero(prim >= 0).squeeze(1)
    keep = keep[torch.randperm(keep.numel(), generator=gen, device=dev)[:n]]
    pts = o[keep] + t[keep, None] * d[keep]
    nrm = scene.tri_shade[prim[keep].long(), 8:11]
    nrm = torch.where((mu.dot(nrm, d[keep]) > 0.0)[:, None], -nrm, nrm)
    u2 = torch.rand((n, 2), generator=gen, device=dev)
    bounce_d = mu.from_local(mu.square_to_cosine_hemisphere(u2), nrm)
    sets["bounce_closest"] = (pts.contiguous(), bounce_d.contiguous(),
                              full(1e-4), full(BIG), False)
    u3 = torch.rand((n, 3), generator=gen, device=dev)
    lpos, _, _, _ = light_sample(scene.light, u3)
    live = torch.rand((n,), generator=gen, device=dev) < 0.5
    sets["shadow_any"] = (pts.contiguous(), (lpos - pts).contiguous(),
                          full(1e-4), torch.where(live, 1.0 - 1e-4, 0.0),
                          True)
    return sets


def kernel_check(scene, width, height, torch):
    """Kernel vs plain version on each ray set; returns the kernel entry."""
    from evplp_tpu_torch.trace.traverse import traverse_cuda, traverse_plain

    nodes = scene.bvh.node_min.shape[0]
    scene_bytes = 36 * nodes + 36 * scene.tris.v0.shape[0]
    entry = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                 bytes_ms=0.0, ops_ms=0.0)
    for name, (o, d, lo, hi, any_hit) in ray_sets(scene, width, height,
                                                      torch).items():
        args = (scene.tris, scene.bvh, o, d, lo, hi, any_hit)
        k = traverse_cuda(*args)
        work: dict = {}
        t0 = time.perf_counter()
        p = traverse_plain(*args, work=work)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1000.0
        torch.cuda.synchronize()
        if any_hit:
            live = hi > lo
            occ_k, occ_p = k[1][live] >= 0, p[1][live] >= 0
            ok = bool((occ_k == occ_p).all())
            err = float((occ_k.float() - occ_p.float()).abs().max())
        else:
            ok = closest_matches(k, p)
            err = float((k[0] - p[0]).abs().max())
        if not ok:
            raise AssertionError(f"kernel disagrees with plain on {name}")
        ms = cuda_ms(lambda: traverse_cuda(*args), reps=20)
        bytes_ms = (RAY_BYTES * o.shape[0] + scene_bytes) / PEAK_BYTES_PER_S * 1e3
        ops_ms = (SLAB_OPS * work["slabs"] + TRI_OPS * work["tris"]
                  ) / PEAK_F32_PER_S * 1e3
        phase("kernel_check", set=name, rays=o.shape[0], match=ok,
              max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
              slab_tests=work["slabs"], tri_tests=work["tris"],
              bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms)
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        entry["bytes_ms"] += bytes_ms
        entry["ops_ms"] += ops_ms
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["bound_by"] = ("bytes" if entry["bytes_ms"] >= entry["ops_ms"]
                         else "operations")
    entry["bound_ms"] = max(entry.pop("bytes_ms"), entry.pop("ops_ms"))
    return entry


class LaunchTimer:
    """Times every traversal-kernel launch of a run with CUDA events, by
    standing in for traverse.traverse_cuda while the run lasts."""

    def __init__(self, traverse_mod, torch):
        self.mod, self.torch = traverse_mod, torch
        self.real = traverse_mod.traverse_cuda
        self.events = []

    def __enter__(self):
        def timed(tris, bvh, o, d, t_min, t_max, any_hit):
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.real(tris, bvh, o, d, t_min, t_max, any_hit)
            ev[1].record()
            live = int((t_max > t_min).sum()) if any_hit else o.shape[0]
            scene_bytes = 36 * (bvh.node_min.shape[0] + tris.v0.shape[0])
            self.events.append((any_hit, o.shape[0], live, scene_bytes, ev))
            return out
        self.mod.traverse_cuda = timed
        return self

    def __exit__(self, *exc):
        self.mod.traverse_cuda = self.real

    def summary(self) -> dict:
        """Launches, rays, live rays, kernel ms and the bytes bound (each
        input read once, each output written once), per cast kind."""
        self.torch.cuda.synchronize()
        out = {}
        for any_hit, rays, live, scene_bytes, (s, e) in self.events:
            k = out.setdefault("any_hit" if any_hit else "closest",
                               dict(launches=0, rays=0, live_rays=0, ms=0.0,
                                    bytes_bound_ms=0.0))
            k["launches"] += 1
            k["rays"] += rays
            k["live_rays"] += live
            k["ms"] += s.elapsed_time(e)
            k["bytes_bound_ms"] += ((RAY_BYTES * rays + scene_bytes)
                                    / PEAK_BYTES_PER_S * 1e3)
        return out


def pass_breakdown(job, torch) -> dict:
    """Mean host-clock ms of each pass of the full-size frame, with the
    device synchronized around every pass (two frames: the warm-up and one
    timed frame of run_photon_fam, with no file output)."""
    import dataclasses
    from evplp_tpu_torch.integrators import photon_fam as pf
    from evplp_tpu_torch.runtime.loop import run_photon_fam

    names = ("trace_gbuffer", "trace_light_paths", "vpl_gather",
             "photon_splat_binned", "light_image")
    real = {n: getattr(pf, n) for n in names}
    ms = dict.fromkeys(names, 0.0)

    def timed(name):
        def fn(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            ms[name] += (time.perf_counter() - t0) * 1000.0
            return out
        return fn

    params = dataclasses.replace(
        job.params, num_max_iteration=1, time_limit_ms=-1.0, use_stat=False,
        combined_filename="", weighted_vpl_filename="",
        weighted_photon_filename="")
    for n in names:
        setattr(pf, n, timed(n))
    try:
        run_photon_fam(dataclasses.replace(job, params=params))
    finally:
        for n in names:
            setattr(pf, n, real[n])
    return {n: v / 2.0 for n, v in ms.items()}


def write_config(config, directory, block_update, res=None) -> str:
    """Copy of a config in directory, with absolute scene paths, its
    technique block updated and, if given, the resolution res = (W, H)."""
    with open(config) as f:
        cfg = json.load(f)
    base = os.path.dirname(config)
    cfg["scene"] = [os.path.join(base, s) for s in cfg["scene"]]
    cfg["arealight"]["obj"] = os.path.join(base, cfg["arealight"]["obj"])
    if res is not None:
        cfg["resX"], cfg["resY"] = res
    cfg["photonfam"].update(block_update)
    path = os.path.join(directory, os.path.basename(config))
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _small_job(config, res, block_update, device):
    from evplp_tpu_torch.scene.config import load_config
    with tempfile.TemporaryDirectory() as tmp:
        return load_config(write_config(config, tmp, block_update, res),
                           device=device)


def reference_check() -> dict:
    """Small renders on the card against references: the Cornell goldens
    tests/golden/{ours,ours_prog}.npz (dense ray casts) at the goldens'
    rtol 2e-3 / atol 2e-4, and a 64x36 box_field frame (kernel ray casts)
    against the same frame on the CPU (plain traversal)."""
    import numpy as np
    from evplp_tpu_torch.runtime.loop import run_photon_fam

    out = {}
    cornell = os.path.join(HERE, "configs", "cornell", "cornell_ours.json")
    golden = dict(rngOffset=3, numMaxIteration=2, timeLimitMs=-1.0,
                  frameMode="accumulate", useJitter=True, useStat=False,
                  numLightPaths=128, numVplLightPaths=8, numMaxBounces=2,
                  radiusPercentage=0.05, combinedFilename="",
                  weightedPhotonFilename="", weightedVplFilename="")
    for name, extra in (("ours", {}),
                        ("ours_prog", dict(misMode="geometryClamp",
                                           DoProgressive=True,
                                           AlphaProgressive=0.7))):
        job = _small_job(cornell, (16, 16), dict(golden, **extra), "cuda")
        img = run_photon_fam(job).images["combined"]
        ref = np.load(os.path.join(HERE, "tests", "golden",
                                   f"{name}.npz"))["img"]
        np.testing.assert_allclose(img, ref, rtol=2e-3, atol=2e-4,
                                   err_msg=f"golden {name}")
        out[name] = float(np.abs(img - ref).max())
    small = dict(numMaxIteration=1, timeLimitMs=-1.0, numLightPaths=1000,
                 useStat=False, combinedFilename="",
                 weightedPhotonFilename="", weightedVplFilename="")
    imgs = [run_photon_fam(_small_job(CONFIG, (64, 36), small, dev))
            .images["combined"] for dev in ("cuda", "cpu")]
    out["box_field_64x36_cuda_vs_cpu"] = float(np.abs(imgs[0] - imgs[1]).max())
    out["box_field_64x36_max"] = float(np.abs(imgs[1]).max())
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-3, atol=1e-4,
                               err_msg="box_field 64x36 cuda vs cpu")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "evplp_tpu_torch")):
        print("chip_smoke: the evplp_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1: environment and build ----
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    from evplp_tpu_torch.native import bvh_native
    from evplp_tpu_torch.trace import traverse
    tb = time.perf_counter()
    traverse.load_library()
    bvh_native.load_library()
    build_s = time.perf_counter() - tb
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], device=kind, nvidia_smi=smi,
          build_s=build_s, wall_s=time.perf_counter() - t0)

    # ---- 2: kernel vs plain on the box_field scene ----
    t0 = time.perf_counter()
    from evplp_tpu_torch.scene.config import load_config
    job = load_config(CONFIG, device="cuda")
    scene = job.scene
    load_s = time.perf_counter() - t0
    entry = kernel_check(scene, job.width, job.height, torch)
    phase("kernel_check_done", triangles=scene.num_triangles,
          nodes=scene.bvh.node_min.shape[0], scene_load_s=load_s,
          wall_s=time.perf_counter() - t0)

    # ---- 3: the main path through the CLI at full size ----
    t0 = time.perf_counter()
    from evplp_tpu_torch import __main__ as cli
    from evplp_tpu_torch.utils.image import load_pfm
    with open(CONFIG) as f:
        block = json.load(f)["photonfam"]
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = write_config(CONFIG, tmp, dict(numMaxIteration=2,
                                                  timeLimitMs=-1.0))
        out_dir = os.path.join(tmp, "out")
        torch.cuda.reset_peak_memory_stats()
        traverse.launches = 0
        buf = io.StringIO()
        with LaunchTimer(traverse, torch) as timer, \
                contextlib.redirect_stdout(buf):
            rc = cli.main([cfg_path, "--output-dir", out_dir])
        launches = traverse.launches
        casts = timer.summary()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if rc != 0:
            raise AssertionError(f"CLI returned {rc}")
        stats = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
        imgs = {k: load_pfm(os.path.join(out_dir, os.path.basename(
            block[k]))) for k in ("combinedFilename", "weightedVplFilename",
                                  "weightedPhotonFilename")}
        with open(os.path.join(out_dir, os.path.basename(
                block["statFilename"]))) as f:
            stat = json.load(f)
    import numpy as np
    for k, img in imgs.items():
        if img.shape != (job.height, job.width, 3):
            raise AssertionError(f"{k}: shape {img.shape}")
        if not (np.isfinite(img).all() and (img >= 0).all()):
            raise AssertionError(f"{k}: non-finite or negative values")
    if not imgs["combinedFilename"].any():
        raise AssertionError("combined image is all zero")
    if stats["dropped_splat_pairs"] != 0:
        raise AssertionError(f"dropped {stats['dropped_splat_pairs']} pairs")
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    p = job.params
    b = p.num_max_bounces + 1
    n_px = job.width * job.height
    rays = n_px + p.num_light_paths * (b - 1) + n_px * p.num_vpl_light_paths * b
    frame_ms = stats["timeMs"] / stats["numIterations"]
    phase("main_path", config=os.path.relpath(CONFIG, HERE),
          width=job.width, height=job.height, iterations=stats["numIterations"],
          time_ms=stats["timeMs"], ms_per_frame=frame_ms,
          mray_per_s=rays / frame_ms / 1e3, rays_per_frame=rays,
          stat_json=stat, dropped_splat_pairs=stats["dropped_splat_pairs"],
          traverse_launches=launches, kernel_by_cast=casts,
          kernel_ms_per_frame=sum(c["ms"] for c in casts.values())
          / (stats["numIterations"] + 1),  # + the warm-up frame
          combined_mean=float(imgs["combinedFilename"].mean()),
          peak_mem_gib=peak_gib,
          device=kind, nvidia_smi=smi, wall_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    passes = pass_breakdown(job, torch)
    phase("pass_breakdown", ms_per_frame=passes,
          sum_ms=sum(passes.values()), wall_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase("reference_check", max_abs_diff=reference_check(),
          wall_s=time.perf_counter() - t0)

    # ---- 4: kernels line, card line, result ----
    kernel = {"name": "bvh_traverse", "route": "cuda",
              "source": "evplp_tpu_torch/csrc/traverse.cu",
              "replaces": "evplp_tpu/trace/packet3.py:63",
              "launches": launches, "max_abs_err": entry["max_abs_err"],
              "ms": entry["ms"], "plain_ms": entry["plain_ms"],
              "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
              "library_ms": None}
    phase("done", wall_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
