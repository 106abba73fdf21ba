#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card.  It
builds the port's kernels from the sources (one nvcc per source, all at
once) and holds each kernel against its plain PyTorch version on samples of
the main paths' inputs.  It drives two paths through the port's CLI at full
size: the EVPLP "ours" photonfam config
`configs/box_field/box_field_ours.json` (1280x720, 300k light paths, 30 VPL
paths, 4 records) for two frames, and the VSL config
`configs/box_field/box_field_vsl.json` (1280x720, 100 VSL paths, 400
records, forceVsl) for one frame plus the warm-up.  It checks their
outputs and the kernels each one launched, times each pass of both frames,
and renders small references on the card (the Cornell goldens, and 64x36
box_field frames against the same frames on the CPU).  Each phase prints
one line; any failure raises and exits non-zero.  The line before the last
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
VSL_CONFIG = os.path.join(HERE, "configs", "box_field", "box_field_vsl.json")
SAMPLE_RAYS = 65_536
SAMPLE_PIXELS = 65_536
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
# operations of the VSL sample kernel, counted from csrc/vsl_sample.cu:
# per sample 660 float operations (sin, cos, pow and sqrt count as one
# each, so the bound is a lower bound) and 64 integer operations of the two
# pcg4d draws; per gated (pixel, record) pair 33 float operations of setup
VSL_SAMPLE_OPS = 660 + 64
VSL_PAIR_OPS = 33
# bytes a pixel moves per group of G records: 16 planes, id and gate bits
# in, G cos_half and count planes in, 3 floats out
VSL_PIXEL_BYTES = 4 * (16 + 2 + 3)
VSL_PIXEL_RECORD_BYTES = 8
# the VSL golden's two pixels whose shadow test turns on the last bit of a
# light vertex (tests/test_torch_frame.py GOLDEN_FLIPS)
GOLDEN_FLIPS = {"ours": 0, "ours_prog": 0, "vsl": 2}


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
            live = (t_max > t_min).sum() if any_hit else o.shape[0]
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
            k["live_rays"] += int(live)
            k["ms"] += s.elapsed_time(e)
            k["bytes_bound_ms"] += ((RAY_BYTES * rays + scene_bytes)
                                    / PEAK_BYTES_PER_S * 1e3)
        return out


def vsl_work(gates, counts, torch):
    """Gated (pixel, record) pairs and the samples they take,
    sum of min(count, 101), as 0-d device tensors."""
    from evplp_tpu_torch.integrators.vsl_kernel import MAX_VSL_SAMPLES
    g = counts.shape[0]
    ids = torch.arange(g, dtype=torch.int32, device=gates.device)[:, None]
    bits = (gates[None, :] >> ids) & 1
    return (bits.sum(),
            (bits * torch.clamp_max(counts, MAX_VSL_SAMPLES)).sum())


def vsl_bound_ms(n, g, pairs, samples) -> tuple:
    """(bytes bound, operations bound) in ms of one group call."""
    bytes_ms = ((VSL_PIXEL_BYTES + VSL_PIXEL_RECORD_BYTES * g) * n
                + 96 * g) / PEAK_BYTES_PER_S * 1e3
    ops_ms = (VSL_SAMPLE_OPS * samples + VSL_PAIR_OPS * pairs
              ) / PEAK_F32_PER_S * 1e3
    return bytes_ms, ops_ms


class VslLaunchTimer:
    """Times every VSL sample-kernel launch of a run with CUDA events, and
    counts the gated pairs and samples each launch was given, by standing
    in for vsl_kernel.vsl_sample_group_cuda while the run lasts."""

    def __init__(self, vsl_kernel_mod, torch):
        self.mod, self.torch = vsl_kernel_mod, torch
        self.real = vsl_kernel_mod.vsl_sample_group_cuda
        self.events = []

    def __enter__(self):
        def timed(pix, pixel_ids, gates, cos_half, counts, table, *rest):
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.real(pix, pixel_ids, gates, cos_half, counts, table,
                            *rest)
            ev[1].record()
            self.events.append((pix.shape[1], table.shape[0],
                                vsl_work(gates, counts, self.torch), ev))
            return out
        self.mod.vsl_sample_group_cuda = timed
        return self

    def __exit__(self, *exc):
        self.mod.vsl_sample_group_cuda = self.real

    def summary(self) -> dict:
        """Launches, gated pairs, samples, kernel ms and both bounds."""
        self.torch.cuda.synchronize()
        out = dict(launches=0, pairs=0, samples=0, ms=0.0,
                   bytes_bound_ms=0.0, ops_bound_ms=0.0)
        for n, g, (pairs, samples), (s, e) in self.events:
            pairs, samples = int(pairs), int(samples)
            bytes_ms, ops_ms = vsl_bound_ms(n, g, pairs, samples)
            out["launches"] += 1
            out["pairs"] += pairs
            out["samples"] += samples
            out["ms"] += s.elapsed_time(e)
            out["bytes_bound_ms"] += bytes_ms
            out["ops_bound_ms"] += ops_ms
        return out


def vsl_group_inputs(job, torch) -> tuple:
    """The arguments of one real VSL group call at full size: the frame's
    G-buffer and one light trace of the config's first frame, the pass's
    seeds, and the first group of 8 records whose gates (from the traversal
    kernel) are not all empty."""
    from evplp_tpu_torch.core import mathutil as mu
    from evplp_tpu_torch.core import rng
    from evplp_tpu_torch.core.sampling import iteration_key
    from evplp_tpu_torch.integrators import vsl, vsl_kernel
    from evplp_tpu_torch.integrators.gbuffer import trace_gbuffer
    from evplp_tpu_torch.integrators.light_trace import trace_light_paths

    p, scene = job.params, job.scene
    dev = scene.device
    key = iteration_key(0, p.rng_offset, dev)
    u = rng.uniform(rng.fold_in(key, 999), (2,))
    jitter = (2.0 * u - 1.0) / torch.tensor([job.width, job.height],
                                             dtype=torch.float32,
                                             device=dev)
    gbuf = trace_gbuffer(scene, job.width, job.height, jitter)
    pm = trace_light_paths(scene, rng.fold_in(key, 1), p.num_light_paths,
                           p.num_max_bounces + 1)
    seed0, seed1 = (int(x) for x in rng.seeds_from_key(rng.fold_in(key, 2)))
    r = torch.tensor(max(scene.bounding_radius * p.vsl_radius_percentage,
                         0.008), dtype=torch.float32, device=dev)
    records = vsl._records_of(pm, p.num_vpl_light_paths)
    m = records["pos"].shape[0]
    group = vsl.TRACE_GROUP
    shifts = torch.arange(group, dtype=torch.int32, device=dev)[:, None]
    for g0 in range(0, m - group + 1, group):
        recs = {k: v[g0:g0 + group] for k, v in records.items()}
        gates = vsl._group_occlusion(scene, gbuf.position, gbuf.normal,
                                     gbuf.stencil, recs)
        if bool(gates.any()):
            break
    else:
        raise AssertionError("every VSL group's gates are empty")
    mask = torch.sum(gates.to(torch.int32) << shifts, dim=0,
                     dtype=torch.int32)
    cos_half, counts = vsl_kernel.ctx_planes(gbuf.position, recs["pos"], r)
    cam = torch.tensor(scene.camera.origin, dtype=torch.float32,
                       device=dev)
    wi10 = mu.normalize(cam[None, :] - gbuf.position)
    pix = vsl_kernel.pack_pixels(gbuf.position, gbuf.normal, gbuf.kd,
                                 gbuf.ks, gbuf.ns, wi10)
    table = vsl_kernel.pack_records(
        recs, torch.tensor(mu.INV_PI, dtype=torch.float32, device=dev)
        / (r * r))
    pixel_ids = torch.arange(pix.shape[1], dtype=torch.int32, device=dev)
    return (pix, pixel_ids, mask, cos_half, counts, table, seed0, seed1,
            g0), float(r)


def vsl_kernel_check(job, torch) -> dict:
    """The VSL kernel against its plain version on SAMPLE_PIXELS pixels in
    the middle of the frame, for one real group; returns the kernel entry."""
    from evplp_tpu_torch.integrators import vsl_kernel

    t0 = time.perf_counter()
    full, radius = vsl_group_inputs(job, torch)
    pix, pixel_ids, mask, cos_half, counts, table = full[:6]
    n = pix.shape[1]
    mid = (n - SAMPLE_PIXELS) // 2
    sl = slice(mid, mid + SAMPLE_PIXELS)
    args = (pix[:, sl].contiguous(), pixel_ids[sl].contiguous(),
            mask[sl].contiguous(), cos_half[:, sl].contiguous(),
            counts[:, sl].contiguous(), table) + full[6:]
    setup_s = time.perf_counter() - t0
    k = vsl_kernel.vsl_sample_group_cuda(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = vsl_kernel.vsl_sample_group_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000.0
    close = torch.isclose(k, p, rtol=2e-4, atol=2e-5).all(dim=1)
    outside = int((~close).sum())
    err = float((k - p).abs().max())
    ms = cuda_ms(lambda: vsl_kernel.vsl_sample_group_cuda(*args), reps=20)
    pairs, samples = (int(x) for x in vsl_work(args[2], args[4], torch))
    bytes_ms, ops_ms = vsl_bound_ms(SAMPLE_PIXELS, table.shape[0], pairs,
                                    samples)
    phase("vsl_kernel_check", config=os.path.relpath(VSL_CONFIG, HERE),
          pixels=SAMPLE_PIXELS, records=table.shape[0], rec_base=args[8],
          vsl_radius=radius, gated_pairs=pairs, samples=samples,
          gated_pixels=int((args[2] != 0).sum()),
          max_count=int(args[4].max()), kernel_ms=ms, plain_ms=plain_ms,
          max_abs_err=err, max_value=float(p.abs().max()),
          pixels_outside_tol=outside, bytes_bound_ms=bytes_ms,
          ops_bound_ms=ops_ms, setup_s=setup_s)
    if outside != 0 or not bool(p.abs().max() > 0):
        raise AssertionError(f"VSL kernel disagrees with plain on {outside} "
                             "pixels (rtol 2e-4, atol 2e-5), or all zero")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def pass_breakdown(job, torch, names) -> dict:
    """Mean host-clock ms of each pass `names` of the full-size frame, with
    the device synchronized around every pass (two frames: the warm-up and
    one timed frame of run_photon_fam, with no file output)."""
    import dataclasses
    from evplp_tpu_torch.integrators import photon_fam as pf
    from evplp_tpu_torch.runtime.loop import run_photon_fam

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


def _outside(img, ref, rtol, atol) -> int:
    """Pixels with any channel outside rtol / atol."""
    import numpy as np
    return int((~np.isclose(img, ref, rtol=rtol, atol=atol).all(axis=-1)).sum())


def reference_check() -> dict:
    """Small renders on the card against references: the Cornell goldens
    tests/golden/{ours,ours_prog,vsl}.npz (dense ray casts) at the goldens'
    rtol 2e-3 / atol 2e-4 (the VSL golden but for its GOLDEN_FLIPS pixels),
    and 64x36 box_field "ours" and VSL frames (kernel ray casts, the VSL
    sample kernel) against the same frames on the CPU (plain versions)."""
    import numpy as np
    from evplp_tpu_torch.runtime.loop import run_photon_fam

    out = {}
    cornell = os.path.join(HERE, "configs", "cornell", "cornell_ours.json")
    common = dict(rngOffset=3, numMaxIteration=2, timeLimitMs=-1.0,
                  frameMode="accumulate", useJitter=True, useStat=False,
                  combinedFilename="", weightedPhotonFilename="",
                  weightedVplFilename="")
    golden = dict(common, numLightPaths=128, numVplLightPaths=8,
                  numMaxBounces=2, radiusPercentage=0.05)
    vsl = dict(common, numLightPaths=64, numVplLightPaths=64,
               numMaxBounces=2, radiusPercentage=0.0, forceVsl=True,
               vslRadiusPercentage=0.05, misMode="one")
    for name, block in (("ours", golden),
                        ("ours_prog", dict(golden, misMode="geometryClamp",
                                           DoProgressive=True,
                                           AlphaProgressive=0.7)),
                        ("vsl", vsl)):
        job = _small_job(cornell, (16, 16), block, "cuda")
        img = run_photon_fam(job).images["combined"]
        ref = np.load(os.path.join(HERE, "tests", "golden",
                                   f"{name}.npz"))["img"]
        outside = _outside(img, ref, 2e-3, 2e-4)
        out[name] = float(np.abs(img - ref).max())
        out[name + "_pixels_outside"] = outside
        if outside > GOLDEN_FLIPS[name]:
            raise AssertionError(f"golden {name}: {outside} pixels outside "
                                 "rtol 2e-3 / atol 2e-4")
    small = dict(numMaxIteration=1, timeLimitMs=-1.0, useStat=False,
                 combinedFilename="", weightedPhotonFilename="",
                 weightedVplFilename="")
    for name, config, block in (
            ("box_field", CONFIG, dict(small, numLightPaths=1000)),
            ("box_field_vsl", VSL_CONFIG, dict(small, numVplLightPaths=8))):
        imgs = [run_photon_fam(_small_job(config, (64, 36), block, dev))
                .images["combined"] for dev in ("cuda", "cpu")]
        outside = _outside(imgs[0], imgs[1], 1e-3, 1e-4)
        out[f"{name}_64x36_cuda_vs_cpu"] = float(np.abs(imgs[0]
                                                        - imgs[1]).max())
        out[f"{name}_64x36_max"] = float(np.abs(imgs[1]).max())
        out[f"{name}_64x36_pixels_outside"] = outside
        if outside or not imgs[1].any():
            raise AssertionError(f"{name} 64x36: {outside} pixels outside "
                                 "rtol 1e-3 / atol 1e-4 (cuda vs cpu)")
    return out


def drive_cli(config, iterations, torch) -> dict:
    """Run `config` through the CLI at full size for `iterations` timed
    frames (plus the warm-up), with every kernel count set to 0 just
    before and read just after; check and return what it produced."""
    import numpy as np
    from evplp_tpu_torch import __main__ as cli
    from evplp_tpu_torch.integrators import vsl_kernel
    from evplp_tpu_torch.trace import traverse
    from evplp_tpu_torch.utils.image import load_pfm

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = write_config(config, tmp, dict(numMaxIteration=iterations,
                                                  timeLimitMs=-1.0))
        with open(cfg_path) as f:
            cfg = json.load(f)
        block = cfg["photonfam"]
        out_dir = os.path.join(tmp, "out")
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        traverse.launches = 0
        vsl_kernel.launches = 0
        with LaunchTimer(traverse, torch) as timer, \
                VslLaunchTimer(vsl_kernel, torch) as vsl_timer, \
                contextlib.redirect_stdout(buf):
            rc = cli.main([cfg_path, "--output-dir", out_dir])
        launches = dict(bvh_traverse=traverse.launches,
                        vsl_sample=vsl_kernel.launches)
        casts = timer.summary()
        vsl_calls = vsl_timer.summary()
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
    for k, img in imgs.items():
        if img.shape != (cfg["resY"], cfg["resX"], 3):
            raise AssertionError(f"{k}: shape {img.shape}")
        if not (np.isfinite(img).all() and (img >= 0).all()):
            raise AssertionError(f"{k}: non-finite or negative values")
    if not imgs["combinedFilename"].any():
        raise AssertionError("combined image is all zero")
    if stats["dropped_splat_pairs"] != 0:
        raise AssertionError(f"dropped {stats['dropped_splat_pairs']} pairs")
    if launches["bvh_traverse"] == 0:
        raise AssertionError("the main path never launched the traversal "
                             "kernel")
    return dict(stats=stats, stat=stat, imgs=imgs, launches=launches,
                casts=casts, vsl_calls=vsl_calls, peak_gib=peak_gib,
                frames=stats["numIterations"] + 1,  # + the warm-up frame
                wall_s=time.perf_counter() - t0)


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

    # ---- 1: environment and build (one compiler per source, together) ----
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    from concurrent.futures import ThreadPoolExecutor
    from evplp_tpu_torch.integrators import vsl_kernel
    from evplp_tpu_torch.native import bvh_native
    from evplp_tpu_torch.trace import traverse

    def timed_build(mod):
        tb = time.perf_counter()
        mod.load_library()
        return time.perf_counter() - tb

    mods = {"traverse": traverse, "vsl_sample": vsl_kernel,
            "bvh_builder": bvh_native}
    with ThreadPoolExecutor(len(mods)) as pool:
        futures = {k: pool.submit(timed_build, m) for k, m in mods.items()}
        build_s = {k: f.result() for k, f in futures.items()}
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], device=kind, nvidia_smi=smi,
          build_s=build_s, wall_s=time.perf_counter() - t0)

    # ---- 2: traversal kernel vs plain on the box_field scene ----
    t0 = time.perf_counter()
    from evplp_tpu_torch.scene.config import load_config
    job = load_config(CONFIG, device="cuda")
    scene = job.scene
    load_s = time.perf_counter() - t0
    entry = kernel_check(scene, job.width, job.height, torch)
    phase("kernel_check_done", triangles=scene.num_triangles,
          nodes=scene.bvh.node_min.shape[0], scene_load_s=load_s,
          wall_s=time.perf_counter() - t0)

    # ---- 3: the "ours" main path through the CLI at full size ----
    run = drive_cli(CONFIG, 2, torch)
    stats, casts = run["stats"], run["casts"]
    if run["launches"]["vsl_sample"] != 0:
        raise AssertionError("the ours path launched the VSL kernel")
    p = job.params
    b = p.num_max_bounces + 1
    n_px = job.width * job.height
    rays = n_px + p.num_light_paths * (b - 1) + n_px * p.num_vpl_light_paths * b
    frame_ms = stats["timeMs"] / stats["numIterations"]
    phase("main_path", config=os.path.relpath(CONFIG, HERE),
          width=job.width, height=job.height, iterations=stats["numIterations"],
          time_ms=stats["timeMs"], ms_per_frame=frame_ms,
          mray_per_s=rays / frame_ms / 1e3, rays_per_frame=rays,
          stat_json=run["stat"],
          dropped_splat_pairs=stats["dropped_splat_pairs"],
          traverse_launches=run["launches"]["bvh_traverse"],
          kernel_by_cast=casts,
          kernel_ms_per_frame=sum(c["ms"] for c in casts.values())
          / run["frames"],
          combined_mean=float(run["imgs"]["combinedFilename"].mean()),
          peak_mem_gib=run["peak_gib"],
          device=kind, nvidia_smi=smi, wall_s=run["wall_s"])
    launches = dict(run["launches"])

    t0 = time.perf_counter()
    passes = pass_breakdown(job, torch, (
        "trace_gbuffer", "trace_light_paths", "vpl_gather",
        "photon_splat_binned", "light_image"))
    phase("pass_breakdown", config=os.path.relpath(CONFIG, HERE),
          ms_per_frame=passes, sum_ms=sum(passes.values()),
          wall_s=time.perf_counter() - t0)

    # ---- 4: VSL kernel vs plain on one real group at full size ----
    t0 = time.perf_counter()
    vjob = load_config(VSL_CONFIG, device="cuda")
    vsl_entry = vsl_kernel_check(vjob, torch)
    phase("vsl_kernel_check_done", wall_s=time.perf_counter() - t0)

    # ---- 5: the VSL main path through the CLI at full size ----
    vrun = drive_cli(VSL_CONFIG, 1, torch)
    vstats, vcasts, vcalls = vrun["stats"], vrun["casts"], vrun["vsl_calls"]
    if vrun["launches"]["vsl_sample"] == 0:
        raise AssertionError("the VSL path never launched the VSL kernel")
    if not vrun["imgs"]["weightedVplFilename"].any():
        raise AssertionError("the VSL image is all zero")
    frames = vrun["frames"]
    shadow = vcasts.get("any_hit", {})
    phase("vsl_main_path", config=os.path.relpath(VSL_CONFIG, HERE),
          width=vjob.width, height=vjob.height,
          iterations=vstats["numIterations"], time_ms=vstats["timeMs"],
          ms_per_frame=vstats["timeMs"] / vstats["numIterations"],
          stat_json=vrun["stat"],
          dropped_splat_pairs=vstats["dropped_splat_pairs"],
          launches=vrun["launches"],
          shadow_segments_per_frame=shadow.get("rays", 0) / frames,
          live_shadow_segments_per_frame=shadow.get("live_rays", 0) / frames,
          gated_pairs_per_frame=vcalls["pairs"] / frames,
          samples_per_frame=vcalls["samples"] / frames,
          vsl_kernel_ms_per_frame=vcalls["ms"] / frames,
          vsl_kernel_ops_bound_ms_per_frame=vcalls["ops_bound_ms"] / frames,
          vsl_kernel_bytes_bound_ms_per_frame=vcalls["bytes_bound_ms"]
          / frames,
          traverse_kernel_ms_per_frame=sum(c["ms"] for c in vcasts.values())
          / frames, kernel_by_cast=vcasts,
          weighted_vpl_mean=float(vrun["imgs"]["weightedVplFilename"].mean()),
          peak_mem_gib=vrun["peak_gib"],
          device=kind, nvidia_smi=smi, wall_s=vrun["wall_s"])
    for k, v in vrun["launches"].items():
        launches[k] += v

    t0 = time.perf_counter()
    passes = pass_breakdown(vjob, torch, (
        "trace_gbuffer", "trace_light_paths", "vsl_gather",
        "photon_splat_binned", "light_image"))
    phase("pass_breakdown", config=os.path.relpath(VSL_CONFIG, HERE),
          ms_per_frame=passes, sum_ms=sum(passes.values()),
          wall_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    phase("reference_check", max_abs_diff=reference_check(),
          wall_s=time.perf_counter() - t0)

    # ---- 6: kernels line, card line, result ----
    kernels = [
        {"name": "bvh_traverse", "route": "cuda",
         "source": "evplp_tpu_torch/csrc/traverse.cu",
         "replaces": "evplp_tpu/trace/packet3.py:63",
         "launches": launches["bvh_traverse"],
         "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
         "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
         "bound_by": entry["bound_by"], "library_ms": None},
        {"name": "vsl_sample_group", "route": "cuda",
         "source": "evplp_tpu_torch/csrc/vsl_sample.cu",
         "replaces": "evplp_tpu/integrators/vsl_kernel.py:154",
         "launches": launches["vsl_sample"],
         "max_abs_err": vsl_entry["max_abs_err"], "ms": vsl_entry["ms"],
         "plain_ms": vsl_entry["plain_ms"], "bound_ms": vsl_entry["bound_ms"],
         "bound_by": vsl_entry["bound_by"], "library_ms": None},
    ]
    phase("done", wall_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
