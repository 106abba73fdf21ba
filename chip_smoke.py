#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card.  It
builds the port's kernels from the sources (one nvcc per source, all at
once) and holds each kernel against its plain PyTorch version on samples of
the main paths' inputs: the three BVH traversal kernels (traverse.cu,
packet7.cu, packet.cu) and the VSL sample kernel.  The VSL sample kernel
(vsl_sample.cu) is held to its plain version bit for bit on two real
full-size groups of the VSL frame, after a phase (vsl_work_shape) that
prints the shape of its work there: the lane efficiency of four work
layouts, the share of samples in which each strategy's guard holds, the
share of pairs without a phong lobe, and the operations the inputs need,
from which its operations bound is counted.  The three traversal kernels
are held to the skip-pointer walk traverse_plain exactly (t, prim, u, v)
and to their own walks' plain versions, on three ray samples, after a
phase (traversal_work_shape) that prints the shape of each walk's work
there: box and triangle tests, the packet's node efficiency, the
two-level loop's inner and drain lane efficiency.  traverse.cu, the
default traversal, is also held to traverse_plain on a sample of each cast
kind of the "ours" and VSL frames, and all three on every recorded PT cast;
a ray on which they differ fails the run, printed with the box graze that
explains it if there is one (box_grazes).  It drives
these paths through the port's CLI at full size (1280x720), each with
every kernel count set to 0 just before and read just after: the EVPLP
"ours" photonfam
config `configs/box_field/box_field_ours.json` (300k light paths, 30 VPL
paths, 4 records) for two frames; the VSL config
`configs/box_field/box_field_vsl.json` (100 VSL paths, 400 records,
forceVsl), the path-tracing config `configs/box_field/box_field_pt.json`
(3 bounces, 1 spp), and the PM and VPL configs `box_field_pm.json` and
`box_field_vpl.json`, for the frames their constants say, each plus the
warm-up.  It renders the same full-size PT frame under each value of the
traversal switch `trace/intersect.py:PACKET_IMPL`, holds the three
kernels to each other cast by cast, and the three images to each other bit
for bit.  It checks the outputs and the kernels
each path launched, times each pass, and renders small references on the
card (the Cornell goldens, and 64x36 box_field frames against the same
frames on the CPU).  Each phase prints one line; any failure raises and
exits non-zero.  Operations bounds count the fewest operations of four
walks (the skip-pointer walk and the three kernels' walks) on samples of
each cast.  The line before the last is a JSON object with one entry per
kernel; the last line is
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
PT_CONFIG = os.path.join(HERE, "configs", "box_field", "box_field_pt.json")
PM_CONFIG = os.path.join(HERE, "configs", "box_field", "box_field_pm.json")
VPL_CONFIG = os.path.join(HERE, "configs", "box_field", "box_field_vpl.json")
CORNELL = os.path.join(HERE, "configs", "cornell")
PT_FRAMES = 3            # timed PT frames through the CLI (+ the warm-up)
SAMPLE_RAYS = 65_536
# camera ray of the PT frame that grazes a leaf box's silhouette (ROADMAP
# queue 3, fault 3): traverse_plain and every kernel must report triangle
# FAULT3_PRIM at t = 3.7943268
FAULT3_RAY = 806_878
FAULT3_PRIM = 24_327
# live rays of each PT cast whose walks are counted for the frame's
# operations bound (a strided sample, scaled to the cast's live rays)
FRAME_OPS_SAMPLE = 4096
# rays of each sampled main-path cast on which kernel #1 is held to
# traverse_plain (a strided sample of its live rays)
CHECK_RAYS = 65_536
SAMPLE_PIXELS = 65_536
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float operations of the traversal walks' inner steps, counted from
# csrc/ray_common.cuh: one slab test (6 sub, 6 mul, 10 min/max, 3
# compares) and one Moller-Trumbore test (53 add/mul/div/compare); a step
# of the ordered walk over the walk records (every kernel's) is two slab
# tests plus 10 (the leaf box's widening, the near-first compare and the
# selects of the push or pop)
SLAB_OPS = 25
TRI_OPS = 53
WALK_STEP_OPS = 2 * SLAB_OPS + 10
# bytes a ray moves: o, d, t_min, t_max in; t, prim, u, v out
RAY_BYTES = 48
# the three traversal kernels, each held to traverse_plain: module, CUDA
# wrapper, the walk it takes (of WALKS, whose plain version takes its
# steps), the walk its wrapper runs on the CPU (its plain version, timed),
# the PACKET_IMPL value that selects it, its source and the TPU kernel it
# replaces
TRAVERSALS = {
    "bvh_traverse": dict(module="traverse", cuda="traverse_cuda",
                         walk="ordered", plain="skip_pointer", impl="packet3",
                         source="evplp_tpu_torch/csrc/traverse.cu",
                         replaces="evplp_tpu/trace/packet3.py:63"),
    "packet7": dict(module="packet7", cuda="packet7_cuda", walk="packet7",
                    plain="packet7", impl="packet7",
                    source="evplp_tpu_torch/csrc/packet7.cu",
                    replaces="evplp_tpu/trace/packet7.py:48"),
    "packet": dict(module="packet", cuda="packet_cuda", walk="packet",
                   plain="packet", impl="packet",
                   source="evplp_tpu_torch/csrc/packet.cu",
                   replaces="evplp_tpu/trace/packet.py:53"),
}
# the four walks that compute the traversal function, each as (module,
# plain version that takes its steps and counts them): the JAX package's
# skip-pointer walk and the three kernels' walks
WALKS = {"skip_pointer": ("traverse", "traverse_plain"),
         "ordered": ("traverse", "walk_plain"),
         "packet7": ("packet7", "packet7_plain"),
         "packet": ("packet", "packet_plain")}
KERNELS = tuple(TRAVERSALS) + ("vsl_sample",)
# the PT frames under the three traversal kernels: pixels that differ at
# all, at most this many (the kernels equal traverse_plain ray for ray, so
# the frames are bit-equal)
PT_IMPL_MAX_PIXELS = 0
# operations of the VSL sample kernel, counted from csrc/vsl_sample.cu;
# sin, cos, pow and sqrt count as one operation each and a negation as none
# (an operand modifier), so every bound is a lower bound.  The count of
# all the work, every strategy and both lobes on every sample (the bound of
# the kernel's one-thread-a-pixel design): 660 float and 64 integer
# operations a sample, 33 a gated (pixel, record) pair
VSL_ALL_SAMPLE_OPS = 660 + 64
VSL_ALL_PAIR_OPS = 33
# The count of what the inputs need (vsl_ops_per_sample), each term on the
# samples or pairs where the kernel does it: every sample's two pcg4d
# draws (64 integer), cone direction, its cosines and guard, eye-BRDF
# direction (either lobe's: 39) and cone test, and the sum (185); the
# light-BRDF direction and cone test where the record is not black (47);
# each strategy's evaluation where its guard holds, phong terms apart
# (cone 64, eye BRDF 70, light BRDF 64); a phong value on the record side
# (10), on the eye side with its reflect (22), a phong pdf (9), a phong
# lobe's weight beyond a lambert one's (10); and a gated pair's setup and
# sum (26).
VSL_NEED_OPS = dict(samples=185, light_dir=47, cone=64, eye_brdf=70,
                    light_brdf=64, phong_f_rec=10, phong_f_eye=22,
                    phong_pdf=9, phong_weight=10, pairs=26)
# the VSL sample kernel's pixels a block and the sample count above which
# a pair takes a warp (csrc/vsl_sample.cu kBlock, kWarpPairSteps)
VSL_BLOCK = 256
VSL_WARP_PAIR_STEPS = 24
# bytes a pixel moves per group of G records: 16 planes, id and gate bits
# in, G cos_half and count planes in, 3 floats out
VSL_PIXEL_BYTES = 4 * (16 + 2 + 3)
VSL_PIXEL_RECORD_BYTES = 8
# the VSL golden's two pixels (row, col) whose shadow test turns on the
# last bit of a light vertex (tests/test_torch_frame.py GOLDEN_FLIPS)
GOLDEN_FLIPS = {"ours": set(), "ours_prog": set(), "vsl": {(14, 6), (14, 7)},
                "pt": set()}


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


def traversal_module_named(module):
    import importlib
    return importlib.import_module("evplp_tpu_torch.trace." + module)


def traversal_module(name):
    return traversal_module_named(TRAVERSALS[name]["module"])


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


def scene_bytes(name, tris, bvh) -> int:
    """Bytes of the scene arrays a traversal kernel reads, each once: the
    64-byte node and 48-byte triangle records of the walk, which all three
    read."""
    return 64 * bvh.walk_nodes.shape[0] + 48 * bvh.walk_tris.shape[0]


def walk_ops(walk, work) -> int:
    """Operations of a walk, from its plain version's counts: box tests
    ("slabs", the skip-pointer walk) or steps of two ("steps", the walks
    over the walk records), and ray-triangle tests."""
    if "steps" in work:
        return WALK_STEP_OPS * work["steps"] + TRI_OPS * work["tris"]
    return SLAB_OPS * work.get("slabs", 0) + TRI_OPS * work["tris"]


def run_walk(walk, tris, bvh, o, d, lo, hi, any_hit) -> tuple:
    """(result, operations, counts) of a walk's plain version on these
    rays; counts are its box tests ("slabs", or "steps" of two) and
    ray-triangle tests ("tris")."""
    mod, fn = WALKS[walk]
    work: dict = {}
    out = getattr(traversal_module_named(mod), fn)(tris, bvh, o, d, lo, hi,
                                                   any_hit, work=work)
    return out, walk_ops(walk, work), work


def least_walk_ops(tris, bvh, o, d, lo, hi, any_hit) -> tuple:
    """(operations, walk): the fewest operations any of the four walks
    needs for these rays.  All of them compute one function, so this
    count, not a kernel's own walk, is what bounds each traversal kernel."""
    ops = {w: run_walk(w, tris, bvh, o, d, lo, hi, any_hit)[1]
           for w in WALKS}
    walk = min(ops, key=ops.get)
    return ops[walk], walk


def differs(k, p, t_min, t_max, any_hit):
    """Bool mask of the rays on which two results of the traversal
    function differ at all: t, prim, u or v (closest hits), the occlusion
    of a live lane (any hit, whose t and prim are those of whichever hit
    was found first)."""
    if any_hit:
        return (t_max > t_min) & ((k[1] >= 0) != (p[1] >= 0))
    return ((k[0] != p[0]) | (k[1] != p[1]) | (k[2] != p[2])
            | (k[3] != p[3]))


def box_grazes(bvh, o, d, a, b, rays, leaf_a, leaf_b, any_hit) -> list:
    """For each ray index on which results a and b (t, prim, u, v)
    disagree: the proof that the disagreement is a box graze, or None.

    The better of the two hits (the least (t, slot); for any hit, the one
    that hit) lies in a leaf.  The walk that missed it must reject one of
    the boxes enclosing that triangle, the root's down to the leaf's, by its
    own test at its own final t (a walk that rejects a box at some t
    rejects it at every smaller t): the exact slab test for internal
    boxes, and for the leaf box leaf_a / leaf_b, None for no test (the
    skip-pointer walk), else the factors (far, t) by which its test widens
    t_far and t ((1.0, 1.0): exact).  Such a box holds a triangle the ray
    hits at t* <= that t, so only rounding rejects it: the ray grazes the
    box's silhouette.  The proof names the ray, the better hit's prim and
    t, the box's node and its depth above the leaf."""
    import torch
    from evplp_tpu_torch.trace.traverse import BIG
    if not rays:
        return []
    count = bvh.node_count.cpu().numpy()
    first = bvh.node_first.cpu().numpy()
    skip = bvh.node_skip.cpu().numpy()
    n = count.shape[0]
    parent = [-1] * n
    leaf_of = {}
    for i in range(n):
        if count[i] == 0:
            parent[i + 1] = i
            if skip[i + 1] < n:
                parent[skip[i + 1]] = i
        else:
            for s in range(first[i], first[i] + count[i]):
                leaf_of[s] = i
    nmin, nmax = bvh.node_min.cpu(), bvh.node_max.cpu()
    sel = torch.tensor(rays, dtype=torch.long, device=o.device)
    oo, dd = o[sel].cpu(), d[sel].cpu()
    ra = [x[sel].cpu() for x in a]
    rb = [x[sel].cpu() for x in b]
    out = []
    for j, ray in enumerate(rays):
        ta, pa, tb, pb = (float(ra[0][j]), int(ra[1][j]), float(rb[0][j]),
                          int(rb[1][j]))
        if any_hit:
            a_better = pa >= 0
        else:
            a_better = pb < 0 or (pa >= 0 and (ta, pa) < (tb, pb))
        prim, t_best = (pa, ta) if a_better else (pb, tb)
        t_w = tb if a_better else ta
        leaf_w = leaf_b if a_better else leaf_a
        proof = None
        if prim >= 0:
            di = dd[j]
            inv = torch.where(torch.abs(di) > 1e-20, 1.0 / di,
                              torch.where(di >= 0, BIG, -BIG))
            node, depth = leaf_of[prim], 0
            while node >= 0:
                t0 = (nmin[node] - oo[j]) * inv
                t1 = (nmax[node] - oo[j]) * inv
                near = torch.amax(torch.minimum(t0, t1))
                far = torch.amin(torch.maximum(t0, t1))
                tw = torch.tensor(t_w, dtype=torch.float32)
                if depth > 0:
                    enter = (near <= far) & (far >= 0.0) & (near <= tw)
                elif leaf_w is None:
                    enter = True
                else:
                    enter = ((near <= far * leaf_w[0]) & (far >= 0.0)
                             & (near <= tw * leaf_w[1]))
                if not bool(enter):
                    proof = dict(ray=ray, prim=prim, t=t_best, missed_by_t=t_w,
                                 node=node, above_leaf=depth,
                                 t_near=float(near), t_far=float(far))
                    break
                node, depth = parent[node], depth + 1
        out.append(proof)
    return out


def exact_check(label, bvh, o, d, lo, hi, any_hit, k, p) -> dict:
    """Hold a traversal kernel's result k to traverse_plain's p on every
    ray: equal t (bit for bit), prim, u and v, or for any hit equal
    occlusion.  Any ray that differs fails the check; the first 20 are
    printed first, with the proof that each is a box graze where
    box_grazes finds one (a diagnostic: a graze excuses nothing).  Returns
    the counts."""
    import torch
    from evplp_tpu_torch.trace.traverse import LEAF_WIDEN, LEAF_WIDEN_T
    rays = torch.nonzero(differs(k, p, lo, hi, any_hit)).squeeze(1).tolist()
    proofs = box_grazes(bvh, o, d, k, p, rays[:20],
                        (LEAF_WIDEN, LEAF_WIDEN_T), None, any_hit)
    both = (k[1] >= 0) & (p[1] >= 0)
    out = dict(rays=o.shape[0], any_hit=any_hit, differing=len(rays),
               max_abs_err=0.0 if any_hit or not bool(both.any()) else
               float((k[0] - p[0])[both].abs().max()))
    for i, proof in zip(rays[:20], proofs):
        phase("differing_ray", check=label, ray=i, any_hit=any_hit,
              kernel=[float(k[0][i]), int(k[1][i])],
              plain=[float(p[0][i]), int(p[1][i])], box_graze=proof)
    if rays:
        raise AssertionError(
            f"{label}: the kernel differs from traverse_plain on "
            f"{len(rays)} rays ({sum(x is not None for x in proofs)} of the "
            f"first {len(proofs)} box grazes): rays {rays[:4]}")
    return out


def kernel_check(name, sets, scene, torch) -> dict:
    """A traversal kernel against traverse_plain (exact_check) and against
    its own walk's plain version (equal results) on each ray set; returns
    the kernel's entry, with its plain version's time (the walk its
    wrapper runs on the CPU), the bytes bound and the operations and
    counts of each walk it ran on each set (traversal_bounds turns the
    operations into its bound, traversal_work_shape prints the counts)."""
    mod = traversal_module(name)
    spec = TRAVERSALS[name]
    cuda_fn = getattr(mod, spec["cuda"])
    entry = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, bytes_ms={},
                 ops={}, counts={})
    phase_name = "kernel_check" if name == "bvh_traverse" else \
        f"{name}_kernel_check"
    for set_name, (o, d, lo, hi, any_hit) in sets.items():
        args = (scene.tris, scene.bvh, o, d, lo, hi, any_hit)
        k = cuda_fn(*args)
        walk_ms = {}
        for walk in ("skip_pointer", spec["walk"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run = run_walk(walk, *args)
            torch.cuda.synchronize()
            walk_ms[walk] = (time.perf_counter() - t0) * 1000.0
            if walk == "skip_pointer":
                p, ref_ops, ref_work = run
        w, ops, counts = run
        plain_ms = walk_ms[spec["plain"]]
        if bool(differs(k, w, lo, hi, any_hit).any()):
            raise AssertionError(f"{name} kernel differs from its walk's "
                                 f"plain version on {set_name}")
        check = exact_check(f"{phase_name}/{set_name}", scene.bvh, o, d,
                            lo, hi, any_hit, k, p)
        ms = cuda_ms(lambda: cuda_fn(*args), reps=20)
        bytes_ms = (RAY_BYTES * o.shape[0] + scene_bytes(
            name, scene.tris, scene.bvh)) / PEAK_BYTES_PER_S * 1e3
        walk_ops_ = {"skip_pointer": ref_ops, spec["walk"]: ops}
        walk_counts = {"skip_pointer": ref_work, spec["walk"]: counts}
        phase(phase_name, set=set_name, **check, kernel_ms=ms,
              plain_ms=plain_ms, walk_ops=walk_ops_, walk_counts=walk_counts,
              bytes_bound_ms=bytes_ms)
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        entry["bytes_ms"][set_name] = bytes_ms
        entry["ops"][set_name] = walk_ops_
        entry["counts"][set_name] = walk_counts
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   check["max_abs_err"])
    return entry


def work_shape(counts) -> dict:
    """The shape of the walks' work on one ray set, from their plain
    versions' counts (walk -> counts): each walk's box and triangle tests
    (as its lanes make them; "steps" are two box tests), and where the walk
    counts them, the packet's node efficiency (the lanes' own wanted
    records over 32 x the records the packet steps through), the lane
    efficiency of the packet's single-ray walks (their passes over 32 x
    the rounds the packets wait on them), and the two-level loop's lane
    efficiency: of its inner loop (steps over 32 x the warp's steps) and
    of its drains (triangle tests over 32 x the most of one lane, summed
    over the drains)."""
    ratios = (("node_efficiency", "lane_packet_steps", "packet_steps", 32),
              ("solo_efficiency", "solo_passes", "solo_rounds", 32),
              ("inner_efficiency", "steps", "inner_iters", 32),
              ("drain_efficiency", "tris", "drain_paid", 1))
    out = {}
    for walk, c in counts.items():
        x = dict(box_tests=c.get("slabs", 2 * c.get("steps", 0)),
                 tri_tests=c["tris"])
        for key, num, den, lanes in ratios:
            if c.get(den):
                x[key] = c[num] / (lanes * c[den])
        out[walk] = dict(x, counts=c)
    return out


def middle_window(n, k) -> slice:
    """The k consecutive indices in the middle of n."""
    start = max((n - k) // 2, 0)
    return slice(start, start + k)


def traversal_work_shape(label, per_set: dict) -> dict:
    """Step 0 of the traversal kernels' design, printed as one phase: the
    work_shape of each walk on each ray set (set -> walk -> counts)."""
    shapes = {s: work_shape(c) for s, c in per_set.items()}
    phase("traversal_work_shape", sets=label, shape=shapes)
    return shapes


def traversal_bounds(entries: dict):
    """Set every traversal kernel's bound_ms from the function they share:
    on each sample set the fewest bytes of the three kernels and the fewest
    operations of the four walks; the bound is the larger of the two
    times, summed over the sets."""
    sets = next(iter(entries.values()))["ops"]
    least = {}
    for s in sets:
        walks = {w: n for e in entries.values()
                 for w, n in e["ops"][s].items()}
        walk = min(walks, key=walks.get)
        least[s] = dict(ops=walks[walk], walk=walk,
                        bytes_ms=min(e["bytes_ms"][s]
                                     for e in entries.values()))
    bytes_ms = sum(x["bytes_ms"] for x in least.values())
    ops_ms = sum(x["ops"] for x in least.values()) / PEAK_F32_PER_S * 1e3
    for e in entries.values():
        del e["bytes_ms"], e["ops"], e["counts"]
        e["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        e["bound_ms"] = max(bytes_ms, ops_ms)
    phase("traversal_bound", per_set=least, bytes_bound_ms=bytes_ms,
          ops_bound_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms))


class LaunchTimer:
    """Times every traversal-kernel launch of a run with CUDA events, by
    standing in for each kernel's CUDA wrapper while the run lasts.  With
    record, also keeps each launch's rays and result; with kind (a function
    of the kernel's name, any_hit and the ray count that names the cast's
    kind, or None), keeps, for the first launch of each kind, a strided
    sample of CHECK_RAYS of its live rays with their results."""

    def __init__(self, torch, record: bool = False, kind=None):
        self.torch, self.record, self.kind = torch, record, kind
        self.real = {n: getattr(traversal_module(n), TRAVERSALS[n]["cuda"])
                     for n in TRAVERSALS}
        self.events, self.casts, self.samples = [], [], {}

    def __enter__(self):
        def timed(name):
            real = self.real[name]

            def fn(tris, bvh, o, d, t_min, t_max, any_hit):
                ev = [self.torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
                out = real(tris, bvh, o, d, t_min, t_max, any_hit)
                ev[1].record()
                kind = self.kind and self.kind(name, any_hit, o.shape[0])
                self.events.append((name, any_hit, o.shape[0],
                                    (t_max > t_min).sum(),
                                    scene_bytes(name, tris, bvh), kind, ev))
                if self.record:
                    self.casts.append((o.clone(), d.clone(), t_min.clone(),
                                       t_max.clone(), any_hit,
                                       tuple(x.clone() for x in out)))
                if kind and kind not in self.samples:
                    live = self.torch.nonzero(t_max > t_min).squeeze(1)
                    idx = live[::max(1, live.numel() // CHECK_RAYS)][
                        :CHECK_RAYS]
                    self.samples[kind] = (
                        tuple(x[idx].contiguous() for x in
                              (o, d, t_min, t_max)) + (any_hit,)
                        + (tuple(x[idx] for x in out),))
                return out
            return fn
        for n in TRAVERSALS:
            setattr(traversal_module(n), TRAVERSALS[n]["cuda"], timed(n))
        return self

    def __exit__(self, *exc):
        for n, real in self.real.items():
            setattr(traversal_module(n), TRAVERSALS[n]["cuda"], real)

    def summary(self) -> dict:
        """Launches, rays, live rays (t_max > t_min), kernel ms and the
        bytes bound (each input read once, each output written once), per
        kernel and cast kind, keyed "<kernel>.<closest|any_hit>"."""
        self.torch.cuda.synchronize()
        out = {}
        for name, any_hit, rays, live, sbytes, _, (s, e) in self.events:
            key = f"{name}.{'any_hit' if any_hit else 'closest'}"
            k = out.setdefault(key, dict(launches=0, rays=0, live_rays=0,
                                         ms=0.0, bytes_bound_ms=0.0))
            k["launches"] += 1
            k["rays"] += rays
            k["live_rays"] += int(live)
            k["ms"] += s.elapsed_time(e)
            k["bytes_bound_ms"] += ((RAY_BYTES * rays + sbytes)
                                    / PEAK_BYTES_PER_S * 1e3)
        return out

    def live_by_kind(self) -> dict:
        """Live rays of all launches, per cast kind."""
        out: dict = {}
        for *_, live, _, kind, _ in self.events:
            if kind:
                out[kind] = out.get(kind, 0) + int(live)
        return out


def cast_kind(width, height):
    """The cast kinds of a photonfam frame under kernel #1: the G-buffer
    (one closest-hit ray a pixel), light bounces (the other closest-hit
    casts) and shadow segments (any hit: VPL chunks, VSL groups)."""
    def kind(name, any_hit, rays):
        if name != "bvh_traverse":
            return None
        if any_hit:
            return "shadow"
        return "gbuffer" if rays == width * height else "bounce"
    return kind


def sampled_casts_check(label, run, scene, torch) -> dict:
    """Kernel #1 against traverse_plain on the sampled rays of each cast
    kind of a main path (exact_check), and the frame's operations bound:
    per kind the fewest walk operations on FRAME_OPS_SAMPLE of the sampled
    live rays, scaled to the kind's live rays per frame."""
    from evplp_tpu_torch.trace.traverse import traverse_plain
    t0 = time.perf_counter()
    checks, kinds, ops = {}, {}, 0.0
    for kind, (o, d, lo, hi, any_hit, k) in run["samples"].items():
        p = traverse_plain(scene.tris, scene.bvh, o, d, lo, hi, any_hit)
        checks[kind] = exact_check(f"{label}/{kind}", scene.bvh, o, d, lo,
                                   hi, any_hit, k, p)
        idx = torch.arange(0, o.shape[0], max(1, o.shape[0]
                                              // FRAME_OPS_SAMPLE),
                           device=o.device)[:FRAME_OPS_SAMPLE]
        n_ops, walk = least_walk_ops(scene.tris, scene.bvh, *(
            x[idx].contiguous() for x in (o, d, lo, hi)), any_hit)
        live = run["live_by_kind"][kind] / run["frames"]
        kinds[kind] = dict(live_rays_per_frame=live, walk=walk,
                           ops_per_ray=n_ops / idx.numel())
        ops += n_ops * live / idx.numel()
    bound_ms = ops / PEAK_F32_PER_S * 1e3
    kernel_ms = run["casts"].get("bvh_traverse.closest", {}).get("ms", 0.0)
    kernel_ms += run["casts"].get("bvh_traverse.any_hit", {}).get("ms", 0.0)
    kernel_ms /= run["frames"]
    bytes_ms = sum(c["bytes_bound_ms"] for k, c in run["casts"].items()
                   if k.startswith("bvh_traverse.")) / run["frames"]
    out = dict(checks=checks, per_kind=kinds, sample_rays=FRAME_OPS_SAMPLE,
               ops_per_frame=ops, ops_bound_ms=bound_ms,
               bytes_bound_ms=bytes_ms, bound_ms=max(bound_ms, bytes_ms),
               bound_by="bytes" if bytes_ms >= bound_ms else "operations",
               kernel_ms_per_frame=kernel_ms,
               share_of_bound=max(bound_ms, bytes_ms) / kernel_ms,
               wall_s=time.perf_counter() - t0)
    phase(label, **out)
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


def vsl_bytes_ms(n, g) -> float:
    """The bytes bound in ms of one group call of g records over n pixels."""
    return ((VSL_PIXEL_BYTES + VSL_PIXEL_RECORD_BYTES * g) * n
            + 96 * g) / PEAK_BYTES_PER_S * 1e3


def vsl_ops_ms(pairs, samples, ops_per_sample=None) -> float:
    """The operations bound in ms of `pairs` gated pairs taking `samples`
    samples: of all the work (VSL_ALL_*) without ops_per_sample, else of
    what the inputs need, with ops_per_sample the needed operations of an
    average sample (vsl_ops_per_sample on a check group)."""
    if ops_per_sample is None:
        ops = VSL_ALL_SAMPLE_OPS * samples + VSL_ALL_PAIR_OPS * pairs
    else:
        ops = ops_per_sample * samples + VSL_NEED_OPS["pairs"] * pairs
    return ops / PEAK_F32_PER_S * 1e3


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
        """Launches, gated pairs, samples, kernel ms and the bytes bound."""
        self.torch.cuda.synchronize()
        out = dict(launches=0, pairs=0, samples=0, ms=0.0,
                   bytes_bound_ms=0.0)
        for n, g, (pairs, samples), (s, e) in self.events:
            out["launches"] += 1
            out["pairs"] += int(pairs)
            out["samples"] += int(samples)
            out["ms"] += s.elapsed_time(e)
            out["bytes_bound_ms"] += vsl_bytes_ms(n, g)
        return out


def vsl_frame_groups(job, torch) -> tuple:
    """The arguments of two real VSL group calls at full size, from the
    frame's G-buffer, one light trace of the config's first frame and the
    pass's seeds: the first group of 8 records whose gates (from the
    traversal kernel) are not all empty and whose records hold both a
    diffuse (ks == 0) and a glossy one, and the first group with gates
    from the middle of the records on.  Returns (first, middle, radius)."""
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
    inv_pi_r2 = torch.tensor(mu.INV_PI, dtype=torch.float32,
                             device=dev) / (r * r)
    records = vsl._records_of(pm, p.num_vpl_light_paths)
    m = records["pos"].shape[0]
    group = vsl.TRACE_GROUP
    shifts = torch.arange(group, dtype=torch.int32, device=dev)[:, None]
    cam = torch.tensor(scene.camera.origin, dtype=torch.float32,
                       device=dev)
    wi10 = mu.normalize(cam[None, :] - gbuf.position)
    pix = vsl_kernel.pack_pixels(gbuf.position, gbuf.normal, gbuf.kd,
                                 gbuf.ks, gbuf.ns, wi10)
    pixel_ids = torch.arange(pix.shape[1], dtype=torch.int32, device=dev)

    def group_args(g0):
        recs = {k: v[g0:g0 + group] for k, v in records.items()}
        gates = vsl._group_occlusion(scene, gbuf.position, gbuf.normal,
                                     gbuf.stencil, recs)
        if not bool(gates.any()):
            return None
        mask = torch.sum(gates.to(torch.int32) << shifts, dim=0,
                         dtype=torch.int32)
        cos_half, counts = vsl_kernel.ctx_planes(gbuf.position, recs["pos"],
                                                 r)
        return (pix, pixel_ids, mask, cos_half, counts,
                vsl_kernel.pack_records(recs, inv_pi_r2), seed0, seed1, g0)

    def mixed(args):
        glossy = (args[5][:, 15:18] != 0).any(dim=1)
        return bool(glossy.any()) and not bool(glossy.all())

    def first_of(starts, want):
        for g0 in starts:
            args = group_args(g0)
            if args is not None and want(args):
                return args
        raise AssertionError("no VSL group with gates"
                             + (" and mixed records" if want is mixed else ""))

    starts = range(0, m - group + 1, group)
    first = first_of(starts, mixed)
    middle = first_of(starts[len(starts) // 2:], lambda a: True)
    return first, middle, float(r)


def check_slice(args) -> tuple:
    """The group call's arguments cut to SAMPLE_PIXELS pixels in the middle
    of the frame."""
    n = args[0].shape[1]
    mid = (n - SAMPLE_PIXELS) // 2
    sl = slice(mid, mid + SAMPLE_PIXELS)
    return (args[0][:, sl].contiguous(), args[1][sl].contiguous(),
            args[2][sl].contiguous(), args[3][:, sl].contiguous(),
            args[4][:, sl].contiguous()) + args[5:]


def lane_efficiency(args, torch) -> dict:
    """Useful share of the lanes' sample steps in four layouts of one
    group call: the sum of the pairs' steps over the steps its warps pay
    for.  `pixels`: one thread a pixel walking the records, so a warp pays
    for each record the largest gated count of its 32 pixels; `pairs`: a
    list of each block's (VSL_BLOCK pixels) gated pairs of non-black
    pixels, record-major, one thread a pair, 32 a warp; `pairs_sorted`:
    that list sorted by count, longest first; `kernel`: the kernel's layout,
    the sorted list with each pair of more than VSL_WARP_PAIR_STEPS steps
    on a warp of its own, 32 steps at a time.  Steps are min(count, 101)."""
    from evplp_tpu_torch.core import brdf
    from evplp_tpu_torch.integrators.vsl_kernel import MAX_VSL_SAMPLES
    pix, gates, counts = args[0], args[2], args[4]
    g, n = counts.shape
    ids = torch.arange(g, dtype=torch.int32, device=gates.device)[:, None]
    bits = ((gates[None, :] >> ids) & 1) > 0
    steps = torch.where(bits, torch.clamp(counts, 0, MAX_VSL_SAMPLES), 0)
    keep = bits & ~brdf.is_black(pix[6:9].T, pix[9:12].T)[None, :]
    pad = (-n) % VSL_BLOCK
    steps = torch.nn.functional.pad(steps, (0, pad))
    keep = torch.nn.functional.pad(keep, (0, pad))

    def paid(chunks):
        return float(32 * chunks.amax(dim=-1).sum())

    out = dict(pixels=float(steps.sum()) / paid(steps.reshape(g, -1, 32)))
    blocks = steps.shape[1] // VSL_BLOCK
    listed = torch.where(keep, steps, -1).reshape(g, blocks, VSL_BLOCK)
    listed = listed.permute(1, 0, 2).reshape(blocks, g * VSL_BLOCK)
    order = torch.sort((listed < 0).to(torch.int8), dim=1, stable=True)[1]
    compact = listed.gather(1, order).clamp_min(0)
    useful = float(compact.sum())
    out["pairs"] = useful / paid(compact.reshape(blocks, -1, 32))
    by_count = torch.sort(listed, dim=1, descending=True)[0].clamp_min(0)
    out["pairs_sorted"] = useful / paid(by_count.reshape(blocks, -1, 32))
    long = by_count > VSL_WARP_PAIR_STEPS
    warp_paid = float(32 * ((by_count[long] + 31) // 32).sum())
    # the other pairs in chunks of 32 from where the long ones end
    rest = torch.sort(torch.where(long, -1, by_count), dim=1,
                      descending=True)[0].clamp_min(0)
    out["kernel"] = useful / (warp_paid + paid(rest.reshape(blocks, -1, 32)))
    out["mean_steps_per_pair"] = useful / max(int(keep.sum()), 1)
    out["block_pixels"] = VSL_BLOCK
    return out


def vsl_sample_work(args, torch) -> dict:
    """Counts, from the plain version run on `args`, of the work the kernel
    does (the terms of VSL_NEED_OPS): samples (of non-black gated pairs),
    samples that build the light-BRDF direction (the record not black),
    each strategy's guard holding, phong values and pdfs on a side whose ks
    makes them non-zero (ks != 0; ks.x > 1e-6), phong lobe weights under a
    guard; and the gated pairs and shares of pixels and records with
    ks == 0."""
    from evplp_tpu_torch.core import brdf
    from evplp_tpu_torch.integrators import vsl_kernel
    pix, gates, table = args[0], args[2], args[5]
    g = table.shape[0]
    eye_ks, rec_ks = pix[9:12].T, table[:, None, 15:18]
    eye_f, rec_f = (eye_ks != 0).any(-1), (rec_ks != 0).any(-1)
    eye_p, rec_p = eye_ks[:, 0] > 1e-6, rec_ks[..., 0] > 1e-6
    black1 = brdf.is_black(pix[6:9].T, eye_ks)
    black2 = table[:, None, 19] > 0.5
    tot = dict.fromkeys(VSL_NEED_OPS, 0)

    def observe(live, cone, eye_brdf, light_brdf, eye_lambert,
                light_lambert):
        live = live & ~black1
        terms = dict(
            samples=live, light_dir=live & ~black2, cone=live & cone,
            eye_brdf=live & eye_brdf, light_brdf=live & light_brdf)
        c, e, lb = terms["cone"], terms["eye_brdf"], terms["light_brdf"]
        for k, v in terms.items():
            tot[k] = tot[k] + v.sum()
        tot["phong_f_rec"] = tot["phong_f_rec"] + ((c | e) & rec_f).sum()
        tot["phong_f_eye"] = tot["phong_f_eye"] + ((c | lb) & eye_f).sum()
        any_g = (c.int() + e.int() + lb.int())
        tot["phong_pdf"] = tot["phong_pdf"] + (any_g * eye_p).sum() + (
            any_g * rec_p).sum()
        tot["phong_weight"] = tot["phong_weight"] + (e & ~eye_lambert).sum(
            ) + (lb & ~light_lambert).sum()

    vsl_kernel.vsl_sample_group_plain(*args, observe=observe)
    ids = torch.arange(g, dtype=torch.int32, device=gates.device)[:, None]
    bits = ((gates[None, :] >> ids) & 1) > 0
    tot["pairs"] = bits.sum()
    out = {k: int(v) for k, v in tot.items()}
    pairs = max(out["pairs"], 1)
    out["eye_ks0_pair_share"] = int((bits & ~eye_f).sum()) / pairs
    out["record_ks0_pair_share"] = int((bits & ~rec_f).sum()) / pairs
    out["glossy_gated_pixels"] = int((bits.any(0) & eye_f).sum())
    out["diffuse_gated_pixels"] = int((bits.any(0) & ~eye_f).sum())
    out["glossy_records"] = int(rec_f.sum())
    return out


def vsl_ops_per_sample(work) -> float:
    """The operations a sample needs on average (VSL_NEED_OPS), from
    vsl_sample_work's counts, the pairs' setup apart."""
    ops = sum(VSL_NEED_OPS[k] * work[k] for k in VSL_NEED_OPS if k != "pairs")
    return ops / max(work["samples"], 1)


def vsl_work_shape(groups, torch) -> dict:
    """Step 0 of the kernel's design, printed as one phase: the lane
    efficiency of each full-size group call in the layouts of
    lane_efficiency, and on each check slice the share of samples in which
    each strategy's guard holds, the share of gated pairs whose eye or
    record side has ks == 0, and the needed operations per sample.
    Returns each check slice's work counts with its lane efficiency and
    needed operations per sample, by label."""
    t0 = time.perf_counter()
    out, works = {}, {}
    for label, args in groups.items():
        cut = check_slice(args)
        pairs, samples = (int(x) for x in vsl_work(args[2], args[4], torch))
        work = vsl_sample_work(cut, torch)
        work.update(lane_efficiency=lane_efficiency(cut, torch),
                    ops_per_sample=vsl_ops_per_sample(work))
        lived = max(work["samples"], 1)
        out[label] = dict(
            rec_base=args[8], pairs=pairs, samples=samples,
            lane_efficiency=lane_efficiency(args, torch),
            check_slice=dict(work, strategy_share={
                k: work[k] / lived for k in ("cone", "eye_brdf",
                                             "light_brdf")}))
        works[label] = work
    phase("vsl_work_shape", config=os.path.relpath(VSL_CONFIG, HERE),
          pixels=groups["first"][0].shape[1], slice_pixels=SAMPLE_PIXELS,
          groups=out, wall_s=time.perf_counter() - t0)
    return works


def vsl_kernel_check(label, args, work, torch) -> dict:
    """The VSL kernel against its plain version on the group's check slice
    (SAMPLE_PIXELS pixels in the middle of the frame, holding diffuse and
    glossy gated pixels, the group diffuse and glossy records): equal bit
    for bit, and within rtol 2e-4 / atol 2e-5.  `work` is the slice's
    entry of vsl_work_shape.  Returns the kernel entry, with the needed
    operations per sample and the lane efficiency."""
    from evplp_tpu_torch.integrators import vsl_kernel

    args = check_slice(args)
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
    ops_per_sample = work["ops_per_sample"]
    bytes_ms = vsl_bytes_ms(SAMPLE_PIXELS, args[5].shape[0])
    all_ms = vsl_ops_ms(pairs, samples)
    need_ms = vsl_ops_ms(pairs, samples, ops_per_sample)
    bound_ms = max(bytes_ms, need_ms)
    phase("vsl_kernel_check", group=label,
          config=os.path.relpath(VSL_CONFIG, HERE), pixels=SAMPLE_PIXELS,
          records=args[5].shape[0], rec_base=args[8], gated_pairs=pairs,
          samples=samples, gated_pixels=int((args[2] != 0).sum()),
          glossy_gated_pixels=work["glossy_gated_pixels"],
          diffuse_gated_pixels=work["diffuse_gated_pixels"],
          glossy_records=work["glossy_records"],
          eye_ks0_pair_share=work["eye_ks0_pair_share"],
          record_ks0_pair_share=work["record_ks0_pair_share"],
          max_count=int(args[4].max()),
          lane_efficiency=work["lane_efficiency"],
          ops_per_sample=ops_per_sample, kernel_ms=ms, plain_ms=plain_ms,
          max_abs_err=err, bit_equal=bool(torch.equal(k, p)),
          max_value=float(p.abs().max()), pixels_outside_tol=outside,
          bytes_bound_ms=bytes_ms, ops_bound_ms=need_ms,
          ops_bound_all_ms=all_ms, share_of_bound=bound_ms / ms,
          share_of_bound_all=max(bytes_ms, all_ms) / ms)
    if outside != 0 or err != 0.0 or not torch.equal(k, p):
        raise AssertionError(f"VSL kernel ({label} group) differs from "
                             f"plain: max abs error {err}, {outside} pixels "
                             "outside rtol 2e-4 / atol 2e-5")
    if not bool(p.abs().max() > 0):
        raise AssertionError(f"VSL kernel check ({label} group): all zero")
    if min(work["glossy_gated_pixels"], work["diffuse_gated_pixels"]) == 0:
        raise AssertionError(f"VSL check slice ({label} group) lacks "
                             "diffuse or glossy gated pixels")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= need_ms else "operations",
                ops_per_sample=ops_per_sample,
                lane_efficiency=work["lane_efficiency"])


def vsl_checks(job, torch) -> dict:
    """Steps 0 and the kernel checks of the VSL sample kernel on two real
    full-size groups of the VSL frame (vsl_frame_groups): vsl_work_shape,
    then vsl_kernel_check of each; returns the first group's kernel
    entry."""
    t0 = time.perf_counter()
    first, middle, radius = vsl_frame_groups(job, torch)
    groups = dict(first=first, middle=middle)
    setup_s = time.perf_counter() - t0
    works = vsl_work_shape(groups, torch)
    if works["first"]["glossy_records"] in (0, first[5].shape[0]):
        raise AssertionError("the first VSL group lacks diffuse or glossy "
                             "records")
    entries = {k: vsl_kernel_check(k, a, works[k], torch)
               for k, a in groups.items()}
    phase("vsl_kernel_check_done", vsl_radius=radius, setup_s=setup_s,
          wall_s=time.perf_counter() - t0)
    return entries["first"]


def pass_breakdown(job, torch, names) -> dict:
    """Mean host-clock ms of each pass `names` of the full-size frame, with
    the device synchronized around every pass (two frames: the warm-up and
    one timed frame of the job's run loop, with no file output)."""
    import dataclasses
    from evplp_tpu_torch.integrators import photon_fam as pf
    from evplp_tpu_torch.runtime import loop

    pt = job.params.technique == "pt"
    mod = loop if pt else pf
    real = {n: getattr(mod, n) for n in names}
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
        write_every_frame=False, output_filename="", combined_filename="",
        weighted_vpl_filename="", weighted_photon_filename="")
    for n in names:
        setattr(mod, n, timed(n))
    try:
        run = loop.run_pt if pt else loop.run_photon_fam
        run(dataclasses.replace(job, params=params))
    finally:
        for n in names:
            setattr(mod, n, real[n])
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
    cfg[technique_of(cfg)].update(block_update)
    path = os.path.join(directory, os.path.basename(config))
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def technique_of(cfg: dict) -> str:
    return next(k for k in ("pt", "photonfam", "lvcphotonfam") if k in cfg)


def _small_job(config, res, block_update, device):
    from evplp_tpu_torch.scene.config import load_config
    with tempfile.TemporaryDirectory() as tmp:
        return load_config(write_config(config, tmp, block_update, res),
                           device=device)


def _outside(img, ref, rtol, atol) -> list:
    """(row, col) of the pixels with any channel outside rtol / atol."""
    import numpy as np
    bad = ~np.isclose(img, ref, rtol=rtol, atol=atol).all(axis=-1)
    return [tuple(int(x) for x in p) for p in np.argwhere(bad)]


def _final_image(job):
    """The combined image of a one-frame run of a small job."""
    from evplp_tpu_torch.runtime.render import render_job
    res = render_job(job)
    return res.images["output" if job.params.technique == "pt"
                      else "combined"]


def reference_check() -> dict:
    """Small renders on the card against references: the Cornell goldens
    tests/golden/{ours,ours_prog,vsl,pt}.npz (dense ray casts) at the
    goldens' rtol 2e-3 / atol 2e-4 (the VSL golden but for its two
    GOLDEN_FLIPS pixels, by position), and 64x36 box_field "ours", VSL and
    PT frames (kernel ray casts, the VSL sample kernel) against the same
    frames on the CPU (plain versions)."""
    import numpy as np

    out = {}
    common = dict(rngOffset=3, numMaxIteration=2, timeLimitMs=-1.0,
                  frameMode="accumulate", useJitter=True, useStat=False)
    dumps = dict(combinedFilename="", weightedPhotonFilename="",
                 weightedVplFilename="")
    golden = dict(common, numLightPaths=128, numVplLightPaths=8,
                  numMaxBounces=2, radiusPercentage=0.05, **dumps)
    vsl = dict(common, numLightPaths=64, numVplLightPaths=64,
               numMaxBounces=2, radiusPercentage=0.0, forceVsl=True,
               vslRadiusPercentage=0.05, misMode="one", **dumps)
    pt = dict(common, numSamplePerPixel=1, numMaxBounces=2,
              outputFilename="")
    ours_cfg = os.path.join(CORNELL, "cornell_ours.json")
    for name, config, block in (
            ("ours", ours_cfg, golden),
            ("ours_prog", ours_cfg, dict(golden, misMode="geometryClamp",
                                         DoProgressive=True,
                                         AlphaProgressive=0.7)),
            ("vsl", ours_cfg, vsl),
            ("pt", os.path.join(CORNELL, "cornell_pt.json"), pt)):
        img = _final_image(_small_job(config, (16, 16), block, "cuda"))
        ref = np.load(os.path.join(HERE, "tests", "golden",
                                   f"{name}.npz"))["img"]
        outside = _outside(img, ref, 2e-3, 2e-4)
        out[name] = float(np.abs(img - ref).max())
        out[name + "_pixels_outside"] = outside
        if not set(outside) <= GOLDEN_FLIPS[name]:
            raise AssertionError(f"golden {name}: pixels {outside} outside "
                                 "rtol 2e-3 / atol 2e-4")
    small = dict(numMaxIteration=1, timeLimitMs=-1.0, useStat=False)
    for name, config, block in (
            ("box_field", CONFIG, dict(small, numLightPaths=1000, **dumps)),
            ("box_field_vsl", VSL_CONFIG, dict(small, numVplLightPaths=8,
                                               **dumps)),
            ("box_field_pt", PT_CONFIG, dict(small, outputFilename=""))):
        imgs = [_final_image(_small_job(config, (64, 36), block, dev))
                for dev in ("cuda", "cpu")]
        outside = _outside(imgs[0], imgs[1], 1e-3, 1e-4)
        out[f"{name}_64x36_cuda_vs_cpu"] = float(np.abs(imgs[0]
                                                        - imgs[1]).max())
        out[f"{name}_64x36_max"] = float(np.abs(imgs[1]).max())
        out[f"{name}_64x36_pixels_outside"] = outside
        if outside or not imgs[1].any():
            raise AssertionError(f"{name} 64x36: pixels {outside} outside "
                                 "rtol 1e-3 / atol 1e-4 (cuda vs cpu)")
    return out


def zero_counts():
    from evplp_tpu_torch.integrators import vsl_kernel
    for n in TRAVERSALS:
        traversal_module(n).launches = 0
    vsl_kernel.launches = 0


def read_counts() -> dict:
    from evplp_tpu_torch.integrators import vsl_kernel
    counts = {n: traversal_module(n).launches for n in TRAVERSALS}
    counts["vsl_sample"] = vsl_kernel.launches
    return counts


# the images each technique's config names, and the one that must not be
# all zero
IMAGE_KEYS = {"pt": ("outputFilename",),
              "photonfam": ("combinedFilename", "weightedVplFilename",
                            "weightedPhotonFilename")}


def cast_totals(casts: dict, frames: int) -> dict:
    """Per-frame launches, rays, live rays and kernel ms over all casts."""
    return {k: sum(c[k] for c in casts.values()) / frames
            for k in ("launches", "rays", "live_rays", "ms")}


def main_path(label, config, iterations, torch, kind, smi, launched=(),
              not_launched=(), nonzero=(), extra=None,
              sample_casts=False) -> dict:
    """Run `config` through the CLI at full size for `iterations` timed
    frames (plus the warm-up), with every kernel count set to 0 just
    before and read just after.  Checks the images (shape, finite, >= 0,
    the first of IMAGE_KEYS and those of `nonzero` not all zero), no
    dropped splat pairs, a timed
    frame, and that the run launched bvh_traverse and every kernel of
    `launched` and none of `not_launched`; prints the phase line `label`,
    with the fields `extra(run)` adds, and returns the run.  With
    sample_casts, the run keeps a sample of each cast kind of kernel #1
    (LaunchTimer, cast_kind)."""
    import numpy as np
    from evplp_tpu_torch import __main__ as cli
    from evplp_tpu_torch.integrators import vsl_kernel
    from evplp_tpu_torch.utils.image import load_pfm

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = write_config(config, tmp, dict(numMaxIteration=iterations,
                                                  timeLimitMs=-1.0))
        with open(cfg_path) as f:
            cfg = json.load(f)
        tech = technique_of(cfg)
        block = cfg[tech]
        out_dir = os.path.join(tmp, "out")
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        zero_counts()
        kinds = cast_kind(cfg["resX"], cfg["resY"]) if sample_casts else None
        with LaunchTimer(torch, kind=kinds) as timer, \
                VslLaunchTimer(vsl_kernel, torch) as vsl_timer, \
                contextlib.redirect_stdout(buf):
            rc = cli.main([cfg_path, "--output-dir", out_dir])
        launches = read_counts()
        casts = timer.summary()
        vsl_calls = vsl_timer.summary()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if rc != 0:
            raise AssertionError(f"{label}: the CLI returned {rc}")
        stats = json.loads(buf.getvalue()[buf.getvalue().index("{"):])
        imgs = {k: load_pfm(os.path.join(out_dir, os.path.basename(
            block[k]))) for k in IMAGE_KEYS[tech]}
        with open(os.path.join(out_dir, os.path.basename(
                block["statFilename"]))) as f:
            stat = json.load(f)
    for k, img in imgs.items():
        if img.shape != (cfg["resY"], cfg["resX"], 3):
            raise AssertionError(f"{label} {k}: shape {img.shape}")
        if not (np.isfinite(img).all() and (img >= 0).all()):
            raise AssertionError(f"{label} {k}: non-finite or negative "
                                 "values")
    for k in (IMAGE_KEYS[tech][0],) + tuple(nonzero):
        if not imgs[k].any():
            raise AssertionError(f"{label}: {k} is all zero")
    if stats.get("dropped_splat_pairs", 0) != 0:
        raise AssertionError(f"{label}: dropped "
                             f"{stats['dropped_splat_pairs']} pairs")
    if stats["numIterations"] < 1 or stat["numIterations"] < 1:
        raise AssertionError(f"{label}: no timed frame")
    for k in ("bvh_traverse",) + tuple(launched):
        if launches[k] == 0:
            raise AssertionError(f"{label} never launched {k}: {launches}")
    for k in not_launched:
        if launches[k]:
            raise AssertionError(f"{label} launched {k}: {launches}")
    run = dict(stats=stats, stat=stat, imgs=imgs, launches=launches,
               casts=casts, vsl_calls=vsl_calls, samples=timer.samples,
               live_by_kind=timer.live_by_kind(),
               frames=stats["numIterations"] + 1)  # + the warm-up frame
    per_frame = cast_totals(casts, run["frames"])
    frame_ms = stats["timeMs"] / stats["numIterations"]
    main_img = imgs[IMAGE_KEYS[tech][0]]
    phase(label, config=os.path.relpath(config, HERE),
          width=main_img.shape[1], height=main_img.shape[0],
          iterations=stats["numIterations"], time_ms=stats["timeMs"],
          ms_per_frame=frame_ms, stat_json=stat,
          dropped_splat_pairs=stats.get("dropped_splat_pairs"),
          launches=launches, casts_per_frame=per_frame["launches"],
          rays_per_frame=per_frame["rays"],
          live_rays_per_frame=per_frame["live_rays"],
          live_mray_per_s=per_frame["live_rays"] / frame_ms / 1e3,
          kernel_ms_per_frame=per_frame["ms"], kernel_by_cast=casts,
          image_means={k: float(v.mean()) for k, v in imgs.items()},
          peak_mem_gib=peak_gib, device=kind, nvidia_smi=smi,
          wall_s=time.perf_counter() - t0,
          **(extra(run) if extra else {}))
    return run


def ours_extra(job):
    """The "ours" frame's rays as bench.py:88-96 counts them, and its
    Mray/s."""
    p = job.params
    b = p.num_max_bounces + 1
    n_px = job.width * job.height
    rays = n_px + p.num_light_paths * (b - 1) + n_px * p.num_vpl_light_paths * b

    def extra(run):
        frame_ms = run["stats"]["timeMs"] / run["stats"]["numIterations"]
        return dict(bench_rays_per_frame=rays,
                    mray_per_s=rays / frame_ms / 1e3)
    return extra


def vsl_extra(entry):
    """The VSL frame's shadow segments, gated pairs, samples, and the sample
    kernel's time and bounds per frame: the bytes bound, the operations
    bound of all the work and that of what the inputs need (the check
    group's needed operations per sample, scaled by each launch's
    samples), with the share of each reached, the check group's lane
    efficiency and the kernel's registers."""
    from evplp_tpu_torch.native import build

    def extra(run):
        frames, calls = run["frames"], run["vsl_calls"]
        shadow = run["casts"].get("bvh_traverse.any_hit", {})
        samples, pairs = calls["samples"], calls["pairs"]
        all_ms = vsl_ops_ms(pairs, samples) / frames
        need_ms = vsl_ops_ms(pairs, samples, entry["ops_per_sample"]) / frames
        ms = calls["ms"] / frames
        bytes_ms = calls["bytes_bound_ms"] / frames
        return dict(
            shadow_segments_per_frame=shadow.get("rays", 0) / frames,
            live_shadow_segments_per_frame=shadow.get("live_rays", 0)
            / frames,
            gated_pairs_per_frame=pairs / frames,
            samples_per_frame=samples / frames,
            vsl_kernel_ms_per_frame=ms,
            vsl_kernel_ops_bound_ms_per_frame=need_ms,
            vsl_kernel_ops_bound_all_ms_per_frame=all_ms,
            vsl_kernel_bytes_bound_ms_per_frame=bytes_ms,
            vsl_kernel_share_of_bound=max(bytes_ms, need_ms) / ms,
            vsl_kernel_share_of_bound_all=max(bytes_ms, all_ms) / ms,
            vsl_check_lane_efficiency=entry["lane_efficiency"],
            vsl_kernel_ptxas=build.library_report("vsl_sample"))
    return extra


def pt_impls(torch) -> dict:
    """The full-size PT frame (run_pt, one timed frame plus the warm-up,
    same key) under each PACKET_IMPL value; each cast's inputs, recorded
    in the packet3 run, give the same hits (t, prim, u, v; any-hit
    occlusion) under the three kernels on every ray, each kernel equals
    traverse_plain on a sample of every cast (exact_check, with ray
    FAULT3_RAY), and the three images are equal bit for bit (at most
    PT_IMPL_MAX_PIXELS pixels differ).  Returns each kernel's launches in
    its own run, and the walks' counts on each cast's sample of the
    operations bound (for traversal_work_shape)."""
    import dataclasses
    import numpy as np
    from evplp_tpu_torch.runtime.loop import run_pt
    from evplp_tpu_torch.scene.config import load_config
    from evplp_tpu_torch.trace import intersect

    job = load_config(PT_CONFIG, device="cuda")
    scene = job.scene
    # the JAX dispatch's fused-node rule: on a scene built with fused node
    # rows (above 280,000 triangles) every value runs packet3
    fused = dataclasses.replace(scene.bvh, fused_nodes=True)
    on_this, on_fused = {}, {}
    try:
        for spec in TRAVERSALS.values():
            intersect.PACKET_IMPL = spec["impl"]
            on_this[spec["impl"]] = intersect.traversal_impl(scene.bvh)
            on_fused[spec["impl"]] = intersect.traversal_impl(fused)
    finally:
        intersect.PACKET_IMPL = "packet3"
    phase("pt_dispatch", triangles=scene.num_triangles,
          fused_nodes=scene.bvh.fused_nodes, impl_on_this_scene=on_this,
          impl_on_a_fused_scene=on_fused)
    job = dataclasses.replace(job, params=dataclasses.replace(
        job.params, num_max_iteration=1, time_limit_ms=-1.0, use_stat=False,
        output_filename="", write_every_frame=False))
    imgs, launches, casts, kernel_ms = {}, {}, [], {}
    try:
        for name, spec in TRAVERSALS.items():
            intersect.PACKET_IMPL = spec["impl"]
            zero_counts()
            with LaunchTimer(torch, record=name == "bvh_traverse") as timer:
                res = run_pt(job)
            counts = read_counts()
            per_frame = cast_totals(timer.summary(), 2)
            if counts[name] == 0 or sum(counts.values()) != counts[name]:
                raise AssertionError(f"PACKET_IMPL={spec['impl']} launched "
                                     f"{counts}")
            launches[name] = counts[name]
            casts = casts or timer.casts
            imgs[name] = res.images["output"]
            kernel_ms[name] = per_frame["ms"]
            phase("pt_impl", impl=spec["impl"], kernel=name,
                  ms_per_frame=res.time_ms / res.num_iterations,
                  kernel_ms_per_frame=per_frame["ms"], launches=counts,
                  live_rays_per_frame=per_frame["live_rays"])
    finally:
        intersect.PACKET_IMPL = "packet3"
    # ---- per cast: #2 and #3 against #1 on every ray of the recorded
    # inputs, and all three against traverse_plain on a sample of each cast
    # (with ray FAULT3_RAY of the closest-hit casts) ----
    from evplp_tpu_torch.trace.traverse import traverse_plain
    exact, gate, fault3 = [], {n: 0 for n in TRAVERSALS}, {}
    for ci, (o, d, lo, hi, any_hit, ref) in enumerate(casts):
        got = {"bvh_traverse": ref}
        for name in ("packet7", "packet"):
            fn = getattr(traversal_module(name), TRAVERSALS[name]["cuda"])
            got[name] = fn(scene.tris, scene.bvh, o, d, lo, hi, any_hit)
            bad = torch.nonzero(differs(got[name], ref, lo, hi, any_hit)
                                ).squeeze(1)
            gate[name] += bad.numel()
            if bad.numel():
                i = bad[:4].tolist()
                g, f = got[name], ref
                raise AssertionError(
                    f"{name} differs from bvh_traverse on {bad.numel()} rays "
                    f"of PT cast {ci}: rays {i}, "
                    f"{[(float(g[0][j]), int(g[1][j])) for j in i]} against "
                    f"{[(float(f[0][j]), int(f[1][j])) for j in i]}")
        live = torch.nonzero(hi > lo).squeeze(1)
        idx = live[::max(1, live.numel() // CHECK_RAYS)][:CHECK_RAYS]
        if not any_hit and o.shape[0] > FAULT3_RAY:
            idx = torch.unique(torch.cat([idx, torch.tensor(
                [FAULT3_RAY], device=idx.device)]))
        sub = tuple(x[idx].contiguous() for x in (o, d, lo, hi))
        p = traverse_plain(scene.tris, scene.bvh, *sub, any_hit)
        for name, k in got.items():
            exact.append(exact_check(f"pt_cast_{ci}/{name}", scene.bvh, *sub,
                                     any_hit, tuple(x[idx] for x in k), p))
        if ci == 0:
            at = idx == FAULT3_RAY
            fault3 = dict(cast=ci, ray=FAULT3_RAY, o=o[FAULT3_RAY].tolist(),
                          d=d[FAULT3_RAY].tolist(),
                          plain=[float(p[0][at][0]), int(p[1][at][0])],
                          **{n: [float(k[0][FAULT3_RAY]),
                                 int(k[1][FAULT3_RAY])]
                             for n, k in got.items()})
            phase("fault3", **fault3)
            if any(fault3[n][1] != FAULT3_PRIM for n in
                   ["plain"] + list(TRAVERSALS)):
                raise AssertionError(f"fault 3: {fault3}")
    phase("pt_casts_exact", casts=len(casts), kernels=list(TRAVERSALS),
          rays=sum(c["rays"] for c in exact),
          differing=sum(c["differing"] for c in exact),
          max_abs_err=max(c["max_abs_err"] for c in exact),
          rays_differing_from_bvh_traverse=gate)
    images = {}
    for name in ("packet7", "packet"):
        diff = np.abs(imgs[name] - imgs["bvh_traverse"])
        outside = [tuple(int(x) for x in q) for q in np.argwhere(
            (imgs[name] != imgs["bvh_traverse"]).any(axis=-1))]
        images[name] = dict(max_abs_diff=float(diff.max()),
                            pixels_differing=len(outside),
                            positions=outside[:20])
        if len(outside) > PT_IMPL_MAX_PIXELS:
            raise AssertionError(f"PT image under {name}: {len(outside)} "
                                 "pixels differ from packet3's")
    phase("pt_impls", images=images, max_pixels=PT_IMPL_MAX_PIXELS)
    # ---- the timed frame's operations bound, shared by the three kernels:
    # per cast, the fewest walk operations on a strided sample of its live
    # rays, scaled to all of them ----
    t0 = time.perf_counter()
    ops, walks, counts = 0.0, [], {}
    for ci, (o, d, lo, hi, any_hit, _) in enumerate(casts):
        if ci < len(casts) // 2:
            continue
        live = torch.nonzero(hi > lo).squeeze(1)
        if live.numel() == 0:
            continue
        idx = live[::max(1, live.numel() // FRAME_OPS_SAMPLE)][
            :FRAME_OPS_SAMPLE]
        cast_ops, walk = least_walk_ops(
            scene.tris, scene.bvh, *(x[idx].contiguous() for x in
                                     (o, d, lo, hi)), any_hit)
        ops += cast_ops * live.numel() / idx.numel()
        walks.append(walk)
        # the kernels' walks on consecutive rays, as their warps take them
        win = middle_window(o.shape[0], FRAME_OPS_SAMPLE)
        counts[f"pt_cast_{ci}"] = {
            w: run_walk(w, scene.tris, scene.bvh, *(
                x[win].contiguous() for x in (o, d, lo, hi)), any_hit)[2]
            for w in ("ordered", "packet7", "packet")}
    bound_ms = ops / PEAK_F32_PER_S * 1e3
    phase("pt_frame_bound", ops_per_frame=ops, ops_bound_ms=bound_ms,
          least_walk_per_cast=walks, sample_rays=FRAME_OPS_SAMPLE,
          kernel_ms_per_frame=kernel_ms,
          share_of_bound={n: bound_ms / ms for n, ms in kernel_ms.items()},
          wall_s=time.perf_counter() - t0)
    return launches, counts


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
    from evplp_tpu_torch.native import build, bvh_native

    def timed_build(mod):
        tb = time.perf_counter()
        mod.load_library()
        return time.perf_counter() - tb

    mods = {n: traversal_module(n) for n in TRAVERSALS}
    mods.update(vsl_sample=vsl_kernel, bvh_builder=bvh_native)
    with ThreadPoolExecutor(len(mods)) as pool:
        futures = {k: pool.submit(timed_build, m) for k, m in mods.items()}
        build_s = {k: f.result() for k, f in futures.items()}
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], device=kind, nvidia_smi=smi,
          build_s=build_s,
          ptxas={lib: build.library_report(lib) for lib in
                 [t["module"] for t in TRAVERSALS.values()] + ["vsl_sample"]},
          wall_s=time.perf_counter() - t0)

    # ---- 2: the traversal kernels vs plain on the box_field scene ----
    t0 = time.perf_counter()
    from evplp_tpu_torch.scene.config import load_config
    job = load_config(CONFIG, device="cuda")
    scene = job.scene
    load_s = time.perf_counter() - t0
    sets = ray_sets(scene, job.width, job.height, torch)
    entries = {n: kernel_check(n, sets, scene, torch) for n in TRAVERSALS}
    traversal_work_shape("samples", {
        s: {w: c for e in entries.values() for w, c in e["counts"][s].items()}
        for s in sets})
    traversal_bounds(entries)
    phase("kernel_check_done", triangles=scene.num_triangles,
          nodes=scene.bvh.node_min.shape[0], bvh_depth=scene.bvh.depth,
          walk_records=scene.bvh.walk_nodes.shape[0],
          walk_bytes=scene_bytes("bvh_traverse", scene.tris, scene.bvh),
          leaf_rows=scene.bvh.pk_tri_rows.shape[0], scene_load_s=load_s,
          wall_s=time.perf_counter() - t0)
    del sets

    # ---- 3: the "ours" main path through the CLI at full size, and #1 on
    # a sample of each of its cast kinds ----
    run = main_path("main_path", CONFIG, 2, torch, kind, smi,
                    not_launched=("vsl_sample",), extra=ours_extra(job),
                    sample_casts=True)
    launches = dict(run["launches"])
    sampled_casts_check("main_path_casts", run, scene, torch)
    del run

    t0 = time.perf_counter()
    passes = pass_breakdown(job, torch, (
        "trace_gbuffer", "trace_light_paths", "vpl_gather",
        "photon_splat_binned", "light_image"))
    phase("pass_breakdown", config=os.path.relpath(CONFIG, HERE),
          ms_per_frame=passes, sum_ms=sum(passes.values()),
          wall_s=time.perf_counter() - t0)
    del job, scene

    # ---- 4: the VSL sample kernel's work shape, and the kernel vs plain
    # on two real groups at full size ----
    vjob = load_config(VSL_CONFIG, device="cuda")
    vsl_entry = vsl_checks(vjob, torch)

    # ---- 5: the VSL main path through the CLI at full size ----
    vrun = main_path("vsl_main_path", VSL_CONFIG, 1, torch, kind, smi,
                     launched=("vsl_sample",),
                     nonzero=("weightedVplFilename",),
                     extra=vsl_extra(vsl_entry),
                     sample_casts=True)
    for k, v in vrun["launches"].items():
        launches[k] += v
    sampled_casts_check("vsl_main_path_casts", vrun, vjob.scene, torch)
    del vrun

    t0 = time.perf_counter()
    passes = pass_breakdown(vjob, torch, (
        "trace_gbuffer", "trace_light_paths", "vsl_gather",
        "photon_splat_binned", "light_image"))
    phase("pass_breakdown", config=os.path.relpath(VSL_CONFIG, HERE),
          ms_per_frame=passes, sum_ms=sum(passes.values()),
          wall_s=time.perf_counter() - t0)
    del vjob

    # ---- 6: the PT main path, its passes, and the three kernels on it ----
    run = main_path("pt_main_path", PT_CONFIG, PT_FRAMES, torch, kind, smi,
                    not_launched=("packet7", "packet", "vsl_sample"))
    for k, v in run["launches"].items():
        launches[k] += v
    t0 = time.perf_counter()
    passes = pass_breakdown(load_config(PT_CONFIG, device="cuda"), torch, (
        "trace_gbuffer", "render_pt_frame", "light_image"))
    phase("pass_breakdown", config=os.path.relpath(PT_CONFIG, HERE),
          ms_per_frame=passes, sum_ms=sum(passes.values()),
          wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    pt_launches, pt_counts = pt_impls(torch)
    for k, v in pt_launches.items():
        launches[k] += v
    traversal_work_shape("pt_casts", pt_counts)
    phase("pt_impls_done", wall_s=time.perf_counter() - t0)

    # ---- 7: the PM and VPL techniques through the CLI at full size ----
    for label, config, image_key in (
            ("pm_main_path", PM_CONFIG, "weightedPhotonFilename"),
            ("vpl_main_path", VPL_CONFIG, "weightedVplFilename")):
        run = main_path(label, config, 1, torch, kind, smi,
                        not_launched=("vsl_sample",), nonzero=(image_key,))
        for k, v in run["launches"].items():
            launches[k] += v

    t0 = time.perf_counter()
    phase("reference_check", max_abs_diff=reference_check(),
          wall_s=time.perf_counter() - t0)

    # ---- 8: kernels line, card line, result ----
    if not all(launches[k] > 0 for k in KERNELS):
        raise AssertionError(f"a kernel was never launched: {launches}")
    entries["vsl_sample"] = vsl_entry
    sources = {n: (t["source"], t["replaces"]) for n, t in TRAVERSALS.items()}
    sources["vsl_sample"] = ("evplp_tpu_torch/csrc/vsl_sample.cu",
                             "evplp_tpu/integrators/vsl_kernel.py:154")
    kernels = [
        {"name": "vsl_sample_group" if n == "vsl_sample" else n,
         "route": "cuda", "source": sources[n][0],
         "replaces": sources[n][1], "launches": launches[n],
         "max_abs_err": entries[n]["max_abs_err"], "ms": entries[n]["ms"],
         "plain_ms": entries[n]["plain_ms"],
         "bound_ms": entries[n]["bound_ms"],
         "bound_by": entries[n]["bound_by"], "library_ms": None}
        for n in KERNELS]
    phase("done", wall_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
