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
for bit.  It drives the LVC technique (`box_field_ours.json` with its block
renamed to lvcphotonfam, one frame: per-pixel light vertices, so
incoherent shadow segments through traverse.cu, held exactly to
traverse_plain on a sample of each cast kind), the textured livingroom
configs `configs/livingroom/livingroom_ours.json` and `livingroom_pt.json`
(192 triangles and the light: every cast takes the dense path and no
traversal kernel may launch; the G-buffer's kd at the textured hits must
equal sample_bilinear there and vary), and a checkpoint / resume of a
small progressive Cornell run through the CLI (bit-equal to the run
without a break; --gamma writes linear ** (1/2.2)).  It times each
traversal kernel on the samples and the LVC casts with the walk records'
padded leaf boxes and without (walk_pad_cost), and the photon splat with
its ordered tile sums and with index_add_'s atomics
(splat_accumulate_cost).  It runs the "ours" config through the CLI with
--profile (each pass timed over two frames), traces one "ours" and one LVC
frame under torch.profiler (runtime/profiling.device_trace: the
operations with the most CUDA time, the kernels launched, the syncs, the
card's idle share of the frame), and writes a full-size output as PFM,
HDR and PNG and reads it back (image_io).  It shards box_field "ours",
LVC, VSL and PT frames over a mesh that names the card four times
(parallel/shard.py: 180 rows and 75,000 paths a shard), each equal to
the single-device frame, runs --mesh 1 through the CLI and checks that
--mesh with more devices than are visible raises, and runs the
equal-time quality harness (runtime/compare.py) on the glossy configs
(a PT ground truth, six variants at 2 s each, the report; dense path,
no traversal kernel).  Its big_scene phase runs the large-scene tier:
box_field_big (25,000 boxes, about 300,000 triangles) and box_field_huge
(200,000 boxes, about 2.4M), whose configs scene/export.py writes at
1280x720 into a temporary directory; past 280,000 triangles the scene is
built with 42-triangle leaves and fused node rows, on which every cast
runs traverse.cu whatever PACKET_IMPL says (packet7.cu and packet.cu must
not launch).  It prints each scene's build (triangles, slots, nodes,
depth, walk-record bytes, the export, load and BVH-build seconds, device
memory), holds traverse.cu to traverse_plain on the three ray samples
and on the sampled casts of the "ours" and LVC runs, and runs "ours",
PT, VSL, PM, VPL and LVC on box_field_big and "ours" on box_field_huge
through the CLI.  It checks the outputs and the kernels
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
import shutil
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
LIVINGROOM = os.path.join(HERE, "configs", "livingroom",
                          "livingroom_ours.json")
LIVINGROOM_PT = os.path.join(HERE, "configs", "livingroom",
                             "livingroom_pt.json")
# timing rounds of each record layout in walk_pad_cost (medians)
PAD_ROUNDS = 5
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
# bytes a ray moves: o, d, t_min, t_max in; t, prim, u, v out; a lane
# that is not traced (t_max <= t_min) needs only t_min, t_max in
RAY_BYTES = 48
DEAD_RAY_BYTES = 24
# bytes of one walk record (two child boxes, refs, counts) and of one
# triangle record (v0, e1, e2) of accel/bvh.py:walk_layout
RECORD_BYTES = 64
TRI_RECORD_BYTES = 48
# rays of each kernel #1 launch of a sampled main path (a strided sample)
# whose scene reads are counted for the frame's bytes bound
READS_SAMPLE = 2048
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


def scene_bytes(bvh) -> dict:
    """Bytes of the scene arrays the traversal kernels read from: the
    walk records and the triangle records (all three read both), and
    their sum."""
    rec = RECORD_BYTES * bvh.walk_nodes.shape[0]
    tri = TRI_RECORD_BYTES * bvh.walk_tris.shape[0]
    return dict(record_bytes=rec, triangle_bytes=tri, scene_bytes=rec + tri)


def ray_bytes(rays, live) -> int:
    """Bytes the rays of a traversal move: RAY_BYTES a live ray,
    DEAD_RAY_BYTES a lane that is not traced."""
    return RAY_BYTES * live + DEAD_RAY_BYTES * (rays - live)


def walk_reads(scene, o, d, lo, hi, any_hit, group=None, groups=1):
    """Bytes of the scene that the ordered walk (walk_plain, kernel #1's)
    reads on these rays: the walk records it steps at and the triangle
    records it tests, each counted once in each group of rays (group:
    each ray's group in [0, groups), default one group).  This, not the
    whole scene, is what the traversal function needs to move; a (groups,)
    int64 tensor."""
    import torch
    from evplp_tpu_torch.trace.traverse import walk_plain
    bvh, dev = scene.bvh, o.device
    seen = {"records": torch.zeros((groups, bvh.walk_nodes.shape[0]),
                                   dtype=torch.bool, device=dev),
            "slots": torch.zeros((groups, bvh.walk_tris.shape[0]),
                                 dtype=torch.bool, device=dev)}
    g = (torch.zeros((o.shape[0],), dtype=torch.long, device=dev)
         if group is None else group)

    def reads(what, rid, ids):
        seen[what][g[rid], ids.long()] = True

    walk_plain(scene.tris, bvh, o, d, lo, hi, any_hit, work={"reads": reads})
    return (RECORD_BYTES * seen["records"].sum(1)
            + TRI_RECORD_BYTES * seen["slots"].sum(1))


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


def kernel_check(name, sets, scene, torch, label=None) -> dict:
    """A traversal kernel against traverse_plain (exact_check) and against
    its own walk's plain version (equal results) on each ray set; returns
    the kernel's entry, with its plain version's time (the walk its
    wrapper runs on the CPU) and the operations and counts of each walk
    it ran on each set (traversal_bounds turns the operations into its
    bound, traversal_work_shape prints the counts).
    label names the phase lines (default: the kernel's)."""
    mod = traversal_module(name)
    spec = TRAVERSALS[name]
    cuda_fn = getattr(mod, spec["cuda"])
    entry = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, ops={}, counts={})
    phase_name = label or ("kernel_check" if name == "bvh_traverse" else
                           f"{name}_kernel_check")
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
        walk_ops_ = {"skip_pointer": ref_ops, spec["walk"]: ops}
        walk_counts = {"skip_pointer": ref_work, spec["walk"]: counts}
        phase(phase_name, set=set_name, **check, kernel_ms=ms,
              plain_ms=plain_ms, walk_ops=walk_ops_, walk_counts=walk_counts)
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
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


def traversal_bounds(entries: dict, sets: dict, scene,
                     label: str = "samples"):
    """Set every traversal kernel's bound_ms from the function they share:
    on each sample set the bytes it needs (the rays', ray_bytes, and the
    scene's that walk_reads counts) and the fewest operations of the walks the
    kernels in entries ran; the bound is the larger of the two times,
    summed over the sets.  label names the sample sets."""
    least = {}
    for s, (o, d, lo, hi, any_hit) in sets.items():
        walks = {w: n for e in entries.values()
                 for w, n in e["ops"][s].items()}
        walk = min(walks, key=walks.get)
        read = int(walk_reads(scene, o, d, lo, hi, any_hit)[0])
        least[s] = dict(ops=walks[walk], walk=walk, scene_bytes_read=read,
                        bytes_ms=(ray_bytes(o.shape[0], int((hi > lo).sum()))
                                  + read) / PEAK_BYTES_PER_S * 1e3)
    bytes_ms = sum(x["bytes_ms"] for x in least.values())
    ops_ms = sum(x["ops"] for x in least.values()) / PEAK_F32_PER_S * 1e3
    for e in entries.values():
        del e["ops"], e["counts"]
        e["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        e["bound_ms"] = max(bytes_ms, ops_ms)
    phase("traversal_bound", sets=label, per_set=least,
          bytes_bound_ms=bytes_ms,
          ops_bound_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms))


class LaunchTimer:
    """Times every traversal-kernel launch of a run with CUDA events, by
    standing in for each kernel's CUDA wrapper while the run lasts.  With
    record, also keeps each launch's rays and result; with kind (a function
    of the kernel's name, any_hit and the ray count that names the cast's
    kind, or None), keeps, for the first launch of each kind, a strided
    sample of CHECK_RAYS of its live rays with their results, and of every
    launch of a kind a strided sample of READS_SAMPLE of its rays (live or
    not: no host sync) for launch_reads."""

    def __init__(self, torch, record: bool = False, kind=None):
        self.torch, self.record, self.kind = torch, record, kind
        self.real = {n: getattr(traversal_module(n), TRAVERSALS[n]["cuda"])
                     for n in TRAVERSALS}
        self.events, self.casts, self.samples = [], [], {}
        self.read_samples = []

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
                                    (t_max > t_min).sum(), kind, ev))
                if kind:
                    idx = self.torch.arange(
                        0, o.shape[0], max(1, o.shape[0] // READS_SAMPLE),
                        device=o.device)[:READS_SAMPLE]
                    self.read_samples.append((any_hit, tuple(
                        x[idx].contiguous() for x in (o, d, t_min, t_max))))
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
        time of the rays' bytes (ray_bytes; the scene's bytes are counted
        by launch_reads), per kernel
        and cast kind, keyed "<kernel>.<closest|any_hit>"."""
        self.torch.cuda.synchronize()
        out = {}
        for name, any_hit, rays, live, _, (s, e) in self.events:
            key = f"{name}.{'any_hit' if any_hit else 'closest'}"
            k = out.setdefault(key, dict(launches=0, rays=0, live_rays=0,
                                         ms=0.0, ray_bytes_ms=0.0))
            k["launches"] += 1
            k["rays"] += rays
            k["live_rays"] += int(live)
            k["ms"] += s.elapsed_time(e)
            k["ray_bytes_ms"] += (ray_bytes(rays, int(live))
                                  / PEAK_BYTES_PER_S * 1e3)
        return out

    def live_by_kind(self) -> dict:
        """Live rays of all launches, per cast kind."""
        out: dict = {}
        for *_, live, kind, _ in self.events:
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


def launch_reads(samples, scene, torch) -> dict:
    """The scene bytes that each sampled launch reads (walk_reads on its
    READS_SAMPLE rays, each launch a group of its own), summed over the
    launches of each of closest and any hit.  A launch reads at least what
    a subset of its rays reads, so this is a lower count."""
    out = {}
    for any_hit in (False, True):
        mine = [x for a, x in samples if a == any_hit]
        if not mine:
            continue
        cols = [torch.cat([x[i] for x in mine]) for i in range(4)]
        group = torch.cat([torch.full((x[0].shape[0],), j, dtype=torch.long,
                                      device=x[0].device)
                           for j, x in enumerate(mine)])
        read = walk_reads(scene, *cols, any_hit, group=group,
                          groups=len(mine))
        out["any_hit" if any_hit else "closest"] = dict(
            launches=len(mine), scene_bytes_read=int(read.sum()),
            most_of_one_launch=int(read.max()))
    return out


def sampled_casts_check(label, run, scene, torch) -> dict:
    """Kernel #1 against traverse_plain on the sampled rays of each cast
    kind of a main path (exact_check), and the frame's bounds: of
    operations, per kind the fewest walk operations on FRAME_OPS_SAMPLE
    of the sampled live rays, scaled to the kind's live rays per frame; of
    bytes, every launch's rays and the scene bytes that launch_reads
    counts."""
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
    reads = launch_reads(run["read_samples"], scene, torch)
    scene_read = sum(x["scene_bytes_read"] for x in reads.values())
    bytes_ms = (sum(c["ray_bytes_ms"] for k, c in run["casts"].items()
                    if k.startswith("bvh_traverse."))
                + scene_read / PEAK_BYTES_PER_S * 1e3) / run["frames"]
    out = dict(checks=checks, per_kind=kinds, sample_rays=FRAME_OPS_SAMPLE,
               scene_reads=reads, reads_sample_rays=READS_SAMPLE,
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
IMAGE_KEYS["lvcphotonfam"] = IMAGE_KEYS["photonfam"]


def cast_totals(casts: dict, frames: int) -> dict:
    """Per-frame launches, rays, live rays and kernel ms over all casts."""
    return {k: sum(c[k] for c in casts.values()) / frames
            for k in ("launches", "rays", "live_rays", "ms")}


def main_path(label, config, iterations, torch, kind, smi, launched=(),
              not_launched=(), nonzero=(), extra=None,
              sample_casts=False, dense=False, cli_args=()) -> dict:
    """Run `config` through the CLI at full size for `iterations` timed
    frames (plus the warm-up), with every kernel count set to 0 just
    before and read just after.  Checks the images (shape, finite, >= 0,
    the first of IMAGE_KEYS and those of `nonzero` not all zero), no
    dropped splat pairs, a timed
    frame, and that the run launched bvh_traverse and every kernel of
    `launched` and none of `not_launched`; with dense (a scene of at most
    BRUTE_FORCE_MAX_TRIS triangles, whose casts take the dense path), that
    it launched no traversal kernel instead.  Prints the phase line
    `label`, with the fields `extra(run)` adds (peak_mem_gib, the device's
    peak in the run; run_peak_mem_gib, less what was held before it), and
    returns the run.  With
    sample_casts, the run keeps a sample of each cast kind of kernel #1
    (LaunchTimer, cast_kind).  cli_args are added to the CLI's
    arguments."""
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
        held = torch.cuda.memory_allocated()
        buf = io.StringIO()
        zero_counts()
        kinds = cast_kind(cfg["resX"], cfg["resY"]) if sample_casts else None
        with LaunchTimer(torch, kind=kinds) as timer, \
                VslLaunchTimer(vsl_kernel, torch) as vsl_timer, \
                contextlib.redirect_stdout(buf):
            rc = cli.main([cfg_path, "--output-dir", out_dir, *cli_args])
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
    required = tuple(launched) if dense else ("bvh_traverse",) + tuple(
        launched)
    for k in required:
        if launches[k] == 0:
            raise AssertionError(f"{label} never launched {k}: {launches}")
    for k in tuple(not_launched) + (tuple(TRAVERSALS) if dense else ()):
        if launches[k]:
            raise AssertionError(f"{label} launched {k}: {launches}")
    run = dict(stats=stats, stat=stat, imgs=imgs, launches=launches,
               casts=casts, vsl_calls=vsl_calls, samples=timer.samples,
               read_samples=timer.read_samples,
               live_by_kind=timer.live_by_kind(),
               frames=stats["numIterations"] + 1)  # + the warm-up frame
    per_frame = cast_totals(casts, run["frames"])
    frame_ms = stats["timeMs"] / stats["numIterations"]
    main_img = imgs[IMAGE_KEYS[tech][0]]
    phase(label, config=os.path.relpath(config, HERE)
          if config.startswith(HERE) else os.path.basename(config),
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
          peak_mem_gib=peak_gib, run_peak_mem_gib=peak_gib - held / 2**30,
          device=kind, nvidia_smi=smi,
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


def vsl_frame_work(run) -> dict:
    """The VSL frame's shadow segments, gated pairs and samples, and the
    sample kernel's launches, time and bytes bound per frame."""
    frames, calls = run["frames"], run["vsl_calls"]
    shadow = run["casts"].get("bvh_traverse.any_hit", {})
    return dict(shadow_segments_per_frame=shadow.get("rays", 0) / frames,
                live_shadow_segments_per_frame=shadow.get("live_rays", 0)
                / frames,
                gated_pairs_per_frame=calls["pairs"] / frames,
                samples_per_frame=calls["samples"] / frames,
                vsl_kernel_launches=calls["launches"],
                vsl_kernel_ms_per_frame=calls["ms"] / frames,
                vsl_kernel_bytes_bound_ms_per_frame=calls["bytes_bound_ms"]
                / frames)


def vsl_extra(entry):
    """vsl_frame_work, and the sample kernel's operations bounds per
    frame: of all the work and of what the inputs need (the check group's
    needed operations per sample, scaled by each launch's samples), with
    the share of each reached, the check group's lane efficiency and the
    kernel's registers."""
    from evplp_tpu_torch.native import build

    def extra(run):
        frames, calls = run["frames"], run["vsl_calls"]
        out = vsl_frame_work(run)
        samples, pairs = calls["samples"], calls["pairs"]
        all_ms = vsl_ops_ms(pairs, samples) / frames
        need_ms = vsl_ops_ms(pairs, samples, entry["ops_per_sample"]) / frames
        ms = out["vsl_kernel_ms_per_frame"]
        bytes_ms = out["vsl_kernel_bytes_bound_ms_per_frame"]
        return dict(
            out, vsl_kernel_ops_bound_ms_per_frame=need_ms,
            vsl_kernel_ops_bound_all_ms_per_frame=all_ms,
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
    # the fused-node rule on a real fused scene: big_scene's fused_dispatch
    on_this = {}
    try:
        for spec in TRAVERSALS.values():
            intersect.PACKET_IMPL = spec["impl"]
            on_this[spec["impl"]] = intersect.traversal_impl(scene.bvh)
    finally:
        intersect.PACKET_IMPL = "packet3"
    phase("pt_dispatch", triangles=scene.num_triangles,
          fused_nodes=scene.bvh.fused_nodes, impl_on_this_scene=on_this)
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


def unpadded_walk(scene):
    """The scene's BVH with walk records whose leaf boxes are not padded
    (accel/bvh.py:walk_pad at WALK_PAD_REL = 0): the records before the
    padding, for walk_pad_cost."""
    import dataclasses
    import torch
    from evplp_tpu_torch.accel import bvh as bvh_mod
    arrays = [getattr(scene.bvh, k).cpu().numpy() for k in bvh_mod.NODE_KEYS]
    arrays += [x.cpu().numpy() for x in (scene.tris.v0, scene.tris.e1,
                                         scene.tris.e2)]
    real = bvh_mod.WALK_PAD_REL
    bvh_mod.WALK_PAD_REL = 0.0
    try:
        nodes, _ = bvh_mod.walk_layout(*arrays)
    finally:
        bvh_mod.WALK_PAD_REL = real
    return dataclasses.replace(scene.bvh, walk_nodes=torch.as_tensor(
        nodes, device=scene.device))


def walk_pad_cost(label, sets, scene, torch) -> dict:
    """What the padded leaf boxes cost: each traversal kernel's time on
    each ray set with the padded records and with the unpadded ones, in
    turns (PAD_ROUNDS rounds, medians), the ordered walk's steps and
    triangle tests with each on FRAME_OPS_SAMPLE consecutive rays, and the
    rays on which the unpadded records change the kernel's result."""
    import statistics
    from evplp_tpu_torch.accel.bvh import walk_pad
    t0 = time.perf_counter()
    bare = unpadded_walk(scene)
    out = {}
    for set_name, ray_set in sets.items():
        o, d, lo, hi, any_hit = ray_set[:5]
        per = {}
        for name, spec in TRAVERSALS.items():
            fn = getattr(traversal_module(name), spec["cuda"])
            times = {"padded": [], "unpadded": []}
            for _ in range(PAD_ROUNDS):
                for layout, bvh in (("padded", scene.bvh),
                                    ("unpadded", bare)):
                    times[layout].append(cuda_ms(
                        lambda: fn(scene.tris, bvh, o, d, lo, hi, any_hit),
                        reps=5))
            changed = differs(fn(scene.tris, scene.bvh, o, d, lo, hi,
                                 any_hit),
                              fn(scene.tris, bare, o, d, lo, hi, any_hit),
                              lo, hi, any_hit)
            per[name] = dict(**{f"{k}_ms": statistics.median(v)
                                for k, v in times.items()},
                             rays_changed=int(changed.sum()))
        win = middle_window(o.shape[0], FRAME_OPS_SAMPLE)
        sub = tuple(x[win].contiguous() for x in (o, d, lo, hi))
        per["ordered_walk"] = {
            layout: run_walk("ordered", scene.tris, bvh, *sub, any_hit)[2]
            for layout, bvh in (("padded", scene.bvh), ("unpadded", bare))}
        out[set_name] = per
    nodes = scene.bvh.node_min.cpu().numpy(), scene.bvh.node_max.cpu().numpy()
    phase("walk_pad_cost", sets=label, pad=float(walk_pad(*nodes)),
          per_set=out, rounds=PAD_ROUNDS, wall_s=time.perf_counter() - t0)
    return out


def lvc_config(directory, config=CONFIG) -> str:
    """An "ours" config (box_field_ours.json by default) with its technique
    block renamed to lvcphotonfam (absolute scene paths), written into
    directory as <scene>_lvc.json."""
    path = write_config(config, directory, {})
    with open(path) as f:
        cfg = json.load(f)
    cfg["lvcphotonfam"] = cfg.pop("photonfam")
    path = os.path.join(directory, os.path.basename(config).replace(
        "_ours", "_lvc"))
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def lvc_extra(run) -> dict:
    """The LVC frame's shadow segments (one a pixel per step of the
    gather), the live ones, and kernel #1's any-hit time per frame: the
    part of lvc_gather that #1 takes."""
    frames = run["frames"]
    shadow = run["casts"].get("bvh_traverse.any_hit", {})
    return dict(shadow_segments_per_frame=shadow.get("rays", 0) / frames,
                live_shadow_segments_per_frame=shadow.get("live_rays", 0)
                / frames,
                shadow_casts_per_frame=shadow.get("launches", 0) / frames,
                kernel_any_hit_ms_per_frame=shadow.get("ms", 0.0) / frames)


def texture_check(job, torch) -> dict:
    """The textures of a textured scene are really used: the full-size
    G-buffer's kd at every pixel whose triangle has a map_Kd layer equals
    sample_bilinear of that layer at the hit's texcoords, and takes many
    values on each layer."""
    from evplp_tpu_torch.integrators.gbuffer import trace_gbuffer
    from evplp_tpu_torch.scene import textures
    from evplp_tpu_torch.trace.intersect import intersect_closest
    t0 = time.perf_counter()
    sc, w, h = job.scene, job.width, job.height
    gbuf = trace_gbuffer(sc, w, h, None)
    o, d = sc.camera.generate_rays(w, h, None, device=sc.device)
    hit = intersect_closest(sc.tris, sc.bvh, o, d, t_min=1e-4)
    prim = torch.clamp_min(hit.prim, 0).long()
    layer = sc.tri_shade[prim, 11].to(torch.int32)
    tex = hit.valid & (layer >= 0)
    want = textures.sample_bilinear(
        sc.tex_data, sc.tex_size, layer[tex],
        textures.hit_uv(sc, prim[tex], hit.u[tex], hit.v[tex]))
    if not torch.equal(gbuf.kd[tex], want):
        raise AssertionError("G-buffer kd differs from sample_bilinear at "
                             "the textured hits")
    per_layer = {}
    for l in range(sc.tex_data.shape[0]):
        kd = gbuf.kd[tex & (layer == l)]
        per_layer[l] = dict(pixels=int(kd.shape[0]),
                            distinct_kd=int(torch.unique(kd, dim=0).shape[0]),
                            mean_kd=kd.mean(0).tolist() if kd.numel() else [])
        if kd.shape[0] and per_layer[l]["distinct_kd"] < 2:
            raise AssertionError(f"texture layer {l}: constant kd")
    if not any(x["distinct_kd"] > 100 for x in per_layer.values()):
        raise AssertionError(f"textures barely vary: {per_layer}")
    out = dict(layers=int(sc.tex_data.shape[0]),
               tex_shape=list(sc.tex_data.shape), textured_pixels=int(
                   tex.sum()), per_layer=per_layer,
               wall_s=time.perf_counter() - t0)
    phase("texture_check", **out)
    return out


def resume_check(torch) -> dict:
    """Checkpoint and resume through the CLI on the card: a progressive
    clamped Cornell run at 64x64 for 4 frames against 2 frames with
    --checkpoint, then --resume and 2 more; the final images must be equal
    bit for bit, and a resume with --gamma must write
    linear ** (1 / 2.2)."""
    import numpy as np
    from evplp_tpu_torch import __main__ as cli
    from evplp_tpu_torch.runtime.checkpoint import load_checkpoint
    from evplp_tpu_torch.utils.image import load_pfm

    t0 = time.perf_counter()
    block = dict(rngOffset=3, timeLimitMs=-1.0, frameMode="accumulate",
                 useJitter=True, useStat=False, numLightPaths=1000,
                 numVplLightPaths=8, numMaxBounces=2, radiusPercentage=0.05,
                 misMode="geometryClamp", DoProgressive=True,
                 AlphaProgressive=0.7, combinedFilename="out/c.pfm",
                 weightedVplFilename="out/c_vpl.pfm",
                 weightedPhotonFilename="out/c_pm.pfm")
    names = ("c", "c_vpl", "c_pm")
    with tempfile.TemporaryDirectory() as tmp:
        def run(frames, sub, *flags):
            d = os.path.join(tmp, sub)
            os.makedirs(d)
            cfg = write_config(os.path.join(CORNELL, "cornell_ours.json"), d,
                               dict(block, numMaxIteration=frames), (64, 64))
            with contextlib.redirect_stdout(io.StringIO()):
                if cli.main([cfg, "--output-dir", os.path.join(d, "out"),
                             *flags]) != 0:
                    raise AssertionError(f"resume: the CLI failed ({sub})")
            return {n: load_pfm(os.path.join(d, "out", f"{n}.pfm"))
                    for n in names}

        ck = os.path.join(tmp, "ck.npz")
        whole = run(4, "whole")
        run(2, "first", "--checkpoint", ck, "--checkpoint-every", "1")
        ck_iters = load_checkpoint(ck, "cuda")[1]
        rest = run(4, "rest", "--resume", ck)
        shown = run(4, "shown", "--resume", ck, "--gamma")
    equal = {n: bool(np.array_equal(rest[n], whole[n])) for n in names}
    gamma_err = {n: float(np.abs(shown[n] - np.power(
        np.maximum(whole[n], 0.0), 1.0 / 2.2)).max()) for n in names}
    out = dict(checkpoint_iterations=ck_iters, bit_equal=equal,
               gamma_max_abs_err=gamma_err,
               combined_max=float(whole["c"].max()),
               wall_s=time.perf_counter() - t0)
    phase("resume", **out)
    if ck_iters != 2 or not all(equal.values()) or not whole["c"].any():
        raise AssertionError(f"resume: {out}")
    for n in names:
        np.testing.assert_allclose(shown[n], np.power(
            np.maximum(whole[n], 0.0), 1.0 / 2.2), rtol=1e-6, atol=0)
    return out


def splat_accumulate_cost(job, torch) -> dict:
    """The photon splat's ordered tile sums (photon_splat.accumulate_tiles)
    against the index_add_ they replaced, on one full-size "ours" frame's
    G-buffer and photon map, in turns (PAD_ROUNDS rounds, medians of
    photon_splat_binned's time, CUDA events): what the order costs, and
    whether each gives the same image on every run.  The ordered sums
    must."""
    import math
    import statistics
    from evplp_tpu_torch.core.sampling import iteration_key
    from evplp_tpu_torch.integrators import photon_splat as ps
    from evplp_tpu_torch.integrators.gbuffer import trace_gbuffer
    from evplp_tpu_torch.integrators.light_trace import trace_light_paths
    t0 = time.perf_counter()
    sc, p = job.scene, job.params
    gbuf = trace_gbuffer(sc, job.width, job.height, None)
    pm = trace_light_paths(sc, iteration_key(0, 0, "cuda"),
                           p.num_light_paths, p.num_max_bounces + 1)
    radius = max(sc.bounding_radius * p.radius_percentage, 1e-6)
    pdf_mc = (p.num_vpl_light_paths / p.num_light_paths) / math.pi / (
        radius * radius)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device="cuda")

    args = (sc, gbuf, pm, f32(radius), p.mis_mode, f32(pdf_mc),
            f32(1.0 / sc.total_area), 1.0 / p.num_light_paths, job.width,
            job.height)

    def index_add(acc, tiles, lengths, contrib):
        acc.index_add_(0, torch.repeat_interleave(
            tiles, lengths, output_size=contrib.shape[0]), contrib)

    real = ps.accumulate_tiles
    variants = {"ordered": real, "index_add": index_add}
    times = {k: [] for k in variants}
    imgs = {k: [] for k in variants}
    try:
        for _ in range(PAD_ROUNDS):
            for name, fn in variants.items():
                ps.accumulate_tiles = fn
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                img, dropped = ps.photon_splat_binned(*args)
                ev[1].record()
                torch.cuda.synchronize()
                times[name].append(ev[0].elapsed_time(ev[1]))
                imgs[name].append(img)
    finally:
        ps.accumulate_tiles = real
    same = {k: all(torch.equal(v[0], x) for x in v[1:])
            for k, v in imgs.items()}
    out = dict(ms={k: statistics.median(v) for k, v in times.items()},
               all_ms=times, same_on_every_run=same,
               max_abs_diff=float((imgs["ordered"][0]
                                   - imgs["index_add"][0]).abs().max()),
               image_max=float(imgs["ordered"][0].abs().max()),
               dropped=int(dropped), rounds=PAD_ROUNDS,
               wall_s=time.perf_counter() - t0)
    phase("splat_accumulate_cost", **out)
    if not same["ordered"]:
        raise AssertionError("the ordered splat differs between runs")
    return out


def frame_args(job) -> tuple:
    """(cfg, zero state, key, (radius, clamp, pdf_mc, VSL radius)) of the
    first timed frame of run_photon_fam on job, as its loop starts them."""
    from evplp_tpu_torch.core.sampling import iteration_key
    from evplp_tpu_torch.integrators import photon_fam as pf
    from evplp_tpu_torch.runtime import loop

    scene = job.scene
    sched = loop.initial_schedule(job)
    cfg = loop._frame_config(job)
    return (cfg, pf.init_state(cfg, scene.device),
            iteration_key(0, job.params.rng_offset, scene.device),
            (sched.radius, sched.clamp, sched.pdf_mc, sched.vsl_radius))


# the passes photon_fam_frame names for --profile, and the trace's event
# categories of work on the card
PROFILE_PASSES = ("gbuffer", "light_trace", "vpl_gather", "photon_splat")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP_OPS = 15


def trace_summary(prof, trace_path) -> dict:
    """From one traced frame (a record_function "frame" span): the TOP_OPS
    operations with the most self CUDA time (key_averages, the profiler's
    names), the kernels launched, the runtime calls that wait for the card
    and the copies, and the share of the frame's wall time in which the
    card runs no kernel, copy or fill."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    frame = next(e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == "frame")
    lo, hi = frame["ts"], frame["ts"] + frame["dur"]
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in events if e.get("cat") in DEVICE_CATS
                   and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    kernels = [e for e in events if e.get("cat") == "kernel"]
    runtime = [e["name"] for e in events if e.get("cat") == "cuda_runtime"]

    def self_ms(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0)) / 1e3
    top = sorted((a for a in prof.key_averages() if a.key != "frame"),
                 key=self_ms, reverse=True)[:TOP_OPS]
    return dict(
        frame_ms=(hi - lo) / 1e3, device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / (hi - lo),
        kernel_launches=len(kernels),
        kernel_ms=sum(e["dur"] for e in kernels) / 1e3,
        mean_kernel_us=(sum(e["dur"] for e in kernels)
                        / max(len(kernels), 1)),
        launch_calls=sum("LaunchKernel" in n for n in runtime),
        syncs=sum("Synchronize" in n for n in runtime),
        copies=sum(e.get("cat") == "gpu_memcpy" for e in events),
        top_self_cuda=[dict(name=a.key[:160], calls=a.count,
                            self_cuda_ms=self_ms(a)) for a in top])


def trace_frames(torch) -> dict:
    """One "ours" and one LVC box_field frame at full size under
    runtime/profiling.device_trace, each summed up by trace_summary, after
    a warm-up frame and an untraced frame timed on the host clock: the
    profiler slows the host's launches, so the card's idle share of an
    untraced frame is reckoned from the traced frame's busy time and the
    untraced frame's time as well."""
    from evplp_tpu_torch.integrators import photon_fam as pf
    from evplp_tpu_torch.runtime.profiling import device_trace
    from evplp_tpu_torch.scene.config import load_config

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, config in (("ours", CONFIG), ("lvc", lvc_config(tmp))):
            t0 = time.perf_counter()
            job = load_config(config, device="cuda")
            cfg, state, key, scalars = frame_args(job)
            pf.photon_fam_frame(job.scene, cfg, state, key, *scalars)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pf.photon_fam_frame(job.scene, cfg, state, key, *scalars)
            torch.cuda.synchronize()
            untraced_ms = (time.perf_counter() - t1) * 1000.0
            log_dir = os.path.join(tmp, f"trace_{label}")
            with device_trace(log_dir) as prof:
                with torch.profiler.record_function("frame"):
                    pf.photon_fam_frame(job.scene, cfg, state, key, *scalars)
                    torch.cuda.synchronize()
            out[label] = trace_summary(prof, os.path.join(log_dir,
                                                          "trace.json"))
            out[label].update(
                untraced_frame_ms=untraced_ms,
                untraced_idle_share=max(0.0, 1.0 - out[label][
                    "device_busy_ms"] / untraced_ms))
            phase("device_trace", technique=label,
                  config=os.path.relpath(config, HERE)
                  if label == "ours" else "box_field_ours.json as "
                  "lvcphotonfam", **out[label],
                  wall_s=time.perf_counter() - t0)
            if out[label]["kernel_launches"] == 0:
                raise AssertionError(f"device_trace {label}: the trace "
                                     "holds no kernel of the card")
            del job, state
    return out


def rgbe_step(img):
    """The size of one step of RGBE's 8-bit mantissa at each pixel,
    2^(e - 8) for the pixel's largest channel m = f 2^e (f in [0.5, 1)),
    and the pixels RGBE stores as black (m < 1e-32)."""
    import numpy as np
    m = img.max(axis=-1, keepdims=True)
    return np.ldexp(1.0, np.frexp(m)[1] - 8), m < 1e-32


# the encoder scales by f 256 / m in float32: a product that rounds just
# below an integer truncates to the step below, so a channel may lie one
# step and a few float32 roundings (2^-10 of a step covers them) away
RGBE_STEPS = 1.0 + 2.0 ** -10


def image_io_check(img) -> dict:
    """A full-size output written through utils/image.save as .pfm, .hdr
    and .png and read back with load: PFM bit for bit, HDR within
    RGBE_STEPS steps of the 8-bit mantissa (rgbe_step; pixels RGBE stores
    as black read back as 0), PNG equal to clip(x * 255 + 0.5) / 255."""
    import numpy as np
    from evplp_tpu_torch.utils import image as im

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        back = {}
        for ext in (".pfm", ".hdr", ".png"):
            path = os.path.join(tmp, "io", "img" + ext)
            im.save(path, img)
            out[ext[1:] + "_bytes"] = os.path.getsize(path)
            back[ext] = im.load(path)
    step, black = rgbe_step(img)
    hdr_err = np.abs(back[".hdr"] - img)
    hdr_steps = np.where(black, 0.0, hdr_err / step)
    png_want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8).astype(
        np.float32) / 255.0
    out.update(shape=list(img.shape), image_max=float(img.max()),
               pfm_equal=bool(np.array_equal(back[".pfm"], img)),
               hdr_max_abs_err=float(hdr_err.max()),
               hdr_max_steps=float(hdr_steps.max()),
               hdr_over_one_step=int((hdr_steps > 1.0).sum()),
               hdr_within=bool((hdr_steps <= RGBE_STEPS).all() and not (
                   black & (back[".hdr"] != 0)).any()),
               png_equal=bool(np.array_equal(back[".png"], png_want)),
               wall_s=time.perf_counter() - t0)
    phase("image_io", **out)
    if not (out["pfm_equal"] and out["hdr_within"] and out["png_equal"]
            and img.any()):
        raise AssertionError(f"image_io: {out}")
    return out


SHARDS = 4
SHARD_RTOL, SHARD_ATOL = 2e-4, 1e-6


def _shard_gate(label, got: dict, want: dict) -> dict:
    """Max abs differences of got against want, raising outside SHARD_RTOL
    / SHARD_ATOL (tests/test_shard.py's bar)."""
    import numpy as np
    diffs = {}
    for k, w in want.items():
        g = got[k].cpu().numpy()
        w = w.cpu().numpy()
        diffs[k] = float(np.abs(g - w).max())
        if not np.allclose(g, w, rtol=SHARD_RTOL, atol=SHARD_ATOL):
            bad = int((~np.isclose(g, w, rtol=SHARD_RTOL,
                                   atol=SHARD_ATOL)).sum())
            raise AssertionError(f"shard {label} {k}: {bad} values outside "
                                 f"rtol {SHARD_RTOL} / atol {SHARD_ATOL}, "
                                 f"max abs diff {diffs[k]}")
    return diffs


def shard_check(torch) -> dict:
    """box_field at full size over a mesh that names the card SHARDS times
    (parallel/shard.py): one sharded and one single-device frame with the
    same key for "ours", LVC, VSL and PT, each timed after a warm-up
    frame of its own kind (the caching allocator's first blocks of each
    shape); the sharded frame must drop no pair and equal the
    single-device one at SHARD_RTOL / SHARD_ATOL, and launch kernel #1
    (and #4 for VSL).  Returns the timed sharded frames' kernel
    launches."""
    from evplp_tpu_torch.core import rng
    from evplp_tpu_torch.core.sampling import iteration_key
    from evplp_tpu_torch.integrators import photon_fam as pf
    from evplp_tpu_torch.integrators.gbuffer import (light_image,
                                                     trace_gbuffer)
    from evplp_tpu_torch.integrators.pt import render_pt_frame
    from evplp_tpu_torch.parallel.shard import (
        Mesh, shard_state, sharded_photon_fam_frame, sharded_pt_frame,
        unshard_state)
    from evplp_tpu_torch.scene.config import load_config

    mesh = Mesh(["cuda:0"] * SHARDS)
    launches = dict.fromkeys(KERNELS, 0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1000.0

    with tempfile.TemporaryDirectory() as tmp:
        runs = (("ours", CONFIG, ("bvh_traverse",)),
                ("lvc", lvc_config(tmp), ("bvh_traverse",)),
                ("vsl", VSL_CONFIG, ("bvh_traverse", "vsl_sample")),
                ("pt", PT_CONFIG, ("bvh_traverse",)))
        for label, config, launched in runs:
            t0 = time.perf_counter()
            job = load_config(config, device="cuda")
            scene, p = job.scene, job.params
            if label == "pt":
                key = iteration_key(0, p.rng_offset, scene.device)
                u = rng.uniform(rng.fold_in(key, 999), (2,))
                jitter = (2.0 * u - 1.0) / torch.tensor(
                    [job.width, job.height], device=scene.device)
                k0 = rng.fold_in(key, 0)

                def single():
                    gbuf = trace_gbuffer(scene, job.width, job.height,
                                         jitter)
                    return dict(image=render_pt_frame(
                        scene, gbuf, k0, p.num_max_bounces),
                        light=light_image(scene, gbuf))

                def sharded():
                    img, light = sharded_pt_frame(
                        scene, mesh, job.width, job.height, k0,
                        p.num_max_bounces, jitter=jitter)
                    return dict(image=img, light=light)
                dropped, paths = 0, 0
            else:
                cfg, state, key, scalars = frame_args(job)

                def single():
                    return pf.photon_fam_frame(scene, cfg, state, key,
                                               *scalars)

                def sharded():
                    return unshard_state(sharded_photon_fam_frame(
                        scene, cfg, mesh, shard_state(state, mesh), key,
                        *scalars))
                paths = cfg.num_light_paths // SHARDS
            single()
            want, single_ms = timed(single)
            sharded()
            zero_counts()
            got, sharded_ms = timed(sharded)
            counts = read_counts()
            if label != "pt":
                dropped = int(got.dropped)
                got, want = ({k: getattr(s, k) for k in (
                    "vpl_acc", "photon_acc", "light_img")}
                    for s in (got, want))
            diffs = _shard_gate(label, got, want)
            phase("shard", technique=label,
                  config=os.path.relpath(config, HERE) if label != "lvc"
                  else "box_field_ours.json as lvcphotonfam",
                  shards=SHARDS, devices=[str(d) for d in mesh.devices],
                  rows_per_shard=job.height // SHARDS,
                  paths_per_shard=paths, dropped_splat_pairs=dropped,
                  max_abs_diff=diffs, single_ms=single_ms,
                  sharded_ms=sharded_ms, launches=counts,
                  wall_s=time.perf_counter() - t0)
            if dropped:
                raise AssertionError(f"shard {label}: dropped {dropped}")
            for k in launched:
                if counts[k] == 0:
                    raise AssertionError(f"shard {label} never launched {k}:"
                                         f" {counts}")
            for k, v in counts.items():
                launches[k] += v
            del job, scene, got, want
    return launches


def mesh_cli_check(torch, kind, smi) -> dict:
    """--mesh through the CLI on the card: one box_field "ours" frame with
    --mesh 1, and --mesh with one device more than are visible, which must
    raise."""
    from evplp_tpu_torch import __main__ as cli

    run = main_path("mesh_cli", CONFIG, 1, torch, kind, smi,
                    not_launched=("vsl_sample",), cli_args=("--mesh", "1"))
    n = torch.cuda.device_count() + 1
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([CONFIG, "--mesh", str(n), "--max-wall-s", "0"])
    except RuntimeError as err:
        if f"{n} CUDA devices" not in str(err):
            raise
        phase("mesh_cli_refuses", mesh=n, error=str(err))
    else:
        raise AssertionError(f"--mesh {n} ran on {n - 1} visible devices")
    return run["launches"]


QUALITY_SCENE = "glossy"
QUALITY_GT_ITERS = 64
QUALITY_BUDGET_MS = 2000.0


def quality_check(torch) -> list:
    """The equal-time harness (runtime/compare.py) on configs/glossy at
    1280x720: a PT ground truth of QUALITY_GT_ITERS frames, the six
    variants at QUALITY_BUDGET_MS each, and the report.  Every row must
    have a timed frame and finite metrics, every image be finite and
    >= 0, no pair be dropped, and no traversal kernel launch (glossy has
    fewer than 2048 triangles: the dense path)."""
    import numpy as np
    from evplp_tpu_torch.runtime import compare

    t0 = time.perf_counter()
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as art:
        common = ["--art-dir", art, "--budget-ms", str(QUALITY_BUDGET_MS),
                  "--device", "cuda"]
        zero_counts()
        with contextlib.redirect_stdout(log):
            compare.main(common + ["gt", QUALITY_SCENE,
                                   str(QUALITY_GT_ITERS)])
            compare.main(common + ["run", QUALITY_SCENE])
            rows = compare.report((QUALITY_SCENE,), art,
                                  budget_ms=QUALITY_BUDGET_MS)
        counts = read_counts()
        images = {}
        for name in ("gt",) + compare.VARIANTS:
            z = np.load(os.path.join(art, f"{QUALITY_SCENE}_{name}.npz"))
            img = z["img"]
            images[name] = dict(
                shape=list(img.shape), mean=float(img.mean()),
                finite=bool(np.isfinite(img).all()),
                nonneg=bool((img >= 0).all()),
                dropped=int(z["dropped"]) if "dropped" in z.files else 0)
    phase("quality", scene=QUALITY_SCENE, gt_iters=QUALITY_GT_ITERS,
          budget_ms=QUALITY_BUDGET_MS, rows=rows, images=images,
          launches=counts, harness_log=log.getvalue().splitlines(),
          wall_s=time.perf_counter() - t0)
    if len(rows) != len(compare.VARIANTS):
        raise AssertionError(f"quality: {len(rows)} rows")
    for r in rows:
        if r["iters"] < 1 or not (np.isfinite(r["mse"])
                                  and np.isfinite(r["rel_mse"])):
            raise AssertionError(f"quality: row {r}")
    for name, v in images.items():
        if not (v["finite"] and v["nonneg"]) or v["dropped"]:
            raise AssertionError(f"quality: image {name} {v}")
    for k in TRAVERSALS:
        if counts[k]:
            raise AssertionError(f"quality launched {k}: {counts}")
    return rows


# The large-scene tier: box_field_big_spec(boxes) keeps the box density of
# box_field and crosses the 280,000-triangle rule (scene/scene.py
# BIG_SCENE_TRIS: 42-triangle leaves, fused_nodes, so every cast runs
# kernel #1 whatever PACKET_IMPL says).  box_field_big runs every
# technique through the CLI; box_field_huge, the JAX package's stretch
# scene (tools/quality_r05.py:stretch), runs the "ours" frame.
BIG_SCENES = {"box_field_big": 25_000, "box_field_huge": 200_000}
BIG_RES = (1280, 720)
# (label, variant of write_scene_matrix or "lvc", timed frames, kernels
# launched besides #1, images that must not be all zero, sample_casts,
# passes of pass_breakdown or None) of each CLI run on a big scene
BIG_RUNS = {
    "box_field_big": (
        ("ours", "ours", 2, (), (), True,
         ("trace_gbuffer", "trace_light_paths", "vpl_gather",
          "photon_splat_binned", "light_image")),
        ("pt", "pt", 1, (), (), False,
         ("trace_gbuffer", "render_pt_frame", "light_image")),
        ("vsl", "vsl", 1, ("vsl_sample",), ("weightedVplFilename",), False,
         ("trace_gbuffer", "trace_light_paths", "vsl_gather",
          "photon_splat_binned", "light_image")),
        ("pm", "pm", 1, (), ("weightedPhotonFilename",), False, None),
        ("vpl", "vpl", 1, (), ("weightedVplFilename",), False, None),
        ("lvc", "lvc", 1, (), ("weightedVplFilename",), True,
         ("trace_gbuffer", "trace_light_paths", "lvc_gather",
          "photon_splat_binned", "light_image"))),
    "box_field_huge": (
        ("ours", "ours", 1, (), (), True,
         ("trace_gbuffer", "trace_light_paths", "vpl_gather",
          "photon_splat_binned", "light_image")),),
}


def big_scene_export(directory, name, boxes) -> tuple:
    """The scene's configs at BIG_RES, written by
    scene/export.py:write_scene_matrix into directory (OBJs once), and the
    "ours" config renamed to lvcphotonfam: ({variant: path}, seconds)."""
    from evplp_tpu_torch.scene.export import write_scene_matrix
    from evplp_tpu_torch.scene.procedural import box_field_big_spec
    t0 = time.perf_counter()
    paths = write_scene_matrix(directory, name, box_field_big_spec(boxes),
                               BIG_RES)
    configs = {os.path.basename(p)[len(name) + 1:-len(".json")]: p
               for p in paths}
    configs["lvc"] = lvc_config(os.path.dirname(configs["ours"]),
                                configs["ours"])
    return configs, time.perf_counter() - t0


def big_scene_load(name, boxes, configs, export_s, torch):
    """Load the "ours" config on the card through load_config, timing the
    OBJ parses (the scene's and the light's) and the BVH build inside it
    (a stand-in never called fails the load: the timing missed it), and
    print the scene's report:
    triangles, slots, nodes, leaves, depth against the kernels' stack,
    the walk and triangle records' bytes, the seconds, the device memory
    the scene holds.  Returns (job, report)."""
    from evplp_tpu_torch.accel.bvh import walk_pad
    from evplp_tpu_torch.scene import config as config_mod
    from evplp_tpu_torch.scene import scene as scene_mod
    from evplp_tpu_torch.scene.config import load_config
    from evplp_tpu_torch.trace.traverse import STACK_DEPTH
    secs = {"load_obj": 0.0, "build_bvh": 0.0}
    calls = dict.fromkeys(secs, 0)
    real = {"load_obj": config_mod.load_obj,
            "build_bvh": scene_mod.build_bvh}

    def timed(key, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            secs[key] += time.perf_counter() - t
            calls[key] += 1
            return out
        return call

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    config_mod.load_obj = timed("load_obj", real["load_obj"])
    scene_mod.build_bvh = timed("build_bvh", real["build_bvh"])
    t0 = time.perf_counter()
    try:
        job = load_config(configs["ours"], device="cuda")
        torch.cuda.synchronize()
    finally:
        config_mod.load_obj, scene_mod.build_bvh = (real["load_obj"],
                                                    real["build_bvh"])
    load_s = time.perf_counter() - t0
    if not all(calls.values()):
        raise AssertionError(f"{name}: load_config's OBJ parses and BVH "
                             f"build were not all timed: {calls}")
    sc, bvh = job.scene, job.scene.bvh
    obj = os.path.join(os.path.dirname(configs["ours"]), f"{name}.obj")
    report = dict(
        boxes=boxes, width=job.width, height=job.height,
        triangles=int((sc.tri_shade[:, 8:11] != 0).any(1).sum()),
        slots=sc.num_triangles, fused_nodes=bvh.fused_nodes, rpl=bvh.rpl,
        leaf_max_tris=int(bvh.node_count.max()),
        nodes=bvh.node_min.shape[0], leaves=int((bvh.node_count > 0).sum()),
        bvh_depth=bvh.depth, stack_depth=STACK_DEPTH,
        walk_records=bvh.walk_nodes.shape[0], **scene_bytes(bvh),
        walk_pad=float(walk_pad(bvh.node_min[:1].cpu().numpy(),
                                bvh.node_max[:1].cpu().numpy())),
        obj_bytes=os.path.getsize(obj), export_s=export_s,
        load_config_s=load_s, load_obj_s=secs["load_obj"],
        build_bvh_s=secs["build_bvh"], timed_calls=calls,
        scene_device_gib=(torch.cuda.memory_allocated() - before) / 2**30,
        load_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    phase("big_scene_report", scene=name, **report)
    if not bvh.fused_nodes or report["leaf_max_tris"] <= 14:
        raise AssertionError(f"{name}: not built with fused 42-triangle "
                             f"leaves: {report}")
    if bvh.depth >= STACK_DEPTH:
        raise AssertionError(f"{name}: BVH depth {bvh.depth}")
    return job, report


def big_kernel_check(name, sets, scene, torch) -> dict:
    """Kernel #1 against traverse_plain (exact_check) and its own walk on
    the scene's ray sets (kernel_check), the four walks' work there, and
    the bound recounted from them (traversal_bounds).  Returns #1's
    entry."""
    label = f"{name}_kernel_check"
    entry = kernel_check("bvh_traverse", sets, scene, torch, label=label)
    for s, (o, d, lo, hi, any_hit) in sets.items():
        for walk in ("packet7", "packet"):
            _, ops, counts = run_walk(walk, scene.tris, scene.bvh, o, d, lo,
                                      hi, any_hit)
            entry["ops"][s][walk] = ops
            entry["counts"][s][walk] = counts
    traversal_work_shape(f"{name}_samples", entry["counts"])
    traversal_bounds({"bvh_traverse": entry}, sets, scene,
                     label=f"{name}_samples")
    phase(label, set="all", ms=entry["ms"], plain_ms=entry["plain_ms"],
          bound_ms=entry["bound_ms"], bound_by=entry["bound_by"],
          share_of_bound=entry["bound_ms"] / entry["ms"],
          max_abs_err=entry["max_abs_err"])
    return entry


def fused_dispatch_check(name, sets, scene, torch) -> dict:
    """The fused-node rule on a big scene: under each PACKET_IMPL value,
    intersect's casts of the ray sets launch kernel #1 once a set and
    neither #2 nor #3, with #1's hits."""
    from evplp_tpu_torch.trace import intersect
    from evplp_tpu_torch.trace.traverse import traverse_cuda
    out = {}
    try:
        for spec in TRAVERSALS.values():
            intersect.PACKET_IMPL = spec["impl"]
            zero_counts()
            same = True
            for o, d, lo, hi, any_hit in sets.values():
                want = traverse_cuda(scene.tris, scene.bvh, o, d, lo, hi,
                                     any_hit)
                if any_hit:
                    got = intersect.intersect_any(scene.tris, scene.bvh, o,
                                                  d, lo, hi)
                    same &= bool(torch.equal(got, want[1] >= 0))
                else:
                    hit = intersect.intersect_closest(scene.tris, scene.bvh,
                                                      o, d, lo, hi)
                    same &= not bool(differs(
                        (hit.t, hit.prim, hit.u, hit.v), want, lo, hi,
                        False).any())
            counts = read_counts()
            out[spec["impl"]] = dict(
                runs=intersect.traversal_impl(scene.bvh), launches=counts,
                equal_to_bvh_traverse=same)
            if (counts["bvh_traverse"] != 2 * len(sets) or counts["packet7"]
                    or counts["packet"] or not same):
                raise AssertionError(f"{name}: PACKET_IMPL={spec['impl']} "
                                     f"gave {out[spec['impl']]}")
    finally:
        intersect.PACKET_IMPL = "packet3"
    phase("fused_dispatch", scene=name, per_impl=out)
    return out


def big_scene_check(torch, kind, smi) -> dict:
    """The large-scene tier on the card: for each scene of BIG_SCENES, its
    configs written by write_scene_matrix, its load and report, kernel #1
    against traverse_plain on the ray sets (and the bound recounted), on
    box_field_big the fused dispatch under each PACKET_IMPL, and the CLI
    runs of BIG_RUNS at full size with the main paths' gates (main_path),
    kernel #1 against traverse_plain on a sample of each cast kind of the
    runs with sample_casts, and the passes of each run that has them.
    Returns the kernels' launches in the CLI runs."""
    from evplp_tpu_torch.scene.config import load_config
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, boxes in BIG_SCENES.items():
            t0 = time.perf_counter()
            configs, export_s = big_scene_export(tmp, name, boxes)
            job, report = big_scene_load(name, boxes, configs, export_s,
                                         torch)
            sets = ray_sets(job.scene, job.width, job.height, torch)
            big_kernel_check(name, sets, job.scene, torch)
            if name == "box_field_big":
                fused_dispatch_check(name, sets, job.scene, torch)
            del sets
            for label, variant, frames, launched, nonzero, sample, passes \
                    in BIG_RUNS[name]:
                label = f"{name}_{label}"
                extra = {"ours": ours_extra(job), "vsl": vsl_frame_work,
                         "lvc": lvc_extra}.get(variant)
                run = main_path(label, configs[variant], frames, torch, kind,
                                smi, launched=launched,
                                not_launched=tuple(
                                    k for k in ("packet7", "packet",
                                                "vsl_sample")
                                    if k not in launched),
                                nonzero=nonzero, extra=extra,
                                sample_casts=sample)
                for k, v in run["launches"].items():
                    launches[k] += v
                if sample:
                    sampled_casts_check(f"{label}_casts", run, job.scene,
                                        torch)
                del run
                if passes is None:
                    continue
                t1 = time.perf_counter()
                pjob = job if variant == "ours" else load_config(
                    configs[variant], device="cuda")
                passes_ms = pass_breakdown(pjob, torch, passes)
                phase("pass_breakdown", config=os.path.basename(
                    configs[variant]), ms_per_frame=passes_ms,
                    sum_ms=sum(passes_ms.values()),
                    wall_s=time.perf_counter() - t1)
                del pjob
            del job
            phase("big_scene_done", scene=name,
                  scene_device_gib=report["scene_device_gib"],
                  wall_s=time.perf_counter() - t0)
            shutil.rmtree(os.path.join(tmp, name))
    return launches


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
    traversal_bounds(entries, sets, scene)
    walk_pad_cost("samples", sets, scene, torch)
    phase("kernel_check_done", triangles=scene.num_triangles,
          nodes=scene.bvh.node_min.shape[0], bvh_depth=scene.bvh.depth,
          walk_records=scene.bvh.walk_nodes.shape[0],
          **scene_bytes(scene.bvh),
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
    splat_accumulate_cost(job, torch)
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

    # ---- 8: the LVC technique (box_field, per-pixel light vertices:
    # incoherent shadow segments through #1) ----
    with tempfile.TemporaryDirectory() as tmp:
        lvc_cfg = lvc_config(tmp)
        lrun = main_path("lvc_main_path", lvc_cfg, 1, torch, kind, smi,
                         not_launched=("vsl_sample",),
                         nonzero=("weightedVplFilename",), extra=lvc_extra,
                         sample_casts=True)
        for k, v in lrun["launches"].items():
            launches[k] += v
        ljob = load_config(lvc_cfg, device="cuda")
        sampled_casts_check("lvc_main_path_casts", lrun, ljob.scene, torch)
        walk_pad_cost("lvc_casts", lrun["samples"], ljob.scene, torch)
        del lrun
        t0 = time.perf_counter()
        passes = pass_breakdown(ljob, torch, (
            "trace_gbuffer", "trace_light_paths", "lvc_gather",
            "photon_splat_binned", "light_image"))
        phase("pass_breakdown", config="box_field_ours.json as lvcphotonfam",
              ms_per_frame=passes, sum_ms=sum(passes.values()),
              wall_s=time.perf_counter() - t0)
        del ljob

    # ---- 9: the large-scene tier (box_field_big, every technique, and
    # the 2.4M-triangle box_field_huge, "ours"; fused 42-triangle leaves,
    # so every cast runs #1) ----
    for k, v in big_scene_check(torch, kind, smi).items():
        launches[k] += v

    # ---- 10: the textured livingroom scene (192 triangles and the light:
    # every cast takes the dense path, no traversal kernel) ----
    rjob = load_config(LIVINGROOM, device="cuda")
    texture_check(rjob, torch)
    main_path("livingroom_main_path", LIVINGROOM, 1, torch, kind, smi,
              not_launched=("vsl_sample",),
              nonzero=("weightedVplFilename", "weightedPhotonFilename"),
              dense=True)
    t0 = time.perf_counter()
    passes = pass_breakdown(rjob, torch, (
        "trace_gbuffer", "trace_light_paths", "vpl_gather",
        "photon_splat_binned", "light_image"))
    phase("pass_breakdown", config=os.path.relpath(LIVINGROOM, HERE),
          ms_per_frame=passes, sum_ms=sum(passes.values()),
          wall_s=time.perf_counter() - t0)
    del rjob
    main_path("livingroom_pt_main_path", LIVINGROOM_PT, 1, torch, kind, smi,
              not_launched=("vsl_sample",), dense=True)
    t0 = time.perf_counter()
    passes = pass_breakdown(load_config(LIVINGROOM_PT, device="cuda"), torch,
                            ("trace_gbuffer", "render_pt_frame",
                             "light_image"))
    phase("pass_breakdown", config=os.path.relpath(LIVINGROOM_PT, HERE),
          ms_per_frame=passes, sum_ms=sum(passes.values()),
          wall_s=time.perf_counter() - t0)

    # ---- 11: checkpoint and resume through the CLI ----
    resume_check(torch)

    # ---- 12: --profile through the CLI, the "ours" and LVC frames under
    # the profiler, and the image formats on a full-size output ----
    prun = main_path("profile", CONFIG, 2, torch, kind, smi,
                     not_launched=("vsl_sample",), cli_args=("--profile",))
    for k, v in prun["launches"].items():
        launches[k] += v
    passes = prun["stats"]["passes"]
    phase("profile_passes", config=os.path.relpath(CONFIG, HERE),
          passes=passes, sum_ms_per_frame=sum(
              v["ms_avg"] for v in passes.values()))
    if sorted(passes) != sorted(PROFILE_PASSES) or any(
            v["calls"] != 2 for v in passes.values()):
        raise AssertionError(f"profile: passes {passes}")
    trace_frames(torch)
    image_io_check(prun["imgs"]["combinedFilename"])
    del prun

    # ---- 13: pixel-row sharding over SHARDS shards of the card, and
    # --mesh through the CLI ----
    for k, v in shard_check(torch).items():
        launches[k] += v
    for k, v in mesh_cli_check(torch, kind, smi).items():
        launches[k] += v

    # ---- 14: the equal-time quality harness on glossy ----
    quality_check(torch)

    t0 = time.perf_counter()
    phase("reference_check", max_abs_diff=reference_check(),
          wall_s=time.perf_counter() - t0)

    # ---- 15: kernels line, card line, result ----
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
