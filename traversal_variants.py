#!/usr/bin/env python3
"""Variants of the BVH traversal kernels timed in turns on one NVIDIA card.

    python3 traversal_variants.py [--set packet:kSolo=4,kStage=16 ...]
                                  [--source packet:parent=DIR/packet.cu ...]
                                  [--parent-plain DIR] [--rounds 3]

Run from a checkout of the repository on a machine with a CUDA card.  It
builds the three traversal kernels (`evplp_tpu_torch/csrc/traverse.cu`,
`packet7.cu`, `packet.cu`) as they are and in variants: each --set
KERNEL:NAME=VALUE,... edits compile-time constants (`constexpr ... NAME`)
of KERNEL's source (traverse, packet7 or packet); each --source
KERNEL:LABEL=PATH is another version of a kernel's file (an earlier
commit's, say), built beside the headers of its own directory.  Every
variant is built with the port's nvcc flags, one nvcc per variant at once.
A source with the C entry of the walk-record kernels (`evplp_traverse`,
`evplp_packet`, `evplp_packet7`) is launched on the BVH's walk records; a
source with the entries of the earlier skip-pointer (`evplp_packet_closest`
/ `_any`) or packed-layout (`evplp_packet7_closest` / `_any`) kernels, on
those arrays.

Cases: chip_smoke's three 65,536-ray samples on box_field, and every cast
of one full-size box_field PT frame (the warm-up and one timed frame,
recorded under PACKET_IMPL = "packet3").  Each variant's result is held to
traverse_plain on every ray of the samples and on a strided sample of each
cast (rays that differ are counted, not raised on), then every variant is
timed with CUDA events on every case, in turns (the order reversed every
other round).  It prints one JSON line per variant: ptxas's registers,
spills and shared memory, the rays that differ, the median ms of each
sample and of the PT frame's casts a frame.  With --parent-plain DIR (a
directory holding an earlier `traverse.py`, `packet.py` and `packet7.py`
of evplp_tpu_torch/trace), it first prints chip_smoke's
traversal_work_shape of those plain walks beside the walks of this
checkout, on the samples and on FRAME_OPS_SAMPLE consecutive rays in the
middle of each cast.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "evplp_tpu_torch", "csrc")
KERNELS = {"traverse": "traverse.cu", "packet7": "packet7.cu",
           "packet": "packet.cu"}
# rays of each PT cast held to traverse_plain (a strided sample)
CHECK_RAYS = 65_536


def edited(src: str, item: str) -> str:
    """src with one NAME=VALUE constant edit applied."""
    name, value = item.split("=", 1)
    pattern = rf"(constexpr \w+ {name} = )[^;]+;"
    if not re.search(pattern, src):
        raise SystemExit(f"no constant {name} to edit")
    return re.sub(pattern, rf"\g<1>{value};", src)


def variant_sources(sets, others) -> dict:
    """Each variant's name -> (kernel, source path, source text)."""
    out = {}
    for kernel, f in KERNELS.items():
        path = os.path.join(CSRC, f)
        with open(path) as fh:
            out[kernel] = (kernel, path, fh.read())
    for variant in sets:
        kernel, edits = variant.split(":", 1)
        _, path, text = out[kernel]
        for item in edits.split(","):
            text = edited(text, item)
        name = f"{kernel}+{edits.replace('=', '_').replace(',', '+')}"
        out[name] = (kernel, path, text)
    for other in others:
        kernel, rest = other.split(":", 1)
        label, path = rest.split("=", 1)
        with open(path) as fh:
            out[f"{kernel}@{label}"] = (kernel, os.path.abspath(path),
                                        fh.read())
    return out


def build_variants(sources: dict) -> dict:
    """name -> (ctypes library, ptxas report), built in parallel, each in a
    directory of its own with the headers beside its source; a variant that
    does not build is reported and left out."""
    from evplp_tpu_torch.native import build

    root = os.path.join(build.BUILD_DIR, "traversal_variants")

    def one(name):
        _, path, text = sources[name]
        vdir = os.path.join(root, re.sub(r"[^\w.+@-]", "_", name))
        os.makedirs(vdir, exist_ok=True)
        headers = []
        for h in build.headers_beside(path):
            shutil.copy(h, vdir)
            headers.append(os.path.join(vdir, os.path.basename(h)))
        src = os.path.join(vdir, os.path.basename(path))
        with open(src, "w") as f:
            f.write(text)
        lib_path = build.build_library(f"tv_{os.path.basename(vdir)}", [src],
                                       build.nvcc_command(), headers)
        with open(f"{lib_path}.log") as f:
            report = build.ptxas_report(f.read())
        return ctypes.CDLL(lib_path), report

    out = {}
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {n: pool.submit(one, n) for n in sources}
        for n, f in futures.items():
            try:
                out[n] = f.result()
            except RuntimeError as err:
                print(json.dumps(dict(variant=n,
                                      build_error=str(err)[-2000:])),
                      flush=True)
    return out


def launcher(lib, scene, case, torch):
    """A function that runs the library's kernel on one case (o, d, t_min,
    t_max, any_hit) and returns (t, prim, u, v), by the C interface the
    library exports."""
    o, d, lo, hi, any_hit = case
    r, dev = o.shape[0], o.device
    bvh, tris = scene.bvh, scene.tris
    out = (torch.empty((r,), dtype=torch.float32, device=dev),
           torch.empty((r,), dtype=torch.int32, device=dev),
           torch.empty((r,), dtype=torch.float32, device=dev),
           torch.empty((r,), dtype=torch.float32, device=dev))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    rays = [o, d, lo, hi]
    if any(hasattr(lib, e) for e in ("evplp_traverse", "evplp_packet",
                                     "evplp_packet7")):
        fn = next(getattr(lib, e) for e in ("evplp_traverse", "evplp_packet",
                                            "evplp_packet7")
                  if hasattr(lib, e))
        fn.argtypes = [vp] * 6 + [ci] + [vp] * 4 + [ci, vp]
        args = [bvh.walk_nodes, bvh.walk_tris] + rays
        tail = [int(any_hit)]
    elif hasattr(lib, "evplp_packet_closest"):
        fn = lib.evplp_packet_any if any_hit else lib.evplp_packet_closest
        fn.argtypes = [vp] * 12 + [ci] + [vp] * 5
        args = [bvh.node_min, bvh.node_max, bvh.node_skip, bvh.node_first,
                bvh.node_count, tris.v0, tris.e1, tris.e2] + rays
        tail = []
    else:
        fn = lib.evplp_packet7_any if any_hit else lib.evplp_packet7_closest
        fn.argtypes = [vp] * 7 + [ci] + [vp] * 5
        args = [bvh.pk_bounds, bvh.pk_meta, bvh.pk_tri_rows] + rays
        tail = []
    fn.restype = ci
    ptrs = [x.data_ptr() for x in args] + [r] + [x.data_ptr() for x in out]

    def run():
        err = fn(*ptrs, *tail, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def load_parent_walks(directory) -> dict:
    """The plain walks of an earlier packet.py and packet7.py in directory,
    each importing the traverse.py beside it: walk name -> function."""
    mods = {}
    for name in ("traverse", "packet", "packet7"):
        with open(os.path.join(directory, f"{name}.py")) as f:
            text = f.read().replace("evplp_tpu_torch.trace.traverse",
                                    "parent_traverse")
        mod = importlib.util.module_from_spec(
            importlib.util.spec_from_loader(f"parent_{name}", loader=None))
        mod.__file__ = os.path.join(directory, f"{name}.py")
        sys.modules[f"parent_{name}"] = mod
        exec(compile(text, os.path.join(directory, f"{name}.py"), "exec"),
             mod.__dict__)
        mods[name] = mod
    return {"packet@parent": mods["packet"].packet_plain,
            "packet7@parent": mods["packet7"].packet7_plain}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("traversal_variants: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", action="append", default=[],
                    help="KERNEL:NAME=VALUE,... edits of one variant")
    ap.add_argument("--source", action="append", default=[],
                    help="KERNEL:LABEL=PATH of another kernel source")
    ap.add_argument("--parent-plain", default=None,
                    help="directory of an earlier packet.py and packet7.py")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from evplp_tpu_torch.runtime.loop import run_pt
    from evplp_tpu_torch.scene.config import load_config
    from evplp_tpu_torch.trace.traverse import traverse_plain

    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build_variants(variant_sources(opts.set, opts.source))

    # the samples and the PT frame's casts, recorded under packet3 (both
    # on the same box_field scene)
    job = load_config(cs.PT_CONFIG, device="cuda")
    scene = job.scene
    cases = dict(cs.ray_sets(scene, job.width, job.height, torch))
    import dataclasses
    job = dataclasses.replace(job, params=dataclasses.replace(
        job.params, num_max_iteration=1, time_limit_ms=-1.0, use_stat=False,
        output_filename="", write_every_frame=False))
    with cs.LaunchTimer(torch, record=True) as timer:
        run_pt(job)
    pt_casts = {f"pt_cast_{i}": c[:5] for i, c in enumerate(timer.casts)}
    cases.update(pt_casts)

    # references: traverse_plain on every sample ray and on a strided
    # sample of each cast
    refs = {}
    for name, (o, d, lo, hi, any_hit) in cases.items():
        if name in pt_casts:
            live = torch.nonzero(hi > lo).squeeze(1)
            idx = live[::max(1, live.numel() // CHECK_RAYS)][:CHECK_RAYS]
        else:
            idx = torch.arange(o.shape[0], device=o.device)
        refs[name] = (idx, traverse_plain(
            scene.tris, scene.bvh, *(x[idx].contiguous() for x in
                                     (o, d, lo, hi)), any_hit))

    if opts.parent_plain:
        parent = load_parent_walks(opts.parent_plain)
        per_case = {}
        for name, (o, d, lo, hi, any_hit) in cases.items():
            win = cs.middle_window(o.shape[0], cs.FRAME_OPS_SAMPLE) \
                if name in pt_casts else slice(None)
            args = (scene.tris, scene.bvh) + tuple(
                x[win].contiguous() for x in (o, d, lo, hi)) + (any_hit,)
            counts = {}
            for w in ("skip_pointer", "ordered", "packet7", "packet"):
                counts[w] = cs.run_walk(w, *args)[2]
            for w, fn in parent.items():
                work: dict = {}
                fn(*args, work=work)
                counts[w] = work
            per_case[name] = counts
        cs.traversal_work_shape("samples_and_pt_cast_samples", per_case)

    runs = {(n, c): launcher(lib, scene, cases[c], torch)
            for n, (lib, _) in libs.items() for c in cases}
    differing = {n: {} for n in libs}
    for (n, c), run in runs.items():
        idx, ref = refs[c]
        got = tuple(x[idx] for x in run())
        lo, hi, any_hit = cases[c][2][idx], cases[c][3][idx], cases[c][4]
        differing[n][c] = int(cs.differs(got, ref, lo, hi, any_hit).sum())
    ms = {n: {c: [] for c in cases} for n in libs}
    names = list(libs)
    for r in range(opts.rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            for c in cases:
                ms[n][c].append(cs.cuda_ms(runs[(n, c)], opts.reps))
    for n in names:
        med = {c: statistics.median(v) for c, v in ms[n].items()}
        print(json.dumps(dict(
            variant=n, kernel=n.split("+")[0].split("@")[0],
            nvidia_smi=smi, ptxas=libs[n][1], differing=differing[n],
            samples_median_ms={c: med[c] for c in cases
                               if c not in pt_casts},
            pt_frame_median_ms=sum(med[c] for c in pt_casts) / 2,
            pt_casts=len(pt_casts), rounds=opts.rounds)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
