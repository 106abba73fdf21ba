#!/usr/bin/env python3
"""Variants of the VSL sample kernel timed in turns on one NVIDIA card.

    python3 vsl_variants.py [--set kBlock=256,maxnreg=96 ...]
                            [--source NAME=OTHER.cu ...] [--rounds 4]

Run from a checkout of the repository on a machine with a CUDA card.  It
builds `evplp_tpu_torch/csrc/vsl_sample.cu` as it is and in variants made
by editing its text: each --set is one variant, a comma-separated list of
NAME=VALUE, where NAME is a compile-time constant (`constexpr ... NAME`),
`minblocks` (the kernel's launch attribute becomes
`__launch_bounds__(kBlock, VALUE)`) or `maxnreg` (`__maxnreg__(VALUE)`).  Each
--source is another version of the file with the same C interface (an
earlier commit's, say).  All are built with the port's nvcc flags, one nvcc
per source at once.  On the two
real full-size groups of the VSL frame that chip_smoke.py checks
(`vsl_frame_groups`), it first prints chip_smoke's `vsl_work_shape` phase
and its kernel checks, then holds every variant to the plain version bit
for bit on each group's check slice, and times every variant with CUDA
events on the check slices and on the full-size groups, in turns (the
order reversed every other round).  It prints one JSON line per variant,
with ptxas's registers, spills and shared memory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "evplp_tpu_torch", "csrc", "vsl_sample.cu")
# the kernel's launch attributes, between `__global__ void` and its name
ATTRS = re.compile(r"(__global__ void )[^\n]*(\nvsl_sample_kernel\()")


def edited(src: str, item: str) -> str:
    """src with one NAME=VALUE edit of --set applied."""
    name, value = item.split("=", 1)
    if name in ("minblocks", "maxnreg"):
        if not ATTRS.search(src):
            raise SystemExit("vsl_sample.cu has no vsl_sample_kernel")
        attr = (f"__launch_bounds__(kBlock, {value})" if name == "minblocks"
                else f"__maxnreg__({value})")
        return ATTRS.sub(rf"\g<1>{attr}\g<2>", src)
    pattern = rf"(constexpr \w+ {name} = )[^;]+;"
    if not re.search(pattern, src):
        raise SystemExit(f"vsl_sample.cu has no constant {name}")
    return re.sub(pattern, rf"\g<1>{value};", src)


def variant_sources(sets, others) -> dict:
    """Each variant's name -> its source text; sets are comma-separated
    NAME=VALUE edits, others NAME=PATH."""
    with open(SOURCE) as f:
        src = f.read()
    out = {"kernel": src}
    for variant in sets:
        text = src
        for item in variant.split(","):
            text = edited(text, item)
        out[variant.replace("=", "_").replace(",", "+")] = text
    for other in others:
        name, path = other.split("=", 1)
        with open(path) as f:
            out[name] = f.read()
    return out


def build_variants(sources: dict) -> dict:
    """name -> (ctypes library, ptxas report), built in parallel; a variant
    that does not build is reported and left out."""
    from evplp_tpu_torch.native import build

    src_dir = os.path.join(build.BUILD_DIR, "vsl_variants")
    os.makedirs(src_dir, exist_ok=True)

    def one(name):
        path = os.path.join(src_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(sources[name])
        lib_path = build.build_library(f"vsl_variant_{name}", [path],
                                       build.nvcc_command())
        lib = ctypes.CDLL(lib_path)
        fn = lib.evplp_vsl_sample_group
        vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn.restype = ci
        fn.argtypes = [vp] * 6 + [ci, ci, cu, cu, ci, vp, vp]
        with open(f"{lib_path}.log") as f:
            report = build.ptxas_report(f.read())
        return lib, report

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


def launcher(lib, args, torch):
    """A function that runs the variant `lib` on the group call `args`
    and returns its (N, 3) output."""
    pix, pids, gates, cos_half, counts, table, seed0, seed1, rec_base = args
    n, g = pix.shape[1], table.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=pix.device)

    def run():
        err = lib.evplp_vsl_sample_group(
            pix.data_ptr(), pids.data_ptr(), gates.data_ptr(),
            cos_half.data_ptr(), counts.data_ptr(), table.data_ptr(), g, n,
            seed0 & 0xFFFFFFFF, seed1 & 0xFFFFFFFF, rec_base, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("vsl_variants: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", action="append", default=[],
                    help="one variant: comma-separated NAME=VALUE edits")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another vsl_sample.cu to time")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from evplp_tpu_torch.integrators import vsl_kernel
    from evplp_tpu_torch.scene.config import load_config

    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build_variants(variant_sources(opts.set, opts.source))
    job = load_config(cs.VSL_CONFIG, device="cuda")
    first, middle, _ = cs.vsl_frame_groups(job, torch)
    groups = dict(first=first, middle=middle)
    works = cs.vsl_work_shape(groups, torch)
    for k, a in groups.items():
        cs.vsl_kernel_check(k, a, works[k], torch)
    cases = {}
    for k, a in groups.items():
        cut = cs.check_slice(a)
        cases[f"{k}_slice"] = (cut, vsl_kernel.vsl_sample_group_plain(*cut))
        cases[f"{k}_full"] = (a, None)
    results = {n: dict(ptxas=rep, bit_equal={}, ms={c: [] for c in cases})
               for n, (_, rep) in libs.items()}
    runs = {(n, c): launcher(lib, cases[c][0], torch)
            for n, (lib, _) in libs.items() for c in cases}
    for (n, c), run in runs.items():
        ref = cases[c][1]
        if ref is not None:
            results[n]["bit_equal"][c] = bool(torch.equal(run(), ref))
    names = list(libs)
    for r in range(opts.rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            for c in cases:
                results[n]["ms"][c].append(cs.cuda_ms(runs[(n, c)],
                                                      opts.reps))
    for n in names:
        print(json.dumps(dict(
            variant=n, nvidia_smi=smi, ptxas=results[n]["ptxas"],
            bit_equal=results[n]["bit_equal"],
            median_ms={c: statistics.median(v)
                       for c, v in results[n]["ms"].items()},
            ms=results[n]["ms"])), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
