"""Equal-time quality protocol (counterpart of the JAX package's
`runtime/compare.py`).

Every technique runs the same config for the same wall-clock budget
through the run loop (runtime/loop.py: BudgetPacer pacing, one warm-up
frame outside the clock), then masked MSE and RelMSE against a converged
jittered-PT ground truth, over the pixels that are neither on the directly
visible emitter nor within 2 px of it.  The artifacts are the JAX
harness's: `<scene>_<variant>.npz` (img, iters, time_ms, dropped) and
`<scene>_gt.npz` (img, mask, iters), so either package's `report` reads
the other's.

CLI:
  python -m evplp_tpu_torch.runtime.compare [--art-dir DIR] [--configs DIR]
      [--budget-ms MS] [--device cuda|cpu] run <scene> [variants,..]
                                            | gt <scene> <iters>
                                            | report [scenes,..]
The artifacts go to bench_artifacts/quality_torch by default, beside the
JAX harness's bench_artifacts/quality.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = os.path.join(REPO, "configs")
ART_DIR = os.path.join(REPO, "bench_artifacts", "quality_torch")
VARIANTS = ("pt", "pm", "vpl", "vsl", "ours", "ours_progressive")
BUDGET_MS = 15000.0


def _device(device):
    """The device to run on; a CUDA device must exist."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def load_variant(scene: str, variant: str, configs: str = CONFIGS,
                 device="cuda"):
    from evplp_tpu_torch.scene.config import load_config
    return load_config(os.path.join(configs, scene,
                                    f"{scene}_{variant}.json"),
                       device=_device(device))


def run_techniques(scene: str, variants=VARIANTS, art: str = ART_DIR,
                   configs: str = CONFIGS, budget_ms: float = BUDGET_MS,
                   device="cuda"):
    """Equal-time runs of the config variants through the run loop; one
    .npz artifact per (scene, variant)."""
    from evplp_tpu_torch.runtime.loop import run_photon_fam, run_pt
    os.makedirs(art, exist_ok=True)
    for variant in variants:
        job = load_variant(scene, variant, configs, device)
        p = job.params
        p.combined_filename = p.weighted_photon_filename = ""
        p.weighted_vpl_filename = p.output_filename = ""
        p.stat_filename = ""
        runner = run_pt if p.technique == "pt" else run_photon_fam

        # a run of one frame outside the budget builds the kernels, as the
        # reference builds its programs before its timer starts
        p.num_max_iteration, p.time_limit_ms = 1, -1.0
        runner(job)
        p.num_max_iteration, p.time_limit_ms = -1, budget_ms

        t0 = time.time()
        result = runner(job)
        key = "output" if p.technique == "pt" else "combined"
        np.savez_compressed(
            os.path.join(art, f"{scene}_{variant}.npz"),
            img=result.images[key].astype(np.float32),
            iters=result.num_iterations, time_ms=result.time_ms,
            dropped=result.stats.get("dropped_splat_pairs", 0))
        print(f"{scene}_{variant}: {result.num_iterations} iters in "
              f"{result.time_ms:.0f} ms (wall {time.time()-t0:.0f}s) "
              f"{result.stats}", flush=True)


def emitter_mask(job) -> np.ndarray:
    """True on the pixels the metrics use: not on, nor within 2 px of, the
    directly visible emitter."""
    from evplp_tpu_torch.integrators.gbuffer import light_image, trace_gbuffer
    gbuf = trace_gbuffer(job.scene, job.width, job.height, None)
    li = light_image(job.scene, gbuf).cpu().numpy()
    lit = (li.sum(axis=-1) > 0.0).reshape(job.height, job.width)
    for _ in range(2):
        d = lit.copy()
        d[1:, :] |= lit[:-1, :]
        d[:-1, :] |= lit[1:, :]
        d[:, 1:] |= lit[:, :-1]
        d[:, :-1] |= lit[:, 1:]
        lit = d
    return ~lit


def run_gt(scene: str, iters: int, art: str = ART_DIR,
           configs: str = CONFIGS, device="cuda"):
    """Converged jittered-PT ground truth and the dilated emitter mask."""
    from evplp_tpu_torch.runtime.loop import run_pt
    os.makedirs(art, exist_ok=True)
    job = load_variant(scene, "pt", configs, device)
    p = job.params
    p.output_filename = p.stat_filename = ""
    p.num_max_iteration, p.time_limit_ms = iters, -1.0
    t0 = time.time()
    result = run_pt(job)
    np.savez_compressed(os.path.join(art, f"{scene}_gt.npz"),
                        img=result.images["output"].astype(np.float32),
                        mask=emitter_mask(job),
                        iters=result.num_iterations)
    print(f"{scene}_gt: {result.num_iterations} iters in "
          f"{time.time()-t0:.0f}s wall", flush=True)


def masked_mse(img, ref, mask):
    """Mean over the masked pixels of ||rgb diff||^2."""
    d = ((img - ref) ** 2).sum(axis=-1)
    return float(d[mask].mean())


def masked_rel_mse(img, ref, mask):
    """Mean over the masked pixels of ||diff||^2 / (||ref||^2 + 0.001)."""
    d = ((img - ref) ** 2).sum(axis=-1)
    den = (ref ** 2).sum(axis=-1) + 1e-3
    return float((d / den)[mask].mean())


def report(scenes, art: str = ART_DIR, variants=VARIANTS,
           budget_ms: float = BUDGET_MS):
    rows = []
    for scene in scenes:
        gt_path = os.path.join(art, f"{scene}_gt.npz")
        if not os.path.exists(gt_path):
            continue
        gt = np.load(gt_path)
        ref, mask = gt["img"], gt["mask"]
        for variant in variants:
            path = os.path.join(art, f"{scene}_{variant}.npz")
            if not os.path.exists(path):
                continue
            z = np.load(path)
            t_ms = float(z["time_ms"])
            rows.append({
                "scene": scene, "variant": variant,
                "iters": int(z["iters"]), "time_ms": t_ms,
                "budget_dev_pct": round(
                    (t_ms - budget_ms) * 100.0 / budget_ms, 1),
                "mse": masked_mse(z["img"], ref, mask),
                "rel_mse": masked_rel_mse(z["img"], ref, mask),
                "gt_iters": int(gt["iters"]),
            })
    print(json.dumps(rows, indent=1))
    return rows


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m evplp_tpu_torch.runtime.compare",
        description="Equal-time quality protocol: run, gt, report")
    ap.add_argument("--art-dir", default=ART_DIR)
    ap.add_argument("--configs", default=CONFIGS)
    ap.add_argument("--budget-ms", type=float, default=BUDGET_MS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("scene")
    r.add_argument("variants", nargs="?", default=",".join(VARIANTS))
    g = sub.add_parser("gt")
    g.add_argument("scene")
    g.add_argument("iters", type=int)
    rep = sub.add_parser("report")
    rep.add_argument("scenes", nargs="?",
                     default="cornell,glossy,livingroom,box_field")
    a = ap.parse_args(argv)
    if a.cmd == "run":
        run_techniques(a.scene, tuple(a.variants.split(",")), a.art_dir,
                       a.configs, a.budget_ms, a.device)
    elif a.cmd == "gt":
        run_gt(a.scene, a.iters, a.art_dir, a.configs, a.device)
    else:
        report(tuple(a.scenes.split(",")), a.art_dir, budget_ms=a.budget_ms)


if __name__ == "__main__":
    main()
