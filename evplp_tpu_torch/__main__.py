"""CLI entry: python -m evplp_tpu_torch config.json [--output-dir DIR]
[--max-wall-s S] [--device cuda|cpu]

Runs a reference-format photonfam config on the card.  The CPU runs only
when asked for with --device cpu; without a card the CLI raises.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def resolve_device(device: str) -> torch.device:
    """The device to run on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass --device cpu to run on the CPU")
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="evplp_tpu_torch",
        description="EVPLP renderer on PyTorch/CUDA (photonfam)")
    ap.add_argument("config", help="reference-format JSON scene config")
    ap.add_argument("--output-dir", default=None,
                    help="redirect configured output files into this dir")
    ap.add_argument("--max-wall-s", type=float, default=None,
                    help="hard wall-clock cap regardless of timeLimitMs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from evplp_tpu_torch.runtime.loop import run_photon_fam
    from evplp_tpu_torch.scene.config import load_config

    job = load_config(args.config, device=dev)
    if job.params.technique != "photonfam":
        raise NotImplementedError(
            f"technique {job.params.technique!r} is not ported yet")
    result = run_photon_fam(job, output_dir=args.output_dir,
                            max_wall_s=args.max_wall_s)
    print(json.dumps({"numIterations": result.num_iterations,
                      "timeMs": round(result.time_ms, 1),
                      **result.stats}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
