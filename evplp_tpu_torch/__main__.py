"""CLI entry: python -m evplp_tpu_torch config.json [--output-dir DIR]
[--max-wall-s S] [--device cuda|cpu]

Runs a reference-format config on the card: a "pt" block (path tracing) or
a "photonfam" block (EVPLP, or VSL with forceVsl); "lvcphotonfam" raises
NotImplementedError.  The CPU runs only when asked for with --device cpu;
without a card the CLI raises.
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
        description="EVPLP renderer on PyTorch/CUDA (pt, photonfam)")
    ap.add_argument("config", help="reference-format JSON scene config")
    ap.add_argument("--output-dir", default=None,
                    help="redirect configured output files into this dir")
    ap.add_argument("--max-wall-s", type=float, default=None,
                    help="hard wall-clock cap regardless of timeLimitMs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from evplp_tpu_torch.runtime.render import render_config

    result = render_config(args.config, output_dir=args.output_dir,
                           max_wall_s=args.max_wall_s, device=dev)
    print(json.dumps({"numIterations": result.num_iterations,
                      "timeMs": round(result.time_ms, 1),
                      **result.stats}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
