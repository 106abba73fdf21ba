"""CLI entry: python -m evplp_tpu_torch config.json [--output-dir DIR]
[--max-wall-s S] [--device cuda|cpu] [--profile] [--gamma] [--checkpoint
PATH [--checkpoint-every N]] [--resume PATH] [--mesh N]

Runs a reference-format config on the card: a "pt" block (path tracing), a
"photonfam" block (EVPLP, or VSL with forceVsl) or an "lvcphotonfam" block
(the LVC gather), textured scenes included.  --profile times each pass of
a photonfam run (printed with the stats); --gamma writes the outputs
through the display transform pow 1/2.2; --checkpoint, --checkpoint-every
and --resume save and resume a photonfam run's progressive state (a pt
config takes only --gamma and --mesh); --mesh N shards the film's rows
over the first N devices of --device's type (parallel/shard.py; resY and
numLightPaths must divide by N).  The CPU runs only when asked for with
--device cpu; without a card the CLI raises.
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
        description="EVPLP renderer on PyTorch/CUDA (pt / photonfam / "
                    "lvcphotonfam)")
    ap.add_argument("config", help="reference-format JSON scene config")
    ap.add_argument("--output-dir", default=None,
                    help="redirect configured output files into this dir")
    ap.add_argument("--max-wall-s", type=float, default=None,
                    help="hard wall-clock cap regardless of timeLimitMs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    ap.add_argument("--profile", action="store_true",
                    help="per-pass device timing (printed with the stats)")
    ap.add_argument("--gamma", action="store_true",
                    help="apply the display gamma (pow 1/2.2) to saved "
                         "outputs; the dumps are linear otherwise")
    ap.add_argument("--checkpoint", default=None,
                    help="write progressive-state checkpoints here")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint file")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="run pixel-row-sharded over the first N devices "
                         "of --device's type (light blocks ring-rotate; "
                         "parallel/shard.py); needs N visible devices and "
                         "resY %% N == 0")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from evplp_tpu_torch.runtime.render import render_config

    kwargs = {"max_wall_s": args.max_wall_s, "display_gamma": args.gamma}
    with open(args.config) as f:
        is_pt = "pt" in json.load(f)
    if not is_pt:
        if args.profile:
            kwargs["profile"] = True
        if args.checkpoint:
            kwargs.update(checkpoint_path=args.checkpoint,
                          checkpoint_every=args.checkpoint_every)
        if args.resume:
            kwargs["resume_from"] = args.resume
    if args.mesh:
        from evplp_tpu_torch.parallel.shard import make_mesh
        kwargs["mesh"] = make_mesh(args.mesh, dev)
    result = render_config(args.config, output_dir=args.output_dir,
                           device=dev, **kwargs)
    print(json.dumps({"numIterations": result.num_iterations,
                      "timeMs": round(result.time_ms, 1),
                      **result.stats}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
