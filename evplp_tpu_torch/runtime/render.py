"""Top-level dispatch by technique (counterpart of the JAX package's
`runtime/render.py`): a config's "pt" block runs the path tracer, its
"photonfam" block the EVPLP family; "lvcphotonfam" is not ported yet."""
from __future__ import annotations

from evplp_tpu_torch.runtime.loop import RunResult, run_photon_fam, run_pt
from evplp_tpu_torch.scene.config import RenderJob, load_config


def render_job(job: RenderJob, output_dir: str | None = None,
               max_wall_s: float | None = None) -> RunResult:
    tech = job.params.technique
    if tech == "pt":
        return run_pt(job, output_dir=output_dir, max_wall_s=max_wall_s)
    if tech == "photonfam":
        return run_photon_fam(job, output_dir=output_dir,
                              max_wall_s=max_wall_s)
    raise NotImplementedError(f"technique {tech!r} is not ported yet")


def render_config(path: str, output_dir: str | None = None,
                  max_wall_s: float | None = None,
                  device="cuda") -> RunResult:
    return render_job(load_config(path, device=device),
                      output_dir=output_dir, max_wall_s=max_wall_s)
