"""Top-level dispatch by technique (counterpart of the JAX package's
`runtime/render.py`): a config's "pt" block runs the path tracer, its
"photonfam" or "lvcphotonfam" block the EVPLP family."""
from __future__ import annotations

from evplp_tpu_torch.runtime.loop import RunResult, run_photon_fam, run_pt
from evplp_tpu_torch.scene.config import RenderJob, load_config


def render_job(job: RenderJob, output_dir: str | None = None,
               **kwargs) -> RunResult:
    """Run the job's technique.  kwargs go to run_photon_fam; a pt job
    takes only max_wall_s, display_gamma and mesh of them."""
    if job.params.technique == "pt":
        return run_pt(job, output_dir=output_dir,
                      max_wall_s=kwargs.get("max_wall_s"),
                      display_gamma=kwargs.get("display_gamma", False),
                      mesh=kwargs.get("mesh"))
    return run_photon_fam(job, output_dir=output_dir, **kwargs)


def render_config(path: str, output_dir: str | None = None, device="cuda",
                  **kwargs) -> RunResult:
    return render_job(load_config(path, device=device),
                      output_dir=output_dir, **kwargs)
