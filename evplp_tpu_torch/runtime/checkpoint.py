"""Checkpoint / resume of progressive photonfam runs (counterpart of the
JAX package's `runtime/checkpoint.py`, same format).

The resumable state is the accumulation buffers, the iteration count and
the progressive schedule (photon radius, clamping value and its start,
alpha, VSL radius, pdf_mc); the RNG needs nothing more, since each frame's
key derives from its iteration number.  One .npz of host arrays, written
to a temporary name and moved into place, so a checkpoint written by
either package resumes in the other.
"""
from __future__ import annotations

import os

import numpy as np

from evplp_tpu_torch.integrators.photon_fam import (FrameState,
                                                    state_from_arrays)

FORMAT_VERSION = 1
SCHEDULE_KEYS = ("radius", "clamp", "clamp_start", "alpha", "vsl_radius",
                 "pdf_mc")


def save_checkpoint(path: str, state: FrameState, num_iterations: int,
                    schedule) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, version=FORMAT_VERSION,
             **{k: getattr(state, k).detach().cpu().numpy()
                for k in ("vpl_acc", "photon_acc", "light_img", "dropped")},
             num_iterations=num_iterations,
             **{k: getattr(schedule, k) for k in SCHEDULE_KEYS})
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda"):
    """-> (FrameState on device, num_iterations, {schedule field: float})."""
    z = np.load(path)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {int(z['version'])}, "
                         f"expected {FORMAT_VERSION}")
    state = state_from_arrays(z["vpl_acc"], z["photon_acc"], z["light_img"],
                              z["dropped"], device=device)
    return (state, int(z["num_iterations"]),
            {k: float(z[k]) for k in SCHEDULE_KEYS})
