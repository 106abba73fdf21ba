"""Film helpers (counterpart of the JAX package's `runtime/film.py`).

The final composite masks the indirect estimates wherever the emitter is
directly visible: light_scale * light + (light <= 0) * (vpl * vpl_scale +
photon * photon_scale), over flat (N, 3) buffers."""
from __future__ import annotations

import numpy as np
import torch


def to_image(flat: torch.Tensor, width: int, height: int) -> np.ndarray:
    """(H*W, 3) tensor -> (H, W, 3) numpy image (row 0 = top)."""
    return flat.detach().cpu().numpy().reshape(height, width, 3)


def composite(vpl, photon, light, vpl_scale=1.0, photon_scale=1.0,
              light_scale=1.0, gamma: bool = False) -> torch.Tensor:
    """The reference's final pass over (N, 3) buffers; with gamma, the
    display transform pow(max(x, 0), 1/2.2)."""
    gi_mask = (light[:, 0:1] * light_scale <= 0.0).to(torch.float32)
    s = (gi_mask * (vpl * vpl_scale + photon * photon_scale)
         + light * light_scale)
    if gamma:
        s = torch.pow(torch.clamp_min(s, 0.0), 1.0 / 2.2)
    return s
