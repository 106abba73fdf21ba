"""Frame stream roots and inverse-CDF draws (counterpart of the JAX
package's `core/sampling.py`).  Keys are threefry keys from `core.rng`."""
from __future__ import annotations

import torch

from evplp_tpu_torch.core import rng


def iteration_key(base_seed: int, iteration: int, device="cuda") -> torch.Tensor:
    """Stream root for one frame: fold_in(PRNGKey(0), base_seed + iteration),
    mirroring the reference's rngSeed = iteration + rngOffset."""
    return rng.fold_in(rng.prng_key(0, device), base_seed + iteration)


def uniform_not_one(u: torch.Tensor) -> torch.Tensor:
    """min(u, 0.999999): the reference's guard before material selection."""
    return torch.clamp_max(u, 0.999999)


def sample_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """First index with cdf[i] >= u (lower-bound search), clamped to n-1."""
    idx = torch.searchsorted(cdf, u.contiguous(), side="left")
    return torch.clamp_max(idx, cdf.shape[0] - 1)
