"""Film helpers (counterpart of the JAX package's `runtime/film.py`)."""
from __future__ import annotations

import numpy as np
import torch


def to_image(flat: torch.Tensor, width: int, height: int) -> np.ndarray:
    """(H*W, 3) tensor -> (H, W, 3) numpy image (row 0 = top)."""
    return flat.detach().cpu().numpy().reshape(height, width, 3)
