"""PFM read and write (counterpart of the PFM part of the JAX package's
`utils/image.py`).  Images are (H, W, 3) float32 numpy arrays, row 0 = top;
PFM stores rows bottom-up."""
from __future__ import annotations

import os

import numpy as np


def save_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, dtype=np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PFM needs an (H, W, 3) image, got {img.shape}")
    h, w, _ = img.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.000000\n")  # little-endian
        f.write(np.ascontiguousarray(img[::-1]).tobytes())


def load_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        channels = 3 if header == b"PF" else 1
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        data = np.frombuffer(f.read(), dtype="<f4" if scale < 0 else ">f4")
        img = data.reshape(h, w, channels)[::-1].astype(np.float32)
        if channels == 1:
            img = np.repeat(img, 3, axis=2)
        return np.ascontiguousarray(img)


def save(path: str, img: np.ndarray) -> None:
    """Write an image; only .pfm is supported."""
    if os.path.splitext(path)[1].lower() != ".pfm":
        raise ValueError(f"unsupported image extension (only .pfm): {path}")
    save_pfm(path, img)
