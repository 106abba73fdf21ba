"""Float image IO and error metrics (counterpart of the JAX package's
`utils/image.py`).

PFM, Radiance HDR (RGBE) and PNG read and write, MSE, RelMSE, error heat
maps, flips, gaussian blur and resize.  Images are (H, W, 3) float32 numpy
arrays, row 0 = top; PFM stores rows bottom-up.  PNGs go through
`utils/png.py` (zlib, no PIL), so .jpg, .bmp and .tga are not read.
"""
from __future__ import annotations

import os

import numpy as np

from evplp_tpu_torch.utils.png import read_png_rgb, write_png_rgb


# ---- PFM ----

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


# ---- Radiance HDR (RGBE): flat scanlines written, flat or RLE read ----

def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    maxc = img.max(axis=-1)
    rgbe = np.zeros(img.shape[:-1] + (4,), dtype=np.uint8)
    valid = maxc >= 1e-32
    mant, expo = np.frexp(np.where(valid, maxc, 1.0))
    scale = mant * 256.0 / np.where(valid, maxc, 1.0)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, expo + 128, 0).astype(np.uint8)
    rgbe[~valid] = 0
    return rgbe


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    expo = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(1.0, expo - (128 + 8)).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[expo == 0] = 0.0
    return out


def save_hdr(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, dtype=np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(_float_to_rgbe(img).tobytes())


def _rle_scanlines(flat: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h, w, 4) RGBE of new-style run-length scanlines; a scanline that
    does not start with 2 2 is read flat."""
    out = np.zeros((h, w, 4), dtype=np.uint8)
    pos = 0
    for y in range(h):
        if flat[pos] == 2 and flat[pos + 1] == 2:
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(flat[pos])
                    pos += 1
                    if count > 128:  # a run of one value
                        out[y, x:x + count - 128, c] = flat[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal values
                        out[y, x:x + count, c] = flat[pos:pos + count]
                        pos += count
                        x += count
        else:
            out[y] = flat[pos:pos + w * 4].reshape(w, 4)
            pos += w * 4
    return out


def load_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        line = f.readline()
        if not line.startswith(b"#?"):
            raise ValueError(f"not a Radiance HDR file: {path}")
        while f.readline().strip() != b"":
            pass
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    flat = np.frombuffer(data, dtype=np.uint8)
    if flat.size == h * w * 4:
        return _rgbe_to_float(flat.reshape(h, w, 4))
    return _rgbe_to_float(_rle_scanlines(flat, h, w))


# ---- PNG (8-bit; gamma is the caller's) ----

def save_png(path: str, img: np.ndarray) -> None:
    u8 = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    write_png_rgb(path, u8)


def load_png(path: str) -> np.ndarray:
    return read_png_rgb(path).astype(np.float32) / 255.0


# ---- dispatch by extension ----

def save(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        save_pfm(path, img)
    elif ext == ".hdr":
        save_hdr(path, img)
    elif ext == ".png":
        save_png(path, img)
    else:
        raise ValueError(f"unsupported image extension: {ext}")


def load(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        return load_pfm(path)
    if ext == ".hdr":
        return load_hdr(path)
    if ext == ".png":
        return load_png(path)
    if ext in (".jpg", ".jpeg", ".bmp", ".tga"):
        raise ValueError(f"{path}: {ext} images are not read (PNG, PFM and "
                         "HDR only)")
    raise ValueError(f"unsupported image extension: {ext}")


# ---- metrics ----

def mse(img: np.ndarray, ref: np.ndarray,
        mask: np.ndarray | None = None) -> float:
    """Mean over pixels of ||rgb diff||^2; with mask, weighted by it."""
    diff = np.asarray(img, np.float64) - np.asarray(ref, np.float64)
    per_px = (diff * diff).sum(axis=-1)
    if mask is not None:
        per_px = per_px * mask
        return float(per_px.sum() / np.maximum(mask.sum(), 1))
    return float(per_px.mean())


def rel_mse(img: np.ndarray, ref: np.ndarray,
            mask: np.ndarray | None = None) -> float:
    """Relative MSE, denominator ||ref||^2 + 0.001."""
    ref64 = np.asarray(ref, np.float64)
    diff = np.asarray(img, np.float64) - ref64
    num = (diff * diff).sum(axis=-1)
    den = (ref64 * ref64).sum(axis=-1) + 0.001
    per_px = num / den
    if mask is not None:
        per_px = per_px * mask
        return float(per_px.sum() / np.maximum(mask.sum(), 1))
    return float(per_px.mean())


def _hsl_to_rgb_vec(h: np.ndarray, lightness: float, s: float) -> np.ndarray:
    """HSL -> RGB over an array of hues (colorsys.hls_to_rgb's values)."""
    c = (1.0 - abs(2.0 * lightness - 1.0)) * s
    hp = h * 6.0
    x = c * (1.0 - np.abs(np.mod(hp, 2.0) - 1.0))
    z = np.zeros_like(h)
    conds = [(hp < 1)[..., None], (hp < 2)[..., None], (hp < 3)[..., None],
             (hp < 4)[..., None], (hp < 5)[..., None], (hp >= 5)[..., None]]
    rgb = np.select(conds, [np.stack(np.broadcast_arrays(*v), -1) for v in
                            [(c, x, z), (x, c, z), (z, c, x),
                             (z, x, c), (x, z, c), (c, z, x)]])
    return (rgb + (lightness - c / 2.0)).astype(np.float32)


def error_heat_image(img: np.ndarray, ref: np.ndarray,
                     scale: float = 1.0) -> np.ndarray:
    """The squared error as an HSL ramp from blue (0) to red (>= 1/scale)."""
    diff = np.asarray(img, np.float64) - np.asarray(ref, np.float64)
    err = np.clip((diff * diff).sum(axis=-1) * scale, 0.0, 1.0)
    hue = (1.0 - err) * (240.0 / 360.0)
    return _hsl_to_rgb_vec(hue, 0.5, 1.0)


# ---- transforms ----

def flip_y(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[::-1])


def power(img: np.ndarray, exponent: float) -> np.ndarray:
    return np.power(np.maximum(img, 0.0), exponent).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float,
                  radius: int | None = None) -> np.ndarray:
    """Separable gaussian blur with edge clamping."""
    if radius is None:
        radius = max(1, int(3.0 * sigma))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k /= k.sum()
    tmp = np.pad(img, ((radius, radius), (0, 0), (0, 0)), mode="edge")
    vert = np.zeros_like(img, dtype=np.float64)
    for i, kv in enumerate(k):
        vert += kv * tmp[i:i + img.shape[0]]
    tmp = np.pad(vert, ((0, 0), (radius, radius), (0, 0)), mode="edge")
    out = np.zeros_like(img, dtype=np.float64)
    for i, kv in enumerate(k):
        out += kv * tmp[:, i:i + img.shape[1]]
    return out.astype(np.float32)


def resize_bilinear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    h, w, _ = img.shape
    ys = (np.arange(new_h) + 0.5) * h / new_h - 0.5
    xs = (np.arange(new_w) + 0.5) * w / new_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx)
    b = img[y0][:, x1] * (1 - fy) * fx
    c = img[y1][:, x0] * fy * (1 - fx)
    d = img[y1][:, x1] * fy * fx
    return (a + b + c + d).astype(np.float32)
