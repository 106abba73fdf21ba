"""PNG reading and writing with the standard library (zlib), for the
texture pool, the exported scenes and the image IO.

Writes 8-bit RGB with filter 0 on every row.  Reads 8-bit, non-interlaced PNGs of colour types 0 (grey), 2 (RGB),
3 (palette), 4 (grey + alpha) and 6 (RGBA), undoes the five row filters
(None, Sub, Up, Average, Paeth) and returns RGB uint8 with any alpha
dropped, as `PIL.Image.open(path).convert("RGB")` gives it.  Any other bit
depth, and interlaced files, raise ValueError naming the file.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each supported colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk after the signature."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, payload
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter(raw: bytes, height: int, stride: int, bpp: int,
             path: str) -> np.ndarray:
    """The (height, stride) uint8 scanlines of the decompressed stream raw,
    each a filter byte then stride filtered bytes; bpp is the bytes of one
    pixel (the distance the Sub, Average and Paeth filters look back)."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            # recon[x] = filt[x] + recon[x - bpp]: a running sum per channel
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            cur = (np.cumsum(lanes.reshape(-1, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)[:stride]
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the PNG at path, row 0 at the top."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNGs are not supported "
                         "(8-bit only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if colour not in CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {colour}")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette image without PLTE")
    ch = CHANNELS[colour]
    px = unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch,
                  path).reshape(height, width, ch)
    if colour == 3:
        return palette[px[..., 0]]
    if colour in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png_rgb(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG, row 0 at the
    top, every row with filter 0 (None)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"{path}: PNG writing needs (H, W, 3) uint8, got "
                         f"{rgb.dtype} {rgb.shape}")
    height, width = rgb.shape[:2]
    rows = np.zeros((height, 1 + 3 * width), np.uint8)
    rows[:, 1:] = rgb.reshape(height, 3 * width)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
