"""The port's image IO and metrics (utils/image.py) against the JAX
package's, on the CPU.

* The round trips of tests/test_image.py: PFM bit for bit; HDR within
  RGBE's quantization (2^-8 of the largest channel's power of two); PNG
  within one 8-bit step.  The port's HDR and PFM files equal the JAX package's byte for byte and each package reads the
  other's; an RLE-compressed HDR (both run and literal packets, and a
  flat scanline among them) reads to the JAX decoder's values.
* PNGs are written without PIL: PIL reads the port's file to
  clip(x * 255 + 0.5) exactly, as the JAX package writes it; the port's
  load of a JAX-written PNG equals the JAX load.  .jpg, .bmp and .tga
  raise ValueError naming the file (the JAX package reads them only
  through PIL).
* mse, rel_mse (with and without mask), error_heat_image, flip_y, power,
  gaussian_blur and resize_bilinear equal the JAX functions at rtol 1e-6."""
import os

import numpy as np
import pytest
from PIL import Image

from evplp_tpu.utils import image as jim
from evplp_tpu_torch.utils import image as im


def _rand_img(h=17, w=23, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, 3)) * 4.0).astype(np.float32)


def test_pfm_roundtrip_and_bytes(tmp_path):
    img = _rand_img()
    a, b = str(tmp_path / "a" / "x.pfm"), str(tmp_path / "b.pfm")
    im.save(a, img)          # save makes the parent directory
    jim.save(b, img)
    np.testing.assert_array_equal(im.load(a), img)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(im.load(b), jim.load(a))


def test_hdr_roundtrip_and_cross_read(tmp_path):
    img = _rand_img()
    img[0, 0] = 0.0          # a black pixel: exponent 0
    a, b = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    im.save(a, img)
    jim.save(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    out = im.load(a)
    np.testing.assert_allclose(out, img, atol=0.02, rtol=0.02)
    # RGBE keeps 8 bits of mantissa: each channel within 2^-8 of the
    # largest channel's power of two, 2^e
    _, e = np.frexp(img.max(axis=-1, keepdims=True))
    assert (np.abs(out - img) < np.ldexp(1.0, e - 8)).all()
    np.testing.assert_array_equal(out, jim.load(a))
    np.testing.assert_array_equal(im.load(b), jim.load(b))
    np.testing.assert_array_equal(im._float_to_rgbe(img),
                                  jim._float_to_rgbe(img))


def _rle_hdr(path, rgbe):
    """Write (h, w, 4) RGBE with new-style RLE scanlines; row 1 flat."""
    h, w, _ = rgbe.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            if y == 1:
                f.write(rgbe[y].tobytes())
                continue
            f.write(bytes([2, 2, w >> 8, w & 255]))
            for c in range(4):
                line = rgbe[y, :, c]
                x = 0
                while x < w:
                    run = 1
                    while x + run < w and run < 127 and \
                            line[x + run] == line[x]:
                        run += 1
                    if run >= 3:
                        f.write(bytes([128 + run, int(line[x])]))
                        x += run
                    else:
                        n = min(w - x, 3)
                        f.write(bytes([n]) + line[x:x + n].tobytes())
                        x += n


def test_hdr_rle_scanlines(tmp_path):
    img = _rand_img(5, 40, seed=2)
    img[:, 10:30] = 1.5      # long runs
    rgbe = jim._float_to_rgbe(img)
    path = str(tmp_path / "rle.hdr")
    _rle_hdr(path, rgbe)
    assert os.path.getsize(path) < rgbe.size + 100
    got = im.load(path)
    np.testing.assert_array_equal(got, jim.load(path))
    np.testing.assert_array_equal(got, im._rgbe_to_float(rgbe))


def test_png_written_without_pil(tmp_path):
    img = np.clip(_rand_img() / 4.0, 0, 1)
    img[0, :3] = [[-0.5, 0.0, 2.0], [1.0, 0.998, 0.002], [0.5, 0.25, 1.0]]
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    im.save(a, img)
    jim.save(b, img)
    want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(a).convert("RGB")),
                                  want)
    np.testing.assert_array_equal(im.load(a), want / np.float32(255.0))
    np.testing.assert_array_equal(im.load(a), jim.load(a))
    np.testing.assert_array_equal(im.load(b), jim.load(b))
    np.testing.assert_allclose(im.load(a), np.clip(img, 0, 1),
                               atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".bmp", ".tga"])
def test_pil_only_formats_raise(tmp_path, ext):
    path = str(tmp_path / f"x{ext}")
    Image.new("RGB", (4, 4)).save(path, format={
        ".jpg": "JPEG", ".jpeg": "JPEG", ".bmp": "BMP", ".tga": "TGA"}[ext])
    with pytest.raises(ValueError, match="x" + ext.replace(".", r"\.")):
        im.load(path)
    with pytest.raises(ValueError, match="unsupported image extension"):
        im.save(path, np.zeros((2, 2, 3), np.float32))


def test_mse_relmse():
    a = np.zeros((4, 4, 3), np.float32)
    b = np.ones((4, 4, 3), np.float32) * 2.0
    assert im.mse(a, b) == 12.0
    np.testing.assert_allclose(im.rel_mse(a, b), 12.0 / (12.0 + 0.001),
                               rtol=1e-6)
    mask = np.zeros((4, 4))
    mask[0, 0] = 1
    assert im.mse(a, b, mask) == 12.0
    x, y = _rand_img(seed=3), _rand_img(seed=4)
    m = np.random.default_rng(5).random((17, 23)) > 0.4
    for fn in ("mse", "rel_mse"):
        for mk in (None, m):
            np.testing.assert_allclose(getattr(im, fn)(x, y, mk),
                                       getattr(jim, fn)(x, y, mk), rtol=1e-6)


def test_error_heat_image():
    x, y = _rand_img(seed=3) / 4.0, _rand_img(seed=4) / 4.0
    for scale in (1.0, 0.3, 8.0):
        got = im.error_heat_image(x, y, scale)
        assert got.dtype == np.float32 and got.shape == x.shape
        np.testing.assert_allclose(got, jim.error_heat_image(x, y, scale),
                                   rtol=1e-6, atol=1e-6)
    hues = np.linspace(0.0, 0.999, 50)
    np.testing.assert_allclose(im._hsl_to_rgb_vec(hues, 0.5, 1.0),
                               jim._hsl_to_rgb_vec(hues, 0.5, 1.0),
                               rtol=1e-6, atol=1e-6)


def test_transforms():
    img = _rand_img(16, 16)
    np.testing.assert_array_equal(im.flip_y(im.flip_y(img)), img)
    np.testing.assert_array_equal(im.flip_y(img), jim.flip_y(img))
    signed = img - 1.0
    for e in (2.0, 1.0 / 2.2):
        np.testing.assert_allclose(im.power(signed, e), jim.power(signed, e),
                                   rtol=1e-6)
    np.testing.assert_allclose(im.power(img, 2.0), img * img, rtol=1e-6)
    for sigma, radius in ((1.0, None), (0.7, 3), (2.5, None)):
        got = im.gaussian_blur(img, sigma, radius)
        assert got.shape == img.shape
        np.testing.assert_allclose(got, jim.gaussian_blur(img, sigma, radius),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(im.gaussian_blur(img, 1.0).mean(), img.mean(),
                               rtol=0.05)
    for h, w in ((8, 8), (5, 11), (32, 20)):
        got = im.resize_bilinear(img, h, w)
        assert got.shape == (h, w, 3)
        np.testing.assert_allclose(got, jim.resize_bilinear(img, h, w),
                                   rtol=1e-6, atol=1e-6)
