"""The port's textures (scene/textures.py) and PNG decoder (utils/png.py)
against the JAX package's textures and PIL, on the CPU.

* The cases of tests/test_textures.py through both packages with the same
  numpy inputs: bilinear lookups at texel centres, REPEAT wrap with u and v
  below 0 and above 1, a pool of non-square layers deduplicated by path
  and padded, and fetch_hit_shading on all three channels (map_Kd, map_Ks,
  map_Ns through its red channel) beside untextured triangles: at 1e-6.
* The PNG decoder against PIL bit for bit: both shipped PNGs, PIL-written
  L / LA / RGB / RGBA / P files, and files written here whose rows use each
  of the five filters in every supported colour type.  16-bit and
  interlaced files raise ValueError naming the file.
* The textured end-to-end scene of tests/test_textures.py (a checkerboard
  floor): the two packages' G-buffers at 1e-6.
* configs/livingroom/livingroom_ours.json and livingroom_pt.json cut to
  32x18 (ours: 300 light paths, 8 VPL paths; one frame and the warm-up):
  the port against the JAX run op by op (jax.disable_jit) at rtol 2e-4,
  atol 2e-6 with no pixel excepted, and against the jitted JAX run at the
  goldens' rtol 2e-3 / atol 2e-4 but for the pixels of JIT_FLIPS, named by
  position: one PT pixel where XLA's fused rounding turns a path
  (ROADMAP queue 3, fault 7)."""
import json
import os
import struct
import zlib
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from evplp_tpu.integrators.gbuffer import trace_gbuffer as jax_trace_gbuffer
from evplp_tpu.runtime.render import render_job as jax_render_job
from evplp_tpu.scene import textures as jtex
from evplp_tpu.scene.camera import Camera as JaxCamera
from evplp_tpu.scene.config import load_config as jax_load_config
from evplp_tpu.scene.scene import build_scene as jax_build_scene
from evplp_tpu_torch.integrators.gbuffer import GBuffer, trace_gbuffer
from evplp_tpu_torch.runtime.render import render_job
from evplp_tpu_torch.scene import textures
from evplp_tpu_torch.scene.camera import Camera
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.scene.scene import build_scene
from evplp_tpu_torch.utils.png import read_png_rgb

LIVINGROOM = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "livingroom")
SHIPPED_PNGS = ("livingroom_parquet.png", "livingroom_wood.png")
# pixels (row, col) of the cut livingroom frames outside the goldens'
# tolerance against the jitted JAX run, where the port equals the same run
# op by op: PT (2, 13), red 0.34574640 against the jitted 0.34801543
JIT_FLIPS = {"ours": set(), "pt": {(2, 13)}}
CHECKER = np.zeros((8, 8, 3), np.uint8)
CHECKER[::2, ::2] = 255
CHECKER[1::2, 1::2] = 255


def _pool(images):
    """The same layers in both packages' pool builders."""
    out = []
    for builder in (textures.TexturePoolBuilder(), jtex.TexturePoolBuilder()):
        for img in images:
            builder.add_image(img)
        out.append(builder.build())
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    return out[0]


def _sample_both(data, size, layer, uv):
    got = textures.sample_bilinear(torch.from_numpy(data),
                                   torch.from_numpy(size),
                                   torch.from_numpy(layer),
                                   torch.from_numpy(uv)).numpy()
    want = np.asarray(jtex.sample_bilinear(jnp.asarray(data),
                                           jnp.asarray(size),
                                           jnp.asarray(layer),
                                           jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    return got


def test_bilinear_texel_centers():
    img = np.asarray([[[1, 0, 0], [0, 1, 0]],
                      [[0, 0, 1], [1, 1, 0]]], np.float32)
    data, size = _pool([img])
    uv = np.asarray([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75],
                     [0.5, 0.5]], np.float32)
    out = _sample_both(data, size, np.zeros(5, np.int32), uv)
    np.testing.assert_allclose(out[:4], [[1, 0, 0], [0, 1, 0], [0, 0, 1],
                                         [1, 1, 0]], atol=1e-6)
    np.testing.assert_allclose(out[4], [0.5, 0.5, 0.25], atol=1e-6)


def test_repeat_wrap():
    rs = np.random.default_rng(3)
    imgs = [rs.uniform(size=(5, 3, 3)).astype(np.float32),
            rs.uniform(size=(2, 7, 3)).astype(np.float32)]
    data, size = _pool(imgs)
    uv = rs.uniform(-2.5, 3.5, (400, 2)).astype(np.float32)
    uv[:4] = [[0.25, 0.25], [2.25, -0.75], [-1.75, 1.25], [-0.01, 1.01]]
    layer = rs.integers(0, 2, 400).astype(np.int32)
    layer[:4] = 0
    out = _sample_both(data, size, layer, uv)
    np.testing.assert_allclose(out[0], out[1], atol=1e-6)
    np.testing.assert_allclose(out[0], out[2], atol=1e-6)
    assert ((uv < 0) & (layer[:, None] == 1)).any()
    assert ((uv > 1) & (layer[:, None] == 1)).any()


def test_pool_dedup_and_padding(tmp_path):
    p1, p2 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    Image.fromarray(np.full((4, 4, 3), 128, np.uint8)).save(p1)
    Image.fromarray(np.arange(48, dtype=np.uint8).reshape(8, 2, 3)).save(p2)
    built = []
    for builder in (textures.TexturePoolBuilder(), jtex.TexturePoolBuilder()):
        assert builder.add_file(p1) == 0
        assert builder.add_file(p2) == 1
        assert builder.add_file(p1) == 0
        built.append(builder.build())
    data, size = built[0]
    assert data.shape == (2, 8, 4, 3)
    np.testing.assert_array_equal(size, [[4, 4], [8, 2]])
    assert not data[0, 4:].any() and not data[1, :, 2:].any()
    np.testing.assert_array_equal(data, built[1][0])
    np.testing.assert_array_equal(size, built[1][1])


def _floor_scenes(layers, pool, kd=(0.5, 0.5, 0.5), ks=(0.0, 0.0, 0.0),
                  ns=0.0):
    """A textured floor quad beside an untextured box top, and a small
    light, in both packages: (port scene, JAX scene)."""
    fpos = np.asarray([[-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1]],
                      np.float32)
    fuv = np.asarray([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    bpos = fpos * 0.25 + np.float32([0.5, 0.2, 0.5])
    fidx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    lpos = np.asarray([[-0.2, 2, -0.2], [0.2, 2, -0.2],
                       [0.2, 2, 0.2], [-0.2, 2, 0.2]], np.float32)
    common = dict(
        positions_list=[fpos, bpos], indices_list=[fidx, fidx],
        kd_list=[np.asarray(kd, np.float32), np.full(3, 0.3, np.float32)],
        ks_list=[np.asarray(ks, np.float32), np.zeros(3, np.float32)],
        ns_list=[ns, 2.0], light_positions=lpos, light_indices=fidx,
        light_intensity=np.asarray([5, 5, 5, 0], np.float32),
        uv_list=[fuv, fuv], kd_layer_list=[layers[0], -1],
        ks_layer_list=[layers[1], -1], ns_layer_list=[layers[2], -1],
        tex_data=pool[0], tex_size=pool[1])
    cam = dict(origin=(0, 3, 0.001), look_at=(0, 0, 0), up=(0, 1, 0),
               fovy=float(np.radians(40.0)), aspect=1.0)
    return (build_scene(camera=Camera(**cam), device="cpu", **common),
            jax_build_scene(camera=JaxCamera(**cam), **common))


def test_fetch_hit_shading_all_channels():
    rs = np.random.default_rng(5)
    pool = _pool([rs.uniform(size=(4, 6, 3)).astype(np.float32),
                  rs.uniform(size=(3, 3, 3)).astype(np.float32),
                  rs.uniform(1, 40, (5, 2, 3)).astype(np.float32)])
    ts, js = _floor_scenes((0, 1, 2), pool, kd=(1, 1, 1), ks=(1, 1, 1),
                           ns=99.0)
    n = 300
    prim = rs.integers(0, ts.num_triangles, n)
    u = rs.uniform(0, 1, n).astype(np.float32)
    v = (rs.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    got = textures.fetch_hit_shading(ts, torch.from_numpy(prim),
                                     torch.from_numpy(u), torch.from_numpy(v))
    want = jtex.fetch_hit_shading(js, jnp.asarray(prim, jnp.int32),
                                  jnp.asarray(u), jnp.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    layer = ts.tri_shade[torch.from_numpy(prim), 11].numpy()
    assert (layer >= 0).any() and (layer < 0).any()
    kd = textures.fetch_kd(ts, torch.from_numpy(prim), torch.from_numpy(u),
                           torch.from_numpy(v))
    np.testing.assert_array_equal(kd.numpy(), got[0].numpy())
    np.testing.assert_allclose(kd.numpy(), np.asarray(jtex.fetch_kd(
        js, jnp.asarray(prim, jnp.int32), jnp.asarray(u), jnp.asarray(v))),
        atol=1e-6, rtol=0)


def test_textured_scene_end_to_end(tmp_path):
    """The checkerboard floor of tests/test_textures.py: kd varies per
    pixel, and the port's G-buffer equals the JAX package's."""
    path = str(tmp_path / "checker.png")
    Image.fromarray(CHECKER).save(path)
    pools = []
    for builder in (textures.TexturePoolBuilder(), jtex.TexturePoolBuilder()):
        assert builder.add_file(path) == 0
        pools.append(builder.build())
    np.testing.assert_array_equal(pools[0][0], pools[1][0])
    ts, js = _floor_scenes((0, -1, -1), pools[0])
    tg = trace_gbuffer(ts, 32, 32)
    jg = jax_trace_gbuffer(js, 32, 32)
    for f in fields(GBuffer):
        np.testing.assert_allclose(getattr(tg, f.name).numpy(),
                                   np.asarray(getattr(jg, f.name)),
                                   atol=1e-6, rtol=1e-6, err_msg=f.name)
    kd = tg.kd.numpy().reshape(32, 32, 3)
    floor = ((tg.stencil > 0) & ~tg.hit_light).numpy().reshape(32, 32)
    vals = kd[floor][:, 0]
    assert (vals > 0.85).any() and (vals < 0.15).any()


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, px, colour, depth=8, interlace=0, palette=None):
    """An 8-bit PNG of px (H, W, channels) uint8 whose row y uses filter
    y % 5 (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(np.int64)
    raw = b""
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, ul)][y % 5]
        raw += bytes([y % 5]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                          0, interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _assert_decodes_as_pil(path):
    got = read_png_rgb(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SHIPPED_PNGS)
def test_png_shipped_equals_pil(name):
    path = os.path.join(LIVINGROOM, name)
    _assert_decodes_as_pil(path)
    assert read_png_rgb(path).shape == (256, 256, 3)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_pil_written_equals_pil(tmp_path, mode):
    rs = np.random.default_rng(9)
    smooth = (np.cumsum(rs.integers(-3, 4, (37, 53, 4)), axis=1)
              % 256).astype(np.uint8)
    rgba = Image.fromarray(smooth, "RGBA")
    img = (rgba.convert("RGB").convert("P", palette=Image.ADAPTIVE)
           if mode == "P" else rgba.convert(mode))
    path = str(tmp_path / f"t_{mode}.png")
    img.save(path)
    _assert_decodes_as_pil(path)


@pytest.mark.parametrize("colour", [0, 2, 3, 4, 6])
def test_png_every_filter_equals_pil(tmp_path, colour):
    rs = np.random.default_rng(colour)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    px = rs.integers(0, 256, (15, 11, ch)).astype(np.uint8)
    palette = None
    if colour == 3:
        px %= 40
        palette = rs.integers(0, 256, (40, 3))
    path = str(tmp_path / f"f{colour}.png")
    _write_png(path, px, colour, palette=palette)
    _assert_decodes_as_pil(path)


@pytest.mark.parametrize("depth,interlace,match", [
    (16, 0, "16-bit"), (8, 1, "interlaced")])
def test_png_unsupported_raises(tmp_path, depth, interlace, match):
    path = str(tmp_path / "bad.png")
    _write_png(path, np.zeros((2, 2, 3), np.uint8), 2, depth=depth,
               interlace=interlace)
    with pytest.raises(ValueError, match=match) as err:
        read_png_rgb(path)
    assert "bad.png" in str(err.value)


def _cut(config, directory, block):
    """A copy of a livingroom config at 32x18 with absolute paths and its
    technique block updated."""
    with open(os.path.join(LIVINGROOM, config)) as f:
        cfg = json.load(f)
    cfg["scene"] = [os.path.join(LIVINGROOM, s) for s in cfg["scene"]]
    cfg["arealight"]["obj"] = os.path.join(LIVINGROOM,
                                           cfg["arealight"]["obj"])
    cfg["resX"], cfg["resY"] = 32, 18
    tech = "pt" if "pt" in cfg else "photonfam"
    cfg[tech].update(block)
    path = os.path.join(directory, config)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


CUTS = {
    "ours": ("livingroom_ours.json", dict(
        numLightPaths=300, numVplLightPaths=8, combinedFilename="",
        weightedPhotonFilename="", weightedVplFilename="")),
    "pt": ("livingroom_pt.json", dict(outputFilename="")),
}


@pytest.mark.parametrize("name", sorted(CUTS))
def test_livingroom_matches_jax(tmp_path, name):
    config, block = CUTS[name]
    path = _cut(config, str(tmp_path), dict(block, numMaxIteration=1,
                                            timeLimitMs=-1.0, useStat=False))
    job = load_config(path, device="cpu")
    assert job.scene.num_triangles <= 2048          # the dense path
    assert int((job.scene.tri_shade[:, 11] >= 0).sum()) > 0
    got = render_job(job).images
    jitted = jax_render_job(jax_load_config(path)).images
    with jax.disable_jit():
        eager = jax_render_job(jax_load_config(path)).images
    main = "output" if name == "pt" else "combined"
    assert got[main].shape == (18, 32, 3) and got[main].max() > 0.0
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(eager[k]), rtol=2e-4,
                                   atol=2e-6, err_msg=k)
        want = np.asarray(jitted[k])
        outside = ~np.isclose(got[k], want, rtol=2e-3, atol=2e-4).all(-1)
        flips = {tuple(int(x) for x in p) for p in np.argwhere(outside)}
        assert flips <= JIT_FLIPS[name], (k, flips)
        np.testing.assert_allclose(got[k][~outside], want[~outside],
                                   rtol=2e-3, atol=2e-4, err_msg=k)
