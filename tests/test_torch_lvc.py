"""The port's LVC gather (integrators/lvc.py) against the JAX package's on
the CPU.

* lvc_offsets equals the JAX function's bit for bit (the same threefry
  draws through the port's core/rng.uniform).
* lvc_gather on the procedural 200-box field (2,412 triangles plus the
  light, above 2048, so every shadow segment goes through the BVH walk,
  traverse_plain on the CPU) at 16x16 with 64 light paths, 4 records and 8
  VPL paths a pixel, for all six misModes, given the JAX package's own
  G-buffer and photon map: rtol 2e-4, atol 2e-6.  The window starts wrap
  around the path pool.
* tests/golden/lvc.npz (the Cornell lvcphotonfam block of
  tests/test_golden.py) through the port's render_config at the golden's
  rtol 2e-3 / atol 2e-4, no pixel excepted.
* An lvcphotonfam config through the CLI on the CPU writes its three
  images, the VPL image non-zero."""
import json
import os
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.core.sampling import iteration_key as jax_iteration_key
from evplp_tpu.integrators import gbuffer as jgb
from evplp_tpu.integrators import light_trace as jlt
from evplp_tpu.integrators import lvc as jlvc
from evplp_tpu.scene import procedural
from evplp_tpu_torch import __main__ as cli
from evplp_tpu_torch.core import rng
from evplp_tpu_torch.core.sampling import iteration_key
from evplp_tpu_torch.integrators import gbuffer, light_trace, lvc
from evplp_tpu_torch.runtime.render import render_config
from evplp_tpu_torch.scene.export import write_cornell_config
from evplp_tpu_torch.utils.image import load_pfm
from tests.test_torch_scene import torch_scene_of

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "lvc.npz")
RES = 16
PATHS = 64
RECORDS = 4
VPL_PATHS = 8
RTOL, ATOL = 2e-4, 2e-6
# the Cornell block of tests/test_golden.py::test_golden_lvc
GOLDEN_BLOCK = dict(rngOffset=3, numMaxIteration=2, timeLimitMs=-1.0,
                    frameMode="accumulate", useJitter=True, useStat=False,
                    statFilename="", numLightPaths=128, numVplLightPaths=8,
                    numMaxBounces=2, radiusPercentage=0.05,
                    combinedFilename="", weightedPhotonFilename="",
                    weightedVplFilename="")


@pytest.fixture(scope="module")
def setup():
    js = procedural.box_field(num_boxes=200)
    ts = torch_scene_of(js)
    assert ts.num_triangles > 2048
    jitter = np.asarray([0.013, -0.021], np.float32)
    jg = jgb.trace_gbuffer(js, RES, RES, jnp.asarray(jitter))
    jpm = jlt.trace_light_paths(js, jax_iteration_key(0, 5), PATHS, RECORDS)
    tg = gbuffer.GBuffer(**{f.name: torch.from_numpy(np.array(getattr(
        jg, f.name))) for f in fields(gbuffer.GBuffer)})
    tpm = light_trace.PhotonMap(**{f.name: torch.from_numpy(np.array(getattr(
        jpm, f.name))) for f in fields(light_trace.PhotonMap)})
    radius = js.bounding_radius * 0.05
    return dict(js=js, ts=ts, jg=jg, jpm=jpm, tg=tg, tpm=tpm,
                clamp=1.0 / js.total_area,
                pdf_mc=(VPL_PATHS / PATHS) / np.pi / radius ** 2)


@pytest.mark.parametrize("n,num_paths", [(RES * RES, PATHS),
                                         (921_600, 300_000)])
def test_lvc_offsets_bit_equal(n, num_paths):
    jkey = jax.random.fold_in(jax_iteration_key(0, 5), 3)
    tkey = rng.fold_in(iteration_key(0, 5, "cpu"), 3)
    want = np.asarray(jlvc.lvc_offsets(jkey, n, num_paths))
    got = lvc.lvc_offsets(tkey, n, num_paths).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < num_paths
    assert len(np.unique(got)) > min(n, num_paths) // 4


@pytest.mark.parametrize("mis_mode", range(6))
def test_lvc_gather_all_mis_modes(setup, mis_mode):
    s = setup
    jkey = jax.random.fold_in(jax_iteration_key(0, 5), 3)
    ref = np.asarray(jlvc.lvc_gather(
        s["js"], s["jg"], s["jpm"], jkey, mis_mode, jnp.float32(s["pdf_mc"]),
        jnp.float32(s["clamp"]), VPL_PATHS))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    tkey = rng.fold_in(iteration_key(0, 5, "cpu"), 3)
    got = lvc.lvc_gather(s["ts"], s["tg"], s["tpm"], tkey, mis_mode,
                         f32(s["pdf_mc"]), f32(s["clamp"]), VPL_PATHS)
    offsets = lvc.lvc_offsets(tkey, RES * RES, PATHS)
    assert bool((offsets + VPL_PATHS > PATHS).any())   # windows wrap
    assert np.abs(ref).max() > 0.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_lvc_golden(tmp_path):
    path = write_cornell_config(str(tmp_path), GOLDEN_BLOCK, "lvcphotonfam",
                                res=16, name="glvc")
    res = render_config(path, device="cpu")
    assert res.num_iterations == 2
    ref = np.load(GOLDEN)["img"]
    img = res.images["combined"]
    assert img.shape == ref.shape and ref.max() > 0.0
    np.testing.assert_allclose(img, ref, rtol=2e-3, atol=2e-4)


def test_lvc_cli(tmp_path, capsys):
    block = dict(GOLDEN_BLOCK, numMaxIteration=1,
                 combinedFilename="out/l.pfm",
                 weightedPhotonFilename="out/l_pm.pfm",
                 weightedVplFilename="out/l_vpl.pfm")
    path = write_cornell_config(str(tmp_path), block, "lvcphotonfam", res=8,
                                name="lvc")
    out = tmp_path / "dumps"
    assert cli.main([path, "--output-dir", str(out), "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["numIterations"] == 1
    assert stats["dropped_splat_pairs"] == 0
    for name in ("l", "l_pm", "l_vpl"):
        img = load_pfm(str(out / f"{name}.pfm"))
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert load_pfm(str(out / "l_vpl.pfm")).max() > 0.0
