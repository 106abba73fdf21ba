"""The port's path tracer against the JAX package on the CPU.

* run_pt on the Cornell block of tests/test_golden.py against
  tests/golden/pt.npz at the golden's rtol 2e-3 / atol 2e-4, no pixel
  excepted.
* run_pt with 2 samples per pixel, cleareveryframe and per-frame snapshots
  against the JAX run_pt: rtol 1e-4, atol 1e-5 (float order).
* render_pt_frame on box_field_200 (3,010 triangles, BVH path) at 32x18
  with 3 bounces, under each PACKET_IMPL, against the JAX render_pt_frame
  run op by op (jax.disable_jit): rtol 1e-4, atol 1e-5, no pixel excepted;
  and against the jitted JAX frame at the same tolerance but for the
  pixels of JIT_FLIPS, where XLA's fused rounding turns one shadow test
  (ROADMAP queue 3).
* The CLI on a small pt config with --device cpu writes the output PFM and
  the stat JSON, and with --gamma the display transform of the same
  image, linear ** (1 / 2.2) at rtol 1e-6."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.core.sampling import iteration_key as jax_iteration_key
from evplp_tpu.integrators import pt as jax_pt
from evplp_tpu.integrators.gbuffer import trace_gbuffer as jax_trace_gbuffer
from evplp_tpu.runtime.loop import run_pt as jax_run_pt
from evplp_tpu.scene import procedural
from evplp_tpu.scene.config import load_config as jax_load_config
from evplp_tpu_torch import __main__ as cli
from evplp_tpu_torch.core import rng
from evplp_tpu_torch.core.sampling import iteration_key
from evplp_tpu_torch.integrators import pt
from evplp_tpu_torch.integrators.gbuffer import trace_gbuffer
from evplp_tpu_torch.runtime.loop import run_pt
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.scene.export import write_cornell_config
from evplp_tpu_torch.trace import intersect
from evplp_tpu_torch.utils.image import load_pfm
from tests.test_torch_scene import torch_scene_of

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pt.npz")
COMMON = dict(rngOffset=3, numMaxIteration=2, timeLimitMs=-1.0,
              frameMode="accumulate", useJitter=True, useStat=False,
              statFilename="")
PT = dict(COMMON, numSamplePerPixel=1, numMaxBounces=2, outputFilename="")
W, H = 32, 18
# (row, col) of the 32x18 box_field_200 frame where the jitted JAX frame
# differs from the same frame run op by op: a vertex-1 shadow segment whose
# test XLA's fused rounding turns (0.0011 at (4, 28); 0.00013 at (15, 0))
JIT_FLIPS = {(4, 28), (15, 0)}


def test_cornell_golden(tmp_path):
    path = write_cornell_config(str(tmp_path), PT, "pt", res=16, name="gpt")
    img = run_pt(load_config(path, device="cpu")).images["output"]
    ref = np.load(GOLDEN)["img"]
    assert ref.max() > 0.0
    np.testing.assert_allclose(img, ref, rtol=2e-3, atol=2e-4)


def test_run_pt_matches_jax(tmp_path):
    block = dict(PT, numSamplePerPixel=2, frameMode="cleareveryframe",
                 numMaxIteration=2, writeEveryFrame=True,
                 outputFilename="out/p.pfm")
    path = write_cornell_config(str(tmp_path), block, "pt", res=16,
                                name="gptrun")
    ref = jax_run_pt(jax_load_config(path), output_dir=str(tmp_path / "j"))
    got = run_pt(load_config(path, device="cpu"),
                 output_dir=str(tmp_path / "t"))
    assert got.num_iterations == ref.num_iterations == 2
    for k in ("output", "pt", "light"):
        np.testing.assert_allclose(got.images[k], np.asarray(ref.images[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for f in ("p_1.pfm", "p_2.pfm", "p.pfm"):
        np.testing.assert_allclose(load_pfm(str(tmp_path / "t" / f)),
                                   load_pfm(str(tmp_path / "j" / f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)


@pytest.fixture(scope="module")
def box_field_frames():
    """The JAX frame, jitted and op by op, and the port's inputs."""
    js = procedural.box_field(num_boxes=200)
    jitter = np.asarray([0.01, -0.02], np.float32)
    gbuf = jax_trace_gbuffer(js, W, H, jnp.asarray(jitter))
    key = jax.random.fold_in(jax_iteration_key(0, 5), 0)
    jitted = np.asarray(jax_pt.render_pt_frame(js, gbuf, key, 3,
                                               tile_shape=(H, W)))
    with jax.disable_jit():
        eager = np.asarray(jax_pt.render_pt_frame(js, gbuf, key, 3,
                                                  tile_shape=(H, W)))
    ts = torch_scene_of(js)
    tg = trace_gbuffer(ts, W, H, torch.from_numpy(jitter))
    tkey = rng.fold_in(iteration_key(0, 5, "cpu"), 0)
    return jitted, eager, ts, tg, tkey


@pytest.mark.parametrize("impl", ["packet3", "packet7", "packet"])
def test_box_field_frame_matches_jax(box_field_frames, impl, monkeypatch):
    jitted, eager, ts, tg, tkey = box_field_frames
    monkeypatch.setattr(intersect, "PACKET_IMPL", impl)
    got = pt.render_pt_frame(ts, tg, tkey, 3).numpy()
    assert np.isfinite(got).all() and (got >= 0).all()
    assert (eager > 0).any(axis=1).mean() > 0.5
    np.testing.assert_allclose(got, eager, rtol=1e-4, atol=1e-5)
    outside = ~np.isclose(got, jitted, rtol=1e-4, atol=1e-5).all(axis=-1)
    flips = {tuple(int(x) for x in divmod(i, W))
             for i in np.flatnonzero(outside)}
    assert flips <= JIT_FLIPS, flips
    np.testing.assert_allclose(got[~outside], jitted[~outside], rtol=1e-4,
                               atol=1e-5)


def test_cli_writes_output_and_stats(tmp_path, capsys):
    block = dict(PT, numMaxIteration=1, useStat=True,
                 statFilename="out/p_stat.json", outputFilename="out/p.pfm")
    path = write_cornell_config(str(tmp_path), block, "pt", res=8)
    job = load_config(path, device="cpu")
    assert job.params.num_sample_per_pixel == 1
    assert job.params.output_filename == "out/p.pfm"
    out = tmp_path / "dumps"
    assert cli.main([path, "--output-dir", str(out), "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["numIterations"] == 1
    img = load_pfm(str(out / "p.pfm"))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.max() > 0.0
    assert json.loads((out / "p_stat.json").read_text())[
        "numIterations"] == 1
    shown = tmp_path / "shown"
    assert cli.main([path, "--output-dir", str(shown), "--device", "cpu",
                     "--gamma"]) == 0
    np.testing.assert_allclose(load_pfm(str(shown / "p.pfm")),
                               np.power(img, 1.0 / 2.2), rtol=1e-6)
