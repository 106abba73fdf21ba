"""Pixel-row sharding (parallel/shard.py) on the CPU, over a mesh that
names the CPU 8 times (the port's counterpart of the 8 virtual devices
tests/conftest.py gives the JAX tests).

* The sharded frame equals the port's single-device photon_fam_frame at
  rtol 2e-4 / atol 1e-6 (the emitter image at rtol 1e-6), for the five
  variants of tests/test_shard.py: vpl, vpl_clamp, vsl, lvc and pm, at
  16x16 Cornell; dropped is 0.  The vpl_clamp frame is also held to the
  JAX package's single-device photon_fam_frame at the same bar.
* Two accumulated frames, and sharded_pt_frame against render_pt_frame.
* The hooks' defaults leave each function as it was: the G-buffer's row
  bands, the light paths' blocks, the splat with row_offset 0 over the
  full height and lvc_gather with its own offsets passed in are bit-equal
  to the default calls.
* The run-loop cases of tests/test_multichip_runtime.py (3 frames; VSL)
  through run_photon_fam(mesh=...), equal to the unsharded run;
  run_pt(mesh=...); `--mesh 2 --device cpu` through the CLI.
* A height or a path count that does not divide by the mesh raises, as
  does a mesh of CUDA devices without a card."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.core.sampling import iteration_key as jax_iteration_key
from evplp_tpu.integrators import photon_fam as jpf
from evplp_tpu.scene import procedural as jp
from evplp_tpu_torch import __main__ as cli
from evplp_tpu_torch.core import rng
from evplp_tpu_torch.core.sampling import iteration_key
from evplp_tpu_torch.integrators import (gbuffer, light_trace, lvc,
                                         photon_splat)
from evplp_tpu_torch.integrators.photon_fam import (
    PhotonFamConfig, init_state, photon_fam_frame)
from evplp_tpu_torch.integrators.pt import render_pt_frame
from evplp_tpu_torch.parallel import shard
from evplp_tpu_torch.parallel.shard import (
    Mesh, make_mesh, shard_state, sharded_photon_fam_frame,
    sharded_pt_frame, unshard_state)
from evplp_tpu_torch.runtime.loop import run_photon_fam, run_pt
from evplp_tpu_torch.scene import procedural
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.scene.export import write_cornell_config

RES = 16
N_DEV = 8
MESH = Mesh(["cpu"] * N_DEV)
SCALARS = (0.08, 0.5, 2.0, 0.15)   # radius, clamp, pdf_mc, VSL radius


@pytest.fixture(scope="module")
def scene():
    return procedural.cornell_box(device="cpu")


def _cfg(**kw):
    base = dict(width=RES, height=RES, num_light_paths=64,
                # not divisible by the mesh: every shard traces the
                # gather's working set itself
                num_vpl_light_paths=6, num_records=3, mis_mode=4,
                accumulate=True, use_jitter=True)
    base.update(kw)
    return PhotonFamConfig(**base)


VARIANTS = {
    "vpl": dict(mis_mode=1),
    "vpl_clamp": dict(mis_mode=4),
    "vsl": dict(force_vsl=True),
    "lvc": dict(lvc=True),
    "pm": dict(num_vpl_light_paths=0),
}


def _close(out, ref):
    for f in ("vpl_acc", "photon_acc"):
        np.testing.assert_allclose(np.asarray(getattr(out, f)),
                                   np.asarray(getattr(ref, f)), rtol=2e-4,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(np.asarray(out.light_img),
                               np.asarray(ref.light_img), rtol=1e-6)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sharded_matches_single_device(scene, variant):
    cfg = _cfg(**VARIANTS[variant])
    key = iteration_key(0, 0, "cpu")
    ref = photon_fam_frame(scene, cfg, init_state(cfg, "cpu"), key,
                           *SCALARS)
    out = sharded_photon_fam_frame(scene, cfg, MESH,
                                   shard_state(init_state(cfg, "cpu"), MESH),
                                   key, *SCALARS)
    assert len(out.vpl_acc) == N_DEV
    assert out.vpl_acc[0].shape == (RES * RES // N_DEV, 3)
    out = unshard_state(out)
    assert int(ref.dropped) == 0 and int(out.dropped) == 0
    _close(out, ref)
    assert float(ref.photon_acc.max()) > 0.0
    if variant != "pm":
        assert float(ref.vpl_acc.max()) > 0.0
    if variant == "vpl_clamp":
        jcfg = jpf.PhotonFamConfig(**dict(
            vars(cfg), splat_tile=4, splat_cap=512, splat_span=8))
        want = jpf.photon_fam_frame(
            jp.cornell_box(), jcfg, jpf.init_state(jcfg),
            jax_iteration_key(0, 0), *(jnp.float32(x) for x in SCALARS))
        _close(out, want)


def test_sharded_accumulation_two_frames(scene):
    cfg = _cfg(num_light_paths=32, num_vpl_light_paths=8, mis_mode=1)
    state = shard_state(init_state(cfg, "cpu"), MESH)
    single = init_state(cfg, "cpu")
    for i in range(2):
        key = iteration_key(0, i, "cpu")
        state = sharded_photon_fam_frame(scene, cfg, MESH, state, key,
                                         0.08, 0.5, 2.0)
        single = photon_fam_frame(scene, cfg, single, key, 0.08, 0.5, 2.0)
    state = unshard_state(state)
    _close(state, single)
    img = state.vpl_acc.numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.max() > 0


def test_sharded_pt_matches_single_device(scene):
    key = iteration_key(0, 3, "cpu")
    img, light = sharded_pt_frame(scene, MESH, RES, RES, key, num_bounces=2,
                                  use_jitter=False)
    gbuf = gbuffer.trace_gbuffer(scene, RES, RES)
    ref = render_pt_frame(scene, gbuf, key, 2)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=2e-4,
                               atol=1e-6)
    assert torch.equal(light, gbuffer.light_image(scene, gbuf))
    assert img.max() > 0


def test_hook_defaults_are_unchanged(scene):
    key = iteration_key(0, 5, "cpu")
    jitter = torch.tensor([0.01, -0.02])
    whole = gbuffer.trace_gbuffer(scene, RES, 12, jitter)
    bands = [gbuffer.trace_gbuffer(scene, RES, 12, jitter, row_start=r,
                                   row_count=4) for r in (0, 4, 8)]
    for f in ("position", "normal", "kd", "ks", "ns", "stencil",
              "hit_light"):
        assert torch.equal(getattr(whole, f), torch.cat(
            [getattr(b, f) for b in bands])), f
        assert torch.equal(getattr(whole, f), getattr(
            gbuffer.trace_gbuffer(scene, RES, 12, jitter, row_start=0,
                                  row_count=12), f)), f

    k1 = rng.fold_in(key, 1)
    pm = light_trace.trace_light_paths(scene, k1, 48, 3)
    blocks = [light_trace.trace_light_paths(scene, k1, 16, 3,
                                            path_offset=o)
              for o in (0, 16, 32)]
    for f in ("pos", "flux", "flags", "p_select"):
        assert torch.equal(getattr(pm, f), torch.cat(
            [getattr(b, f) for b in blocks])), f

    args = (scene, whole, pm, torch.tensor(0.1), 4, torch.tensor(2.0),
            torch.tensor(0.5), 1.0 / 48, RES, 12, jitter)
    img, drop = photon_splat.photon_splat_binned(*args)
    img0, drop0 = photon_splat.photon_splat_binned(*args, row_offset=0.0,
                                                   full_height=12)
    assert torch.equal(img, img0) and int(drop) == int(drop0) == 0
    assert float(img.max()) > 0.0

    k3 = rng.fold_in(key, 3)
    lv = lvc.lvc_gather(scene, whole, pm, k3, 1, torch.tensor(2.0),
                        torch.tensor(0.5), 4)
    lv0 = lvc.lvc_gather(scene, whole, pm, k3, 1, torch.tensor(2.0),
                         torch.tensor(0.5), 4,
                         offsets=lvc.lvc_offsets(k3, RES * 12, 48))
    assert torch.equal(lv, lv0) and float(lv.max()) > 0.0


BLOCK = dict(rngOffset=0, timeLimitMs=-1.0, frameMode="accumulate",
             useStat=False, statFilename="", radiusPercentage=0.05,
             combinedFilename="", weightedPhotonFilename="",
             weightedVplFilename="")
LOOP_RUNS = {
    "three_frames": dict(BLOCK, numMaxIteration=3, useJitter=True,
                         numLightPaths=64, numVplLightPaths=8,
                         numMaxBounces=2, DoProgressive=True),
    "vsl": dict(BLOCK, numMaxIteration=1, useJitter=False, numLightPaths=16,
                numVplLightPaths=8, numMaxBounces=1, forceVsl=True,
                vslRadiusPercentage=0.05, run={"photonSplat": False}),
}


@pytest.mark.parametrize("name", sorted(LOOP_RUNS))
def test_run_loop_sharded(tmp_path, name):
    path = write_cornell_config(str(tmp_path), LOOP_RUNS[name], "photonfam",
                                res=16, name="mc")
    res = run_photon_fam(load_config(path, device="cpu"),
                         mesh=make_mesh(N_DEV, "cpu"))
    ref = run_photon_fam(load_config(path, device="cpu"))
    assert res.num_iterations == ref.num_iterations == \
        LOOP_RUNS[name]["numMaxIteration"]
    assert res.stats["dropped_splat_pairs"] == 0
    img = res.images["combined"]
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all() and (img >= 0).all() and img.max() > 0
    for k in ("combined", "weighted_vpl", "weighted_photon"):
        np.testing.assert_allclose(res.images[k], ref.images[k], rtol=2e-4,
                                   atol=1e-6, err_msg=k)


def test_run_pt_sharded(tmp_path):
    path = write_cornell_config(str(tmp_path), dict(
        rngOffset=2, numMaxIteration=2, timeLimitMs=-1.0, useStat=False,
        useJitter=True, numSamplePerPixel=2, numMaxBounces=2,
        outputFilename=""), "pt", res=16, name="pt")
    res = run_pt(load_config(path, device="cpu"), mesh=make_mesh(4, "cpu"))
    ref = run_pt(load_config(path, device="cpu"))
    assert res.num_iterations == ref.num_iterations == 2
    for k in ("output", "pt", "light"):
        np.testing.assert_allclose(res.images[k], ref.images[k], rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    assert res.images["output"].max() > 0


def test_cli_mesh(tmp_path, capsys):
    block = dict(LOOP_RUNS["three_frames"], numMaxIteration=1,
                 combinedFilename="out/c.pfm")
    path = write_cornell_config(str(tmp_path), block, "photonfam", res=8,
                                name="cli")
    assert cli.main([path, "--device", "cpu", "--mesh", "2",
                     "--output-dir", str(tmp_path / "o")]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["numIterations"] == 1
    assert summary["dropped_splat_pairs"] == 0
    assert (tmp_path / "o" / "c.pfm").exists()


def test_indivisible_shapes_raise(scene):
    mesh = Mesh(["cpu"] * 3)
    cfg = _cfg()
    with pytest.raises(AssertionError, match="height 16 must divide"):
        sharded_photon_fam_frame(scene, cfg, mesh,
                                 shard_state(init_state(cfg, "cpu"), mesh),
                                 iteration_key(0, 0, "cpu"), *SCALARS)
    with pytest.raises(AssertionError, match="height 16 must divide"):
        sharded_pt_frame(scene, mesh, RES, RES, iteration_key(0, 0, "cpu"),
                         2)
    cfg = _cfg(num_light_paths=60)
    with pytest.raises(AssertionError, match="numLightPaths 60 must divide"):
        sharded_photon_fam_frame(scene, cfg, MESH,
                                 shard_state(init_state(cfg, "cpu"), MESH),
                                 iteration_key(0, 0, "cpu"), *SCALARS)


def test_cuda_mesh_without_card_raises(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="0 are visible"):
        make_mesh(2, "cuda")
    with pytest.raises(RuntimeError, match="0 are visible"):
        make_mesh(None, "cuda")
    mesh = Mesh(["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="CUDA devices are available"):
        sharded_pt_frame(scene, mesh, RES, RES, iteration_key(0, 0, "cpu"),
                         2)
    assert make_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    assert shard.make_mesh(device="cpu").size == 1
