"""Checkpoint / resume (runtime/checkpoint.py) and the output flags of the
port's CLI, on the CPU, on a progressive clamped Cornell run at 16x16
(the block of the ours_prog golden, 128 light paths, 8 VPL paths).

* Two frames, a checkpoint, a resume and two more frames give images bit
  for bit equal to four frames run without a break.
* A checkpoint written by the JAX package's save_checkpoint (the same .npz
  format) resumes in the port, and the port's next frame agrees with the
  JAX package's resume from the same file at rtol 2e-4, atol 2e-6.
* `python -m evplp_tpu_torch --device cpu` with --checkpoint (every frame)
  and then --resume --gamma: the resumed run's outputs equal the
  uninterrupted run's linear ** (1 / 2.2) at rtol 1e-6, and the checkpoint
  holds the iteration count."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from evplp_tpu.runtime.loop import run_photon_fam as jax_run_photon_fam
from evplp_tpu.scene.config import load_config as jax_load_config
from evplp_tpu_torch.runtime.checkpoint import FORMAT_VERSION, load_checkpoint
from evplp_tpu_torch.runtime.loop import run_photon_fam
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.scene.export import write_cornell_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = dict(rngOffset=3, timeLimitMs=-1.0, frameMode="accumulate",
             useJitter=True, useStat=False, statFilename="",
             numLightPaths=128, numVplLightPaths=8, numMaxBounces=2,
             radiusPercentage=0.05, misMode="geometryClamp",
             DoProgressive=True, AlphaProgressive=0.7, combinedFilename="",
             weightedPhotonFilename="", weightedVplFilename="")
OUTPUTS = ("combined", "weighted_vpl", "weighted_photon")


def _config(tmp_path, frames, name, **extra):
    return write_cornell_config(str(tmp_path), dict(
        BLOCK, numMaxIteration=frames, **extra), "photonfam", res=16,
        name=name)


def test_resume_is_bit_equal(tmp_path):
    whole = run_photon_fam(load_config(_config(tmp_path, 4, "whole"),
                                       device="cpu"))
    ck = str(tmp_path / "ck.npz")
    first = run_photon_fam(load_config(_config(tmp_path, 2, "first"),
                                       device="cpu"),
                           checkpoint_path=ck, checkpoint_every=50)
    assert first.num_iterations == 2
    state, iters, sched = load_checkpoint(ck, "cpu")
    assert iters == 2 and sched["radius"] > 0.0
    rest = run_photon_fam(load_config(_config(tmp_path, 4, "rest"),
                                      device="cpu"), resume_from=ck)
    assert rest.num_iterations == whole.num_iterations == 4
    assert whole.images["combined"].max() > 0.0
    for k in OUTPUTS:
        np.testing.assert_array_equal(rest.images[k], whole.images[k],
                                      err_msg=k)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    from evplp_tpu.runtime.checkpoint import FORMAT_VERSION as JAX_VERSION
    assert JAX_VERSION == FORMAT_VERSION
    ck = str(tmp_path / "jax.npz")
    jax_run_photon_fam(jax_load_config(_config(tmp_path, 2, "j2")),
                       checkpoint_path=ck, checkpoint_every=50)
    state, iters, _ = load_checkpoint(ck, "cpu")
    assert iters == 2 and float(state.vpl_acc.abs().max()) > 0.0
    path = _config(tmp_path, 3, "j3")
    want = jax_run_photon_fam(jax_load_config(path), resume_from=ck)
    got = run_photon_fam(load_config(path, device="cpu"), resume_from=ck)
    assert got.num_iterations == want.num_iterations == 3
    for k in OUTPUTS:
        np.testing.assert_allclose(got.images[k], np.asarray(want.images[k]),
                                   rtol=2e-4, atol=2e-6, err_msg=k)


def _cli(args):
    proc = subprocess.run([sys.executable, "-m", "evplp_tpu_torch", *args,
                           "--device", "cpu"], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout[proc.stdout.index("{"):])


def test_cli_gamma_checkpoint_resume(tmp_path):
    from evplp_tpu_torch.utils.image import load_pfm
    files = dict(combinedFilename="out/c.pfm",
                 weightedVplFilename="out/c_vpl.pfm",
                 weightedPhotonFilename="out/c_pm.pfm")
    whole = run_photon_fam(load_config(_config(tmp_path, 3, "whole"),
                                       device="cpu"))
    ck = str(tmp_path / "cli.npz")
    first = _cli([_config(tmp_path, 2, "first", **files), "--output-dir",
                  str(tmp_path / "a"), "--checkpoint", ck,
                  "--checkpoint-every", "1"])
    assert first["numIterations"] == 2
    assert load_checkpoint(ck, "cpu")[1] == 2
    rest = _cli([_config(tmp_path, 3, "rest", **files), "--output-dir",
                 str(tmp_path / "b"), "--resume", ck, "--gamma"])
    assert rest["numIterations"] == 3
    for k, name in zip(OUTPUTS, ("c", "c_vpl", "c_pm")):
        img = load_pfm(str(tmp_path / "b" / f"{name}.pfm"))
        want = np.power(np.maximum(whole.images[k], 0.0), 1.0 / 2.2)
        np.testing.assert_allclose(img, want, rtol=1e-6, atol=0, err_msg=k)
    assert whole.images["weighted_photon"].max() > 0.0


def test_checkpoint_format_version_is_checked(tmp_path):
    ck = str(tmp_path / "old.npz")
    np.savez(ck, version=FORMAT_VERSION + 1)
    with pytest.raises(ValueError, match="format"):
        load_checkpoint(ck, "cpu")
