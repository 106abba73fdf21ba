"""The port's whole "ours" frame and run loop against the JAX package.

* config -> run_photon_fam on the Cornell box against the committed goldens
  `tests/golden/ours.npz` and `ours_prog.npz`, at the goldens' own
  tolerance (rtol 2e-3, atol 2e-4, as tests/test_golden.py uses);
* two frames on the procedural box_field (>2048 triangles, BVH path) at
  16x16 against the JAX frame, the second starting from the JAX package's
  state: rtol 1e-4, atol 1e-5 (float order, as in test_torch_integrators);
* the CLI on the CPU writes the three PFMs and the stat JSON."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from evplp_tpu.core.sampling import iteration_key as jax_iteration_key
from evplp_tpu.integrators import photon_fam as jpf
from evplp_tpu.scene import procedural
from evplp_tpu.scene.export import write_cornell_config
from evplp_tpu_torch import __main__ as cli
from evplp_tpu_torch.core.sampling import iteration_key
from evplp_tpu_torch.integrators import photon_fam
from evplp_tpu_torch.runtime.loop import run_photon_fam
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.utils.image import load_pfm
from tests.test_torch_scene import torch_scene_of

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
COMMON = dict(rngOffset=3, numMaxIteration=2, timeLimitMs=-1.0,
              frameMode="accumulate", useJitter=True, useStat=False,
              statFilename="")
OURS = dict(COMMON, numLightPaths=128, numVplLightPaths=8, numMaxBounces=2,
            radiusPercentage=0.05, combinedFilename="",
            weightedPhotonFilename="", weightedVplFilename="")


@pytest.mark.parametrize("golden,block", [
    ("ours", OURS),
    ("ours_prog", dict(OURS, misMode="geometryClamp", DoProgressive=True,
                       AlphaProgressive=0.7)),
])
def test_cornell_goldens(tmp_path, golden, block):
    path = write_cornell_config(str(tmp_path), block, "photonfam", res=16,
                                name="g" + golden)
    img = run_photon_fam(load_config(path, device="cpu")).images["combined"]
    ref = np.load(os.path.join(GOLDEN_DIR, f"{golden}.npz"))["img"]
    np.testing.assert_allclose(img, ref, rtol=2e-3, atol=2e-4)


def test_box_field_frames_match_jax():
    js = procedural.box_field(num_boxes=200)
    ts = torch_scene_of(js)
    kw = dict(width=16, height=16, num_light_paths=64, num_vpl_light_paths=8,
              num_records=4, mis_mode=1, accumulate=True, use_jitter=True)
    jc, tc = jpf.PhotonFamConfig(**kw), photon_fam.PhotonFamConfig(**kw)
    radius = js.bounding_radius * 0.05
    clamp = 1.0 / js.total_area
    pdf_mc = (8 / 64) / np.pi / radius ** 2
    scalars = [jnp.float32(x) for x in (radius, clamp, pdf_mc, 0.0)]
    jstate = jpf.init_state(jc)
    tstate = photon_fam.init_state(tc, "cpu")
    for it in (0, 1):
        jstate = jpf.photon_fam_frame(js, jc, jstate, jax_iteration_key(0, it),
                                      *scalars)
        tstate = photon_fam.photon_fam_frame(ts, tc, tstate,
                                             iteration_key(0, it, "cpu"),
                                             radius, clamp, pdf_mc)
        for f in ("vpl_acc", "photon_acc", "light_img"):
            np.testing.assert_allclose(getattr(tstate, f).numpy(),
                                       np.asarray(getattr(jstate, f)),
                                       rtol=1e-4, atol=1e-5, err_msg=f)
        assert int(tstate.dropped) == 0
        # the next frame starts from the JAX package's state
        tstate = photon_fam.state_from_arrays(
            *(np.asarray(getattr(jstate, f)) for f in
              ("vpl_acc", "photon_acc", "light_img", "dropped")),
            device="cpu")
    assert np.asarray(jstate.vpl_acc).max() > 0.0
    assert np.asarray(jstate.photon_acc).max() > 0.0


def test_cli_writes_dumps_and_stats(tmp_path, capsys):
    block = dict(OURS, numMaxIteration=1, useStat=True,
                 statFilename="out/c_stat.json", combinedFilename="out/c.pfm",
                 weightedVplFilename="out/c_vpl.pfm",
                 weightedPhotonFilename="out/c_pm.pfm")
    path = write_cornell_config(str(tmp_path), block, "photonfam", res=8)
    out = tmp_path / "dumps"
    assert cli.main([path, "--output-dir", str(out), "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["numIterations"] == 1
    assert summary["dropped_splat_pairs"] == 0
    imgs = {n: load_pfm(str(out / n)) for n in ("c.pfm", "c_vpl.pfm",
                                                "c_pm.pfm")}
    for img in imgs.values():
        assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(imgs["c.pfm"], imgs["c_vpl.pfm"]
                               + imgs["c_pm.pfm"], rtol=1e-5, atol=1e-6)
    stat = json.loads((out / "c_stat.json").read_text())
    assert stat["numIterations"] == 1
