"""The port's equal-time quality harness (runtime/compare.py), on the CPU.

* tests/test_compare.py's mini protocol through the port: configs written
  by the port's scene/export.py (16x16 Cornell, few paths), a ground
  truth of 3 PT iterations, then pt and ours at a 200 ms budget, through
  `main` with --device cpu; the report's rows have iters >= 1 and finite
  metrics, and the JAX package's `report` reads the port's artifacts to
  the same rows.
* masked_mse and masked_rel_mse equal the JAX functions on the same
  images exactly (the same numpy on the same arrays), and
  emitter_mask equals the JAX mask on the Cornell and glossy views.
* --device cuda without a card raises."""
import json
import os

import numpy as np
import pytest
import torch

from evplp_tpu.runtime import compare as jcompare
from evplp_tpu.scene.config import load_config as jax_load_config
from evplp_tpu_torch.runtime import compare
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.scene.export import technique_block, write_spec_config
from evplp_tpu_torch.scene.procedural import cornell_spec

RES = 16


def _mini_configs(root):
    """A configs/-shaped mini tree: <root>/cornell/cornell_{pt,ours}.json
    at 16x16 with few paths, so each frame takes milliseconds."""
    scene_dir = os.path.join(root, "cornell")
    spec = cornell_spec()
    first = True
    for variant in ("pt", "ours"):
        tech, block = technique_block(variant, "cornell", False, 200.0)
        block["numLightPaths"] = min(block.get("numLightPaths", 128), 256)
        block["numVplLightPaths"] = min(block.get("numVplLightPaths", 8), 8)
        block["numMaxBounces"] = 2
        write_spec_config(scene_dir, "cornell", spec, tech, block,
                          f"cornell_{variant}", RES, RES, write_objs=first)
        first = False
    return root


def test_protocol_end_to_end(tmp_path, capsys):
    configs = _mini_configs(str(tmp_path / "configs"))
    art = str(tmp_path / "art")
    common = ["--art-dir", art, "--configs", configs, "--budget-ms", "200",
              "--device", "cpu"]

    compare.main(common + ["gt", "cornell", "3"])
    gt = np.load(os.path.join(art, "cornell_gt.npz"))
    assert gt["img"].shape == (RES, RES, 3) and np.isfinite(gt["img"]).all()
    assert gt["mask"].dtype == bool and gt["mask"].any()
    assert int(gt["iters"]) == 3

    compare.main(common + ["run", "cornell", "pt,ours"])
    for variant in ("pt", "ours"):
        z = np.load(os.path.join(art, f"cornell_{variant}.npz"))
        assert set(z.files) == {"img", "iters", "time_ms", "dropped"}
        assert int(z["dropped"]) == 0
    capsys.readouterr()
    rows = compare.report(("cornell",), art, variants=("pt", "ours"),
                          budget_ms=200.0)
    assert json.loads(capsys.readouterr().out) == rows
    assert {r["variant"] for r in rows} == {"pt", "ours"}
    for r in rows:
        assert r["iters"] >= 1 and r["gt_iters"] == 3
        assert np.isfinite(r["mse"]) and np.isfinite(r["rel_mse"])
        json.dumps(r)
    assert jcompare.report(("cornell",), art, variants=("pt", "ours"),
                           budget_ms=200.0) == rows


def test_masked_metrics_match_jax():
    rs = np.random.default_rng(4)
    img = rs.random((24, 40, 3)).astype(np.float32) * 3.0
    ref = rs.random((24, 40, 3)).astype(np.float32) * 3.0
    mask = rs.random((24, 40)) > 0.3
    for fn in ("masked_mse", "masked_rel_mse"):
        got = getattr(compare, fn)(img, ref, mask)
        want = getattr(jcompare, fn)(img, ref, mask)
        assert got == want
        assert got > 0.0


@pytest.mark.parametrize("config", ["cornell/cornell_pt.json",
                                    "glossy/glossy_pt.json"])
def test_emitter_mask_matches_jax(tmp_path, config):
    with open(os.path.join(compare.CONFIGS, config)) as f:
        cfg = json.load(f)
    base = os.path.dirname(os.path.join(compare.CONFIGS, config))
    cfg["scene"] = [os.path.join(base, s) for s in cfg["scene"]]
    cfg["arealight"]["obj"] = os.path.join(base, cfg["arealight"]["obj"])
    cfg["resX"], cfg["resY"] = 48, 27
    path = str(tmp_path / "m.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    got = compare.emitter_mask(load_config(path, device="cpu"))
    want = jcompare.emitter_mask(jax_load_config(path))
    assert got.dtype == bool and got.shape == (27, 48)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_cuda_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    configs = _mini_configs(str(tmp_path / "configs"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare.main(["--art-dir", str(tmp_path / "art"), "--configs",
                      configs, "gt", "cornell", "1"])
    assert not os.path.exists(tmp_path / "art" / "cornell_gt.npz")
