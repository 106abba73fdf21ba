"""The port's scene export (scene/export.py) against the JAX package's, on
the CPU: each function writes into its own temporary directory, and every
OBJ, MTL and JSON file must equal the JAX package's byte for byte, every
PNG decode to the same pixels (PIL reads the JAX package's PNGs here; the
port writes its own with zlib).  `python -m evplp_tpu_torch.scene.export
DIR` writes the shipped configs/ tree: the same files again."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from evplp_tpu.scene import export as je
from evplp_tpu.scene import procedural as jp
from evplp_tpu_torch.scene import export as te
from evplp_tpu_torch.scene import procedural as tp
from evplp_tpu_torch.utils.png import read_png_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_tree(port_dir, jax_dir, expect_png=False):
    """Every file of jax_dir exists in port_dir with equal bytes (PNGs:
    equal pixels); returns the number of files compared."""
    names = sorted(os.path.relpath(os.path.join(r, f), jax_dir)
                   for r, _, fs in os.walk(jax_dir) for f in fs)
    got = sorted(os.path.relpath(os.path.join(r, f), port_dir)
                 for r, _, fs in os.walk(port_dir) for f in fs)
    assert got == names
    pngs = 0
    for name in names:
        a, b = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".png"):
            pngs += 1
            want = np.asarray(Image.open(b).convert("RGB"))
            np.testing.assert_array_equal(read_png_rgb(a), want,
                                          err_msg=name)
            np.testing.assert_array_equal(
                np.asarray(Image.open(a).convert("RGB")), want, err_msg=name)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    assert (pngs > 0) == expect_png
    return len(names)


BLOCK = dict(rngOffset=0, numMaxIteration=2, timeLimitMs=-1.0,
             frameMode="accumulate", useJitter=True, useStat=False,
             numLightPaths=128, numVplLightPaths=8, numMaxBounces=2,
             radiusPercentage=0.05, combinedFilename="c.pfm")


def test_write_cornell_config(tmp_path):
    paths = []
    for mod, d in ((te, "port"), (je, "jax")):
        paths.append(mod.write_cornell_config(
            str(tmp_path / d), BLOCK, "photonfam", res=16,
            intensity=(10.0, 11.0, 12.0, 0.0), name="mini"))
    assert [os.path.basename(p) for p in paths] == ["mini.json"] * 2
    assert _assert_same_tree(str(tmp_path / "port"),
                             str(tmp_path / "jax")) == 5


def test_write_cornell_obj(tmp_path):
    for mod, d in ((te, "port"), (je, "jax")):
        mod.write_cornell_obj(str(tmp_path / d), glossy_exponent=12.0)
    assert _assert_same_tree(str(tmp_path / "port"),
                             str(tmp_path / "jax")) == 4


def test_write_spec_config_textured(tmp_path):
    """livingroom: texcoords (v/vt faces), map_Kd and the two PNGs."""
    for mod, proc, d in ((te, tp, "port"), (je, jp, "jax")):
        tech, block = mod.technique_block("ours", "livingroom", True, 500.0)
        mod.write_spec_config(str(tmp_path / d), "livingroom",
                              proc.livingroom_spec(), tech, block,
                              "lr_ours", 32, 18)
    assert _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"),
                             expect_png=True) == 7


def test_write_scene_matrix(tmp_path):
    for mod, proc, d in ((te, tp, "port"), (je, jp, "jax")):
        paths = mod.write_scene_matrix(str(tmp_path / d), "glossy",
                                       proc.glossy_spec(), res=(64, 36),
                                       time_limit_ms=2000.0)
        assert len(paths) == 10
    assert _assert_same_tree(str(tmp_path / "port"),
                             str(tmp_path / "jax")) == 14


@pytest.mark.parametrize("variant", te.VARIANTS)
@pytest.mark.parametrize("progressive", [False, True])
def test_technique_block(variant, progressive):
    got = te.technique_block(variant, "box_field", progressive, 1234.0)
    want = je.technique_block(variant, "box_field", progressive, 1234.0)
    assert json.dumps(got) == json.dumps(want)


def test_technique_block_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        te.technique_block("bdpt", "cornell", False)


def test_main_writes_the_shipped_configs(tmp_path):
    """The module's entry point writes the configs/ tree the repo ships
    (written by the JAX package's export); without an argument it
    refuses, so it never rewrites configs/ by default."""
    out = tmp_path / "configs"
    proc = subprocess.run([sys.executable, "-m",
                           "evplp_tpu_torch.scene.export", str(out)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.split()) == 40
    for scene in ("cornell", "glossy", "box_field", "livingroom"):
        n = _assert_same_tree(str(out / scene),
                              os.path.join(REPO, "configs", scene),
                              expect_png=scene == "livingroom")
        assert n == (16 if scene == "livingroom" else 14)
    bare = subprocess.run([sys.executable, "-m",
                           "evplp_tpu_torch.scene.export"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert bare.returncode != 0 and "usage" in bare.stderr
