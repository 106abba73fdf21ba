"""The port's native OBJ/MTL loader (native/obj_loader.cpp through
native/obj_native.py) against the JAX package's Python and native loaders
and the port's own Python loop, on the OBJs of tests/test_obj_native.py
(the gnarly one: comments, negative indices, fans, unknown materials, an
mtllib with a space, a 120-gon, texture map paths; and a 40x40 grid with
per-row material runs and texcoords): every array equal.  The library
lands under build/evplp_tpu_torch/, not beside its source; a missing file
raises FileNotFoundError under every mode; a failed build raises under
native="1" and falls back to the Python loop under "auto"."""
import glob
import os

import numpy as np
import pytest

from evplp_tpu.scene.objloader import load_obj as jax_load_obj
from evplp_tpu_torch.native import build, obj_native
from evplp_tpu_torch.scene.objloader import load_obj
from tests.test_obj_native import GNARLY_MTL_A, _assert_same, _write_gnarly


def _write_grid(tmp_path, n=40):
    rng = np.random.default_rng(3)
    lines = ["mtllib a.mtl"]
    (tmp_path / "a.mtl").write_text(GNARLY_MTL_A)
    for i in range(n + 1):
        for j in range(n + 1):
            lines.append(f"v {i} {rng.standard_normal():.6f} {j}")
            lines.append(f"vt {i/n:.6f} {j/n:.6f}")
    for i in range(n):
        lines.append("usemtl " + ("red" if i % 2 else "tex"))
        for j in range(n):
            a = i * (n + 1) + j + 1
            b, c = a + 1, a + n + 1
            lines.append(f"f {a}/{a} {b}/{b} {c + 1}/{c + 1} {c}/{c}")
    obj = tmp_path / "grid.obj"
    obj.write_text("\n".join(lines) + "\n")
    return obj


@pytest.mark.parametrize("write", [_write_gnarly, _write_grid])
def test_native_matches_both_packages(tmp_path, write):
    obj = str(write(tmp_path))
    port_native = load_obj(obj, native="1")
    _assert_same(jax_load_obj(obj, native="0"), port_native)
    _assert_same(jax_load_obj(obj, native="1"), port_native)
    _assert_same(load_obj(obj, native="0"), port_native)
    _assert_same(load_obj(obj, native="auto"), port_native)
    meshes, mats = port_native
    assert sum(m.indices.shape[0] for m in meshes) > 40
    assert any(m.map_kd for m in mats)


def test_library_lands_under_build():
    obj_native.load_library()
    here = os.path.dirname(os.path.abspath(obj_native.__file__))
    assert glob.glob(os.path.join(build.BUILD_DIR, "libobj_*.so"))
    assert not glob.glob(os.path.join(here, "*.so"))


@pytest.mark.parametrize("native", ["0", "1", "auto"])
def test_missing_file_raises(tmp_path, native):
    with pytest.raises(FileNotFoundError):
        load_obj(str(tmp_path / "nope.obj"), native=native)


def test_failed_build_raises_under_native(tmp_path, monkeypatch):
    obj = str(_write_gnarly(tmp_path))

    def broken(*args, **kwargs):
        raise RuntimeError("building obj failed")
    monkeypatch.setattr(obj_native, "_lib", None)
    monkeypatch.setattr(obj_native, "build_library", broken)
    with pytest.raises(RuntimeError, match="building obj failed"):
        load_obj(obj, native="1")
    _assert_same(load_obj(obj, native="0"), load_obj(obj, native="auto"))
