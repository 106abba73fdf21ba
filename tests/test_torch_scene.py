"""The port's host-side scene build against the JAX package's: the
slot-ordered triangle arrays, the packed shading rows, the BVH node arrays
and the light CDF must be equal bit for bit (array_equal), so that prim ids
from the two packages compare 1:1.  Camera rays and light samples are
float math on the same inputs: rtol 1e-6 (last-ulp differences between
XLA's and PyTorch's CPU kernels)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.core.light import light_sample as jax_light_sample
from evplp_tpu.scene import procedural
from evplp_tpu.scene.config import load_config as jax_load_config
from evplp_tpu_torch.core.light import light_sample
from evplp_tpu_torch.scene.camera import Camera
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.scene.objloader import load_obj
from evplp_tpu_torch.scene.scene import (build_scene, scene_arrays,
                                         scene_from_arrays)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def jax_scene_arrays(js) -> dict:
    """The JAX SceneData's fields as numpy arrays, keyed for
    evplp_tpu_torch.scene.scene.scene_from_arrays."""
    cam = js.camera
    out = dict(v0=js.tris.v0, e1=js.tris.e1, e2=js.tris.e2, n=js.tris.n,
               tri_shade=js.tri_shade, node_min=js.bvh.node_min,
               node_max=js.bvh.node_max, node_skip=js.bvh.node_skip,
               node_first=js.bvh.node_first, node_count=js.bvh.node_count)
    out.update({"light_" + k: getattr(js.light, k) for k in
                ("v0", "v1", "v2", "cdf", "area", "intensity")})
    out = {k: np.asarray(v) for k, v in out.items()}
    out.update(cam_origin=np.asarray(cam.origin),
               cam_look_at=np.asarray(cam.look_at),
               cam_up=np.asarray(cam.up), cam_fovy=cam.fovy,
               cam_aspect=cam.aspect, bounding_radius=js.bounding_radius,
               total_area=js.total_area)
    return out


def torch_scene_of(js):
    """The port's SceneData holding the JAX scene's very arrays (CPU)."""
    return scene_from_arrays(jax_scene_arrays(js), "cpu")


def _build_from_spec(spec):
    cam = spec["camera"]
    camera = Camera(origin=tuple(cam["origin"]),
                    look_at=tuple(cam["direction"]), up=tuple(cam["up"]),
                    fovy=float(np.radians(cam["fovy"])), aspect=1.0)
    g = spec["groups"]
    return build_scene(
        [x[1] for x in g], [x[2] for x in g],
        [np.asarray(x[3], np.float32) for x in g],
        [np.asarray(x[4], np.float32) for x in g], [x[5] for x in g],
        spec["light"][0], spec["light"][1],
        np.asarray(spec["intensity"], np.float32), camera, device="cpu")


def _assert_same_scene(jax_arrays: dict, port_arrays: dict):
    for k, v in jax_arrays.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(port_arrays[k], v, err_msg=k)
        else:
            assert port_arrays[k] == v, k


@pytest.mark.parametrize("name,spec_fn", [
    ("cornell", procedural.cornell_spec),
    ("glossy", procedural.glossy_spec),
    ("box_field_200", lambda: procedural.box_field_spec(num_boxes=200)),
])
def test_build_scene_bit_exact(name, spec_fn):
    spec = spec_fn()
    js = procedural._build(spec)
    ts = _build_from_spec(spec)
    if name == "box_field_200":
        assert js.num_triangles > 2048   # the slot-ordered BVH layout
    _assert_same_scene(jax_scene_arrays(js), scene_arrays(ts))


@pytest.mark.parametrize("config", ["cornell/cornell_ours.json",
                                    "box_field/box_field_ours.json"])
def test_load_config_bit_exact(config):
    path = os.path.join(CONFIGS, config)
    jj = jax_load_config(path)
    tj = load_config(path, device="cpu")
    assert (tj.width, tj.height) == (jj.width, jj.height)
    assert tj.params.num_light_paths == jj.params.num_light_paths
    assert tj.params.mis_mode == jj.params.mis_mode
    _assert_same_scene(jax_scene_arrays(jj.scene), scene_arrays(tj.scene))


def test_obj_texture_map_raises(tmp_path):
    (tmp_path / "m.mtl").write_text("newmtl wood\nKd 1 1 1\nmap_Kd wood.png\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl wood\nf 1 2 3\n")
    with pytest.raises(NotImplementedError, match="map_Kd"):
        load_obj(str(tmp_path / "m.obj"))


def test_camera_rays_and_light_samples():
    js = procedural.box_field(num_boxes=200)
    ts = torch_scene_of(js)
    jitter = np.asarray([0.01, -0.02], np.float32)
    jo, jd = js.camera.generate_rays(24, 16, jnp.asarray(jitter))
    to, td = ts.camera.generate_rays(24, 16, torch.from_numpy(jitter),
                                     device="cpu")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    u3 = np.random.default_rng(0).uniform(size=(512, 3)).astype(np.float32)
    jout = jax_light_sample(js.light, jnp.asarray(u3))
    tout = light_sample(ts.light, torch.from_numpy(u3))
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    assert jax.default_backend() == "cpu"
