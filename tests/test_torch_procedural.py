"""The port's scene tooling against the JAX package's, on the CPU.

* Every spec of scene/procedural.py (cornell, glossy, livingroom with its
  two textures, box_field at seeds 0 and 1, box_field_big) equals the JAX
  spec bit for bit: group names, positions, indices, materials, texcoords,
  texture names and images, the light quad, intensity and camera.
* Every built scene (cornell, glossy, livingroom, box_field of 200 boxes,
  the furnace and the plane-light scene) equals the JAX SceneData's arrays
  at rtol 1e-6 (atol 1e-6), through scene_arrays.
* utils/aabb.py equals evplp_tpu.utils.aabb at 1e-6 on the cases of
  tests/test_misc_parity.py and on batches of random boxes.
* The 200-box field of tests/test_torch_cuda.py takes the procedural
  spec's room and boxes: its non-light triangles are those of
  procedural.box_field(200)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.scene import procedural as jp
from evplp_tpu.utils import aabb as jaabb
from evplp_tpu_torch.scene import procedural as tp
from evplp_tpu_torch.scene.scene import scene_arrays
from evplp_tpu_torch.utils import aabb
from tests.test_torch_cuda import box_field_scene
from tests.test_torch_scene import jax_scene_arrays

SPECS = {
    "cornell": lambda m: m.cornell_spec(),
    "cornell_glossy_50": lambda m: m.cornell_spec(glossy_exponent=50.0),
    "glossy": lambda m: m.glossy_spec(),
    "livingroom": lambda m: m.livingroom_spec(),
    "box_field_seed0": lambda m: m.box_field_spec(300, seed=0),
    "box_field_seed1": lambda m: m.box_field_spec(300, seed=1),
    "box_field_scaled": lambda m: m.box_field_spec(100, seed=1,
                                                   room_scale=1.5),
    "box_field_big": lambda m: m.box_field_big_spec(2000),
}


def _assert_equal_tree(got, want, path="spec"):
    """Equal structure and bit-equal arrays (dtype included)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_equal_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_bit_equal(name):
    _assert_equal_tree(SPECS[name](tp), SPECS[name](jp))


@pytest.mark.parametrize("fn", ["_checker_texture", "_wood_texture"])
def test_textures_bit_equal(fn):
    for kw in ({}, {"n": 64}):
        got, want = getattr(tp, fn)(**kw), getattr(jp, fn)(**kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_box_helpers_bit_equal():
    for got, want in ((tp._box([0.1, 0.2, 0.3], [0.4, 0.8, 0.5]),
                       jp._box([0.1, 0.2, 0.3], [0.4, 0.8, 0.5])),
                      (tp._quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]),
                       jp._quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]))):
        _assert_equal_tree(got, want)


SCENES = {
    "cornell_box": lambda m, **d: m.cornell_box(**d),
    "glossy_box": lambda m, **d: m.glossy_box(**d),
    "livingroom": lambda m, **d: m.livingroom(**d),
    "box_field_200": lambda m, **d: m.box_field(num_boxes=200, **d),
    "furnace_scene": lambda m, **d: m.furnace_scene(**d),
    "plane_light_scene": lambda m, **d: m.plane_light_scene(**d),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_built_scene_matches_jax(name):
    got = scene_arrays(SCENES[name](tp, device="cpu"))
    want = jax_scene_arrays(SCENES[name](jp))
    for k, v in want.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(got[k]), v, rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_scenes_default_to_the_card(monkeypatch):
    """The scene functions place their scene on device, "cuda" unless
    told otherwise; without a card that raises."""
    seen = []
    monkeypatch.setattr(tp, "build_scene",
                        lambda *a, **k: seen.append(k["device"]))
    for fn in SCENES.values():
        fn(tp)
    assert seen == ["cuda"] * len(SCENES)


def test_cuda_tests_box_field_takes_the_spec_geometry():
    def non_light(arrays):
        keep = arrays["tri_shade"][:, 7] < 0.5
        rows = np.concatenate([arrays["v0"][keep], arrays["e1"][keep],
                               arrays["e2"][keep]], axis=1)
        rows = rows[np.abs(rows).sum(axis=1) > 0]   # padding slots
        return rows[np.lexsort(rows.T[::-1])]
    got = non_light(scene_arrays(box_field_scene(200, "cpu")))
    want = non_light(scene_arrays(tp.box_field(200, device="cpu")))
    assert got.shape == (2410, 9)
    np.testing.assert_array_equal(got, want)


def _pair(lo, hi):
    return (aabb.Aabb(torch.tensor(lo, dtype=torch.float32),
                      torch.tensor(hi, dtype=torch.float32)),
            jaabb.Aabb(jnp.asarray(lo, jnp.float32),
                       jnp.asarray(hi, jnp.float32)))


def _close(got, want):
    if isinstance(got, aabb.Aabb):
        _close(got.lo, want.lo)
        _close(got.hi, want.hi)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_aabb_misc_parity_cases():
    """The cases of tests/test_misc_parity.py, each against the JAX
    function."""
    pts_a = [[0, 0, 0], [1, 2, 3.0]]
    pts_b = [[0.5, 0.5, 0.5], [2, 1, 1.0]]
    a, ja = aabb.from_points(torch.tensor(pts_a)), jaabb.from_points(
        jnp.asarray(pts_a))
    b, jb = aabb.from_points(torch.tensor(pts_b)), jaabb.from_points(
        jnp.asarray(pts_b))
    _close(aabb.union(a, b), jaabb.union(ja, jb))
    i, ji = aabb.intersect(a, b), jaabb.intersect(ja, jb)
    _close(i, ji)
    assert bool(aabb.is_valid(i)) == bool(jaabb.is_valid(ji)) is True
    _close(aabb.diagonal_length2(a), jaabb.diagonal_length2(ja))
    _close(aabb.surface_area(a), jaabb.surface_area(ja))
    assert float(aabb.surface_area(a)) == 2 * (1 * 2 + 2 * 3 + 3 * 1)
    for p in ([0.5, 1.0, 2.0], [2.0, 0.0, 0.0]):
        assert bool(aabb.contains(a, torch.tensor(p))) == bool(
            jaabb.contains(ja, jnp.asarray(p)))
    unit, junit = _pair([0, 0, 0], [1, 1, 1])
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [1.0, 2.0, 3.0]
    out = aabb.transform(unit, torch.from_numpy(m))
    _close(out, jaabb.transform(junit, jnp.asarray(m)))
    _close(out.lo, np.asarray([1, 2, 3]))
    box, jbox = _pair([1, -0.5, -0.5], [2, 0.5, 0.5])
    inside, jinside = _pair([-1, -1, -1], [1, 1, 1])
    origin, axis = [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]
    for bx, jbx in ((box, jbox), (inside, jinside)):
        _close(aabb.max_cos_bound(bx, torch.tensor(origin),
                                  torch.tensor(axis)),
               jaabb.max_cos_bound(jbx, jnp.asarray(origin),
                                   jnp.asarray(axis)))
    assert float(aabb.max_cos_bound(inside, torch.tensor(origin),
                                    torch.tensor(axis))) == 1.0


def test_aabb_batched_random_boxes():
    rs = np.random.default_rng(3)
    lo = rs.uniform(-2, 1, (64, 3)).astype(np.float32)
    hi = (lo + rs.uniform(-0.2, 1.5, (64, 3))).astype(np.float32)
    lo2 = rs.uniform(-2, 1, (64, 3)).astype(np.float32)
    hi2 = (lo2 + rs.uniform(0.1, 1.5, (64, 3))).astype(np.float32)
    a, ja = _pair(lo, hi)
    b, jb = _pair(lo2, hi2)
    for fn in ("union", "intersect"):
        _close(getattr(aabb, fn)(a, b), getattr(jaabb, fn)(ja, jb))
    for fn in ("is_valid", "diagonal_length2", "surface_area"):
        got, want = getattr(aabb, fn)(a), getattr(jaabb, fn)(ja)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    pts = rs.uniform(-2, 2, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        aabb.contains(a, torch.from_numpy(pts)).numpy(),
        np.asarray(jaabb.contains(ja, jnp.asarray(pts))))
    axis = rs.normal(size=(64, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    _close(aabb.max_cos_bound(a, torch.from_numpy(pts),
                              torch.from_numpy(axis)),
           jaabb.max_cos_bound(ja, jnp.asarray(pts), jnp.asarray(axis)))
    m = rs.normal(size=(4, 4)).astype(np.float32)
    m[3] = [0, 0, 0, 1]
    _close(aabb.transform(a, torch.from_numpy(m)),
           jaabb.transform(ja, jnp.asarray(m)))
    empty = aabb.empty((2,), device="cpu")
    _close(empty, jaabb.empty((2,)))
    assert not bool(aabb.is_valid(empty).any())
    pts_t = torch.from_numpy(pts)
    _close(aabb.from_points(pts_t), jaabb.from_points(jnp.asarray(pts)))
