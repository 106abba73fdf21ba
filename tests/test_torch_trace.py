"""Ray casting: the port's dense path (cornell, 36 triangles) and its plain
BVH traversal (procedural box_field with 200 boxes, >2048 triangles, so the
JAX side reaches `_traverse_one`) against the JAX package's
intersect_closest / intersect_any on the same scene and rays.

Tolerance: prims equal, or a t-tie at rtol 1e-4 (coplanar duplicates, as
bench.py's kernel check allows); t at rtol 1e-5 (both evaluate the same
float ops, XLA and PyTorch CPU kernels may differ in the last ulp).
Any-hit results must be equal.  The CUDA kernel itself is held against the
plain version on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.scene import procedural
from evplp_tpu.trace import intersect as jax_intersect
from evplp_tpu_torch.trace import intersect, traverse
from tests.test_torch_scene import torch_scene_of

SCENES = {"cornell": lambda: procedural.cornell_box(),
          "box_field_200": lambda: procedural.box_field(num_boxes=200)}


def _rays(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def _assert_closest_match(t_p, prim_p, t_j, prim_j):
    assert ((prim_p >= 0) == (prim_j >= 0)).all()
    m = prim_j >= 0
    tie = np.isclose(t_p[m], t_j[m], rtol=1e-4)
    assert ((prim_p[m] == prim_j[m]) | tie).all()
    np.testing.assert_allclose(t_p, t_j, rtol=1e-5)


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    js = SCENES[request.param]()
    return request.param, js, torch_scene_of(js)


def test_closest_matches_jax(scenes):
    name, js, ts = scenes
    lo, hi = ([0.05, 0.05, 0.05], [0.95, 0.95, 0.95]) if name == "cornell" \
        else ([0.2, 0.1, 0.2], [3.8, 1.9, 3.8])
    o, d = _rays(1500, 1, lo, hi)
    jh = jax_intersect.intersect_closest(js.tris, js.bvh, jnp.asarray(o),
                                         jnp.asarray(d), t_min=1e-4)
    th = intersect.intersect_closest(ts.tris, ts.bvh, torch.from_numpy(o),
                                     torch.from_numpy(d), t_min=1e-4)
    _assert_closest_match(th.t.numpy(), th.prim.numpy(), np.asarray(jh.t),
                          np.asarray(jh.prim))
    assert (th.prim.numpy() >= 0).mean() > 0.5
    m = np.asarray(jh.prim) == th.prim.numpy()
    np.testing.assert_allclose(th.u.numpy()[m], np.asarray(jh.u)[m],
                               rtol=1e-4, atol=1e-5)


def test_occluded_segment_matches_jax(scenes):
    """Segment semantics: unnormalized direction, t in (eps, 1 - eps), and
    live=False lanes are not traced (compared on live lanes only)."""
    name, js, ts = scenes
    lo, hi = ([0.05, 0.05, 0.05], [0.95, 0.95, 0.95]) if name == "cornell" \
        else ([0.2, 0.1, 0.2], [3.8, 1.9, 3.8])
    a, _ = _rays(1500, 2, lo, hi)
    b, _ = _rays(1500, 3, lo, hi)
    live = np.random.default_rng(4).uniform(size=1500) < 0.6
    jo = np.asarray(jax_intersect.occluded_segment(
        js.tris, js.bvh, jnp.asarray(a), jnp.asarray(b), eps=1e-4,
        live=jnp.asarray(live)))
    to = intersect.occluded_segment(
        ts.tris, ts.bvh, torch.from_numpy(a), torch.from_numpy(b), eps=1e-4,
        live=torch.from_numpy(live)).numpy()
    np.testing.assert_array_equal(to[live], jo[live])
    assert 0.05 < to[live].mean() < 0.95
    ja = np.asarray(jax_intersect.intersect_any(
        js.tris, js.bvh, jnp.asarray(a), jnp.asarray(b - a), t_min=1e-4,
        t_max=1.0))
    ta = intersect.intersect_any(ts.tris, ts.bvh, torch.from_numpy(a),
                                 torch.from_numpy(b - a), t_min=1e-4,
                                 t_max=1.0).numpy()
    np.testing.assert_array_equal(ta, ja)


def test_cpu_tensors_take_the_plain_walk():
    js = SCENES["box_field_200"]()
    ts = torch_scene_of(js)
    o, d = _rays(64, 5, [0.2, 0.1, 0.2], [3.8, 1.9, 3.8])
    before = traverse.launches
    args = (ts.tris, ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
            torch.full((64,), 1e-4), torch.full((64,), traverse.BIG))
    t, prim, _, _ = traverse.traverse(*args, False)
    assert traverse.launches == before
    t2, prim2, _, _ = traverse.traverse_plain(*args, False)
    assert torch.equal(prim, prim2) and torch.equal(t, t2)
    with pytest.raises(ValueError, match="CUDA"):
        traverse.traverse_cuda(*args, False)
