"""The port's packed BVH layout, its two further traversals (packet7: the
two-level loop; packet: one shared stack per packet) and the PACKET_IMPL
switch, against the JAX package on the CPU.

* pk_* arrays, node arrays and the slot order: bit for bit (array_equal)
  with the JAX build_bvh(..., slot_order=True), at leaf sizes 14 (rpl 1)
  and 28 (rpl 2).
* packet7_plain against the JAX Pallas packet7_trace in interpret mode
  (rows=4, npack=2), as tests/test_packet.py runs it: hit masks equal; prim
  equal where hit, or a t-tie at rtol 1e-4 (near-child-first order is per
  ray here, per packet there); t at rtol 1e-4; u at atol 1e-4; any-hit
  masks equal on live lanes.  Dead lanes report no hit here (the TPU
  kernel reports them as hits).
* packet_plain against the JAX Pallas packet_trace in interpret mode at
  the sizes of tests/test_packet.py: closest t at rtol 1e-4 with prim
  equal; any-hit masks equal.
* Under each PACKET_IMPL value the port's casts match the JAX functions at
  the tolerance of tests/test_torch_trace.py (prims equal or a t-tie at
  rtol 1e-4, t at rtol 1e-5, any-hit equal); closest_and_segment is
  compared on live segments only (JAX reports True on dead ones)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.accel.bvh import build_bvh as jax_build_bvh
from evplp_tpu.scene import procedural
from evplp_tpu.trace import intersect as jax_intersect
from evplp_tpu.trace import packet as jax_packet
from evplp_tpu.trace import packet7 as jax_packet7
from evplp_tpu.trace.intersect import Triangles as JaxTriangles
from evplp_tpu_torch.accel.bvh import (NODE_KEYS, PACKED_KEYS, build_bvh,
                                      bvh_from_arrays)
from evplp_tpu_torch.scene.scene import Triangles
from evplp_tpu_torch.trace import intersect, packet, packet7, traverse
from tests.test_torch_scene import torch_scene_of
from tests.test_torch_trace import _assert_closest_match, _rays

IMPLS = ("packet3", "packet7", "packet")
BOX_LO, BOX_HI = [0.2, 0.1, 0.2], [3.8, 1.9, 3.8]


def _random_tris(n, seed):
    """Random triangles as tests/test_packet.py makes them."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (n, 3)).astype(np.float32)
    return base, base + e1, base + e2


def _box_field_tris():
    """The builder-order triangles of box_field_200 (3,010 > 2048)."""
    js = procedural.box_field(num_boxes=200)
    valid = np.asarray(js.bvh.pk_prim_map) >= 0
    v0 = np.asarray(js.tris.v0)[valid]
    return v0, v0 + np.asarray(js.tris.e1)[valid], \
        v0 + np.asarray(js.tris.e2)[valid]


@pytest.fixture(scope="module")
def box_field():
    js = procedural.box_field(num_boxes=200)
    return js, torch_scene_of(js)


@pytest.mark.parametrize("leaf_size", [14, 28])
@pytest.mark.parametrize("scene", ["box_field_200", "random_3000"])
def test_packed_layout_bit_exact(scene, leaf_size):
    v0, v1, v2 = (_box_field_tris() if scene == "box_field_200"
                  else _random_tris(3000, 7))
    jb, jorder = jax_build_bvh(v0, v1, v2, leaf_size=leaf_size,
                               slot_order=True)
    arrays, order = build_bvh(v0, v1, v2, leaf_size=leaf_size)
    np.testing.assert_array_equal(order, jorder)
    for k in PACKED_KEYS + NODE_KEYS:
        np.testing.assert_array_equal(arrays[k], np.asarray(getattr(jb, k)),
                                      err_msg=k)
    assert arrays["bvh_rpl"] == jb.rpl == leaf_size // 14
    assert arrays["bvh_fused_nodes"] is False


def _port_bvh(jb, v0, v1, v2):
    """The port's BVH holding a JAX BVH's very arrays (CPU); v0, v1, v2 are
    the triangles in the order its node arrays index."""
    arrays = {k: np.asarray(getattr(jb, k)) for k in PACKED_KEYS + NODE_KEYS}
    return bvh_from_arrays(dict(arrays, bvh_rpl=jb.rpl,
                                bvh_fused_nodes=False, v0=v0, e1=v1 - v0,
                                e2=v2 - v0), "cpu")


def _jax_packed(leaf_size):
    """A packed, builder-ordered JAX BVH of the tests/test_packet.py scene
    and the port's BVH holding the same arrays."""
    v0, v1, v2 = _random_tris(311, 2)
    jb, perm = jax_build_bvh(v0, v1, v2, leaf_size=leaf_size, pack=True)
    return jb, _port_bvh(jb, v0[perm], v1[perm], v2[perm])


@pytest.fixture
def interpret():
    jax_packet.set_interpret(True)
    jax_packet7.set_interpret(True)
    yield
    jax_packet.set_interpret(False)
    jax_packet7.set_interpret(False)


def _jax_rays(r, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (r, 3)).astype(np.float32),
            rng.normal(0, 1, (r, 3)).astype(np.float32))


@pytest.mark.parametrize("leaf_size", [14, 28])
def test_packet7_plain_matches_jax_kernel(interpret, leaf_size):
    jb, tb = _jax_packed(leaf_size)
    assert tb.rpl == leaf_size // 14
    o, d = _jax_rays(300, 3)
    pm = np.asarray(jb.pk_prim_map)
    args = (jb.pk_tri_rows, jb.pk_meta, jb.pk_bounds, jb.pk_prim_map,
            jnp.asarray(o), jnp.asarray(d))
    kw = dict(rows=4, npack=2, rpl=jb.rpl)

    jt, jp, ju, _ = (np.asarray(x) for x in jax_packet7.packet7_trace(
        *args, 1e-4, 3e38, **kw))
    r = 300
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, slot, u, _ = (x.numpy() for x in packet7.packet7_plain(
        None, tb, to, td, torch.full((r,), 1e-4), torch.full((r,), 3e38),
        False))
    prim = np.where(slot >= 0, pm[np.maximum(slot, 0)], -1)
    np.testing.assert_array_equal(prim >= 0, jp >= 0)
    m = jp >= 0
    assert m.mean() > 0.1
    tie = np.isclose(t[m], jt[m], rtol=1e-4)
    assert ((prim[m] == jp[m]) | tie).all()
    np.testing.assert_allclose(t[m], jt[m], rtol=1e-4)
    same = m & (prim == jp)
    np.testing.assert_allclose(u[same], ju[same], atol=1e-4)

    dead = np.arange(r) % 3 == 0
    t_max = np.where(dead, 0.0, 2.0).astype(np.float32)
    _, jp2, _, _ = jax_packet7.packet7_trace(
        *args, jnp.full((r,), 1e-3), jnp.asarray(t_max), any_hit=True, **kw)
    _, s2, _, _ = packet7.packet7_plain(
        None, tb, to, td, torch.full((r,), 1e-3), torch.from_numpy(t_max),
        True)
    jp2, s2 = np.asarray(jp2), s2.numpy()
    np.testing.assert_array_equal(s2[~dead] >= 0, jp2[~dead] >= 0)
    assert 0.1 < (s2[~dead] >= 0).mean() < 0.9
    assert (jp2[dead] >= 0).all() and (s2[dead] == -1).all()


def _jax_v1_scene(n, seed):
    v0, v1, v2 = _random_tris(n, seed)
    jb, perm = jax_build_bvh(v0, v1, v2, pack=True)
    v0, v1, v2 = v0[perm], v1[perm], v2[perm]
    e1, e2 = v1 - v0, v2 - v0
    nrm = np.cross(e1, e2)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    jt = JaxTriangles(v0=jnp.asarray(v0), e1=jnp.asarray(e1),
                      e2=jnp.asarray(e2), n=jnp.asarray(nrm))
    tt = Triangles(*(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                     for x in (v0, e1, e2, nrm)))
    return jt, jb, tt, _port_bvh(jb, v0, v1, v2)


def test_packet_plain_matches_jax_kernel(interpret):
    jt, jb, tt, tb = _jax_v1_scene(200, 0)
    o, d = _jax_rays(300, 1)
    r = 300
    jtt, jp, _, _ = (np.asarray(x) for x in jax_packet.packet_trace(
        jt, jb, jnp.asarray(o), jnp.asarray(d), 1e-4, 3e38, any_hit=False))
    t, prim, _, _ = (x.numpy() for x in packet.packet_plain(
        tt, tb, torch.from_numpy(o), torch.from_numpy(d),
        torch.full((r,), 1e-4), torch.full((r,), 3e38), False))
    np.testing.assert_array_equal(prim >= 0, jp >= 0)
    m = jp >= 0
    assert m.mean() > 0.1
    np.testing.assert_allclose(t[m], jtt[m], rtol=1e-4)
    np.testing.assert_array_equal(prim[m], jp[m])

    jt, jb, tt, tb = _jax_v1_scene(150, 5)
    o, d = _jax_rays(257, 6)
    r = 257
    _, jp, _, _ = jax_packet.packet_trace(jt, jb, jnp.asarray(o),
                                          jnp.asarray(d), 1e-3, 2.0,
                                          any_hit=True)
    _, prim, _, _ = packet.packet_plain(
        tt, tb, torch.from_numpy(o), torch.from_numpy(d),
        torch.full((r,), 1e-3), torch.full((r,), 2.0), True)
    np.testing.assert_array_equal(prim.numpy() >= 0, np.asarray(jp) >= 0)


@pytest.fixture
def impl(request, monkeypatch):
    monkeypatch.setattr(intersect, "PACKET_IMPL", request.param)
    return request.param


@pytest.mark.parametrize("impl", IMPLS, indirect=True)
def test_switch_casts_match_jax(box_field, impl):
    js, ts = box_field
    n = 1500
    o, d = _rays(n, 1, BOX_LO, BOX_HI)
    jh = jax_intersect.intersect_closest(js.tris, js.bvh, jnp.asarray(o),
                                         jnp.asarray(d), t_min=1e-4)
    th = intersect.intersect_closest(ts.tris, ts.bvh, torch.from_numpy(o),
                                     torch.from_numpy(d), t_min=1e-4)
    _assert_closest_match(th.t.numpy(), th.prim.numpy(), np.asarray(jh.t),
                          np.asarray(jh.prim))

    a, _ = _rays(n, 2, BOX_LO, BOX_HI)
    b, _ = _rays(n, 3, BOX_LO, BOX_HI)
    live = np.random.default_rng(4).uniform(size=n) < 0.6
    jo = np.asarray(jax_intersect.occluded_segment(
        js.tris, js.bvh, jnp.asarray(a), jnp.asarray(b), eps=1e-4,
        live=jnp.asarray(live)))
    to = intersect.occluded_segment(
        ts.tris, ts.bvh, torch.from_numpy(a), torch.from_numpy(b), eps=1e-4,
        live=torch.from_numpy(live)).numpy()
    np.testing.assert_array_equal(to[live], jo[live])
    assert not to[~live].any()      # dead lanes report no hit
    ja = np.asarray(jax_intersect.intersect_any(
        js.tris, js.bvh, jnp.asarray(a), jnp.asarray(b - a), t_min=1e-4,
        t_max=1.0))
    ta = intersect.intersect_any(ts.tris, ts.bvh, torch.from_numpy(a),
                                 torch.from_numpy(b - a), t_min=1e-4,
                                 t_max=1.0).numpy()
    np.testing.assert_array_equal(ta, ja)

    t_max = np.where(live, 3e38, 0.0).astype(np.float32)
    jh, jocc = jax_intersect.closest_and_segment(
        js.tris, js.bvh, jnp.asarray(a), jnp.asarray(d), 1e-5,
        jnp.asarray(t_max), jnp.asarray(b), seg_eps=1e-5,
        seg_live=jnp.asarray(live))
    th, tocc = intersect.closest_and_segment(
        ts.tris, ts.bvh, torch.from_numpy(a), torch.from_numpy(d), 1e-5,
        torch.from_numpy(t_max), torch.from_numpy(b), seg_eps=1e-5,
        seg_live=torch.from_numpy(live))
    _assert_closest_match(th.t.numpy(), th.prim.numpy(), np.asarray(jh.t),
                          np.asarray(jh.prim))
    np.testing.assert_array_equal(tocc.numpy()[live], np.asarray(jocc)[live])
    assert not tocc.numpy()[~live].any()


def test_switch_routes_casts(box_field, monkeypatch):
    """Each value reaches its module (the plain walk on CPU tensors, no
    kernel launch); a fused-node scene gives way to packet3 as the JAX
    dispatch does; an unknown value raises."""
    _, ts = box_field
    o, d = _rays(64, 5, BOX_LO, BOX_HI)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    calls = []
    for name, mod, attr in (("packet3", traverse, "traverse_plain"),
                            ("packet7", packet7, "packet7_plain"),
                            ("packet", packet, "packet_plain")):
        real = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    before = (traverse.launches, packet7.launches, packet.launches)
    for name in IMPLS:
        monkeypatch.setattr(intersect, "PACKET_IMPL", name)
        assert intersect.traversal_impl(ts.bvh) == name
        intersect.intersect_any(ts.tris, ts.bvh, o, d, t_max=1.0)
        assert calls[-1] == name
        fused = dataclasses.replace(ts.bvh, fused_nodes=True)
        assert intersect.traversal_impl(fused) == "packet3"
        intersect.intersect_closest(ts.tris, fused, o, d)
        assert calls[-1] == "packet3"
    assert (traverse.launches, packet7.launches, packet.launches) == before
    monkeypatch.setattr(intersect, "PACKET_IMPL", "packet9")
    with pytest.raises(ValueError, match="PACKET_IMPL"):
        intersect.intersect_closest(ts.tris, ts.bvh, o, d)


@pytest.mark.parametrize("cuda_fn", [packet7.packet7_cuda,
                                     packet.packet_cuda])
def test_cpu_tensors_take_the_plain_walk(box_field, cuda_fn):
    _, ts = box_field
    o, d = _rays(64, 5, BOX_LO, BOX_HI)
    args = (ts.tris, ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
            torch.full((64,), 1e-4), torch.full((64,), traverse.BIG))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fn(*args, False)
    t, prim, _, _ = traverse.traverse_plain(*args, False)
    for trace in (packet7.packet7_trace, packet.packet_trace):
        t2, prim2, _, _ = trace(*args, False)
        assert torch.equal(prim, prim2) and torch.equal(t, t2)
