"""The traversal kernel's layout and walk on the CPU: the walk records of
`accel/bvh.py:walk_layout` and `trace/traverse.py:walk_plain`, the
kernel's ordered walk in plain PyTorch.

Scenes: box_field_200 and cornell carried over from the JAX package (its
build_bvh's arrays), box_field_200 built by the port from the same spec,
coincident duplicate triangles (> 2048, slot order), and a scene whose
root is a leaf.

* The records are copies: each internal child's box equals node_min /
  node_max bit for bit, each leaf child's box is that box padded outwards
  by walk_pad (2^-16 of the scene's largest coordinate, each bound
  moved out by at least the pad and at most one float32 step beyond it),
  child references follow the skip pointers (and pk_meta[:, 2]),
  each leaf's (first, count) is the node arrays' own, and the triangle
  records equal v0 / e1 / e2 bit for bit.
* The walk from the super-root reaches every slot of every leaf exactly
  once, and leaf node_first grows strictly in DFS order: the invariant by
  which "least slot on ties" is `_traverse_one`'s "first found".
* walk_plain equals traverse_plain exactly (t, prim, u, v; any-hit
  occlusion on live lanes), and the JAX package's intersect_closest at the
  tolerance of tests/test_torch_trace.py; on rays aimed at the shared
  edges of coincident duplicates it returns the lower slot of each pair.
* walk_plain reports what it reads (work["reads"]): one record a step, one
  slot a triangle test, each by a live ray, every hit's slot among them.
* traverse_cuda and walk_plain raise on a tree deeper than the stack."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.scene import procedural
from evplp_tpu.trace import intersect as jax_intersect
from evplp_tpu_torch.accel.bvh import walk_pad
from evplp_tpu_torch.trace import traverse
from tests.test_torch_cuda import (_quads, _scene, duplicate_grid_scene,
                                   grid_edge_rays, lower_of_duplicates)
from tests.test_torch_scene import _build_from_spec, torch_scene_of
from tests.test_torch_trace import _assert_closest_match, _rays

BOX_LO, BOX_HI = [0.2, 0.1, 0.2], [3.8, 1.9, 3.8]
SCENES = {
    "box_field_200_jax": lambda: torch_scene_of(
        procedural.box_field(num_boxes=200)),
    "box_field_200_port": lambda: _build_from_spec(
        procedural.box_field_spec(num_boxes=200)),
    "cornell_jax": lambda: torch_scene_of(procedural.cornell_box()),
    "duplicates": lambda: duplicate_grid_scene("cpu"),
    "root_leaf": lambda: _scene([_quads([[[0, 0, 0], [0, 0, 4], [4, 0, 4],
                                          [4, 0, 0]]])], "cpu"),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return request.param, SCENES[request.param]()


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _node_arrays(bvh):
    return (bvh.node_min.numpy(), bvh.node_max.numpy(),
            bvh.node_skip.numpy(), bvh.node_first.numpy(),
            bvh.node_count.numpy())


def test_walk_records_copy_the_node_arrays(scene):
    name, sc = scene
    bvh = sc.bvh
    nmin, nmax, skip, first, count = _node_arrays(bvh)
    n = count.shape[0]
    internal = np.nonzero(count == 0)[0]
    assert (name == "root_leaf") == (internal.size == 0)
    rec = np.zeros(n, np.int64)
    rec[internal] = 1 + np.arange(internal.size)
    nodes = bvh.walk_nodes.numpy()
    words = nodes.view(np.int32)
    assert nodes.shape == (1 + internal.size, 16)
    # record 0: the root and an empty leaf; record 1 + k: internal node k
    kids = np.stack([np.r_[0, internal + 1], np.r_[0, skip[internal + 1]]], 1)
    if bvh.pk_meta.shape[0] == n:
        np.testing.assert_array_equal(kids[1:, 1],
                                      bvh.pk_meta.numpy()[internal, 2])
    pad = float(walk_pad(nmin, nmax))
    assert pad == np.float32(2.0 ** -16 * max(np.abs(nmin[0]).max(),
                                               np.abs(nmax[0]).max()))
    for c in range(2):
        k = kids[:, c]
        lo, hi = nodes[:, 6 * c:6 * c + 3], nodes[:, 6 * c + 3:6 * c + 6]
        inner = count[k] == 0
        np.testing.assert_array_equal(_bits(lo[inner]), _bits(nmin[k][inner]))
        np.testing.assert_array_equal(_bits(hi[inner]), _bits(nmax[k][inner]))
        lo64, hi64 = (np.asarray(x, np.float64) for x in (lo, hi))
        want_lo = nmin[k].astype(np.float64) - pad
        want_hi = nmax[k].astype(np.float64) + pad
        assert (lo64[~inner] <= want_lo[~inner]).all()
        assert (hi64[~inner] >= want_hi[~inner]).all()
        np.testing.assert_array_equal(
            np.nextafter(lo[~inner], np.float32(np.inf)) > want_lo[~inner],
            True)
        np.testing.assert_array_equal(
            np.nextafter(hi[~inner], np.float32(-np.inf)) < want_hi[~inner],
            True)
        ref, cnt = words[:, 12 + c], words[:, 14 + c]
        if c == 1:
            assert (ref[0], cnt[0]) == (-1, 0)
            ref, cnt, k = ref[1:], cnt[1:], k[1:]
        leaf = count[k] > 0
        np.testing.assert_array_equal(ref < 0, leaf)
        np.testing.assert_array_equal(~ref[leaf], first[k][leaf])
        np.testing.assert_array_equal(cnt, count[k])
        np.testing.assert_array_equal(ref[~leaf], rec[k][~leaf])
    tris = bvh.walk_tris.numpy()
    assert tris.shape == (sc.num_triangles, 12)
    for c, x in enumerate((sc.tris.v0, sc.tris.e1, sc.tris.e2)):
        np.testing.assert_array_equal(_bits(tris[:, 4 * c:4 * c + 3]),
                                      _bits(x.numpy()))
        assert not tris[:, 4 * c + 3].any()


def test_walk_reaches_every_slot_once(scene):
    _, sc = scene
    nodes = sc.bvh.walk_nodes.numpy().view(np.int32)
    _, _, _, first, count = _node_arrays(sc.bvh)
    seen, todo = [], [0]
    while todo:
        w = nodes[todo.pop()]
        for ref, cnt in ((w[12], w[14]), (w[13], w[15])):
            if ref >= 0:
                todo.append(ref)
            else:
                seen.extend(range(~ref, ~ref + cnt))
    leaves = count > 0
    want = np.concatenate([np.arange(f, f + c) for f, c in
                           zip(first[leaves], count[leaves])])
    assert len(seen) == len(want) == count.sum()
    np.testing.assert_array_equal(np.sort(seen), np.sort(want))
    assert len(set(seen)) == len(seen)


def test_leaf_first_grows_with_dfs_order(scene):
    _, sc = scene
    _, _, _, first, count = _node_arrays(sc.bvh)
    leaves = np.nonzero(count > 0)[0]
    f, c = first[leaves], count[leaves]
    assert (np.diff(f) > 0).all()
    assert (f[:-1] + c[:-1] <= f[1:]).all()


def _scene_rays(name, n, seed):
    if name == "duplicates":
        return grid_edge_rays()
    if name.startswith("cornell"):
        return _rays(n, seed, [0.05, 0.05, 0.05], [0.95, 0.95, 0.95])
    return _rays(n, seed, BOX_LO, BOX_HI)


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_plain_equals_traverse_plain(scene, any_hit):
    name, sc = scene
    o, d = (torch.from_numpy(x) for x in _scene_rays(name, 3000, 11))
    r = o.shape[0]
    t_min = torch.full((r,), 1e-4)
    t_max = torch.full((r,), traverse.BIG)
    if any_hit:
        live = torch.from_numpy(np.random.default_rng(12).uniform(
            size=r) < 0.6)
        t_max = torch.where(live, 1.0 - 1e-4, 0.0)
        d = d * 1.5
    args = (sc.tris, sc.bvh, o, d, t_min, t_max, any_hit)
    work_w, work_p = {}, {}
    got = traverse.walk_plain(*args, work=work_w)
    want = traverse.traverse_plain(*args, work=work_p)
    if any_hit:
        live = t_max > t_min
        assert torch.equal(got[1][live] >= 0, want[1][live] >= 0)
        assert not bool((got[1][~live] >= 0).any())
        assert float((want[1][live] >= 0).float().mean()) > 0.05
    else:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert float((want[1] >= 0).float().mean()) > 0.2
    assert 0 < work_w["tris"] <= work_p["tris"]
    assert work_w["steps"] > 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_plain_reports_its_reads(scene, any_hit):
    """work["reads"] sees one record a step and one slot a triangle test,
    each named by the ray's index in o; only live rays read, and every
    hit's slot was read by its ray."""
    name, sc = scene
    o, d = (torch.from_numpy(x) for x in _scene_rays(name, 500, 13))
    r = o.shape[0]
    live = torch.from_numpy(np.random.default_rng(14).uniform(size=r) < 0.7)
    t_min = torch.full((r,), 1e-4)
    t_max = torch.where(live, traverse.BIG, 0.0)
    reads = {"records": [], "slots": []}

    def note(what, rid, ids):
        reads[what].append(torch.stack([rid, ids.long()], 1))

    work = {"reads": note}
    _, prim, _, _ = traverse.walk_plain(sc.tris, sc.bvh, o, d, t_min, t_max,
                                        any_hit, work=work)
    rec, slot = (torch.cat(reads[k]) for k in ("records", "slots"))
    assert rec.shape[0] == work["steps"] and slot.shape[0] == work["tris"]
    assert bool(live[rec[:, 0]].all()) and bool(live[slot[:, 0]].all())
    assert 0 <= int(rec[:, 1].min()) and int(rec[:, 1].max()) < (
        sc.bvh.walk_nodes.shape[0])
    assert 0 <= int(slot[:, 1].min()) and int(slot[:, 1].max()) < (
        sc.bvh.walk_tris.shape[0])
    hit = torch.nonzero(prim >= 0).squeeze(1)
    assert hit.numel() > 0
    pairs = set(map(tuple, slot.tolist()))
    assert all((int(i), int(prim[i])) in pairs for i in hit)


def test_walk_plain_matches_jax():
    js = procedural.box_field(num_boxes=200)
    ts = torch_scene_of(js)
    o, d = _rays(1500, 13, BOX_LO, BOX_HI)
    jh = jax_intersect.intersect_closest(js.tris, js.bvh, jnp.asarray(o),
                                         jnp.asarray(d), t_min=1e-4)
    r = o.shape[0]
    t, prim, u, _ = traverse.walk_plain(
        ts.tris, ts.bvh, torch.from_numpy(o), torch.from_numpy(d),
        torch.full((r,), 1e-4), torch.full((r,), traverse.BIG), False)
    _assert_closest_match(t.numpy(), prim.numpy(), np.asarray(jh.t),
                          np.asarray(jh.prim))
    m = np.asarray(jh.prim) == prim.numpy()
    np.testing.assert_allclose(u.numpy()[m], np.asarray(jh.u)[m],
                               rtol=1e-4, atol=1e-5)


def test_ties_take_the_least_slot():
    sc = duplicate_grid_scene("cpu")
    assert sc.num_triangles > 2048
    o, d = (torch.from_numpy(x) for x in grid_edge_rays())
    r = o.shape[0]
    args = (sc.tris, sc.bvh, o, d, torch.full((r,), 1e-4),
            torch.full((r,), traverse.BIG), False)
    got = traverse.walk_plain(*args)
    for g, w in zip(got, traverse.traverse_plain(*args)):
        assert torch.equal(g, w)
    hit = got[1] >= 0
    assert float(hit.float().mean()) > 0.9
    assert lower_of_duplicates(sc.tris, got[1][hit])


def test_walk_raises_above_stack_depth():
    sc = SCENES["box_field_200_jax"]()
    deep = dataclasses.replace(sc.bvh, depth=traverse.STACK_DEPTH)
    args = (sc.tris, deep, torch.zeros((4, 3)), torch.ones((4, 3)),
            torch.full((4,), 1e-4), torch.full((4,), traverse.BIG), False)
    for fn in (traverse.traverse_cuda, traverse.walk_plain):
        with pytest.raises(ValueError, match="depth"):
            fn(*args)
    traverse.walk_plain(sc.tris, dataclasses.replace(
        sc.bvh, depth=traverse.STACK_DEPTH - 1), *args[2:])
