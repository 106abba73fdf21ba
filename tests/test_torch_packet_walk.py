"""The walks of the two packet kernels on the CPU: `trace/packet.py:
packet_plain` (csrc/packet.cu, warp packets over the walk records with
single-ray walks where fewer than SOLO rays want a node) and
`trace/packet7.py:packet7_plain` (csrc/packet7.cu, the ordered one-ray step
as a warp-wide inner loop, then each ray's drain), each taking its kernel's
steps in plain PyTorch.

* Both equal `traverse_plain` exactly: t bit for bit, prim, u and v (any
  hit: the occlusion of live lanes; lanes with t_max <= t_min report t_max
  and prim -1), on box_field_200 (from the JAX package and built by the
  port), random triangles, coincident duplicates, a scene whose root is a
  leaf and (packet only: packet7 raises on the dense path's scene, which
  has no packed layout) cornell; on the duplicates each hit is the lower
  slot of its pair.
* On rays aimed at triangle edges of a 200-box field (seeds 1 and 2), of
  which many graze a leaf box's silhouette (its exact slab test rejects it
  at every t), walk_plain (kernel #1's walk) and both equal traverse_plain
  on every ray: the walk records' boxes are padded in space
  (accel/bvh.py:walk_pad), so no graze is lost.
* On a few rays of other seeds (3 of 8,192 at seeds 17 and 24), all
  three walks find a hit one or two float32 steps nearer than
  traverse_plain, which culls it at a near-tie in its DFS order (fault 6);
  the test names those rays and holds the rest exactly.
* packet_plain is exact at every SOLO threshold (0: a pure packet; 32, the
  kernel's: packet steps only where every lane wants the node; 33: all
  single-ray walks).
* The counts: packet7 takes walk_plain's steps and triangle tests, one for
  one (each ray drains exactly where its own queue fills or its walk
  ends; only the warp's schedule differs); the packet's node efficiency
  lies in (0, 1].
* On the JAX package's pack-only BVH, whose triangles keep the leaf order
  of its SAH build, packet7 reports the packed layout's slots, which name
  traverse_plain's triangles.
* Both raise on a tree deeper than the stack."""
import dataclasses

import numpy as np
import pytest
import torch

from evplp_tpu_torch.trace import packet, packet7, traverse
from tests.test_torch_cuda import (_scene, box_field_scene,
                                   duplicate_grid_scene, edge_rays,
                                   grid_edge_rays, lower_of_duplicates,
                                   silhouette_grazes)
from tests.test_torch_packet import _jax_rays, _jax_v1_scene
from tests.test_torch_walk import SCENES, _scene_rays

WALKS = {"packet": packet.packet_plain, "packet7": packet7.packet7_plain}


def _random_scene():
    """3,000 random triangles in the 4 x 2 x 4 room (numpy seed 7)."""
    rs = np.random.default_rng(7)
    base = rs.uniform([0.2, 0.1, 0.2], [3.8, 1.9, 3.8], (3000, 3))
    pos = np.concatenate([base, base + rs.normal(0, 0.1, (3000, 3)),
                          base + rs.normal(0, 0.1, (3000, 3))], axis=1)
    pos = pos.reshape(-1, 3).astype(np.float32)
    return _scene([(pos, np.arange(pos.shape[0]).reshape(-1, 3))], "cpu")


ALL_SCENES = dict(SCENES, random_3000=_random_scene)


@pytest.fixture(scope="module", params=sorted(ALL_SCENES))
def scene(request):
    return request.param, ALL_SCENES[request.param]()


def _packed(sc) -> bool:
    return sc.bvh.pk_meta.shape[0] == sc.bvh.node_min.shape[0]


def _args(name, sc, any_hit):
    """The rays of test_torch_walk, with every seventh lane dead
    (t_max <= t_min)."""
    o, d = (torch.from_numpy(x) for x in _scene_rays(
        "box_field" if name == "random_3000" else name, 3000, 11))
    r = o.shape[0]
    t_min = torch.full((r,), 1e-4)
    t_max = torch.full((r,), traverse.BIG)
    if any_hit:
        live = torch.from_numpy(np.random.default_rng(12).uniform(
            size=r) < 0.6)
        t_max = torch.where(live, 1.0 - 1e-4, 0.0)
        d = d * 1.5
    dead = torch.arange(r) % 7 == 0
    t_max = torch.where(dead, t_min, t_max)
    return sc.tris, sc.bvh, o, d, t_min, t_max, any_hit


def _assert_same(got, want, t_min, t_max, any_hit):
    live = t_max > t_min
    assert torch.equal(got[0][~live], t_max[~live])
    assert bool((got[1][~live] == -1).all())
    if any_hit:
        assert torch.equal(got[1][live] >= 0, want[1][live] >= 0)
        return
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("walk", sorted(WALKS))
@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_equals_traverse_plain(scene, walk, any_hit):
    name, sc = scene
    args = _args(name, sc, any_hit)
    if walk == "packet7" and not _packed(sc):
        # the dense path's scene: packet7 needs the packed layout
        with pytest.raises(ValueError, match="packed layout"):
            WALKS[walk](*args)
        return
    want = traverse.traverse_plain(*args)
    work = {}
    got = WALKS[walk](*args, work=work)
    _assert_same(got, want, *args[4:])
    hits = float((want[1] >= 0).float().mean())
    assert hits > (0.05 if any_hit else 0.2)
    assert 0 < work["tris"] and 0 < work["steps"]


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_ties_take_the_least_slot(walk):
    sc = duplicate_grid_scene("cpu")
    o, d = (torch.from_numpy(x) for x in grid_edge_rays())
    r = o.shape[0]
    args = (sc.tris, sc.bvh, o, d, torch.full((r,), 1e-4),
            torch.full((r,), traverse.BIG), False)
    got = WALKS[walk](*args)
    _assert_same(got, traverse.traverse_plain(*args), *args[4:])
    hit = got[1] >= 0
    assert float(hit.float().mean()) > 0.9
    assert lower_of_duplicates(sc.tris, got[1][hit])


@pytest.fixture(scope="module", params=[1, 2])
def grazes(request):
    sc = box_field_scene(200, "cpu")
    o, d = (torch.from_numpy(x) for x in edge_rays(sc, 4096, request.param))
    r = o.shape[0]
    args = (sc.tris, sc.bvh, o, d, torch.full((r,), 1e-4),
            torch.full((r,), traverse.BIG), False)
    want = traverse.traverse_plain(*args)
    graze = silhouette_grazes(sc.bvh, o, d, want[0], want[1])
    return args, want, graze, traverse.walk_plain(*args)


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_leaf_box_grazes_keep_their_hits(grazes, walk):
    args, want, graze, ordered = grazes
    got = WALKS[walk](*args)
    _assert_same(got, ordered, *args[4:])
    beyond = (ordered[0] != want[0]) | (ordered[1] != want[1])
    assert int(beyond.sum()) == 0
    assert int(graze.sum()) > 20
    _assert_same(got, want, *args[4:])
    _assert_same(ordered, want, *args[4:])


# (seed -> rays) of edge_rays(box_field_scene(200), 4096, seed) on which the
# walks find a hit one or two float32 steps nearer than traverse_plain:
# Moller-Trumbore places it just before the t_near of an internal box that
# the skip-pointer walk, in its DFS order, culls at its current t, while
# the near-first walks test that box first (ROADMAP queue 3, fault 6)
NEARER_THAN_REFERENCE = {17: [2582, 3388], 24: [1611]}


@pytest.mark.parametrize("seed", sorted(NEARER_THAN_REFERENCE))
def test_walks_keep_hits_the_reference_culls_at_ties(seed):
    sc = box_field_scene(200, "cpu")
    o, d = (torch.from_numpy(x) for x in edge_rays(sc, 4096, seed))
    r = o.shape[0]
    args = (sc.tris, sc.bvh, o, d, torch.full((r,), 1e-4),
            torch.full((r,), traverse.BIG), False)
    want = traverse.traverse_plain(*args)
    for walk in (traverse.walk_plain, *WALKS.values()):
        got = walk(*args)
        differing = (got[0] != want[0]) | (got[1] != want[1])
        rays = torch.nonzero(differing).squeeze(1)
        assert rays.tolist() == NEARER_THAN_REFERENCE[seed]
        assert bool((want[1][rays] >= 0).all() & (got[1][rays] >= 0).all())
        steps = (want[0][rays].view(torch.int32)
                 - got[0][rays].view(torch.int32))
        assert bool(((steps >= 1) & (steps <= 2)).all())
        keep = ~differing
        _assert_same(tuple(x[keep] for x in got),
                     tuple(x[keep] for x in want), args[4][keep],
                     args[5][keep], False)


@pytest.mark.parametrize("solo", [0, 4, 16, 32, 33])
def test_packet_exact_at_every_solo_threshold(monkeypatch, solo):
    monkeypatch.setattr(packet, "SOLO", solo)
    for sc, (o, d) in ((SCENES["box_field_200_port"](),
                        _scene_rays("box_field", 1500, 3)),
                       (duplicate_grid_scene("cpu"), grid_edge_rays())):
        o, d = torch.from_numpy(o), torch.from_numpy(d)
        r = o.shape[0]
        args = (sc.tris, sc.bvh, o, d, torch.full((r,), 1e-4),
                torch.full((r,), traverse.BIG), False)
        work = {}
        got = packet.packet_plain(*args, work=work)
        _assert_same(got, traverse.traverse_plain(*args), *args[4:])
        assert (work.get("solo_walks", 0) > 0) == (solo > 0)
        if solo <= 32:
            assert 0 < work["lane_packet_steps"] <= 32 * work["packet_steps"]


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_counts(any_hit):
    sc = SCENES["box_field_200_port"]()
    args = _args("box_field_200_port", sc, any_hit)
    ordered, p7, pk = {}, {}, {}
    traverse.walk_plain(*args, work=ordered)
    packet7.packet7_plain(*args, work=p7)
    packet.packet_plain(*args, work=pk)
    assert p7["steps"] == ordered["steps"]
    assert p7["tris"] == ordered["tris"]
    assert p7["drain_paid"] >= p7["tris"]
    assert 32 * p7["inner_iters"] >= p7["steps"]
    assert pk.get("lane_packet_steps", 0) <= 32 * pk.get("packet_steps", 0)
    assert pk["steps"] > 0 and pk["solo_walks"] > 0


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_walk_raises_above_stack_depth(walk):
    sc = SCENES["box_field_200_jax"]()
    deep = dataclasses.replace(sc.bvh, depth=traverse.STACK_DEPTH)
    args = (sc.tris, deep, torch.zeros((4, 3)), torch.ones((4, 3)),
            torch.full((4,), 1e-4), torch.full((4,), traverse.BIG), False)
    with pytest.raises(ValueError, match="depth"):
        WALKS[walk](*args)
    WALKS[walk](sc.tris, dataclasses.replace(
        sc.bvh, depth=traverse.STACK_DEPTH - 1), *args[2:])


def test_packet7_reports_slots_on_a_pack_only_bvh():
    """On the JAX package's pack-only BVH (triangles in the leaf order of
    its SAH build, not slot order) packet7 reports the packed layout's
    slots, and they name traverse_plain's triangles; the port's own BVHs
    are slot-ordered."""
    assert _random_scene().bvh.slot_order
    _, _, tt, tb = _jax_v1_scene(400, 3)
    assert not tb.slot_order
    o, d = (torch.from_numpy(x) for x in _jax_rays(500, 4))
    r = o.shape[0]
    args = (tt, tb, o, d, torch.full((r,), 1e-4),
            torch.full((r,), traverse.BIG), False)
    t, slot, u, v = packet7.packet7_plain(*args)
    want = traverse.traverse_plain(*args)
    prim = torch.where(slot >= 0, tb.pk_prim_map[slot.clamp_min(0).long()],
                       -1)
    assert float((want[1] >= 0).float().mean()) > 0.1
    for g, w in zip((t, prim, u, v), want):
        assert torch.equal(g, w)
