"""The port's kernels on the card against their plain PyTorch versions: the
three traversal kernels (traverse.cu, packet7.cu, packet.cu) on the
box_field config's scene (24,010 triangles), and exactly against
traverse_plain on a 200-box field, on coincident duplicate triangles and
(all three) on rays aimed at triangle edges, among them leaf-box
silhouette grazes, where they equal traverse_plain on every ray (the
200-box field from the port's scene/procedural.py, the others made with
numpy here), and the VSL sample-loop kernel on a random
group of 8 records over 16,384 pixels made with numpy and on a group with
every lobe case it branches on (tests/torch_vsl_cases.py).  These tests
need a CUDA card and skip elsewhere; the file imports no JAX, so it runs
on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerance: closest hits agree prim for prim or tie in t at rtol 1e-4, with t
at rtol 1e-5 (the kernel is built with -fmad=false and rounds as the plain
ops do); any-hit results are equal on live lanes.  All three are also held
to traverse_plain exactly (t, prim, u, v equal; ties in t go to the least
slot).  The VSL kernel equals its plain version bit for bit: both round
op for op (-fmad=false, the same formulas and order), and the work the
kernel skips adds +0 exactly."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.integrators import vsl_kernel
from evplp_tpu_torch.scene import procedural
from evplp_tpu_torch.scene.camera import Camera
from evplp_tpu_torch.scene.config import load_config
from evplp_tpu_torch.scene.scene import build_scene
from evplp_tpu_torch.trace import packet, packet7, traverse
from torch_vsl_cases import mixed_lobe_group, strategy_counter

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "box_field", "box_field_ours.json")
N = 16384


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return load_config(CONFIG, device="cuda").scene


def _rays(scene, any_hit):
    gen = torch.Generator(device="cuda").manual_seed(7)
    lo = torch.tensor([0.2, 0.05, 0.2], device="cuda")
    hi = torch.tensor([3.8, 1.9, 3.8], device="cuda")
    o = lo + (hi - lo) * torch.rand((N, 3), generator=gen, device="cuda")
    d = torch.randn((N, 3), generator=gen, device="cuda")
    t_min = torch.full((N,), 1e-4, device="cuda")
    t_max = torch.full((N,), traverse.BIG, device="cuda")
    if any_hit:
        live = torch.rand((N,), generator=gen, device="cuda") < 0.5
        t_max = torch.where(live, 1.0 - 1e-4, 0.0)
    return scene.tris, scene.bvh, o, d, t_min, t_max, any_hit


def _quads(quads):
    """Positions and indices of quads (p0, p1, p2, p3), two triangles
    each."""
    pos = np.asarray(quads, np.float32).reshape(-1, 3)
    tri = np.array([[0, 1, 2], [0, 2, 3]])
    idx = (4 * np.arange(len(quads))[:, None, None] + tri).reshape(-1, 3)
    return pos, idx


def _scene(meshes, device):
    """A scene of the meshes (positions, indices), grey, with a small light
    quad at y = 2.5."""
    light = _quads([[[1.6, 2.5, 1.6], [2.4, 2.5, 1.6], [2.4, 2.5, 2.4],
                     [1.6, 2.5, 2.4]]])
    cam = Camera(origin=(2.0, 1.2, 7.0), look_at=(2.0, 0.8, 0.0),
                 up=(0.0, 1.0, 0.0), fovy=0.6, aspect=1.0)
    k = len(meshes)
    return build_scene([m[0] for m in meshes], [m[1] for m in meshes],
                       [(0.5, 0.5, 0.5)] * k, [(0.0, 0.0, 0.0)] * k,
                       [0.0] * k, light[0], light[1], (10.0, 10.0, 10.0),
                       cam, device=device)


def box_field_scene(num_boxes, device, seed=0):
    """The room and boxes of procedural.box_field_spec(num_boxes, seed)
    (200 boxes: 2,410 triangles), grey, with this file's light quad at
    y = 2.5 and camera (_scene).  Its arrays equal, bit for bit, those of
    the numpy field this function built before it took the spec's
    geometry.  procedural.box_field itself differs in its light quad
    (y = 1.99), materials and camera, which move the BVH; the rays that
    tests/test_torch_packet_walk.py names for fault 6 belong to this
    BVH."""
    spec = procedural.box_field_spec(num_boxes, seed)
    return _scene([(g[1], g[2]) for g in spec["groups"]], device)


def duplicate_grid_scene(device, n=24):
    """n x n unit-square quads on the plane y = 0 over [0, 4]^2, each of
    their 2 n^2 triangles twice, as two meshes (coincident duplicates in
    other slots; 2,306 triangles for n = 24)."""
    x = np.linspace(0.0, 4.0, n + 1, dtype=np.float32)
    quads = [([x[i], 0, x[j]], [x[i + 1], 0, x[j]], [x[i + 1], 0, x[j + 1]],
              [x[i], 0, x[j + 1]]) for i in range(n) for j in range(n)]
    grid = _quads(quads)
    return _scene([grid, grid], device)


def grid_edge_rays(n=24, seed=5):
    """Rays from above, tilted at random, aimed at the grid's inner
    vertices, edge midpoints and diagonal midpoints (points shared by two
    or more triangles): (o, d) float32."""
    rs = np.random.default_rng(seed)
    h = 4.0 / n
    g = np.arange(1, n) * h
    pts = np.concatenate([np.stack(np.meshgrid(g + a, g + b), -1).reshape(
        -1, 2) for a, b in ((0, 0), (h / 2, 0), (0, h / 2), (h / 2, h / 2))])
    target = np.stack([pts[:, 0], np.zeros(len(pts)), pts[:, 1]], -1)
    tilt = rs.uniform(0.05, 0.3, (len(pts), 2)) * rs.choice([-1, 1],
                                                          (len(pts), 2))
    o = target + np.stack([tilt[:, 0], np.full(len(pts), 1.5), tilt[:, 1]],
                          -1)
    return o.astype(np.float32), (target - o).astype(np.float32)


def edge_rays(scene, n, seed):
    """Rays from random points of the 4 x 2 x 4 room aimed at random points
    of random triangle edges (many graze a box's silhouette or a leaf box's
    face): (o, d) float32."""
    rs = np.random.default_rng(seed)
    k = rs.integers(0, scene.num_triangles, n)
    v0, e1, e2 = (x.cpu().numpy()[k] for x in (scene.tris.v0, scene.tris.e1,
                                               scene.tris.e2))
    s = rs.uniform(0.05, 0.95, (n, 1)).astype(np.float32)
    side = rs.integers(0, 3, n)[:, None]
    p = np.where(side == 0, v0 + s * e1,
                 np.where(side == 1, v0 + s * e2, v0 + e1 + s * (e2 - e1)))
    o = rs.uniform([0.1, 0.1, 0.1], [3.9, 1.9, 3.9], (n, 3))
    return o.astype(np.float32), (p - o).astype(np.float32)


def silhouette_grazes(bvh, o, d, t, prim):
    """Rays whose hit triangle's leaf box the exact slab test rejects at
    every t (t_near > t_far, or t_far < 0): the ray grazes the box's
    silhouette."""
    leaf = torch.nonzero(bvh.node_count > 0).squeeze(1)
    j = torch.searchsorted(bvh.node_first[leaf], prim.clamp_min(0),
                           right=True) - 1
    node = leaf[j]
    inv = traverse.inv_dir(d)
    t0 = (bvh.node_min[node] - o) * inv
    t1 = (bvh.node_max[node] - o) * inv
    near = torch.amax(torch.minimum(t0, t1), dim=1)
    far = torch.amin(torch.maximum(t0, t1), dim=1)
    return (prim >= 0) & ~((near <= far) & (far >= 0.0))


def lower_of_duplicates(tris, prim) -> bool:
    """Whether each prim has exactly one coincident duplicate and is the
    lower slot of the two."""
    p = prim.long()
    same = ((tris.v0[None] == tris.v0[p][:, None]).all(-1)
            & (tris.e1[None] == tris.e1[p][:, None]).all(-1)
            & (tris.e2[None] == tris.e2[p][:, None]).all(-1))
    return bool((same.sum(1) == 2).all()) and bool(
        (same.int().argmax(1) == p).all())


# (module, dispatching wrapper, plain version) of each traversal kernel
TRAVERSALS = {
    "traverse": (traverse, traverse.traverse, traverse.traverse_plain),
    "packet7": (packet7, packet7.packet7_trace, packet7.packet7_plain),
    "packet": (packet, packet.packet_trace, packet.packet_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(TRAVERSALS))
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain(scene, any_hit, kernel):
    mod, wrapper, plain = TRAVERSALS[kernel]
    args = _rays(scene, any_hit)
    before = mod.launches
    t_k, p_k, _, _ = wrapper(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    t_p, p_p, _, _ = plain(*args)
    p_k, p_p = p_k.cpu().numpy(), p_p.cpu().numpy()
    if any_hit:
        live = (args[5] > args[4]).cpu().numpy()
        np.testing.assert_array_equal(p_k[live] >= 0, p_p[live] >= 0)
        return
    t_k, t_p = t_k.cpu().numpy(), t_p.cpu().numpy()
    assert ((p_k >= 0) == (p_p >= 0)).all()
    m = p_p >= 0
    assert ((p_k[m] == p_p[m]) | np.isclose(t_k[m], t_p[m], rtol=1e-4)).all()
    np.testing.assert_allclose(t_k, t_p, rtol=1e-5)
    assert m.mean() > 0.5


@pytest.fixture(scope="module")
def box_field_200():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return box_field_scene(200, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_equals_plain_exactly(box_field_200, any_hit):
    args = _rays(box_field_200, any_hit)
    t_k, p_k, u_k, v_k = traverse.traverse_cuda(*args)
    t_p, p_p, u_p, v_p = traverse.traverse_plain(*args)
    if any_hit:
        live = args[5] > args[4]
        assert torch.equal(p_k[live] >= 0, p_p[live] >= 0)
        assert 0.1 < float((p_p[live] >= 0).float().mean()) < 0.9
        return
    assert float((p_p >= 0).float().mean()) > 0.5
    for got, want in ((t_k, t_p), (p_k, p_p), (u_k, u_p), (v_k, v_p)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_traverse_kernel_ties_take_the_least_slot():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scene = duplicate_grid_scene("cuda")
    o, d = (torch.from_numpy(x).cuda() for x in grid_edge_rays())
    r = o.shape[0]
    args = (scene.tris, scene.bvh, o, d, torch.full((r,), 1e-4,
                                                    device="cuda"),
            torch.full((r,), traverse.BIG, device="cuda"), False)
    t_k, p_k, u_k, v_k = traverse.traverse_cuda(*args)
    t_p, p_p, u_p, v_p = traverse.traverse_plain(*args)
    for got, want in ((t_k, t_p), (p_k, p_p), (u_k, u_p), (v_k, v_p)):
        assert torch.equal(got, want)
    hit = p_k >= 0
    assert float(hit.float().mean()) > 0.9
    assert lower_of_duplicates(scene.tris, p_k[hit])


# the wrappers of the two packet kernels, held to traverse_plain exactly
PACKET_KERNELS = {"packet7": packet7.packet7_cuda,
                  "packet": packet.packet_cuda}


def _assert_same_hits(got, want, t_min, t_max, any_hit):
    if any_hit:
        live = t_max > t_min
        assert torch.equal(got[1][live] >= 0, want[1][live] >= 0)
        assert not bool((got[1][~live] >= 0).any())
        return
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(PACKET_KERNELS))
@pytest.mark.parametrize("any_hit", [False, True])
def test_packet_kernels_equal_traverse_plain_exactly(box_field_200, kernel,
                                                     any_hit):
    args = _rays(box_field_200, any_hit)
    got = PACKET_KERNELS[kernel](*args)
    _assert_same_hits(got, traverse.traverse_plain(*args), args[4], args[5],
                      any_hit)
    _assert_same_hits(got, TRAVERSALS[kernel][2](*args), args[4], args[5],
                      any_hit)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(PACKET_KERNELS))
def test_packet_kernels_ties_take_the_least_slot(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scene = duplicate_grid_scene("cuda")
    o, d = (torch.from_numpy(x).cuda() for x in grid_edge_rays())
    r = o.shape[0]
    args = (scene.tris, scene.bvh, o, d, torch.full((r,), 1e-4,
                                                    device="cuda"),
            torch.full((r,), traverse.BIG, device="cuda"), False)
    got = PACKET_KERNELS[kernel](*args)
    _assert_same_hits(got, traverse.traverse_plain(*args), *args[4:])
    hit = got[1] >= 0
    assert float(hit.float().mean()) > 0.9
    assert lower_of_duplicates(scene.tris, got[1][hit])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(PACKET_KERNELS))
def test_packet_kernels_keep_leaf_box_grazes(box_field_200, kernel):
    o, d = (torch.from_numpy(x).cuda() for x in edge_rays(box_field_200,
                                                          4096, 1))
    r = o.shape[0]
    args = (box_field_200.tris, box_field_200.bvh, o, d,
            torch.full((r,), 1e-4, device="cuda"),
            torch.full((r,), traverse.BIG, device="cuda"), False)
    want = traverse.traverse_plain(*args)
    got = PACKET_KERNELS[kernel](*args)
    # the padded leaf boxes (accel/bvh.py:walk_pad) keep every graze
    _assert_same_hits(got, traverse.traverse_cuda(*args), *args[4:])
    assert int(silhouette_grazes(box_field_200.bvh, o, d, want[0],
                                 want[1]).sum()) > 20
    _assert_same_hits(got, want, *args[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(TRAVERSALS))
@pytest.mark.parametrize("seed", [1, 2])
def test_kernels_keep_every_leaf_box_graze(box_field_200, kernel, seed):
    """The rays of tests/test_torch_packet_walk.py::
    test_leaf_box_grazes_keep_their_hits: each kernel equals traverse_plain
    on every one of them (t, prim, u, v), 0 rays differing."""
    o, d = (torch.from_numpy(x).cuda() for x in edge_rays(box_field_200,
                                                          4096, seed))
    r = o.shape[0]
    args = (box_field_200.tris, box_field_200.bvh, o, d,
            torch.full((r,), 1e-4, device="cuda"),
            torch.full((r,), traverse.BIG, device="cuda"), False)
    want = traverse.traverse_plain(*args)
    got = dict(PACKET_KERNELS, traverse=traverse.traverse_cuda)[kernel](*args)
    differing = (got[0] != want[0]) | (got[1] != want[1])
    assert int(differing.sum()) == 0
    _assert_same_hits(got, want, *args[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("cuda_fn", [traverse.traverse_cuda,
                                     packet7.packet7_cuda,
                                     packet.packet_cuda])
def test_wrapper_rejects_bad_inputs(scene, cuda_fn):
    tris, bvh, o, d, t_min, t_max, _ = _rays(scene, False)
    with pytest.raises(TypeError):
        cuda_fn(tris, bvh, o.double(), d, t_min, t_max, False)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fn(tris, bvh, o.t().contiguous().t(), d, t_min, t_max, False)
    with pytest.raises(ValueError, match="shape"):
        cuda_fn(tris, bvh, o, d, t_min[:-1], t_max, False)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fn(tris, bvh, o.cpu(), d.cpu(), t_min.cpu(), t_max.cpu(), False)


@pytest.mark.cuda
def test_packet_wrappers_reject_bad_scenes(scene):
    tris, bvh, o, d, t_min, t_max, _ = _rays(scene, False)
    for fn, mod in ((traverse.traverse_cuda, traverse),
                    (packet7.packet7_cuda, packet7),
                    (packet.packet_cuda, packet)):
        deep = dataclasses.replace(bvh, depth=mod.STACK_DEPTH)
        with pytest.raises(ValueError, match="depth"):
            fn(tris, deep, o, d, t_min, t_max, False)
    unpacked = dataclasses.replace(bvh, pk_meta=bvh.pk_meta[:1])
    with pytest.raises(ValueError, match="packed layout"):
        packet7.packet7_cuda(tris, unpacked, o, d, t_min, t_max, False)
    with pytest.raises(TypeError):
        packet7.packet7_cuda(tris, dataclasses.replace(
            bvh, pk_meta=bvh.pk_meta.long()), o, d, t_min, t_max, False)


@pytest.fixture(scope="module")
def vsl_group():
    """Kernel arguments for G = 8 records over 16,384 pixels (numpy seed 3),
    with 7 black pixels and ~80% of the gate bits set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rs = np.random.default_rng(3)
    n, g = 16384, 8

    def unit(k):
        v = rs.normal(size=(k, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    pos = cuda(rs.uniform(-2, 2, (n, 3)))
    kd = rs.uniform(0, 0.6, (n, 3))
    ks = rs.uniform(0, 0.3, (n, 3))
    kd[:7] = ks[:7] = 0.0
    wi10 = mu.normalize(cuda([0.0, 0.0, 6.0])[None] - pos)
    pix = vsl_kernel.pack_pixels(pos, cuda(unit(n)), cuda(kd), cuda(ks),
                                 cuda(rs.uniform(1, 64, n)), wi10)
    recs = dict(pos=cuda(rs.uniform(-3, 3, (g, 3))), normal=cuda(unit(g)),
                flux_dir=cuda(unit(g)), flux=cuda(rs.uniform(0, 2, (g, 3))),
                kd=cuda(rs.uniform(0, 0.7, (g, 3))),
                ks=cuda(rs.uniform(0, 0.3, (g, 3))),
                ns=cuda(rs.uniform(1, 32, g)))
    r = cuda(0.4)
    gates = rs.uniform(size=(g, n)) < 0.8
    mask = (gates.astype(np.int64) << np.arange(g)[:, None]).sum(0)
    cos_half, counts = vsl_kernel.ctx_planes(pos, recs["pos"], r)
    table = vsl_kernel.pack_records(
        recs, torch.tensor(mu.INV_PI, device="cuda") / (r * r))
    return [pix, cuda(np.arange(n) + 1000, torch.int32),
            cuda(mask, torch.int32), cos_half, counts, table, 0xDEADBEEF, 17,
            3]


@pytest.mark.cuda
def test_vsl_kernel_matches_plain(vsl_group):
    before = vsl_kernel.launches
    got = vsl_kernel.vsl_sample_group(*vsl_group)
    torch.cuda.synchronize()
    assert vsl_kernel.launches == before + 1
    want = vsl_kernel.vsl_sample_group_plain(*vsl_group)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert want.max() > 0.0 and (got[:7] == 0.0).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("records", [7, vsl_kernel.MAX_GROUP])
def test_vsl_kernel_mixed_lobes_bit_equal(records):
    """Diffuse, green-only phong and kd == 0 pixels and records, black
    pixels and a black record: the kernel's lobe and guard branches give
    the plain version's bits, and every strategy contributes; also for the
    largest group a call takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = mixed_lobe_group(g=records)

    def cuda(x):
        return torch.from_numpy(np.asarray(x)).to("cuda")

    px = {k: cuda(v) for k, v in s["px"].items()}
    recs = {k: cuda(v) for k, v in s["recs"].items()}
    r = cuda(s["radius"])
    wi10 = mu.normalize(cuda(s["cam"])[None] - px["position"])
    cos_half, counts = vsl_kernel.ctx_planes(px["position"], recs["pos"], r)
    args = [vsl_kernel.pack_pixels(px["position"], px["normal"], px["kd"],
                                   px["ks"], px["ns"], wi10),
            cuda(s["pids"]), cuda(s["mask"]), cos_half, counts,
            vsl_kernel.pack_records(
                recs, torch.tensor(mu.INV_PI, device="cuda") / (r * r)),
            0xDEADBEEF, 17, 3]
    got = vsl_kernel.vsl_sample_group_cuda(*args).cpu().numpy()
    observe, hits = strategy_counter()
    want = vsl_kernel.vsl_sample_group_plain(*args, observe=observe)
    want = want.cpu().numpy()
    assert min(hits.values()) > 0, hits
    assert want.max() > 0.0 and (got[:3] == 0.0).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_vsl_wrapper_rejects_bad_inputs(vsl_group):
    def call(i, x):
        args = list(vsl_group)
        args[i] = x
        return vsl_kernel.vsl_sample_group_cuda(*args)

    pix, pids, mask, cos_half, counts, table = vsl_group[:6]
    with pytest.raises(TypeError):
        call(4, counts.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        call(3, cos_half[:, 1:].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(0, pix.T.contiguous().T)
    with pytest.raises(ValueError, match="expected"):
        call(1, pids.cpu())
    with pytest.raises(ValueError, match="records"):
        call(5, table.repeat(5, 1))


@pytest.mark.cuda
def test_binned_splat_is_deterministic(scene):
    """The binned photon splat gives the same image bit for bit on every
    run (its tile sums are ordered), which a resumed progressive run needs
    to equal one without a break."""
    from evplp_tpu_torch.core.sampling import iteration_key
    from evplp_tpu_torch.integrators.gbuffer import trace_gbuffer
    from evplp_tpu_torch.integrators.light_trace import trace_light_paths
    from evplp_tpu_torch.integrators.photon_splat import photon_splat_binned
    sc = scene
    gbuf = trace_gbuffer(sc, 160, 90, None)
    pm = trace_light_paths(sc, iteration_key(0, 5, "cuda"), 20_000, 4)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda")
    args = (sc, gbuf, pm, f32(0.05), 4, f32(0.3), f32(1.0 / sc.total_area),
            1.0 / 20_000, 160, 90)
    first, dropped = photon_splat_binned(*args)
    assert int(dropped) == 0 and float(first.abs().max()) > 0.0
    for _ in range(3):
        assert torch.equal(photon_splat_binned(*args)[0], first)
