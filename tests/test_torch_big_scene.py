"""The large-scene tier against the JAX package: box_field_big (25,000
boxes at constant density, 300,010 triangles), the first procedural scene
above BIG_SCENE_TRIS = 280,000, so both packages build it with 42-triangle
leaves and fused node rows, and every cast on it takes kernel #1's path
(trace/intersect.py:traversal_impl).  The scene is built once per package.

* The build: the slot-ordered arrays, the node arrays, the packed rows,
  rpl and fused_nodes equal bit for bit (array_equal, as
  tests/test_torch_scene.py holds the smaller scenes); the port's walk
  records (accel/bvh.py:walk_layout), walked from the super-root, give the
  JAX BVH's internal boxes bit for bit and its leaves' (first, count) in
  DFS order, each leaf box holding the exact one.
* The casts: 1,024 camera rays, 1,024 cosine bounce rays from their hits
  and 1,024 shadow segments from those hits to points on the light,
  through the JAX intersect_closest / intersect_any (its CPU walk,
  `_traverse_one`) and the port's (traverse_plain on the CPU): prims and
  any-hit flags equal, no ray excepted; t at rtol 1e-6 (it comes out bit
  for bit).  u and v: bit for bit the JAX `_ray_tri` run op by op on each
  hit's triangle, within twice Moller-Trumbore's float32 rounding bound
  of the float64 values, and against the jitted JAX walk at rtol 1e-6 or,
  where the bound exceeds that, within twice the bound (ROADMAP fault 8:
  XLA fuses the jitted `_ray_tri`'s multiply-adds, which `_ray_tri_fma`
  reproduces; `python -m tests.test_torch_big_scene` prints the witness).
* The frame: one "ours" photon_fam_frame at 32x18 against the jitted JAX
  frame at the goldens' tolerance (rtol 2e-3, atol 2e-4), no pixel
  excepted.
* AnimationCamera against the JAX class, on the cases of
  tests/test_misc_parity.py and on seeded times before 0, inside and past
  the total.

On the CPU the port takes its plain walks; kernel #1 is held to
traverse_plain on these scenes on the card, by chip_smoke.py's big_scene
phase."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.core.sampling import iteration_key as jax_iteration_key
from evplp_tpu.integrators import photon_fam as jpf
from evplp_tpu.scene import procedural as jax_procedural
from evplp_tpu.scene.camera import AnimationCamera as JaxAnimationCamera
from evplp_tpu.scene.camera import Camera as JaxCamera
from evplp_tpu.trace import intersect as jax_intersect
from evplp_tpu_torch.accel.bvh import pad_boxes, walk_pad
from evplp_tpu_torch.core import mathutil as mu
from evplp_tpu_torch.core.light import light_sample
from evplp_tpu_torch.core.sampling import iteration_key
from evplp_tpu_torch.integrators import photon_fam
from evplp_tpu_torch.scene import procedural
from evplp_tpu_torch.scene.camera import AnimationCamera, Camera
from evplp_tpu_torch.scene.scene import BIG_SCENE_TRIS, scene_arrays
from evplp_tpu_torch.trace import intersect
from evplp_tpu_torch.trace.traverse import STACK_DEPTH
from tests.test_torch_scene import _assert_same_scene, jax_scene_arrays

CAST_RAYS = (32, 32)      # camera rays (W, H): 1,024 rays of each kind
SEED = 7
# rays of each cast kind allowed to differ, named by index (none so far)
CAST_EXCEPTIONS = {"camera": set(), "bounce": set(), "shadow": set()}
# pixels (row, col) of the frame allowed outside the goldens' tolerance
FRAME_EXCEPTIONS: set = set()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its plain walks are
    thousands of small operations, which more threads only slow when the
    suite's workers share the cores (15x on the camera cast)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def big():
    """(JAX scene, port scene) of box_field_big, both on the CPU."""
    return (jax_procedural.box_field_big(),
            procedural.box_field_big(device="cpu"))


def test_build_matches_jax(big):
    js, ts = big
    real = int((ts.tri_shade[:, 0:3].abs().sum(1) > 0).sum())
    assert real > BIG_SCENE_TRIS
    assert ts.bvh.fused_nodes and js.bvh.fused_nodes
    assert ts.bvh.rpl == js.bvh.rpl == 3
    assert int(ts.bvh.node_count.max()) == 42
    _assert_same_scene(jax_scene_arrays(js), scene_arrays(ts))


def test_walk_records_reproduce_the_jax_tree(big):
    js, ts = big
    nmin, nmax = np.asarray(js.bvh.node_min), np.asarray(js.bvh.node_max)
    count = np.asarray(js.bvh.node_count)
    first = np.asarray(js.bvh.node_first)
    nodes = ts.bvh.walk_nodes.numpy()
    words = nodes.view(np.int32)
    lo, hi = pad_boxes(nmin, nmax, walk_pad(nmin, nmax))
    # walk the records depth first from the super-root's left child,
    # left before right, as the JAX node arrays are laid out
    seen, stack, depth = [], [(0, 0, 0)], 0
    while stack:
        rec, c, level = stack.pop()
        depth = max(depth, level)
        box = nodes[rec, 6 * c:6 * c + 6]
        ref, n = words[rec, 12 + c], words[rec, 14 + c]
        seen.append((ref < 0, box, ~ref if ref < 0 else -1, n))
        if ref >= 0:
            stack += [(ref, 1, level + 1), (ref, 0, level + 1)]
    assert len(seen) == nmin.shape[0]
    for i, (leaf, box, f, n) in enumerate(seen):
        assert leaf == (count[i] > 0), i
        if leaf:
            assert (f, n) == (first[i], count[i]), i
            np.testing.assert_array_equal(box, np.concatenate(
                [lo[i], hi[i]]), err_msg=str(i))
            assert (box[:3] <= nmin[i]).all() and (box[3:] >= nmax[i]).all()
        else:
            np.testing.assert_array_equal(box, np.concatenate(
                [nmin[i], nmax[i]]), err_msg=str(i))
    assert ts.bvh.depth == depth < STACK_DEPTH
    tris = ts.bvh.walk_tris.numpy()
    for c, x in enumerate((js.tris.v0, js.tris.e1, js.tris.e2)):
        np.testing.assert_array_equal(tris[:, 4 * c:4 * c + 3],
                                      np.asarray(x))


def _rays(ts, kind):
    """(o, d, t_min, t_max, any_hit) of one cast kind, as numpy arrays."""
    o, d = ts.camera.generate_rays(*CAST_RAYS, device="cpu")
    lo = np.full((o.shape[0],), 1e-4, np.float32)
    if kind == "camera":
        return o.numpy(), d.numpy(), lo, np.full_like(lo, 3.4e38), False
    hit = intersect.intersect_closest(ts.tris, ts.bvh, o, d, t_min=1e-4)
    assert bool(hit.valid.all())
    p = o + hit.t[:, None] * d
    nrm = ts.tri_shade[hit.prim.long(), 8:11]
    nrm = torch.where((mu.dot(nrm, d) > 0.0)[:, None], -nrm, nrm)
    rng = np.random.default_rng(SEED)
    if kind == "bounce":
        u2 = torch.from_numpy(rng.uniform(size=(o.shape[0], 2)).astype(
            np.float32))
        b = mu.from_local(mu.square_to_cosine_hemisphere(u2), nrm)
        return p.numpy(), b.numpy(), lo, np.full_like(lo, 3.4e38), False
    u3 = torch.from_numpy(rng.uniform(size=(o.shape[0], 3)).astype(
        np.float32))
    lpos = light_sample(ts.light, u3)[0]
    return (p.numpy(), (lpos - p).numpy(), lo, np.full_like(lo, 1.0 - 1e-4),
            True)


def _abs_cross(a, b):
    """|a_j b_k| + |a_k b_j| per component of a x b: what its rounding
    scales with."""
    return np.stack([np.abs(a[:, j] * b[:, k]) + np.abs(a[:, k] * b[:, j])
                     for j, k in ((1, 2), (2, 0), (0, 1))], axis=1)


def _fma(a, b, c):
    """float32 a * b + c rounded once (the float32 product is exact in
    float64; a double rounding of the sum is possible but rare)."""
    f64 = np.float64
    return (a.astype(f64) * b.astype(f64) + c.astype(f64)).astype(np.float32)


def _hit_triangles(ts, prim):
    """v0, e1, e2 of each hit's triangle, as float32 numpy arrays."""
    return [x.numpy()[prim] for x in (ts.tris.v0, ts.tris.e1, ts.tris.e2)]


def _ray_tri_fma(o, d, v0, e1, e2):
    """u, v of Moller-Trumbore in float32 with each multiply-add fused:
    each cross component fma(a_j, b_k, -(a_k b_j)), each dot product
    fma(x2, y2, fma(x1, y1, x0 y0))."""
    def cross(a, b):
        return np.stack([_fma(a[:, j], b[:, k], -(a[:, k] * b[:, j]))
                         for j, k in ((1, 2), (2, 0), (0, 1))], axis=1)

    def dot(a, b):
        return _fma(a[:, 2], b[:, 2], _fma(a[:, 1], b[:, 1],
                                           a[:, 0] * b[:, 0]))
    pvec, tvec = cross(d, e2), o - v0
    inv = np.float32(1.0) / dot(e1, pvec)
    return dot(tvec, pvec) * inv, dot(d, cross(tvec, e1)) * inv


def _ray_tri_f64(o, d, v0, e1, e2):
    """u, v of Moller-Trumbore in float64 on the same float32 inputs."""
    o, d, v0, e1, e2 = (x.astype(np.float64) for x in (o, d, v0, e1, e2))
    pvec, tvec = np.cross(d, e2), o - v0
    det = (e1 * pvec).sum(1)
    return (tvec * pvec).sum(1) / det, (d * np.cross(tvec, e1)).sum(1) / det


def _barycentric_bounds(ts, o, d, prim, u, v):
    """The first-order rounding bound of Moller-Trumbore's u and v in
    float32 on each ray's hit triangle, u_eps |1 / det| (N + |x| N_det),
    N summing the magnitudes of the numerator's products and N_det those
    of det's (in float64)."""
    f64 = [x.numpy()[prim].astype(np.float64)
           for x in (ts.tris.v0, ts.tris.e1, ts.tris.e2)]
    o, d = o.astype(np.float64), d.astype(np.float64)
    tv, e1, e2 = o - f64[0], f64[1], f64[2]
    pa, qa = _abs_cross(d, e2), _abs_cross(tv, e1)
    inv = np.abs(1.0 / (e1 * np.cross(d, e2)).sum(1))
    n_det = (np.abs(e1) * pa).sum(1)
    eps = 2.0 ** -24
    return (eps * inv * ((np.abs(tv) * pa).sum(1) + np.abs(u) * n_det),
            eps * inv * ((np.abs(d) * qa).sum(1) + np.abs(v) * n_det))


@pytest.mark.parametrize("kind", sorted(CAST_EXCEPTIONS))
def test_casts_match_jax(big, kind):
    js, ts = big
    o, d, lo, hi, any_hit = _rays(ts, kind)
    args = [jnp.asarray(x) for x in (o, d, lo, hi)]
    targs = [torch.from_numpy(x) for x in (o, d, lo, hi)]
    ok = np.ones(o.shape[0], bool)
    ok[sorted(CAST_EXCEPTIONS[kind])] = False
    if any_hit:
        want = np.asarray(jax_intersect.intersect_any(js.tris, js.bvh,
                                                      *args[:2], *args[2:]))
        got = intersect.intersect_any(ts.tris, ts.bvh, *targs).numpy()
        bad = np.nonzero(ok & (got != want))[0]
        assert bad.size == 0, (bad[:8], got[bad[:8]], want[bad[:8]])
        assert 0.05 < got.mean() < 0.95
        return
    jh = jax_intersect.intersect_closest(js.tris, js.bvh, *args)
    th = intersect.intersect_closest(ts.tris, ts.bvh, *targs)
    want = [np.asarray(x) for x in (jh.prim, jh.t, jh.u, jh.v)]
    got = [x.numpy() for x in (th.prim, th.t, th.u, th.v)]
    bad = np.nonzero(ok & (got[0] != want[0]))[0]
    assert bad.size == 0, (bad[:8], got[0][bad[:8]], want[0][bad[:8]],
                           got[1][bad[:8]], want[1][bad[:8]])
    ok &= got[0] >= 0
    assert ok.mean() > 0.5
    np.testing.assert_allclose(got[1][ok], want[1][ok], rtol=1e-6,
                               err_msg="t")
    # u and v: the port is the JAX _ray_tri run op by op, bit for bit, and
    # within twice its rounding bound of the float64 values
    tri = _hit_triangles(ts, got[0][ok])
    with jax.disable_jit():
        eager = jax_intersect._ray_tri(*(jnp.asarray(x) for x in (
            o[ok], d[ok], *tri)))[1:3]
    exact = _ray_tri_f64(o[ok], d[ok], *tri)
    bounds = _barycentric_bounds(ts, o[ok], d[ok], got[0][ok],
                                 got[2][ok], got[3][ok])
    for name, g, e, x, bound in zip("uv", got[2:], eager, exact, bounds):
        np.testing.assert_array_equal(g[ok], np.asarray(e), err_msg=name)
        far = np.abs(g[ok] - x) > 2.0 * bound
        assert not far.any(), (name, np.nonzero(ok)[0][far][:8])
    # fault 8: against the jitted JAX walk, u and v at rtol 1e-6, or within
    # twice their rounding bound where that bound exceeds it (XLA fuses the
    # jitted _ray_tri's multiply-adds; the port rounds each product)
    for name, g, w, bound in zip("uv", got[2:], want[2:], bounds):
        err = np.abs(g[ok] - w[ok])
        tol = np.maximum(1e-6 * np.abs(w[ok]), 2.0 * bound)
        assert (err <= tol).all(), (name, np.nonzero(ok)[0][err > tol][:8])


def test_ours_frame_matches_jax(big):
    js, ts = big
    kw = dict(width=32, height=18, num_light_paths=512,
              num_vpl_light_paths=4, num_records=4, mis_mode=1,
              accumulate=True, use_jitter=True)
    jc, tc = jpf.PhotonFamConfig(**kw), photon_fam.PhotonFamConfig(**kw)
    radius = js.bounding_radius * 0.05
    clamp = 1.0 / js.total_area
    pdf_mc = (4 / 512) / np.pi / radius ** 2
    jstate = jpf.photon_fam_frame(
        js, jc, jpf.init_state(jc), jax_iteration_key(0, 0),
        *(jnp.float32(x) for x in (radius, clamp, pdf_mc, 0.0)))
    tstate = photon_fam.photon_fam_frame(
        ts, tc, photon_fam.init_state(tc, "cpu"), iteration_key(0, 0, "cpu"),
        radius, clamp, pdf_mc)
    assert int(tstate.dropped) == int(jstate.dropped) == 0
    mask = np.zeros(18 * 32, bool)
    for row, col in FRAME_EXCEPTIONS:
        mask[row * 32 + col] = True
    for f in ("vpl_acc", "photon_acc", "light_img"):
        got = getattr(tstate, f).numpy()
        want = np.asarray(getattr(jstate, f))
        np.testing.assert_allclose(got[~mask], want[~mask], rtol=2e-3,
                                   atol=2e-4, err_msg=f)
    assert np.asarray(jstate.vpl_acc).max() > 0.0
    assert np.asarray(jstate.photon_acc).max() > 0.0


def _camera_pair(origin0, origin1, fovy0, fovy1, aspect=1.0):
    """The same two cameras as (port, JAX) pairs."""
    args = [(tuple(origin0), tuple(np.add(origin0, (0, 0, -1))), (0, 1, 0),
             fovy0, aspect),
            (tuple(origin1), tuple(np.add(origin1, (0, 0, -1))), (0, 1, 0),
             fovy1, aspect)]
    return ([Camera(*a) for a in args], [JaxCamera(*a) for a in args])


def test_animation_camera_misc_parity_cases():
    (c0, c1), (j0, j1) = _camera_pair((0, 0, 0), (2, 0, 0), 1.0, 0.5)
    anim = AnimationCamera(c0, c1, total_time_ms=100.0)
    ref = JaxAnimationCamera(j0, j1, total_time_ms=100.0)
    mid = anim.at(50.0)
    np.testing.assert_allclose(mid.origin, (1, 0, 0))
    np.testing.assert_allclose(mid.fovy, 0.75)
    assert anim.at(-5.0).origin == c0.origin
    assert anim.at(500.0).origin == c1.origin
    for t in (-5.0, 0.0, 50.0, 100.0, 500.0):
        assert vars(anim.at(t)) == vars(ref.at(t)), t


def test_animation_camera_matches_jax_on_seeded_times():
    rng = np.random.default_rng(SEED)
    for _ in range(8):
        o0, o1 = rng.normal(size=(2, 3)).tolist()
        fovy = rng.uniform(0.2, 1.5, 2).tolist()
        total = float(rng.uniform(10.0, 1000.0))
        (c0, c1), (j0, j1) = _camera_pair(o0, o1, *fovy,
                                          aspect=float(rng.uniform(0.5, 2)))
        anim = AnimationCamera(c0, c1, total)
        ref = JaxAnimationCamera(j0, j1, total)
        times = rng.uniform(-0.5 * total, 1.5 * total, 16).tolist()
        for t in times + [-1.0, 0.0, total, 2.0 * total]:
            got, want = anim.at(t), ref.at(t)
            assert vars(got) == vars(want), t
            assert got.aspect == c0.aspect
        assert anim.at(-1.0) == c0 and anim.at(2.0 * total) == c1


def fault8_witness():
    """Print, for the camera and bounce casts, what ROADMAP fault 8 rests
    on: the hits whose u or v differ from the jitted JAX walk's beyond
    rtol 1e-6; the shares of the jitted values that _ray_tri_fma and the
    port reproduce bit for bit; on the differing hits, how often each side
    is nearer the float64 value; and each side's largest distance from it
    in rounding bounds."""
    js = jax_procedural.box_field_big()
    ts = procedural.box_field_big(device="cpu")
    for kind in ("camera", "bounce"):
        o, d, lo, hi, _ = _rays(ts, kind)
        jh = jax_intersect.intersect_closest(js.tris, js.bvh, *(
            jnp.asarray(x) for x in (o, d, lo, hi)))
        th = intersect.intersect_closest(ts.tris, ts.bvh, *(
            torch.from_numpy(x) for x in (o, d, lo, hi)))
        prim = th.prim.numpy()
        ok = prim >= 0
        tri = _hit_triangles(ts, prim[ok])
        fused = _ray_tri_fma(o[ok], d[ok], *tri)
        exact = _ray_tri_f64(o[ok], d[ok], *tri)
        port = [x.numpy()[ok] for x in (th.u, th.v)]
        jit = [np.asarray(x)[ok] for x in (jh.u, jh.v)]
        bounds = _barycentric_bounds(ts, o[ok], d[ok], prim[ok], *port)
        differ = np.zeros(ok.sum(), bool)
        for g, w in zip(port, jit):
            differ |= np.abs(g - w) > 1e-6 * np.abs(w)
        out = dict(kind=kind, hits=int(ok.sum()), differ=int(differ.sum()))
        for name, g, w, f, x, b in zip("uv", port, jit, fused, exact,
                                       bounds):
            dp, dj = (np.abs(y[differ] - x[differ]) for y in (g, w))
            out[name] = dict(
                fma_equals_jit=float(np.mean(f == w)),
                port_equals_jit=float(np.mean(g == w)),
                port_nearer=int((dp < dj).sum()),
                jit_nearer=int((dj < dp).sum()), tied=int((dp == dj).sum()),
                port_bounds=float(np.max(np.abs(g - x) / b)),
                jit_bounds=float(np.max(np.abs(w - x) / b)))
        print(out)


if __name__ == "__main__":
    fault8_witness()
