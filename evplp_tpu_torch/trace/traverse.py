"""BVH ray traversal: the Hopper kernel's wrapper and its plain versions.

`traverse` computes, for a batch of rays against the slot-ordered triangles
and the BVH, the closest hit (t, prim, u, v) in (t_min, t_max) or, with
any_hit, whether any triangle lies in that interval.  It is the
counterpart of the JAX package's Pallas packet kernel
(`trace/packet3.py:_kernel`, entry `packet3_trace`), and its function is
that of the JAX CPU walk `_traverse_one`: the least t, the first triangle in
DFS order (the least slot) on ties.

On a CUDA tensor the wrapper launches `csrc/traverse.cu` (built with nvcc at
first use, bound with ctypes) and never anything else; on a CPU tensor it
runs `traverse_plain`, the skip-pointer walk of `_traverse_one` in plain
PyTorch, which is also the kernel's reference on the card.  The kernel takes
another path to the same hits: an ordered walk over the BVH's walk records
(`accel/bvh.py:walk_layout`) that culls leaves by a conservative box test
and breaks ties in t by the least slot.  `walk_plain` takes the kernel's
steps in plain PyTorch; the tests and chip_smoke.py use it to check that
walk on the CPU and to count its operations.  Its state, `WalkState`, is
also the single-ray walk of packet.py's and packet7.py's plain versions,
whose kernels share the walk (csrc/ray_common.cuh) and the C interface
(`load_walk_library`, `launch_walk_kernel`).  `launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import os

import torch

from evplp_tpu_torch.accel.bvh import WALK_NODE_FLOATS, WALK_TRI_FLOATS
from evplp_tpu_torch.native.build import check_tensor, load_cuda_library

TRI_EPS = 1e-9          # determinant cutoff
BIG = 3.4e38
WARP = 32               # lanes of a warp
# the walk's node stack (a ray's, or a packet's) and a ray's leaf queue
# (csrc/ray_common.cuh kStackDepth, kQueueCap)
STACK_DEPTH = 64
QUEUE_CAP = 8
# The kernels' conservative leaf-box test (csrc/ray_common.cuh kLeafWiden,
# kLeafWidenT): t_near <= t_far * LEAF_WIDEN and t_near <= t * LEAF_WIDEN_T,
# the float32 roundings of 1 + 2 gamma_3 and (1 + 2 gamma_3)^2,
# gamma_3 = 3u / (1 - 3u), u = 2^-24
LEAF_WIDEN = 1.0 + 3.0 * 2.0 ** -23
LEAF_WIDEN_T = 1.0 + 6.0 * 2.0 ** -23

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "traverse.cu")

launches = 0


def load_walk_library(name: str, source: str, entry: str) -> ctypes.CDLL:
    """Build (at first use) and load a traversal kernel library whose C
    entry `entry` takes the walk records, the rays and the outputs."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # walk nodes, walk tris; rays: o, d, t_min, t_max, R; out: t, prim, u,
    # v; any_hit; stream
    args = [vp] * 6 + [ci] + [vp] * 4 + [ci, vp]
    return load_cuda_library(name, source, {entry: args})


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return load_walk_library("traverse", _SRC, "evplp_traverse")


def check_rays_alloc_hits(o, d, t_min, t_max, what: str):
    """Raise unless the ray batch lies on a CUDA device as (R, 3) / (R,)
    contiguous float32; return empty (t, prim, u, v) outputs."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    r = o.shape[0]
    f32 = torch.float32
    for x, name, shape in ((o, "o", (r, 3)), (d, "d", (r, 3)),
                           (t_min, "t_min", (r,)), (t_max, "t_max", (r,))):
        check_tensor(x, name, f32, shape, dev)
    return (torch.empty((r,), dtype=f32, device=dev),
            torch.empty((r,), dtype=torch.int32, device=dev),
            torch.empty((r,), dtype=f32, device=dev),
            torch.empty((r,), dtype=f32, device=dev))


def check_stack_depth(bvh):
    """Raise unless the tree is shallow enough for the kernel's stack."""
    if bvh.depth >= STACK_DEPTH:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the kernel's stack "
                         f"of {STACK_DEPTH}")


def check_walk_scene(tris, bvh, dev):
    """Raise unless the BVH's walk records lie on dev, one triangle record
    per triangle."""
    check_tensor(bvh.walk_nodes, "walk_nodes", torch.float32,
                 (bvh.walk_nodes.shape[0], WALK_NODE_FLOATS), dev)
    check_tensor(bvh.walk_tris, "walk_tris", torch.float32,
                 (tris.v0.shape[0], WALK_TRI_FLOATS), dev)


def launch_walk_kernel(load, entry: str, what: str, tris, bvh, o, d, t_min,
                       t_max, any_hit: bool, check_scene=None):
    """Check the inputs of a kernel over the BVH's walk records (and, with
    check_scene, check_scene(bvh, device) after the rays), launch `entry`
    of the library `load()` returns on PyTorch's current stream, and return
    (t, prim, u, v); raise if the launch fails."""
    check_stack_depth(bvh)
    t, prim, u, v = check_rays_alloc_hits(o, d, t_min, t_max, what)
    dev, r = o.device, o.shape[0]
    check_walk_scene(tris, bvh, dev)
    if check_scene is not None:
        check_scene(bvh, dev)
    if r == 0:
        return t, prim, u, v
    fn = getattr(load(), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bvh.walk_nodes.data_ptr(), bvh.walk_tris.data_ptr(),
                 o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                 t_max.data_ptr(), r, t.data_ptr(), prim.data_ptr(),
                 u.data_ptr(), v.data_ptr(), int(any_hit), stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    return t, prim, u, v


def traverse_cuda(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Launch the CUDA kernel on PyTorch's current stream.  Returns
    (t, prim, u, v); with any_hit, prim >= 0 marks an occluded ray and
    t, u, v are those of the first hit found.  The kernel reads the BVH's
    walk records, not `tris`."""
    global launches
    out = launch_walk_kernel(load_library, "evplp_traverse",
                             "the traversal kernel", tris, bvh, o, d, t_min,
                             t_max, any_hit)
    if o.shape[0]:
        launches += 1
    return out


def ray_tri(o, d, v0, e1, e2):
    """Moller-Trumbore, double-sided, over broadcastable (..., 3) tensors.
    Returns (t, u, v, ok-geometry); sums are ((x + y) + z)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    v0x, v0y, v0z = v0.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    good = torch.abs(det) > TRI_EPS
    inv_det = torch.where(good, 1.0 / det, 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = good & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def traverse_plain(tris, bvh, o, d, t_min, t_max, any_hit: bool,
                   work: dict | None = None):
    """The kernel's walk in plain PyTorch, batched over rays.

    Every live ray steps through the DFS node array: at a leaf it tests the
    leaf's triangles (closest hit in (t_min, t), first index on ties) and
    goes to skip[node]; at an internal node it goes to node + 1 if the ray
    enters the box before t, else to skip[node].  Finished rays leave the
    batch each step.  Lanes with t_max <= t_min are never traced.

    work: optional dict; "slabs" and "tris" are incremented by the box tests
    (internal node visits) and ray-triangle tests of the walk (an any-hit
    walk finishes the leaf of its first hit, the kernel stops at the hit)."""
    r = o.shape[0]
    dev = o.device
    num_nodes = bvh.node_min.shape[0]
    last_tri = tris.v0.shape[0] - 1
    t_out = t_max.clone()
    prim_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((r,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((r,), dtype=torch.float32, device=dev)
    leaf_k = torch.arange(int(bvh.node_count.max()), device=dev)

    ids = torch.nonzero(t_max > t_min).squeeze(1)
    oa, da, lo = o[ids], d[ids], t_min[ids]
    inv = inv_dir(da)
    t = t_max[ids]
    prim = torch.full_like(ids, -1, dtype=torch.int32)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    node = torch.zeros_like(ids)
    while ids.numel():
        count = bvh.node_count[node]
        leaf = count > 0
        li = torch.nonzero(leaf).squeeze(1)
        if work is not None:
            work["slabs"] = work.get("slabs", 0) + int((~leaf).sum())
            work["tris"] = work.get("tris", 0) + int(count.sum())
        if li.numel():
            tri = torch.clamp_max(bvh.node_first[node[li]][:, None] + leaf_k,
                                  last_tri)
            tt, uu, vv, ok = ray_tri(oa[li, None], da[li, None], tris.v0[tri],
                                     tris.e1[tri], tris.e2[tri])
            ok = (ok & (leaf_k < count[li][:, None])
                  & (tt > lo[li][:, None]) & (tt < t[li][:, None]))
            tt = torch.where(ok, tt, float("inf"))
            j = torch.argmin(tt, dim=1, keepdim=True)
            best = tt.gather(1, j)[:, 0]
            better = best < t[li]
            t[li] = torch.where(better, best, t[li])
            prim[li] = torch.where(better, tri.gather(1, j)[:, 0].int(),
                                   prim[li])
            u[li] = torch.where(better, uu.gather(1, j)[:, 0], u[li])
            v[li] = torch.where(better, vv.gather(1, j)[:, 0], v[li])
        t0 = (bvh.node_min[node] - oa) * inv
        t1 = (bvh.node_max[node] - oa) * inv
        t_near = torch.amax(torch.minimum(t0, t1), dim=1)
        t_far = torch.amin(torch.maximum(t0, t1), dim=1)
        box = (t_near <= t_far) & (t_far >= 0.0) & (t_near <= t)
        skip = bvh.node_skip[node].long()
        node = torch.where(leaf | ~box, skip, node + 1)
        done = node >= num_nodes
        if any_hit:
            done = done | (prim >= 0)
        if bool(done.any()):
            fin = ids[done]
            t_out[fin], prim_out[fin] = t[done], prim[done]
            u_out[fin], v_out[fin] = u[done], v[done]
            keep = ~done
            ids, node, oa, da, inv, lo = (x[keep] for x in
                                          (ids, node, oa, da, inv, lo))
            t, prim, u, v = t[keep], prim[keep], u[keep], v[keep]
    return t_out, prim_out, u_out, v_out


def _slab(lo, hi, oa, inv):
    """(t_near, t_far) of each ray's slab interval through its box."""
    t0 = (lo - oa) * inv
    t1 = (hi - oa) * inv
    return (torch.amax(torch.minimum(t0, t1), dim=-1),
            torch.amin(torch.maximum(t0, t1), dim=-1))


def inv_dir(d):
    """1/d, or +-BIG where |d| <= 1e-20 (csrc/ray_common.cuh inv_dir)."""
    return torch.where(torch.abs(d) > 1e-20, 1.0 / d,
                       torch.where(d >= 0, BIG, -BIG))


def test_children(nodes, words, rec, oa, inv, t, wide: bool = False):
    """Both children of walk records rec for rays (oa, inv) at t, as
    csrc/ray_common.cuh test_children: (near_l, near_r, ref_l, ref_r,
    cnt_l, cnt_r, want_l, want_r); a leaf child is wanted by the
    conservative leaf-box test, an internal one by the exact slab test, or
    with wide at t * LEAF_WIDEN_T.  rec broadcasts against the rays'
    leading dimensions."""
    b, w = nodes[rec], words[rec]
    near_l, far_l = _slab(b[..., 0:3], b[..., 3:6], oa, inv)
    near_r, far_r = _slab(b[..., 6:9], b[..., 9:12], oa, inv)
    ref_l, ref_r, cnt_l, cnt_r = w[..., 12], w[..., 13], w[..., 14], w[..., 15]
    want = []
    t_in = t * LEAF_WIDEN_T if wide else t
    for near, far, ref in ((near_l, far_l, ref_l), (near_r, far_r, ref_r)):
        want.append(torch.where(
            ref < 0, (near <= far * LEAF_WIDEN) & (far >= 0.0)
            & (near <= t * LEAF_WIDEN_T),
            (near <= far) & (far >= 0.0) & (near <= t_in)))
    return near_l, near_r, ref_l, ref_r, cnt_l, cnt_r, want[0], want[1]


def add_work(work, key, n):
    """Add n to work[key] (work: a dict of counts, or None)."""
    if work is not None:
        work[key] = work.get(key, 0) + int(n)


class WalkState:
    """The ordered walk of csrc/ray_common.cuh (`step`, `walk`) for a batch
    of rays, in plain PyTorch: each ray's best hit (t, slot, u, v), its
    current record (-1: none), node stack and leaf queue.  walk_plain,
    packet_plain and packet7_plain move rays through it; `rows` index the
    batch.  With wide, internal boxes are tested at t * LEAF_WIDEN_T, as
    packet.cu's walks test them."""

    PER_RAY = ("oa", "da", "inv", "lo", "t", "prim", "u", "v", "cur", "sp",
               "qn", "stack_ref", "stack_near", "q_first", "q_count",
               "q_near")

    def __init__(self, bvh, o, d, t_min, t, wide: bool = False):
        dev, n = o.device, o.shape[0]
        self.wide = wide
        self.nodes = bvh.walk_nodes
        self.words = self.nodes.view(torch.int32).long()
        rec = bvh.walk_tris
        self.tv0, self.te1, self.te2 = rec[:, 0:3], rec[:, 4:7], rec[:, 8:11]
        self.last = rec.shape[0] - 1
        self.kk = torch.arange(max(int(self.words[:, 14:16].max()), 1),
                               device=dev)
        i64, f32 = torch.int64, torch.float32
        self.oa, self.da, self.lo, self.t = o, d, t_min, t.clone()
        self.inv = inv_dir(d)
        self.prim = torch.full((n,), -1, dtype=i64, device=dev)
        self.u = torch.zeros((n,), dtype=f32, device=dev)
        self.v = torch.zeros((n,), dtype=f32, device=dev)
        self.cur = torch.full((n,), -1, dtype=i64, device=dev)
        self.sp = torch.zeros((n,), dtype=i64, device=dev)
        self.qn = torch.zeros((n,), dtype=i64, device=dev)
        self.stack_ref = torch.zeros((n, STACK_DEPTH), dtype=i64, device=dev)
        self.stack_near = torch.zeros((n, STACK_DEPTH), dtype=f32,
                                      device=dev)
        self.q_first = torch.zeros((n, QUEUE_CAP), dtype=i64, device=dev)
        self.q_count = torch.zeros_like(self.q_first)
        self.q_near = torch.zeros((n, QUEUE_CAP), dtype=f32, device=dev)

    @classmethod
    def in_warps(cls, bvh, o, d, t_min, t_max, wide: bool = False):
        """The state of R rays padded to whole warps of WARP with lanes
        that are not traced (t_max <= t_min), and the number of warps."""
        num = -(-o.shape[0] // WARP)
        pad = num * WARP - o.shape[0]

        def lanes(x, fill):
            return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])

        return cls(bvh, lanes(o, 0.0), lanes(d, 1.0), lanes(t_min, 1.0),
                   lanes(t_max, 0.0), wide), num

    def keep(self, keep):
        """Keep only the rays where `keep` (a bool mask) holds."""
        for k in self.PER_RAY:
            setattr(self, k, getattr(self, k)[keep])

    def stepping(self):
        """Rays whose walk is alive and whose queue has room for a step's
        two leaves."""
        return (self.cur >= 0) & (self.qn + 2 <= QUEUE_CAP)

    def step(self, ii, work=None):
        """One step of rays ii at their current records: test both
        children, queue the wanted leaves near first, descend into the
        nearer wanted internal child and push the other, or pop the next
        stacked node that t still admits."""
        if not ii.numel():
            return
        (near_l, near_r, ref_l, ref_r, cnt_l, cnt_r, want_l,
         want_r) = test_children(self.nodes, self.words, self.cur[ii],
                                 self.oa[ii], self.inv[ii], self.t[ii],
                                 self.wide)
        leaf_l, leaf_r = ref_l < 0, ref_r < 0
        l_first = near_l <= near_r
        q = self.qn[ii]
        for first in (True, False):
            pick_l = l_first if first else ~l_first
            add = torch.where(pick_l, want_l & leaf_l, want_r & leaf_r)
            rows, pos = ii[add], q[add]
            self.q_first[rows, pos] = ~torch.where(pick_l, ref_l, ref_r)[add]
            self.q_count[rows, pos] = torch.where(pick_l, cnt_l, cnt_r)[add]
            self.q_near[rows, pos] = torch.where(pick_l, near_l, near_r)[add]
            q = q + add
        self.qn[ii] = q
        go_l, go_r = want_l & ~leaf_l, want_r & ~leaf_r
        both = go_l & go_r
        rows, s = ii[both], self.sp[ii[both]]
        self.stack_ref[rows, s] = torch.where(l_first, ref_r, ref_l)[both]
        self.stack_near[rows, s] = torch.where(l_first, near_r, near_l)[both]
        self.sp[rows] = s + 1
        nxt = torch.where(both, torch.where(l_first, ref_l, ref_r),
                          torch.where(go_l, ref_l,
                                      torch.where(go_r, ref_r, -1)))
        self.cur[ii] = nxt
        pp = ii[nxt < 0]
        while pp.numel():
            pp = pp[self.sp[pp] > 0]
            self.sp[pp] -= 1
            t = self.t[pp] * LEAF_WIDEN_T if self.wide else self.t[pp]
            ok = self.stack_near[pp, self.sp[pp]] <= t
            self.cur[pp[ok]] = self.stack_ref[pp[ok], self.sp[pp[ok]]]
            pp = pp[~ok]
        add_work(work, "steps", ii.numel())

    def leaf_hits(self, rows, first, count, bound, any_hit):
        """Each row's hit among the `count` triangles from slot `first`
        with t in (t_min, bound] (ray_common.cuh ray_tri): (tt, slot, u, v,
        ok, tested).  Closest: the least (t, slot).  Any hit: the first hit
        in slot order with t < bound, where test_tris stops."""
        slot = torch.clamp_max(first[:, None] + self.kk, self.last)
        tt, uu, vv, ok = ray_tri(self.oa[rows, None], self.da[rows, None],
                                 self.tv0[slot], self.te1[slot],
                                 self.te2[slot])
        ok = (ok & (self.kk < count[:, None]) & (tt > self.lo[rows, None])
              & (tt <= bound[:, None]))
        if any_hit:
            ok &= tt < bound[:, None]
            j = torch.argmax(ok.to(torch.int8), dim=1, keepdim=True)
            hit = ok.any(dim=1)
            tested = torch.where(hit, j[:, 0] + 1, count)
        else:
            j = torch.argmin(torch.where(ok, tt, float("inf")), dim=1,
                             keepdim=True)
            hit = ok.gather(1, j)[:, 0]
            tested = count
        return (tt.gather(1, j)[:, 0], slot.gather(1, j)[:, 0],
                uu.gather(1, j)[:, 0], vv.gather(1, j)[:, 0], hit, tested)

    def offer(self, rows, tt, slot, uu, vv, ok):
        """Take each row's hit (tt <= t) where it beats the best: the least
        (t, slot) (ray_common.cuh better_hit)."""
        t, prim = self.t[rows], self.prim[rows]
        better = ok & ((tt < t) | (slot < prim))
        self.t[rows] = torch.where(better, tt, t)
        self.prim[rows] = torch.where(better, slot, prim)
        self.u[rows] = torch.where(better, uu, self.u[rows])
        self.v[rows] = torch.where(better, vv, self.v[rows])

    def test_leaf(self, rows, first, count, any_hit, work=None):
        """Rows test the leaf (first, count) against their t, as
        ray_common.cuh test_leaf; returns each row's triangle tests."""
        if not rows.numel():
            return count
        *hit, tested = self.leaf_hits(rows, first, count, self.t[rows],
                                      any_hit)
        add_work(work, "tris", tested.sum())
        self.offer(rows, *hit)
        return tested

    def drain(self, rows, any_hit, work=None):
        """Drain the queues of rows in order, each leaf skipped if t no
        longer admits it (ray_common.cuh walk); returns each row's
        triangle tests."""
        tests = torch.zeros_like(rows)
        for qi in range(QUEUE_CAP):
            take = (self.qn[rows] > qi) & (
                self.q_near[rows, qi] <= self.t[rows] * LEAF_WIDEN_T)
            if any_hit:
                take &= self.prim[rows] < 0
            r = rows[take]
            tests[take] += self.test_leaf(r, self.q_first[r, qi],
                                          self.q_count[r, qi], any_hit, work)
        self.qn[rows] = 0
        return tests

    def walk_pass(self, rows, any_hit, work=None):
        """One pass of the walk for rows: a step where the walk steps, else
        a drain of the queue.  Returns the rows whose walk has ended (any
        hit: at its first hit)."""
        stepping = self.stepping()[rows]
        self.step(rows[stepping], work)
        self.drain(rows[~stepping & (self.qn[rows] > 0)], any_hit, work)
        done = (self.cur[rows] < 0) & (self.qn[rows] == 0)
        if any_hit:
            done |= self.prim[rows] >= 0
        return rows[done]

    def hits(self):
        """(t, prim, u, v) with prim as int32."""
        return self.t, self.prim.int(), self.u, self.v


def walk_plain(tris, bvh, o, d, t_min, t_max, any_hit: bool,
               work: dict | None = None):
    """The kernel's ordered walk in plain PyTorch, batched over rays; the
    same function as traverse_plain (for the tests and chip_smoke.py).

    Each pass moves every unfinished ray one kernel step: while its walk is
    alive and its leaf queue has room for two leaves, a step at its current
    record (slab tests of both children, wanted leaves queued near first,
    descent into the nearer wanted internal child, push or pop); else a
    drain of its queued leaves in order, each skipped if t no longer admits
    it, keeping the least (t, slot).

    work: optional dict; "steps" and "tris" are incremented by the kernel
    steps (two box tests each) and ray-triangle tests of the walk (an
    any-hit ray stops at its first hit)."""
    r, dev = o.shape[0], o.device
    check_stack_depth(bvh)
    check_walk_scene(tris, bvh, dev)
    t_out = t_max.clone()
    prim_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((r,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((r,), dtype=torch.float32, device=dev)
    ids = torch.nonzero(t_max > t_min).squeeze(1)
    ws = WalkState(bvh, o[ids], d[ids], t_min[ids], t_max[ids])
    ws.cur.zero_()
    while ids.numel():
        done = ws.walk_pass(torch.arange(ids.numel(), device=dev), any_hit,
                            work)
        if done.numel():
            fin = ids[done]
            t, prim, u, v = ws.hits()
            t_out[fin], prim_out[fin] = t[done], prim[done]
            u_out[fin], v_out[fin] = u[done], v[done]
            keep = torch.ones_like(ids, dtype=torch.bool)
            keep[done] = False
            ids = ids[keep]
            ws.keep(keep)
    return t_out, prim_out, u_out, v_out


def traverse(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Closest- or any-hit traversal: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if o.device.type == "cuda":
        return traverse_cuda(tris, bvh, o, d, t_min, t_max, any_hit)
    if o.device.type == "cpu":
        return traverse_plain(tris, bvh, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no traversal for device {o.device}")
