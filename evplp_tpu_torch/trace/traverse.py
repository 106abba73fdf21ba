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
walk on the CPU and to count its operations.  `launches` counts kernel
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
STACK_DEPTH = 64        # per-ray node stack (csrc/traverse.cu kStackDepth)
QUEUE_CAP = 8           # per-ray leaf queue (csrc/traverse.cu kQueueCap)
# The kernel's conservative leaf-box test (csrc/traverse.cu kLeafWiden,
# kLeafWidenT): t_near <= t_far * LEAF_WIDEN and t_near <= t * LEAF_WIDEN_T,
# the float32 roundings of 1 + 2 gamma_3 and (1 + 2 gamma_3)^2,
# gamma_3 = 3u / (1 - 3u), u = 2^-24
LEAF_WIDEN = 1.0 + 3.0 * 2.0 ** -23
LEAF_WIDEN_T = 1.0 + 6.0 * 2.0 ** -23

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "traverse.cu")

launches = 0


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # walk nodes, walk tris; rays: o, d, t_min, t_max, R; out: t, prim, u,
    # v; any_hit; stream
    args = [vp] * 6 + [ci] + [vp] * 4 + [ci, vp]
    return load_cuda_library("traverse", _SRC, {"evplp_traverse": args})


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


def check_skip_pointer_scene(tris, bvh, dev):
    """Raise unless the skip-pointer node arrays and the triangle SoA lie on
    dev with the kernels' dtypes and shapes."""
    n, nt = bvh.node_min.shape[0], tris.v0.shape[0]
    f32, i32 = torch.float32, torch.int32
    for x, name, dt, shape in (
            (bvh.node_min, "node_min", f32, (n, 3)),
            (bvh.node_max, "node_max", f32, (n, 3)),
            (bvh.node_skip, "node_skip", i32, (n,)),
            (bvh.node_first, "node_first", i32, (n,)),
            (bvh.node_count, "node_count", i32, (n,)),
            (tris.v0, "v0", f32, (nt, 3)), (tris.e1, "e1", f32, (nt, 3)),
            (tris.e2, "e2", f32, (nt, 3))):
        check_tensor(x, name, dt, shape, dev)


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


def traverse_cuda(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Launch the CUDA kernel on PyTorch's current stream.  Returns
    (t, prim, u, v); with any_hit, prim >= 0 marks an occluded ray and
    t, u, v are those of the first hit found.  The kernel reads the BVH's
    walk records, not `tris`."""
    global launches
    check_stack_depth(bvh)
    t, prim, u, v = check_rays_alloc_hits(o, d, t_min, t_max,
                                          "the traversal kernel")
    dev, r = o.device, o.shape[0]
    check_walk_scene(tris, bvh, dev)
    if r == 0:
        return t, prim, u, v
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.evplp_traverse(
            bvh.walk_nodes.data_ptr(), bvh.walk_tris.data_ptr(),
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            r, t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            int(any_hit), stream)
    if err != 0:
        raise RuntimeError(f"traversal kernel launch failed: CUDA error {err}")
    launches += 1
    return t, prim, u, v


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
    inv = torch.where(torch.abs(da) > 1e-20, 1.0 / da,
                      torch.where(da >= 0, BIG, -BIG))
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
    return (torch.amax(torch.minimum(t0, t1), dim=1),
            torch.amin(torch.maximum(t0, t1), dim=1))


def walk_plain(tris, bvh, o, d, t_min, t_max, any_hit: bool,
               work: dict | None = None):
    """The kernel's ordered walk in plain PyTorch, batched over rays; the
    same function as traverse_plain but for box grazes (for the tests and
    chip_smoke.py).

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
    nodes = bvh.walk_nodes
    words = nodes.view(torch.int32).long()
    rec = bvh.walk_tris
    tv0, te1, te2 = rec[:, 0:3], rec[:, 4:7], rec[:, 8:11]
    last = rec.shape[0] - 1
    kk = torch.arange(max(int(words[:, 14:16].max()), 1), device=dev)
    t_out = t_max.clone()
    prim_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((r,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((r,), dtype=torch.float32, device=dev)

    ids = torch.nonzero(t_max > t_min).squeeze(1)
    n = ids.numel()
    oa, da, lo, t = o[ids], d[ids], t_min[ids], t_max[ids]
    inv = torch.where(torch.abs(da) > 1e-20, 1.0 / da,
                      torch.where(da >= 0, BIG, -BIG))
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    cur = torch.zeros((n,), dtype=torch.int64, device=dev)
    sp = torch.zeros_like(cur)
    qn = torch.zeros_like(cur)
    stack_ref = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack_near = torch.zeros((n, STACK_DEPTH), dtype=torch.float32,
                             device=dev)
    q_first = torch.zeros((n, QUEUE_CAP), dtype=torch.int64, device=dev)
    q_count = torch.zeros_like(q_first)
    q_near = torch.zeros((n, QUEUE_CAP), dtype=torch.float32, device=dev)

    while ids.numel():
        stepping = (cur >= 0) & (qn + 2 <= QUEUE_CAP)
        ii = torch.nonzero(stepping).squeeze(1)
        if ii.numel():
            b, w, tt = nodes[cur[ii]], words[cur[ii]], t[ii]
            near_l, far_l = _slab(b[:, 0:3], b[:, 3:6], oa[ii], inv[ii])
            near_r, far_r = _slab(b[:, 6:9], b[:, 9:12], oa[ii], inv[ii])
            ref_l, ref_r, cnt_l, cnt_r = w[:, 12], w[:, 13], w[:, 14], w[:, 15]
            leaf_l, leaf_r = ref_l < 0, ref_r < 0
            want = []
            for near, far, leaf in ((near_l, far_l, leaf_l),
                                    (near_r, far_r, leaf_r)):
                wide = far * LEAF_WIDEN
                want.append(torch.where(
                    leaf, (near <= wide) & (far >= 0.0)
                    & (near <= tt * LEAF_WIDEN_T),
                    (near <= far) & (far >= 0.0) & (near <= tt)))
            want_l, want_r = want
            l_first = near_l <= near_r
            q = qn[ii]
            for first in (True, False):
                pick_l = l_first if first else ~l_first
                add = torch.where(pick_l, want_l & leaf_l, want_r & leaf_r)
                rows, pos = ii[add], q[add]
                q_first[rows, pos] = ~torch.where(pick_l, ref_l, ref_r)[add]
                q_count[rows, pos] = torch.where(pick_l, cnt_l, cnt_r)[add]
                q_near[rows, pos] = torch.where(pick_l, near_l, near_r)[add]
                q = q + add
            qn[ii] = q
            go_l, go_r = want_l & ~leaf_l, want_r & ~leaf_r
            both = go_l & go_r
            rows, s = ii[both], sp[ii[both]]
            stack_ref[rows, s] = torch.where(l_first, ref_r, ref_l)[both]
            stack_near[rows, s] = torch.where(l_first, near_r, near_l)[both]
            sp[rows] = s + 1
            nxt = torch.where(both, torch.where(l_first, ref_l, ref_r),
                              torch.where(go_l, ref_l,
                                          torch.where(go_r, ref_r, -1)))
            cur[ii] = nxt
            pp = ii[nxt < 0]
            while pp.numel():
                pp = pp[sp[pp] > 0]
                sp[pp] -= 1
                ok = stack_near[pp, sp[pp]] <= t[pp]
                cur[pp[ok]] = stack_ref[pp[ok], sp[pp[ok]]]
                pp = pp[~ok]
            if work is not None:
                work["steps"] = work.get("steps", 0) + ii.numel()
        dj = torch.nonzero(~stepping & (qn > 0)).squeeze(1)
        for qi in range(QUEUE_CAP):
            rows = dj[qn[dj] > qi]
            rows = rows[q_near[rows, qi] <= t[rows] * LEAF_WIDEN_T]
            if any_hit:
                rows = rows[prim[rows] < 0]
            if not rows.numel():
                continue
            cnt = q_count[rows, qi]
            slot = torch.clamp_max(q_first[rows, qi][:, None] + kk, last)
            tt, uu, vv, ok = ray_tri(oa[rows, None], da[rows, None],
                                     tv0[slot], te1[slot], te2[slot])
            ok = (ok & (kk < cnt[:, None]) & (tt > lo[rows, None])
                  & (tt <= t[rows, None]))
            if any_hit:
                j = torch.argmax(ok.to(torch.int8), dim=1, keepdim=True)
                better = ok.any(dim=1)
                tested = torch.where(better, j[:, 0] + 1, cnt)
            else:
                j = torch.argmin(torch.where(ok, tt, float("inf")), dim=1,
                                 keepdim=True)
                best, bs = tt.gather(1, j)[:, 0], slot.gather(1, j)[:, 0]
                better = ok.gather(1, j)[:, 0] & (
                    (best < t[rows]) | ((best == t[rows]) & (bs < prim[rows])))
                tested = cnt
            if work is not None:
                work["tris"] = work.get("tris", 0) + int(tested.sum())
            t[rows] = torch.where(better, tt.gather(1, j)[:, 0], t[rows])
            prim[rows] = torch.where(better, slot.gather(1, j)[:, 0],
                                     prim[rows])
            u[rows] = torch.where(better, uu.gather(1, j)[:, 0], u[rows])
            v[rows] = torch.where(better, vv.gather(1, j)[:, 0], v[rows])
        qn[dj] = 0
        done = (cur < 0) & (qn == 0)
        if any_hit:
            done |= prim >= 0
        if bool(done.any()):
            fin = ids[done]
            t_out[fin], prim_out[fin] = t[done], prim[done].int()
            u_out[fin], v_out[fin] = u[done], v[done]
            keep = ~done
            (ids, oa, da, inv, lo, t, prim, u, v, cur, sp, qn, stack_ref,
             stack_near, q_first, q_count, q_near) = (
                x[keep] for x in (ids, oa, da, inv, lo, t, prim, u, v, cur,
                                  sp, qn, stack_ref, stack_near, q_first,
                                  q_count, q_near))
    return t_out, prim_out, u_out, v_out


def traverse(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Closest- or any-hit traversal: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if o.device.type == "cuda":
        return traverse_cuda(tris, bvh, o, d, t_min, t_max, any_hit)
    if o.device.type == "cpu":
        return traverse_plain(tris, bvh, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no traversal for device {o.device}")
