"""BVH ray traversal: the Hopper kernel's wrapper and its plain version.

`traverse` computes, for a batch of rays against the slot-ordered triangles
and the skip-pointer BVH, the closest hit (t, prim, u, v) in (t_min, t_max)
or, with any_hit, whether any triangle lies in that interval.  It is the
counterpart of the JAX package's Pallas packet kernel
(`trace/packet3.py:_kernel`, entry `packet3_trace`).

On a CUDA tensor the wrapper launches `csrc/traverse.cu` (built with nvcc at
first use, bound with ctypes) and never anything else; on a CPU tensor it
runs `traverse_plain`, the same walk in plain PyTorch, which also serves as
the kernel's reference on the card.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import os

import torch

from evplp_tpu_torch.native.build import check_tensor, load_cuda_library

TRI_EPS = 1e-9          # determinant cutoff
BIG = 3.4e38

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "traverse.cu")

launches = 0


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # nodes: min, max, skip, first, count, N; tris: v0, e1, e2;
    # rays: o, d, t_min, t_max, R; out: t, prim, u, v; stream
    args = [vp] * 5 + [ci] + [vp] * 7 + [ci] + [vp] * 5
    return load_cuda_library("traverse", _SRC, {
        "evplp_traverse_closest": args, "evplp_traverse_any": args})


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


def traverse_cuda(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Launch the CUDA kernel on PyTorch's current stream.  Returns
    (t, prim, u, v); with any_hit, prim >= 0 marks an occluded ray and
    t, u, v are those of the first hit found."""
    global launches
    t, prim, u, v = check_rays_alloc_hits(o, d, t_min, t_max,
                                          "the traversal kernel")
    check_skip_pointer_scene(tris, bvh, o.device)
    dev, r, n = o.device, o.shape[0], bvh.node_min.shape[0]
    if r == 0:
        return t, prim, u, v
    lib = load_library()
    fn = lib.evplp_traverse_any if any_hit else lib.evplp_traverse_closest
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bvh.node_min.data_ptr(), bvh.node_max.data_ptr(),
                 bvh.node_skip.data_ptr(), bvh.node_first.data_ptr(),
                 bvh.node_count.data_ptr(), n,
                 tris.v0.data_ptr(), tris.e1.data_ptr(), tris.e2.data_ptr(),
                 o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                 t_max.data_ptr(), r, t.data_ptr(), prim.data_ptr(),
                 u.data_ptr(), v.data_ptr(), stream)
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


def traverse(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Closest- or any-hit traversal: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if o.device.type == "cuda":
        return traverse_cuda(tris, bvh, o, d, t_min, t_max, any_hit)
    if o.device.type == "cpu":
        return traverse_plain(tris, bvh, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no traversal for device {o.device}")
