"""BVH ray traversal over the packed node layout, two-level loop: the Hopper
kernel's wrapper and its plain version.

`packet7_trace` computes what `trace/traverse.py:traverse` computes, the
closest hit (t, slot, u, v) in (t_min, t_max) or, with any_hit, whether any
triangle lies in that interval, from the packed arrays of the port's BVH
(`pk_bounds`, `pk_meta`, `pk_tri_rows`).  It is the counterpart of the JAX
package's Pallas kernel `trace/packet7.py:_kernel` (entry `packet7_trace`):
an inner loop of slab tests on both children, near-child-first steering by
the node's split axis and leaf enqueues, and an outer loop that drains the
queued leaves.  Here a "packet" is one ray, and near first is taken from the
sign of the ray's own direction on the split axis, so only the triangle
that wins an exact tie in t can differ from the other traversals.  The
returned ids are slot ids, the triangle ids of a slot-ordered scene.  Lanes
with t_max <= t_min are not traced and report no hit (t_max, -1).

On a CUDA tensor the wrapper launches `csrc/packet7.cu` (built with nvcc at
first use, bound with ctypes) and never anything else; on a CPU tensor it
runs `packet7_plain`, the same walk in plain PyTorch, which also serves as
the kernel's reference on the card.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import os

import torch

from evplp_tpu_torch.accel.bvh import ROW_STRIDE, ROW_TRIS
from evplp_tpu_torch.native.build import check_tensor, load_cuda_library
from evplp_tpu_torch.trace.traverse import (BIG, check_rays_alloc_hits,
                                            ray_tri)

STACK_DEPTH = 64        # per-ray node stack (csrc/packet7.cu kStackDepth)
QUEUE_CAP = 8           # per-ray leaf queue (csrc/packet7.cu kQueueCap)
# rays per batched drain of the plain version (bounds its temporaries)
DRAIN_BLOCK = 1 << 13

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "packet7.cu")

launches = 0


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # bounds, meta, rows; rays: o, d, t_min, t_max, R; out: t, prim, u, v;
    # stream
    args = [vp] * 7 + [ci] + [vp] * 5
    return load_cuda_library("packet7", _SRC, {
        "evplp_packet7_closest": args, "evplp_packet7_any": args})


def check_packed_scene(bvh, dev):
    """Raise unless the BVH carries the packed layout on dev, with a tree
    shallow enough for the kernel's stack."""
    n = bvh.node_min.shape[0]
    if bvh.pk_meta.shape[0] != n:
        raise ValueError("the BVH has no packed layout (scenes of at most "
                         "2048 triangles are tested densely)")
    if bvh.depth >= STACK_DEPTH:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the kernel's stack "
                         f"of {STACK_DEPTH}")
    check_tensor(bvh.pk_bounds, "pk_bounds", torch.float32, (n, 8), dev)
    check_tensor(bvh.pk_meta, "pk_meta", torch.int32, (n, 4), dev)
    check_tensor(bvh.pk_tri_rows, "pk_tri_rows", torch.float32,
                 (bvh.pk_tri_rows.shape[0], 128), dev)


def packet7_cuda(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Launch the CUDA kernel on PyTorch's current stream.  Returns
    (t, slot, u, v); with any_hit, slot >= 0 marks an occluded ray and
    t, u, v are those of the first hit found.  `tris` is not read."""
    global launches
    t, prim, u, v = check_rays_alloc_hits(o, d, t_min, t_max,
                                          "the packet7 kernel")
    dev, r = o.device, o.shape[0]
    check_packed_scene(bvh, dev)
    if r == 0:
        return t, prim, u, v
    lib = load_library()
    fn = lib.evplp_packet7_any if any_hit else lib.evplp_packet7_closest
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bvh.pk_bounds.data_ptr(), bvh.pk_meta.data_ptr(),
                 bvh.pk_tri_rows.data_ptr(), o.data_ptr(), d.data_ptr(),
                 t_min.data_ptr(), t_max.data_ptr(), r, t.data_ptr(),
                 prim.data_ptr(), u.data_ptr(), v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"packet7 kernel launch failed: CUDA error {err}")
    launches += 1
    return t, prim, u, v


def _box_hit(bounds, node, oa, inv, t):
    """Slab test of each ray against its node's box, as in the kernel."""
    b = bounds[node]
    t0 = (b[:, 0:3] - oa) * inv
    t1 = (b[:, 3:6] - oa) * inv
    t_near = torch.amax(torch.minimum(t0, t1), dim=1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=1)
    return (t_near <= t_far) & (t_far >= 0.0) & (t_near <= t)


def packet7_plain(tris, bvh, o, d, t_min, t_max, any_hit: bool,
                  work: dict | None = None):
    """The kernel's two-level walk in plain PyTorch, batched over rays.

    Each pass of the loop moves every unfinished ray one step: an inner
    step (slab tests of both children, leaf enqueues, steering, push/pop)
    while its walk is alive and its queue has room, else a drain of its
    queued leaves.  Each ray thus runs the kernel's sequence of steps.

    work: optional dict; "slabs" and "tris" are incremented by the box tests
    and ray-triangle tests the kernel makes (an any-hit ray stops at its
    first hit)."""
    r, dev = o.shape[0], o.device
    check_packed_scene(bvh, dev)
    meta = bvh.pk_meta.long()
    slots = bvh.pk_tri_rows[:, :ROW_TRIS * ROW_STRIDE].reshape(-1, ROW_STRIDE)
    maxk = bvh.rpl * ROW_TRIS
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
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    queue = torch.zeros((n, QUEUE_CAP), dtype=torch.int64, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    qn = torch.zeros_like(sp)
    cur = torch.zeros_like(sp)
    if int(meta[0, 0]) > 0:      # the root is a leaf
        qn += 1
        cur -= 1
    qk = torch.arange(QUEUE_CAP, device=dev)[:, None]
    kk = torch.arange(maxk, device=dev)[None, :]
    last_slot = slots.shape[0] - 1

    while ids.numel():
        alive = (cur >= 0) | (sp > 0)
        inner = alive & (qn < QUEUE_CAP - 1)
        ii = torch.nonzero(inner).squeeze(1)
        if ii.numel():
            c = cur[ii]
            left, right, axis = c + 1, meta[c, 2], meta[c, 3]
            tt = t[ii]
            wl = _box_hit(bvh.pk_bounds, left, oa[ii], inv[ii], tt)
            wr = _box_hit(bvh.pk_bounds, right, oa[ii], inv[ii], tt)
            l_leaf, r_leaf = meta[left, 0] > 0, meta[right, 0] > 0
            q = qn[ii]
            for want, child in ((wl & l_leaf, left), (wr & r_leaf, right)):
                queue[ii[want], q[want]] = child[want]
                q = q + want
            qn[ii] = q
            wl, wr = wl & ~l_leaf, wr & ~r_leaf
            pos = da[ii].gather(1, axis[:, None])[:, 0] >= 0.0
            first = torch.where(pos, left, right)
            second = torch.where(pos, right, left)
            wf = torch.where(pos, wl, wr)
            ws = torch.where(pos, wr, wl)
            c = torch.where(wf, first, torch.where(ws, second, -1))
            s = sp[ii]
            push = wf & ws
            stack[ii[push], s[push]] = second[push]
            s = s + push
            pop = (c < 0) & (s > 0)
            top = stack[ii, torch.clamp_min(s - 1, 0)]
            cur[ii] = torch.where(pop, top, c)
            sp[ii] = s - pop.long()
            if work is not None:
                work["slabs"] = work.get("slabs", 0) + 2 * ii.numel()
        dj = torch.nonzero(~inner & (qn > 0)).squeeze(1)
        for b0 in range(0, dj.numel(), DRAIN_BLOCK):
            _drain(dj[b0:b0 + DRAIN_BLOCK], queue, qn, meta, slots, qk, kk,
                   last_slot, oa, da, lo, t, prim, u, v, any_hit, work)
        qn[dj] = 0
        done = ~((cur >= 0) | (sp > 0)) & (qn == 0)
        if any_hit:
            done |= prim >= 0
        if bool(done.any()):
            fin = ids[done]
            t_out[fin], prim_out[fin] = t[done], prim[done].int()
            u_out[fin], v_out[fin] = u[done], v[done]
            keep = ~done
            (ids, oa, da, inv, lo, t, prim, u, v, stack, queue, sp, qn,
             cur) = (x[keep] for x in (ids, oa, da, inv, lo, t, prim, u, v,
                                       stack, queue, sp, qn, cur))
    return t_out, prim_out, u_out, v_out


def _drain(dj, queue, qn, meta, slots, qk, kk, last_slot, oa, da, lo, t,
           prim, u, v, any_hit, work):
    """Test the queued leaves of rays dj in queue order, in place: the
    least t in (t_min, t) wins, the first slot on ties; any hit keeps the
    first hit."""
    m = meta[queue[dj]]                                    # (D, Q, 4)
    valid = (qk[None] < qn[dj][:, None, None]) & (kk[None] < m[..., 0:1])
    slot = torch.clamp(m[..., 1:2] * ROW_TRIS + kk[None], 0, last_slot)
    valid, slot = valid.flatten(1), slot.flatten(1)        # (D, Q * maxk)
    tri = slots[slot]
    tt, uu, vv, ok = ray_tri(oa[dj, None], da[dj, None], tri[..., 0:3],
                             tri[..., 3:6], tri[..., 6:9])
    ok = ok & valid & (tt > lo[dj, None]) & (tt < t[dj, None])
    if any_hit:
        j = torch.argmax(ok.to(torch.int8), dim=1, keepdim=True)
        hit = ok.any(dim=1)
        if work is not None:
            tested = torch.cumsum(valid, dim=1).gather(1, j)[:, 0]
            work["tris"] = work.get("tris", 0) + int(
                torch.where(hit, tested, valid.sum(dim=1)).sum())
    else:
        j = torch.argmin(torch.where(ok, tt, float("inf")), dim=1,
                         keepdim=True)
        hit = ok.gather(1, j)[:, 0]
        if work is not None:
            work["tris"] = work.get("tris", 0) + int(valid.sum())
    t[dj] = torch.where(hit, tt.gather(1, j)[:, 0], t[dj])
    prim[dj] = torch.where(hit, slot.gather(1, j)[:, 0], prim[dj])
    u[dj] = torch.where(hit, uu.gather(1, j)[:, 0], u[dj])
    v[dj] = torch.where(hit, vv.gather(1, j)[:, 0], v[dj])


def packet7_trace(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Closest- or any-hit traversal: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if o.device.type == "cuda":
        return packet7_cuda(tris, bvh, o, d, t_min, t_max, any_hit)
    if o.device.type == "cpu":
        return packet7_plain(tris, bvh, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no packet7 traversal for device {o.device}")
