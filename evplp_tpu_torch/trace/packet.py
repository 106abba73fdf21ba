"""BVH ray traversal with one shared stack per packet: the Hopper kernel's
wrapper and its plain version.

`packet_trace` computes what `trace/traverse.py:traverse` computes, the
closest hit (t, prim, u, v) in (t_min, t_max) or, with any_hit, whether any
triangle lies in that interval, from the skip-pointer node arrays and the
slot-ordered triangles.  It is the counterpart of the JAX package's Pallas
kernel `trace/packet.py:_packet_kernel` (entry `packet_trace`), the v1
packet traversal that the JAX package no longer dispatches: a packet of
rays shares one node stack, each popped node is slab-tested against all of
them, and the packet descends if any ray wants the node.  Here a packet is
PACKET rays, one warp on the card.  Lanes with t_max <= t_min are not traced
and report no hit (t_max, -1).

On a CUDA tensor the wrapper launches `csrc/packet.cu` (built with nvcc at
first use, bound with ctypes) and never anything else; on a CPU tensor it
runs `packet_plain`, the same walk in plain PyTorch, which also serves as
the kernel's reference on the card.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import os

import torch

from evplp_tpu_torch.native.build import load_cuda_library
from evplp_tpu_torch.trace.traverse import (BIG, check_rays_alloc_hits,
                                            check_skip_pointer_scene, ray_tri)

PACKET = 32             # rays per packet: one warp
STACK_DEPTH = 96        # shared node stack per packet (csrc/packet.cu)

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "packet.cu")

launches = 0


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # nodes: min, max, skip, first, count; tris: v0, e1, e2;
    # rays: o, d, t_min, t_max, R; out: t, prim, u, v; stream
    args = [vp] * 12 + [ci] + [vp] * 5
    return load_cuda_library("packet", _SRC, {
        "evplp_packet_closest": args, "evplp_packet_any": args})


def _check_depth(bvh):
    # a packet's stack holds at most one entry per level plus two
    if bvh.depth + 2 > STACK_DEPTH:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the packet stack "
                         f"of {STACK_DEPTH}")


def packet_cuda(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Launch the CUDA kernel on PyTorch's current stream.  Returns
    (t, prim, u, v); with any_hit, prim >= 0 marks an occluded ray and
    t, u, v are those of its first hit."""
    global launches
    t, prim, u, v = check_rays_alloc_hits(o, d, t_min, t_max,
                                          "the packet kernel")
    dev, r = o.device, o.shape[0]
    check_skip_pointer_scene(tris, bvh, dev)
    _check_depth(bvh)
    if r == 0:
        return t, prim, u, v
    lib = load_library()
    fn = lib.evplp_packet_any if any_hit else lib.evplp_packet_closest
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bvh.node_min.data_ptr(), bvh.node_max.data_ptr(),
                 bvh.node_skip.data_ptr(), bvh.node_first.data_ptr(),
                 bvh.node_count.data_ptr(), tris.v0.data_ptr(),
                 tris.e1.data_ptr(), tris.e2.data_ptr(), o.data_ptr(),
                 d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), r,
                 t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"packet kernel launch failed: CUDA error {err}")
    launches += 1
    return t, prim, u, v


def packet_plain(tris, bvh, o, d, t_min, t_max, any_hit: bool,
                 work: dict | None = None):
    """The kernel's walk in plain PyTorch, batched over packets of PACKET
    consecutive rays (the last one padded with lanes that are not traced).

    Every packet with a non-empty stack pops its top node, slab-tests it
    against its rays and, if any ray wants it, tests all the leaf's
    triangles against all its rays (closest: least t in (t_min, t), the
    first triangle on ties; any hit: the first hit of rays without one) or
    pushes the right child, then the left.  An any-hit packet stops when
    each of its rays has a hit or is not traced.

    work: optional dict; "slabs" and "tris" are incremented by the box tests
    and ray-triangle tests the kernel makes (every lane of a packet tests
    every node it pops and every triangle of a wanted leaf)."""
    r, dev = o.shape[0], o.device
    _check_depth(bvh)
    num = -(-r // PACKET)
    pad = num * PACKET - r

    def lanes(x, fill):
        x = torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])
        return x.reshape((num, PACKET) + x.shape[1:])

    oa, da = lanes(o, 0.0), lanes(d, 1.0)
    lo, t = lanes(t_min, 1.0), lanes(t_max, 0.0)
    live = t > lo
    inv = torch.where(torch.abs(da) > 1e-20, 1.0 / da,
                      torch.where(da >= 0, BIG, -BIG))
    prim = torch.full((num, PACKET), -1, dtype=torch.int32, device=dev)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    stack = torch.zeros((num, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = live.any(dim=1).long()
    leaf_k = torch.arange(int(bvh.node_count.max()), device=dev)
    last_tri = tris.v0.shape[0] - 1

    act = torch.nonzero(sp > 0).squeeze(1)
    while act.numel():
        s = sp[act] - 1
        node = stack[act, s]
        oo, ii = oa[act], inv[act]
        t0 = (bvh.node_min[node][:, None] - oo) * ii
        t1 = (bvh.node_max[node][:, None] - oo) * ii
        t_near = torch.amax(torch.minimum(t0, t1), dim=2)
        t_far = torch.amin(torch.maximum(t0, t1), dim=2)
        want = (live[act] & (t_near <= t_far) & (t_far >= 0.0)
                & (t_near <= t[act]))
        if any_hit:
            want &= prim[act] < 0
        wanted = want.any(dim=1)
        count = bvh.node_count[node]
        if work is not None:
            work["slabs"] = work.get("slabs", 0) + PACKET * act.numel()
        leaf = wanted & (count > 0)
        if bool(leaf.any()):
            pk, nl = act[leaf], node[leaf]
            tri = torch.clamp_max(bvh.node_first[nl][:, None] + leaf_k,
                                  last_tri)                   # (L, K)
            tt, uu, vv, ok = ray_tri(
                oa[pk][:, :, None], da[pk][:, :, None],
                tris.v0[tri][:, None], tris.e1[tri][:, None],
                tris.e2[tri][:, None])                        # (L, P, K)
            ok = (ok & (leaf_k < count[leaf][:, None])[:, None]
                  & (tt > lo[pk][:, :, None]) & (tt < t[pk][:, :, None]))
            if any_hit:
                ok &= (prim[pk] < 0)[:, :, None]
                j = torch.argmax(ok.to(torch.int8), dim=2, keepdim=True)
            else:
                j = torch.argmin(torch.where(ok, tt, float("inf")), dim=2,
                                 keepdim=True)
            hit = ok.gather(2, j)[..., 0]
            t[pk] = torch.where(hit, tt.gather(2, j)[..., 0], t[pk])
            prim[pk] = torch.where(
                hit, tri[:, None, :].expand_as(tt).gather(2, j)[..., 0].int(),
                prim[pk])
            u[pk] = torch.where(hit, uu.gather(2, j)[..., 0], u[pk])
            v[pk] = torch.where(hit, vv.gather(2, j)[..., 0], v[pk])
            if work is not None:
                work["tris"] = work.get("tris", 0) + PACKET * int(
                    count[leaf].sum())
        push = wanted & (count == 0)
        pp, nn, sp_p = act[push], node[push], s[push]
        stack[pp, sp_p] = bvh.node_skip[nn + 1].long()
        stack[pp, sp_p + 1] = nn + 1
        sp[act] = s + 2 * push.long()
        if any_hit:
            done = ((prim[act] >= 0) | ~live[act]).all(dim=1)
            sp[act[done]] = 0
        act = act[sp[act] > 0]
    return tuple(x.reshape(-1)[:r] for x in (t, prim, u, v))


def packet_trace(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Closest- or any-hit traversal: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if o.device.type == "cuda":
        return packet_cuda(tris, bvh, o, d, t_min, t_max, any_hit)
    if o.device.type == "cpu":
        return packet_plain(tris, bvh, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no packet traversal for device {o.device}")
