"""BVH ray traversal as a two-level loop with a warp-wide leaf drain: the
Hopper kernel's wrapper and its plain version.

`packet7_trace` computes what `trace/traverse.py:traverse` computes, the
closest hit (t, slot, u, v) in (t_min, t_max) or, with any_hit, whether any
triangle lies in that interval, and equals `traverse_plain` ray for ray on
a slot-ordered BVH.  It is the counterpart of the JAX package's Pallas
kernel `trace/packet7.py:_kernel` (entry `packet7_trace`): an inner loop of
slab tests on both children, near-child-first steering and leaf enqueues,
and an outer loop that drains the queued leaves.  Here the inner loop is
the ordered step of `traverse.walk_plain` (`WalkState`) over the BVH's
walk records, one thread a ray, and the warp steps while any of its rays
can; then each of the warp's rays drains its queued leaves in order,
keeping the least (t, slot).  It needs the packed layout of the
port's BVH (`pk_meta`, as the TPU kernel does) and returns its slot ids,
which are the triangle ids of a slot-ordered scene.  Lanes with
t_max <= t_min are not traced and report no hit (t_max, -1).

On a CUDA tensor the wrapper launches `csrc/packet7.cu` (built with nvcc at
first use, bound with ctypes) and never anything else; on a CPU tensor it
runs `packet7_plain`, the same steps in plain PyTorch, which the tests and
chip_smoke.py also use to count the kernel's work.  `launches` counts
kernel launches.
"""
from __future__ import annotations

import os

import torch

from evplp_tpu_torch.accel.bvh import ROW_TRIS, WALK_TRI_FLOATS
from evplp_tpu_torch.native.build import check_tensor
from evplp_tpu_torch.trace.traverse import (
    STACK_DEPTH, WARP, WalkState, add_work, launch_walk_kernel,
    load_walk_library)


_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "packet7.cu")

launches = 0


def load_library():
    """Build (at first use) and load the kernel library."""
    return load_walk_library("packet7", _SRC, "evplp_packet7")


def check_packed_scene(bvh, dev):
    """Raise unless the BVH carries the packed layout and the walk records
    on dev, with a tree shallow enough for the kernel's stack."""
    n = bvh.node_min.shape[0]
    if bvh.pk_meta.shape[0] != n:
        raise ValueError("the BVH has no packed layout (scenes of at most "
                         "2048 triangles are tested densely)")
    if bvh.depth >= STACK_DEPTH:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the kernel's stack "
                         f"of {STACK_DEPTH}")
    check_tensor(bvh.pk_meta, "pk_meta", torch.int32, (n, 4), dev)
    check_tensor(bvh.walk_tris, "walk_tris", torch.float32,
                 (bvh.walk_tris.shape[0], WALK_TRI_FLOATS), dev)


def slot_ids(bvh, prim):
    """The packed layout's slot ids (leaf_row * ROW_TRIS + k) of the node
    arrays' triangle ids: the same ids on a slot-ordered BVH, which is
    every packed BVH `build_bvh` makes."""
    if bvh.slot_order:
        return prim
    leaf = torch.nonzero(bvh.node_count > 0).squeeze(1)
    first = bvh.node_first[leaf]
    base = bvh.pk_meta[leaf, 1] * ROW_TRIS
    j = torch.clamp_min(torch.searchsorted(first, prim, right=True) - 1, 0)
    return torch.where(prim >= 0, prim - first[j] + base[j], prim)


def packet7_cuda(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Launch the CUDA kernel on PyTorch's current stream.  Returns
    (t, slot, u, v); with any_hit, slot >= 0 marks an occluded ray and
    t, u, v are those of its least (t, slot) in the drain that found it.
    The kernel reads the BVH's walk records, not `tris`."""
    global launches
    t, prim, u, v = launch_walk_kernel(load_library, "evplp_packet7",
                                       "the packet7 kernel", tris, bvh, o,
                                       d, t_min, t_max, any_hit,
                                       check_packed_scene)
    if o.shape[0]:
        launches += 1
    return t, slot_ids(bvh, prim), u, v


def packet7_plain(tris, bvh, o, d, t_min, t_max, any_hit: bool,
                  work: dict | None = None):
    """The kernel's two-level loop in plain PyTorch, batched over warps of
    WARP consecutive rays (the last one padded with lanes that are not
    traced).

    Each round moves every warp one kernel action: where any of its rays
    can step (walk alive, room for two leaves in its queue), those rays
    take one ordered step; else the warp drains: each ray its own queue in
    order, skipping the leaves its shrinking t no longer admits, keeping
    the least (t, slot); any hit ends a ray at its first hit.  `tris` is
    not read.

    work: optional dict, incremented by "steps" and "tris" (the rays' steps
    and ray-triangle tests), "inner_iters" (steps of warps), "drains"
    (drains of warps) and "drain_paid" (32 x the most triangle tests of one
    ray in a drain, summed over the drains: the lanes' time the drains
    take)."""
    r, dev = o.shape[0], o.device
    check_packed_scene(bvh, dev)
    ws, num = WalkState.in_warps(bvh, o, d, t_min, t_max)
    ws.cur[ws.t > ws.lo] = 0
    rows_of = (torch.arange(num, device=dev)[:, None] * WARP
               + torch.arange(WARP, device=dev))
    warps = torch.nonzero((ws.cur >= 0).reshape(num, WARP).any(dim=1)
                          ).squeeze(1)
    while warps.numel():
        rows = rows_of[warps]                                  # (W, WARP)
        can = ws.stepping()[rows]
        stepping = can.any(dim=1)
        ws.step(rows[can], work)
        add_work(work, "inner_iters", stepping.sum())
        dr = rows[~stepping]
        if dr.numel():
            _drain_warps(ws, dr, any_hit, work)
        warps = warps[((ws.cur[rows] >= 0) | (ws.qn[rows] > 0)).any(dim=1)]
    t, prim, u, v = ws.hits()
    return t[:r], slot_ids(bvh, prim[:r]), u[:r], v[:r]


def _drain_warps(ws, dr, any_hit, work):
    """The drains of warps dr ((D, WARP) rows, csrc/packet7.cu): each lane
    drains its own queue in order (WalkState.drain); any hit ends the walk
    of a ray that took a hit."""
    rows = dr.reshape(-1)
    tests = ws.drain(rows, any_hit, work).reshape(dr.shape)
    add_work(work, "drains", dr.shape[0])
    add_work(work, "drain_paid", WARP * tests.amax(dim=1).sum())
    if any_hit:
        ws.cur[rows[ws.prim[rows] >= 0]] = -1


def packet7_trace(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Closest- or any-hit traversal: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if o.device.type == "cuda":
        return packet7_cuda(tris, bvh, o, d, t_min, t_max, any_hit)
    if o.device.type == "cpu":
        return packet7_plain(tris, bvh, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no packet7 traversal for device {o.device}")
