"""BVH ray traversal by warp packets: the Hopper kernel's wrapper and its
plain version.

`packet_trace` computes what `trace/traverse.py:traverse` computes, the
closest hit (t, prim, u, v) in (t_min, t_max) or, with any_hit, whether any
triangle lies in that interval, and equals `traverse_plain` ray for ray.
It is the counterpart of the JAX package's Pallas kernel
`trace/packet.py:_packet_kernel` (entry `packet_trace`), the v1 packet
traversal that the JAX package no longer dispatches: a packet of rays
shares one node stack, and the packet descends where any of its rays wants
a node.  Here a packet is PACKET consecutive rays, one warp on the card,
walking the BVH's walk records (`accel/bvh.py:walk_layout`): each step
tests one record's two children against every ray of the step's mask,
each ray culls leaves by its own conservative test and keeps the least
(t, slot), the packet descends into the child more of its rays reach first
and stacks the other with the mask of the rays that want it, and when
fewer than SOLO rays want a node, each walks that subtree alone with the
ordered walk of `traverse.walk_plain` (`WalkState`).  Lanes with
t_max <= t_min are not traced and report no hit (t_max, -1).

On a CUDA tensor the wrapper launches `csrc/packet.cu` (built with nvcc at
first use, bound with ctypes) and never anything else; on a CPU tensor it
runs `packet_plain`, the same steps in plain PyTorch, which the tests and
chip_smoke.py also use to count the kernel's work.  `launches` counts
kernel launches.
"""
from __future__ import annotations

import os

import torch

from evplp_tpu_torch.trace.traverse import (
    LEAF_WIDEN_T, STACK_DEPTH, WARP, WalkState, add_work, check_stack_depth,
    check_walk_scene, launch_walk_kernel, load_walk_library, test_children)

PACKET = WARP           # rays per packet: one warp
# a node that fewer than SOLO of the packet's rays want is walked by each of
# them alone (csrc/packet.cu kSolo): the packet steps only where all want it
SOLO = 32

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "packet.cu")

launches = 0


def load_library():
    """Build (at first use) and load the kernel library."""
    return load_walk_library("packet", _SRC, "evplp_packet")


def packet_cuda(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Launch the CUDA kernel on PyTorch's current stream.  Returns
    (t, prim, u, v); with any_hit, prim >= 0 marks an occluded ray and
    t, u, v are those of its first hit.  The kernel reads the BVH's walk
    records, not `tris`."""
    global launches
    out = launch_walk_kernel(load_library, "evplp_packet",
                             "the packet kernel", tris, bvh, o, d, t_min,
                             t_max, any_hit)
    if o.shape[0]:
        launches += 1
    return out


def _left_first(want_l, want_r, near_l, near_r):
    """Per packet, whether it takes the left child first (csrc/packet.cu
    left_first): lanes that want one child vote for it, lanes that want
    both for the nearer; left wins a tie of votes."""
    votes_l = (want_l & (~want_r | (near_l <= near_r))).sum(dim=1)
    votes_r = (want_r & (~want_l | (near_r < near_l))).sum(dim=1)
    return votes_l >= votes_r


def packet_plain(tris, bvh, o, d, t_min, t_max, any_hit: bool,
                 work: dict | None = None):
    """The kernel's packet walk in plain PyTorch, batched over packets of
    PACKET consecutive rays (the last one padded with lanes that are not
    traced).

    Each round moves every packet one kernel action: a pop of its stack
    (the popped node keeps the lanes of its mask whose t still admits it),
    then, where fewer than SOLO lanes want the node, a single-ray walk of
    the subtree by each of them (one WalkState pass a round, the packet
    waiting until all have ended), else a packet step: both children tested
    by every lane of the mask, the wanted leaves tested by the lanes whose
    own leaf test passed (the leaf more lanes reach first first), and the
    packet descends into the child more lanes reach first, stacking the
    other with its mask.

    work: optional dict, incremented by "steps" (record steps of lanes: a
    lane of a packet step's mask, or one single-ray step), "tris"
    (ray-triangle tests of lanes), "packet_steps" (steps of packets),
    "lane_packet_steps" (the lanes in their masks), "solo_walks" (subtrees
    walked alone), "solo_passes" (their WalkState passes) and
    "solo_rounds" (rounds packets spent waiting on them)."""
    r, dev = o.shape[0], o.device
    check_stack_depth(bvh)
    check_walk_scene(tris, bvh, dev)
    ws, num = WalkState.in_warps(bvh, o, d, t_min, t_max, wide=True)
    lane_ids = torch.arange(PACKET, device=dev)
    rows_of = torch.arange(num, device=dev)[:, None] * PACKET + lane_ids
    i64 = torch.int64
    cur = torch.zeros((num,), dtype=i64, device=dev)
    mask = (ws.t > ws.lo).reshape(num, PACKET)
    sp = torch.zeros((num,), dtype=i64, device=dev)
    sref = torch.zeros((num, STACK_DEPTH), dtype=i64, device=dev)
    smask = torch.zeros((num, STACK_DEPTH, PACKET), dtype=torch.bool,
                        device=dev)
    snear = torch.zeros((num, STACK_DEPTH, PACKET), dtype=torch.float32,
                        device=dev)
    waiting = torch.zeros((num,), dtype=torch.bool, device=dev)
    ended = ~mask.any(dim=1)
    solo = torch.zeros((num * PACKET,), dtype=torch.bool, device=dev)

    def alive(rows):
        return ws.prim[rows] < 0 if any_hit else torch.ones_like(
            rows, dtype=torch.bool)

    while True:
        # pops: each packet without a node takes stacked nodes until one
        # keeps a lane
        pk = torch.nonzero(~waiting & ~ended & (cur < 0)).squeeze(1)
        while pk.numel():
            empty = sp[pk] == 0
            ended[pk[empty]] = True
            pk = pk[~empty]
            sp[pk] -= 1
            s, rows = sp[pk], rows_of[pk]
            m = (smask[pk, s] & (snear[pk, s] <= ws.t[rows] * LEAF_WIDEN_T)
                 & alive(rows))
            mask[pk], cur[pk] = m, sref[pk, s]
            pk = pk[~m.any(dim=1)]
        act = ~waiting & ~ended
        # fewer than SOLO lanes: each walks the subtree alone
        few = torch.nonzero(act & (mask.sum(dim=1) < SOLO)).squeeze(1)
        if few.numel():
            rows = rows_of[few][mask[few]]
            ws.cur[rows] = cur[few][:, None].expand(-1, PACKET)[mask[few]]
            ws.sp[rows] = 0
            ws.qn[rows] = 0
            solo[rows] = True
            waiting[few] = True
            cur[few] = -1
            add_work(work, "solo_walks", rows.numel())
        pk = torch.nonzero(act & (mask.sum(dim=1) >= SOLO)).squeeze(1)
        if pk.numel():
            _packet_step(ws, pk, rows_of[pk], cur, mask, sp, sref, smask,
                         snear, any_hit, work)
        rows = torch.nonzero(solo).squeeze(1)
        if rows.numel():
            add_work(work, "solo_rounds", int(waiting.sum()))
            add_work(work, "solo_passes", rows.numel())
            done = ws.walk_pass(rows, any_hit, work)
            solo[done] = False
            ws.cur[done] = -1
            ws.qn[done] = 0
            waiting &= solo.reshape(num, PACKET).any(dim=1)
        elif not bool(act.any()):
            break
    t, prim, u, v = ws.hits()
    return t[:r], prim[:r], u[:r], v[:r]


def _packet_step(ws, pk, rows, cur, mask, sp, sref, smask, snear, any_hit,
                 work):
    """One packet step of packets pk (lanes `rows`, (P, PACKET)) at their
    records cur[pk] (csrc/packet.cu)."""
    m = mask[pk]
    (near_l, near_r, ref_l, ref_r, cnt_l, cnt_r, want_l,
     want_r) = test_children(ws.nodes, ws.words, cur[pk][:, None],
                             ws.oa[rows], ws.inv[rows], ws.t[rows], True)
    want_l, want_r = want_l & m, want_r & m
    leaf_l, leaf_r = ref_l < 0, ref_r < 0           # (P, 1)
    lw_l, lw_r = want_l & leaf_l, want_r & leaf_r
    lf = _left_first(lw_l, lw_r, near_l, near_r)[:, None]
    for first in (True, False):
        pick_l = lf if first else ~lf
        want = torch.where(pick_l, lw_l, lw_r)
        if not first:   # the second leaf, if t still admits it
            want &= torch.where(pick_l, near_l, near_r) <= (
                ws.t[rows] * LEAF_WIDEN_T)
            if any_hit:
                want &= ws.prim[rows] < 0
        ref = torch.where(pick_l, ref_l, ref_r).expand_as(want)
        cnt = torch.where(pick_l, cnt_l, cnt_r).expand_as(want)
        ws.test_leaf(rows[want], ~ref[want], cnt[want], any_hit, work)
    alive = ws.prim[rows] < 0 if any_hit else True
    go_l, go_r = want_l & ~leaf_l & alive, want_r & ~leaf_r & alive
    has_l, has_r = go_l.any(dim=1), go_r.any(dim=1)
    lf = _left_first(go_l, go_r, near_l, near_r)
    both = has_l & has_r
    pb, s = pk[both], sp[pk[both]]
    lfb = lf[both][:, None]
    sref[pb, s] = torch.where(lfb, ref_r[both], ref_l[both])[:, 0]
    smask[pb, s] = torch.where(lfb, go_r[both], go_l[both])
    snear[pb, s] = torch.where(lfb, near_r[both], near_l[both])
    sp[pb] = s + 1
    take_l = torch.where(both, lf, has_l)
    cur[pk] = torch.where(both | has_l | has_r,
                          torch.where(take_l, ref_l[:, 0], ref_r[:, 0]), -1)
    mask[pk] = torch.where(take_l[:, None], go_l, go_r)
    add_work(work, "packet_steps", pk.numel())
    add_work(work, "lane_packet_steps", m.sum())
    add_work(work, "steps", m.sum())


def packet_trace(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    """Closest- or any-hit traversal: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if o.device.type == "cuda":
        return packet_cuda(tris, bvh, o, d, t_min, t_max, any_hit)
    if o.device.type == "cpu":
        return packet_plain(tris, bvh, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no packet traversal for device {o.device}")
