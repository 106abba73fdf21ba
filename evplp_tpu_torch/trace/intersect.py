"""Ray casting against the scene (counterpart of the JAX package's
`trace/intersect.py`).

Scenes of at most BRUTE_FORCE_MAX_TRIS triangles are tested densely (rays x
triangles, in blocks); larger scenes go through the BVH traversal that
the module constant PACKET_IMPL selects ("packet3", "packet7" or "packet"),
its CUDA kernel on CUDA tensors.  "packet" is the port's only way to put
the v1 packet kernel (csrc/packet.cu) on a path.  Directions may be
unnormalized: t is in units of |d|, which shadow segments use (origin =
one end, direction = the other end minus it, t in (eps, 1 - eps)).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from evplp_tpu_torch.accel.bvh import BRUTE_FORCE_MAX_TRIS
from evplp_tpu_torch.trace.packet import packet_trace
from evplp_tpu_torch.trace.packet7 import packet7_trace
from evplp_tpu_torch.trace.traverse import BIG, ray_tri, traverse

# elements of one dense (rays x triangles) block
BRUTE_BLOCK_ELEMS = 1 << 22

# The traversal every ray cast above BRUTE_FORCE_MAX_TRIS goes through, the
# counterpart of the JAX package's A/B constant of the same name (a module
# constant, not a flag):
#   "packet3": trace/traverse.py, kernel csrc/traverse.cu (the default);
#   "packet7": trace/packet7.py, kernel csrc/packet7.cu, the two-level loop
#              with a warp-wide leaf drain;
#   "packet":  trace/packet.py, kernel csrc/packet.cu, warp packets with
#              single-ray walks where a packet falls apart; the JAX package
#              no longer dispatches its v1 kernel, so this value is the
#              port's only path to that kernel.
# All three read the BVH's walk records and equal traverse_plain ray for
# ray, so the value changes no result.
# On a scene the JAX package builds with fused node rows (bvh.fused_nodes,
# above 280,000 triangles) every value gives way to "packet3", as the JAX
# dispatch does: its other kernels do not read that layout.
PACKET_IMPL = "packet3"
TRAVERSALS = {"packet3": traverse, "packet7": packet7_trace,
              "packet": packet_trace}


@dataclass(frozen=True)
class Hit:
    """Closest hit.  prim == -1 means a miss; t is in |d| units (t_max on a
    miss)."""
    t: torch.Tensor
    prim: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor

    @property
    def valid(self):
        return self.prim >= 0


def _interval(x, r: int, like: torch.Tensor) -> torch.Tensor:
    """Scalar or (R,) bound -> contiguous (R,) float32."""
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return x.expand(r).contiguous()


def _brute(tris, o, d, t_min, t_max, any_hit: bool):
    """Dense test of every ray against every triangle, in ray blocks.
    Closest hit: the least t, first triangle on ties."""
    r, nt = o.shape[0], tris.v0.shape[0]
    block = max(1, BRUTE_BLOCK_ELEMS // max(nt, 1))
    outs = []
    for s in range(0, r, block):
        e = min(r, s + block)
        tt, uu, vv, ok = ray_tri(o[s:e, None], d[s:e, None], tris.v0[None],
                                 tris.e1[None], tris.e2[None])
        ok = ok & (tt > t_min[s:e, None]) & (tt < t_max[s:e, None])
        if any_hit:
            outs.append(ok.any(dim=1))
            continue
        tt = torch.where(ok, tt, BIG)
        j = torch.argmin(tt, dim=1, keepdim=True)
        best = tt.gather(1, j)[:, 0]
        hit = best < BIG
        outs.append((torch.where(hit, best, t_max[s:e]),
                     torch.where(hit, j[:, 0].int(), -1),
                     torch.where(hit, uu.gather(1, j)[:, 0], 0.0),
                     torch.where(hit, vv.gather(1, j)[:, 0], 0.0)))
    if any_hit:
        return torch.cat(outs) if outs else torch.zeros(
            (0,), dtype=torch.bool, device=o.device)
    if not outs:
        z = torch.zeros((0,), dtype=torch.float32, device=o.device)
        return z, torch.zeros((0,), dtype=torch.int32, device=o.device), z, z
    return tuple(torch.cat(x) for x in zip(*outs))


def traversal_impl(bvh) -> str:
    """The PACKET_IMPL value a cast against bvh runs under."""
    if PACKET_IMPL not in TRAVERSALS:
        raise ValueError(f"PACKET_IMPL must be one of {sorted(TRAVERSALS)}, "
                         f"got {PACKET_IMPL!r}")
    return "packet3" if bvh.fused_nodes else PACKET_IMPL


def _traverse(tris, bvh, o, d, t_min, t_max, any_hit: bool):
    return TRAVERSALS[traversal_impl(bvh)](tris, bvh, o, d, t_min, t_max,
                                           any_hit)


def intersect_closest(tris, bvh, o, d, t_min=1e-5, t_max=BIG) -> Hit:
    """Closest hit for rays o, d: (R, 3); t_min/t_max scalar or (R,)."""
    r = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    t_min, t_max = _interval(t_min, r, o), _interval(t_max, r, o)
    if tris.v0.shape[0] <= BRUTE_FORCE_MAX_TRIS:
        return Hit(*_brute(tris, o, d, t_min, t_max, False))
    return Hit(*_traverse(tris, bvh, o, d, t_min, t_max, False))


def intersect_any(tris, bvh, o, d, t_min=1e-5, t_max=BIG) -> torch.Tensor:
    """True where any triangle lies in (t_min, t_max) along the ray.  Lanes
    with an empty interval are never traced and report False, under every
    PACKET_IMPL."""
    r = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    t_min, t_max = _interval(t_min, r, o), _interval(t_max, r, o)
    if tris.v0.shape[0] <= BRUTE_FORCE_MAX_TRIS:
        return _brute(tris, o, d, t_min, t_max, True)
    return _traverse(tris, bvh, o, d, t_min, t_max, True)[1] >= 0


def occluded_segment(tris, bvh, p_from, p_to, eps: float = 1e-4, live=None):
    """Segment occlusion the reference's way: origin p_from, unnormalized
    direction p_to - p_from, t in (eps, 1 - eps).  live: optional (R,) bool;
    segments with live False are not traced and report False (the JAX
    package leaves their result unspecified; callers mask them out)."""
    d = p_to - p_from
    t_max = 1.0 - eps
    if live is not None:
        t_max = torch.where(live, 1.0 - eps, 0.0)
    return intersect_any(tris, bvh, p_from, d, t_min=eps, t_max=t_max)


def closest_and_segment(tris, bvh, o, d, t_min, t_max, seg_to,
                        seg_eps: float = 1e-5, seg_live=None):
    """Path tracing's paired trace at one vertex: the closest hit along d
    and the occlusion of the segment o -> seg_to, as intersect_closest plus
    occluded_segment (the JAX function's branch off the packet path; its
    shared sort permutation is TPU tuning).  Returns (Hit, occluded);
    segments with seg_live False are not traced and report False."""
    hit = intersect_closest(tris, bvh, o, d, t_min=t_min, t_max=t_max)
    occluded = occluded_segment(tris, bvh, o, seg_to, eps=seg_eps,
                                live=seg_live)
    return hit, occluded
