"""Ray casting against the scene (counterpart of the JAX package's
`trace/intersect.py`).

Scenes of at most BRUTE_FORCE_MAX_TRIS triangles are tested densely (rays x
triangles, in blocks); larger scenes go through the BVH traversal
(`trace/traverse.py`), the CUDA kernel on CUDA tensors.  Directions may be
unnormalized: t is in units of |d|, which shadow segments use (origin =
one end, direction = the other end minus it, t in (eps, 1 - eps)).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from evplp_tpu_torch.accel.bvh import BRUTE_FORCE_MAX_TRIS
from evplp_tpu_torch.trace.traverse import BIG, ray_tri, traverse

# elements of one dense (rays x triangles) block
BRUTE_BLOCK_ELEMS = 1 << 22


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


def intersect_closest(tris, bvh, o, d, t_min=1e-5, t_max=BIG) -> Hit:
    """Closest hit for rays o, d: (R, 3); t_min/t_max scalar or (R,)."""
    r = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    t_min, t_max = _interval(t_min, r, o), _interval(t_max, r, o)
    if tris.v0.shape[0] <= BRUTE_FORCE_MAX_TRIS:
        return Hit(*_brute(tris, o, d, t_min, t_max, False))
    return Hit(*traverse(tris, bvh, o, d, t_min, t_max, False))


def intersect_any(tris, bvh, o, d, t_min=1e-5, t_max=BIG) -> torch.Tensor:
    """True where any triangle lies in (t_min, t_max) along the ray.  Lanes
    with an empty interval are never traced (and report False)."""
    r = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    t_min, t_max = _interval(t_min, r, o), _interval(t_max, r, o)
    if tris.v0.shape[0] <= BRUTE_FORCE_MAX_TRIS:
        return _brute(tris, o, d, t_min, t_max, True)
    return traverse(tris, bvh, o, d, t_min, t_max, True)[1] >= 0


def occluded_segment(tris, bvh, p_from, p_to, eps: float = 1e-4, live=None):
    """Segment occlusion the reference's way: origin p_from, unnormalized
    direction p_to - p_from, t in (eps, 1 - eps).  live: optional (R,) bool;
    segments with live False are not traced (their result is unspecified;
    callers mask them out)."""
    d = p_to - p_from
    t_max = 1.0 - eps
    if live is not None:
        t_max = torch.where(live, 1.0 - eps, 0.0)
    return intersect_any(tris, bvh, p_from, d, t_min=eps, t_max=t_max)
