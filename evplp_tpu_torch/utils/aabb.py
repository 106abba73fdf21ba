"""Axis-aligned bounding boxes (counterpart of the JAX package's
`utils/aabb.py`).

Batched over leading dimensions of torch tensors: union, intersection,
transform by a 4x4 matrix, diagonal, surface area, containment, and the
lightcuts bound `max_cos_bound`, the largest cosine between an axis and
the directions from an origin to any point of the box.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from evplp_tpu_torch.core import mathutil as mu


@dataclass(frozen=True)
class Aabb:
    lo: torch.Tensor  # (..., 3)
    hi: torch.Tensor  # (..., 3)


def empty(shape=(), device="cuda") -> Aabb:
    big = torch.full(tuple(shape) + (3,), 3.0e38, dtype=torch.float32,
                     device=device)
    return Aabb(lo=big, hi=-big)


def from_points(points: torch.Tensor, axis=0) -> Aabb:
    return Aabb(lo=torch.amin(points, dim=axis),
                hi=torch.amax(points, dim=axis))


def union(a: Aabb, b: Aabb) -> Aabb:
    return Aabb(lo=torch.minimum(a.lo, b.lo), hi=torch.maximum(a.hi, b.hi))


def intersect(a: Aabb, b: Aabb) -> Aabb:
    return Aabb(lo=torch.maximum(a.lo, b.lo), hi=torch.minimum(a.hi, b.hi))


def is_valid(a: Aabb) -> torch.Tensor:
    return torch.all(a.lo <= a.hi, dim=-1)


def diagonal_length2(a: Aabb) -> torch.Tensor:
    d = torch.clamp_min(a.hi - a.lo, 0.0)
    return torch.sum(d * d, dim=-1)


def surface_area(a: Aabb) -> torch.Tensor:
    d = torch.clamp_min(a.hi - a.lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def contains(a: Aabb, p: torch.Tensor) -> torch.Tensor:
    return torch.all((p >= a.lo) & (p <= a.hi), dim=-1)


def _corner(a: Aabb, m: int) -> torch.Tensor:
    """Corner m of the box: bit k of m picks hi on axis k."""
    return torch.stack([a.hi[..., k] if m & (1 << k) else a.lo[..., k]
                        for k in range(3)], dim=-1)


def transform(a: Aabb, matrix: torch.Tensor) -> Aabb:
    """Transform by a 4x4 matrix: the box of the 8 transformed corners."""
    corners = torch.stack([_corner(a, m) for m in range(8)])  # (8, ..., 3)
    h = torch.cat([corners, torch.ones(corners.shape[:-1] + (1,),
                                       dtype=corners.dtype,
                                       device=corners.device)], dim=-1)
    out = torch.einsum("ij,c...j->c...i", matrix.to(h.dtype), h)[..., :3]
    return Aabb(lo=torch.amin(out, dim=0), hi=torch.amax(out, dim=0))


def max_cos_bound(a: Aabb, origin: torch.Tensor,
                  axis_dir: torch.Tensor) -> torch.Tensor:
    """Upper bound on cos(angle) between axis_dir and the directions from
    origin to any point of the box, evaluated over the 8 corners; 1 where
    the origin lies inside the box."""
    best = torch.full(a.lo.shape[:-1], -1.0, dtype=a.lo.dtype,
                      device=a.lo.device)
    for m in range(8):
        c = mu.dot(mu.normalize(_corner(a, m) - origin), axis_dir)
        best = torch.maximum(best, c)
    return torch.where(contains(a, origin), 1.0, best)
