"""Vector math, orthonormal bases, warps and MIS heuristics over batched
(..., 3) tensors (counterpart of the JAX package's `core/mathutil.py`).

Every function broadcasts over leading batch dimensions and treats the
last axis as xyz.  Sums over xyz are written as ((x + y) + z), the order
the reference's reductions take.
"""
from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi

EPS_REFL = 1e-6          # reflectance / black-surface cutoff
EPS_COS = 1e-6           # cosine cutoffs in Phong eval


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis, summed ((x + y) + z) on
    every device (a reduction kernel may pick another order)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize; zero vectors stay (numerically) zero."""
    return v * torch.reciprocal(torch.sqrt(torch.clamp_min(dot(v, v), eps)))[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def reflect(incident: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """GLSL-convention reflect: I - 2*dot(I, N)*N."""
    return incident - 2.0 * dot(incident, n)[..., None] * n


def max_color(c: torch.Tensor) -> torch.Tensor:
    """Max RGB component."""
    return torch.amax(c, dim=-1)


def orthonormal_basis(z: torch.Tensor):
    """Branchless ONB from a unit z axis (Duff et al.); (x, y, z) is
    right-handed."""
    zx, zy, zz = z[..., 0], z[..., 1], z[..., 2]
    sign = torch.where(zz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + zz)
    b = zx * zy * a
    x = torch.stack([1.0 + sign * zx * zx * a, sign * b, -sign * zx], dim=-1)
    y = torch.stack([b, sign + zy * zy * a, -zy], dim=-1)
    return x, y


def from_local(local_dir: torch.Tensor, z_axis: torch.Tensor) -> torch.Tensor:
    """Direction in the ONB frame of z_axis -> world space."""
    x, y = orthonormal_basis(z_axis)
    return (local_dir[..., 0:1] * x + local_dir[..., 1:2] * y
            + local_dir[..., 2:3] * z_axis)


def geometry_term(n1, n2, v12):
    """Two-cosine geometry term with unnormalized v12:
    max(n1.v12, 0) max(-n2.v12, 0) / |v12|^4 = cos1 cos2 / |v12|^2."""
    cos1_u = torch.clamp_min(dot(n1, v12), 0.0)
    cos2_u = torch.clamp_min(-dot(n2, v12), 0.0)
    d2 = torch.clamp_min(dot(v12, v12), 1e-20)
    return cos1_u * cos2_u / (d2 * d2)


def square_to_power_cosine(u: torch.Tensor, exponent) -> torch.Tensor:
    """u -> direction with pdfW = (n+1)/(2pi) cos^n(theta) around +z."""
    cos_t = torch.pow(u[..., 0], 1.0 / (exponent + 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u[..., 1]
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                       dim=-1)


def square_to_cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """u -> cosine-weighted unit dir around +z (pdfW = cos/pi)."""
    x, y = u[..., 0], u[..., 1]
    r = torch.sqrt(torch.clamp_min(1.0 - x, 0.0))
    phi = TWO_PI * y
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r,
                        torch.sqrt(torch.clamp_min(x, 0.0))], dim=-1)


def square_to_cone(u: torch.Tensor, cos_half: torch.Tensor) -> torch.Tensor:
    """Uniform direction in the cone around +z whose half angle has cosine
    cos_half."""
    phi = TWO_PI * u[..., 0]
    z = 1.0 - u[..., 1] * (1.0 - cos_half)
    sl = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([torch.cos(phi) * sl, torch.sin(phi) * sl, z], dim=-1)


def square_to_solid_angle(u: torch.Tensor, half_angle: torch.Tensor) -> torch.Tensor:
    """Uniform direction in a cone of half_angle around +z."""
    return square_to_cone(u, torch.cos(half_angle))


def square_to_barycentric(u: torch.Tensor):
    """Uniform triangle warp: beta = sqrt(x)(1-y), gamma = sqrt(x) y."""
    s = torch.sqrt(u[..., 0])
    return s * (1.0 - u[..., 1]), s * u[..., 1]


def balance_heuristic(pdf_a, pdf_b):
    """pdfA/(pdfA+pdfB), 0 when both vanish."""
    s = pdf_a + pdf_b
    return torch.where(s > 1e-8, pdf_a / torch.clamp_min(s, 1e-20), 0.0)


def max_heuristic(pdf_a, pdf_b):
    """1 if pdfA > pdfB else 0."""
    return torch.where(pdf_a > pdf_b, 1.0, 0.0)


def power_heuristic2(pdf_a, pdf_b):
    """Power-2 heuristic."""
    return balance_heuristic(pdf_a * pdf_a, pdf_b * pdf_b)
