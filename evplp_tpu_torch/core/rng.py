"""Counter-based random numbers, bit-exact with the JAX package.

Two generators live here:

* `pcg4d` / `uniform4` (Jarzynski & Olano, JCGT 2020): four uint32 counters
  in, four mixed uint32 (or four U[0,1) floats) out.
* `prng_key` / `fold_in` / `uniform`: JAX's default threefry2x32 PRNG as
  `jax.random.PRNGKey`, `jax.random.fold_in` and `jax.random.uniform` draw
  it under `jax_threefry_partitionable=True`.  A key is an int64 tensor of
  shape (..., 2) holding two uint32 words, so a batch of keys is one tensor.

PyTorch has no full uint32 arithmetic on every device, so uint32 values are
carried in int64 and wrapped with `& 0xFFFFFFFF` after each add and
multiply.  Products are split into 16-bit halves so no int64 product can
overflow; the same code runs on CPU and CUDA.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M = 1664525
_A = 1013904223
_INV24 = float(1.0 / (1 << 24))


def _u32(x) -> torch.Tensor:
    """Any integer tensor (or int) -> int64 holding its uint32 bit pattern."""
    x = torch.as_tensor(x)
    return x.to(torch.int64) & MASK32


def _mul(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 values in int64, without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def pcg4d(x, y, z, w):
    """Vectorized pcg4d: four uint32 counters -> four mixed uint32 (int64)."""
    x = (_mul(_u32(x), _M) + _A) & MASK32
    y = (_mul(_u32(y), _M) + _A) & MASK32
    z = (_mul(_u32(z), _M) + _A) & MASK32
    w = (_mul(_u32(w), _M) + _A) & MASK32
    for shift_round in (False, True):
        if shift_round:
            x = x ^ (x >> 16)
            y = y ^ (y >> 16)
            z = z ^ (z >> 16)
            w = w ^ (w >> 16)
        x = (x + _mul(y, w)) & MASK32
        y = (y + _mul(z, x)) & MASK32
        z = (z + _mul(x, y)) & MASK32
        w = (w + _mul(y, z)) & MASK32
    return x, y, z, w


def uniform4(x, y, z, w):
    """Four U[0,1) float32 tensors from four uint32 counters (24-bit)."""
    return tuple((v >> 8).to(torch.float32) * _INV24
                 for v in pcg4d(x, y, z, w))


# ---------------------------------------------------------------------------
# threefry2x32 (Salmon et al., SC'11), as jax.random draws it
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block function on uint32-in-int64 tensors.
    Returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a 32-bit seed: the words (0, seed)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: threefry of the counter pair (0, data) under key.

    key: (..., 2); data: int or integer tensor broadcasting against
    key[..., 0].  Returns keys of the broadcast shape + (2,)."""
    data = _u32(data).to(key.device)
    k0, k1 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32-bit random words in the partitionable threefry layout: element i
    (row-major) is out0 ^ out1 of threefry(key, (i >> 32, i & mask)).

    key: (..., 2) -> (..., *shape) uint32-in-int64."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,))
    k1 = key[..., 1].reshape(lead + (1,))
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & MASK32)
    return (y0 ^ y1).reshape(lead + tuple(shape))


def uniform(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32: the top 23 bits as the
    mantissa of a float in [1, 2), minus one."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    f = fbits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)
