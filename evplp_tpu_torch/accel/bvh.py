"""BVH construction (host) and its device arrays (counterpart of the JAX
package's `accel/bvh.py`).

The tree is the C++ binned-SAH builder's (`native/bvh_builder.cpp`),
flattened in depth-first order with skip pointers so traversal is
stackless: a ray at node i goes to i + 1 when it enters the box and to
skip[i] when it misses the box or has tested the leaf.

Scenes above `BRUTE_FORCE_MAX_TRIS` store their triangles in SLOT order:
leaf L owns slots [L * ROW_TRIS, (L + rpl) * ROW_TRIS), padded with empty
slots, so the traversal's slot ids are the triangle ids the shading tables
use and both packages report the same prim ids.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from evplp_tpu_torch.native import bvh_native

# triangles per slot row of a leaf (the JAX package's packed-row width)
ROW_TRIS = 14
BRUTE_FORCE_MAX_TRIS = 2048


@dataclass(frozen=True)
class BVH:
    """Flattened BVH, N nodes in DFS order, root 0.

    node_min/node_max: (N, 3) f32 bounds.  node_skip: (N,) i32, the node
    after this subtree (N = done).  node_first: (N,) i32, leaf: first
    triangle (slot); internal: -1.  node_count: (N,) i32, leaf: number of
    triangles; internal: 0."""
    node_min: torch.Tensor
    node_max: torch.Tensor
    node_skip: torch.Tensor
    node_first: torch.Tensor
    node_count: torch.Tensor


def _slot_order(first, count, perm, leaf_size: int):
    """Slot layout of the leaves: returns (order, node_first) where order[s]
    is the triangle in slot s (-1 = padding) and node_first is slot-based."""
    rpl = -(-leaf_size // ROW_TRIS)
    leaf_nodes = np.nonzero(count > 0)[0]
    num_rows = max(len(leaf_nodes), 1) * rpl
    leaf_row = np.zeros(count.shape[0], np.int32)
    leaf_row[leaf_nodes] = rpl * np.arange(len(leaf_nodes), dtype=np.int32)
    k = np.arange(rpl * ROW_TRIS, dtype=np.int64)[None, :]
    tri_idx = first[leaf_nodes].astype(np.int64)[:, None] + k
    counts = np.minimum(count[leaf_nodes], rpl * ROW_TRIS).astype(np.int64)
    valid = (k < counts[:, None]) & (tri_idx < perm.shape[0])
    prim_map = np.full((num_rows * ROW_TRIS,), -1, np.int64)
    prim_map[:len(leaf_nodes) * rpl * ROW_TRIS] = np.where(
        valid, tri_idx, -1).reshape(-1)
    order = np.where(prim_map >= 0, perm[np.maximum(prim_map, 0)], -1)
    node_first = np.where(count > 0, leaf_row * ROW_TRIS, -1).astype(np.int32)
    return order, node_first


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              leaf_size: int = 14):
    """Build and flatten.  Returns (arrays, order): `arrays` holds the five
    node arrays as numpy, and per-triangle arrays must be stored as
    X[order[i]] (order[i] == -1: an empty padding slot).  Above
    BRUTE_FORCE_MAX_TRIS the order is the slot order, else the builder's
    leaf permutation."""
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    nmin, nmax, skip, first, count, perm = bvh_native.build(v0, v1, v2,
                                                            leaf_size)
    order = perm
    if v0.shape[0] > BRUTE_FORCE_MAX_TRIS:
        order, first = _slot_order(first, count, perm, leaf_size)
    arrays = dict(node_min=nmin, node_max=nmax,
                  node_skip=skip.astype(np.int32),
                  node_first=first.astype(np.int32),
                  node_count=count.astype(np.int32))
    return arrays, order


def bvh_from_arrays(arrays: dict, device) -> BVH:
    return BVH(**{k: torch.as_tensor(np.array(arrays[k]), device=device)
                  for k in ("node_min", "node_max", "node_skip",
                            "node_first", "node_count")})
