"""BVH construction (host) and its device arrays (counterpart of the JAX
package's `accel/bvh.py`).

The tree is the C++ binned-SAH builder's (`native/bvh_builder.cpp`),
flattened in depth-first order with skip pointers so traversal is
stackless: a ray at node i goes to i + 1 when it enters the box and to
skip[i] when it misses the box or has tested the leaf.

Scenes above `BRUTE_FORCE_MAX_TRIS` also get the packed node layout of the
JAX package's packet kernels (`_pack_for_packet`): triangle rows of
ROW_TRIS slots, per-node meta [count, leaf_row, right_child, split_axis]
and (N, 8) bounds.  Their triangles are stored in SLOT order: leaf L owns
slots [L * ROW_TRIS, (L + rpl) * ROW_TRIS), padded with empty slots, so
the traversals' slot ids are the triangle ids the shading tables use and
both packages report the same prim ids.  The JAX package's fused-node and
packed16 forms are TPU memory layouts and are not built.

Every BVH also gets the layout that the port's three traversal kernels
read (`walk_layout`; csrc/traverse.cu, packet7.cu, packet.cu): one 64-byte
record per internal node holding both children's boxes and references, and
one 48-byte record per triangle.  It is a bit-for-bit copy of the node and
triangle arrays; the packed layout and the skip-pointer arrays stay for the
plain walks, the JAX comparisons and packet7's slot ids.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from evplp_tpu_torch.native import bvh_native

# triangles per slot row of a leaf (the JAX package's packed-row width), and
# floats per slot (v0, e1, e2)
ROW_TRIS = 14
ROW_STRIDE = 9
BRUTE_FORCE_MAX_TRIS = 2048

NODE_KEYS = ("node_min", "node_max", "node_skip", "node_first", "node_count")
PACKED_KEYS = ("pk_tri_rows", "pk_meta", "pk_bounds", "pk_prim_map")
# floats of one walk node record and of one walk triangle record
WALK_NODE_FLOATS = 16
WALK_TRI_FLOATS = 12


@dataclass(frozen=True)
class BVH:
    """Flattened BVH, N nodes in DFS order, root 0.

    node_min/node_max: (N, 3) f32 bounds.  node_skip: (N,) i32, the node
    after this subtree (N = done).  node_first: (N,) i32, leaf: first
    triangle (slot); internal: -1.  node_count: (N,) i32, leaf: number of
    triangles; internal: 0.

    pk_tri_rows: (L, 128) f32, ROW_TRIS slots of (v0, e1, e2) per row, rpl
    rows per leaf.  pk_meta: (N, 4) i32 [count, leaf_row, right_child,
    split_axis].  pk_bounds: (N, 8) f32 [min3, max3, two meta words].
    pk_prim_map: (L * ROW_TRIS,) i32, the builder-order triangle of each
    slot (-1 = padding).  One-row dummies at or below BRUTE_FORCE_MAX_TRIS.

    walk_nodes: (M, 16) f32 and walk_tris: (T, 12) f32, the traversal
    kernels' records (`walk_layout`).

    rpl: slot rows per leaf.  fused_nodes: the JAX package would build this
    scene with fused node rows (above 280,000 triangles); its dispatch then
    runs only the packet3 kernel.  depth: the longest root-to-leaf path in
    edges, which bounds the traversal stacks.  slot_order: the packed
    layout is present and node_first holds its slots (leaf_row *
    ROW_TRIS), as in every packed BVH `build_bvh` makes (the JAX package's
    pack-only build keeps the leaf order of its SAH build)."""
    node_min: torch.Tensor
    node_max: torch.Tensor
    node_skip: torch.Tensor
    node_first: torch.Tensor
    node_count: torch.Tensor
    pk_tri_rows: torch.Tensor
    pk_meta: torch.Tensor
    pk_bounds: torch.Tensor
    pk_prim_map: torch.Tensor
    walk_nodes: torch.Tensor
    walk_tris: torch.Tensor
    rpl: int = 1
    fused_nodes: bool = False
    depth: int = 0
    slot_order: bool = False


def pack_for_packet(nmin, nmax, skip, first, count, v0p, v1p, v2p,
                    leaf_size: int):
    """The packet kernels' layout, a copy of the JAX package's
    `_pack_for_packet`: (tri_rows, meta, bounds, prim_map) as numpy.  The
    v*p arrays are the triangles in the builder's leaf order."""
    n = count.shape[0]
    num_tris = v0p.shape[0]
    rpl = -(-leaf_size // ROW_TRIS)
    assert count.max(initial=0) <= rpl * ROW_TRIS, \
        f"packet layout requires leaf_size <= {rpl * ROW_TRIS}"
    leaf_nodes = np.nonzero(count > 0)[0]
    l = max(len(leaf_nodes), 1) * rpl

    leaf_row_of_node = np.zeros(n, np.int32)
    leaf_row_of_node[leaf_nodes] = rpl * np.arange(len(leaf_nodes),
                                                   dtype=np.int32)

    starts = first[leaf_nodes].astype(np.int64)
    counts = np.minimum(count[leaf_nodes], rpl * ROW_TRIS).astype(np.int64)
    k = np.arange(rpl * ROW_TRIS, dtype=np.int64)[None, :]
    tri_idx = starts[:, None] + k
    valid = (k < counts[:, None]) & (tri_idx < num_tris)
    tri_c = np.minimum(tri_idx, num_tris - 1)

    e1p = v1p - v0p
    e2p = v2p - v0p
    rows = np.zeros((l, ROW_TRIS, ROW_STRIDE), np.float32)
    nl = len(leaf_nodes) * rpl
    for c, x in enumerate((v0p, e1p, e2p)):
        rows[:nl, :, 3 * c:3 * c + 3] = np.where(
            valid[..., None], x[tri_c], 0).reshape(-1, ROW_TRIS, 3)
    rows = np.pad(rows.reshape(l, ROW_TRIS * ROW_STRIDE),
                  ((0, 0), (0, 128 - ROW_TRIS * ROW_STRIDE)))
    prim_map = np.full((l * ROW_TRIS,), -1, np.int32)
    prim_map[:nl * ROW_TRIS] = np.where(valid, tri_c, -1).astype(
        np.int32).reshape(-1)

    meta = np.zeros((n, 4), np.int32)
    meta[:, 0] = np.minimum(count, rpl * ROW_TRIS)
    meta[:, 1] = np.where(count > 0, leaf_row_of_node, 0)
    internal = np.nonzero(count == 0)[0]
    right = np.zeros(n, np.int32)
    right[internal] = skip[np.minimum(internal + 1, n - 1)]
    meta[:, 2] = right

    # split axis for near-child-first traversal: the axis along which the
    # two children's box centres are farthest apart (left = lower side)
    ctr = (nmin + nmax) * 0.5
    left_id = np.minimum(internal + 1, n - 1)
    right_id = np.minimum(right[internal], n - 1)
    gap = ctr[right_id] - ctr[left_id]
    meta[internal, 3] = np.argmax(gap, axis=1).astype(np.int32) \
        if len(internal) else 0

    bounds = np.zeros((n, 8), np.float32)
    bounds[:, 0:3] = nmin
    bounds[:, 3:6] = nmax
    # the JAX package's fused meta words ride in lanes 6/7 (unused here)
    w0 = (meta[:, 0] | (meta[:, 1] << 6)).astype(np.int32)
    w1 = ((meta[:, 2] << 2) | meta[:, 3]).astype(np.int32)
    bounds[:, 6] = w0.view(np.float32)
    bounds[:, 7] = w1.view(np.float32)
    return rows, meta, bounds, prim_map


def _dummy_packed():
    return (np.zeros((1, 128), np.float32), np.zeros((1, 4), np.int32),
            np.zeros((1, 8), np.float32), np.full((8,), -1, np.int32))


def tree_depth(skip: np.ndarray, count: np.ndarray) -> int:
    """Longest root-to-leaf path, in edges, of a skip-pointer DFS tree."""
    n = count.shape[0]
    depth = np.zeros(n, np.int64)
    for i in np.nonzero(count[:-1] == 0)[0]:
        depth[i + 1] = depth[i] + 1
        if skip[i + 1] < n:
            depth[skip[i + 1]] = depth[i] + 1
    return int(depth.max(initial=0))


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              leaf_size: int = 14, fused_nodes: bool = False):
    """Build and flatten.  Returns (arrays, order): `arrays` holds the node
    arrays, the packed layout (dummies at or below BRUTE_FORCE_MAX_TRIS),
    rpl and fused_nodes, and per-triangle arrays must be stored as
    X[order[i]] (order[i] == -1: an empty padding slot).  Above
    BRUTE_FORCE_MAX_TRIS the order is the slot order, else the builder's
    leaf permutation."""
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    nmin, nmax, skip, first, count, perm = bvh_native.build(v0, v1, v2,
                                                            leaf_size)
    order = perm
    pack = v0.shape[0] > BRUTE_FORCE_MAX_TRIS
    pk = _dummy_packed()
    if pack:
        pk = pack_for_packet(nmin, nmax, skip, first, count, v0[perm],
                             v1[perm], v2[perm], leaf_size)
        prim_map = pk[3]
        order = np.where(prim_map >= 0, perm[np.maximum(prim_map, 0)], -1)
        # node_first in slot space: leaf_row * ROW_TRIS
        first = np.where(count > 0, pk[1][:, 1] * ROW_TRIS, -1)
    arrays = dict(node_min=nmin, node_max=nmax,
                  node_skip=skip.astype(np.int32),
                  node_first=first.astype(np.int32),
                  node_count=count.astype(np.int32),
                  **dict(zip(PACKED_KEYS, pk)),
                  bvh_rpl=-(-leaf_size // ROW_TRIS) if pack else 1,
                  bvh_fused_nodes=bool(pack and fused_nodes))
    return arrays, order


def walk_layout(nmin, nmax, skip, first, count, v0, e1, e2):
    """The traversal kernels' records, as numpy: (nodes (M, 16) f32,
    tris (T, 12) f32).  Boxes and vertices are copied bit for bit.

    Node record 0 is a super-root whose left child is the root and whose
    right child is an empty leaf; record 1 + k is the k-th internal node in
    DFS order.  A record holds [left box min3 max3, right box min3 max3,
    left ref, right ref, left count, right count], the last four as int32
    bits.  The children of internal node i are i + 1 and skip[i + 1].  A ref
    >= 0 is an internal child's record; a ref < 0 is a leaf whose first
    triangle is ~ref and whose triangle count is the count word.  Triangle
    record s is [v0, 0, e1, 0, e2, 0] of triangle s, in the order the node
    arrays index (the slot order above BRUTE_FORCE_MAX_TRIS)."""
    n = count.shape[0]
    internal = np.nonzero(count == 0)[0]
    rec = np.zeros(n, np.int64)
    rec[internal] = 1 + np.arange(len(internal))
    left = internal + 1
    kids = np.stack([np.concatenate([[0], left]),
                     np.concatenate([[0], skip[left]])], axis=1)  # (M, 2)
    nodes = np.zeros((kids.shape[0], WALK_NODE_FLOATS), np.float32)
    words = nodes.view(np.int32)
    for c in range(2):
        k = kids[:, c]
        nodes[:, 6 * c:6 * c + 3] = nmin[k]
        nodes[:, 6 * c + 3:6 * c + 6] = nmax[k]
        words[:, 12 + c] = np.where(count[k] > 0, ~first[k], rec[k])
        words[:, 14 + c] = count[k]
    # the super-root's right child: an empty leaf (no triangles)
    words[0, 13], words[0, 15] = -1, 0
    nt = v0.shape[0]
    tris = np.zeros((nt, WALK_TRI_FLOATS), np.float32)
    for c, x in enumerate((v0, e1, e2)):
        tris[:, 4 * c:4 * c + 3] = x
    return nodes, tris


def bvh_from_arrays(arrays: dict, device) -> BVH:
    """BVH from numpy arrays keyed as `build_bvh` writes them, plus the
    triangles v0, e1, e2 in the order the node arrays index (as
    `scene.scene_arrays` writes them), from which the walk records are
    derived."""
    skip = np.asarray(arrays["node_skip"])
    count = np.asarray(arrays["node_count"])
    meta = np.asarray(arrays["pk_meta"])
    leaf = count > 0
    slot_order = meta.shape[0] == count.shape[0] and bool(np.array_equal(
        np.asarray(arrays["node_first"])[leaf], meta[leaf, 1] * ROW_TRIS))
    walk = walk_layout(*(np.asarray(arrays[k]) for k in NODE_KEYS + (
        "v0", "e1", "e2")))
    return BVH(**{k: torch.as_tensor(np.array(arrays[k]), device=device)
                  for k in NODE_KEYS + PACKED_KEYS},
               walk_nodes=torch.as_tensor(walk[0], device=device),
               walk_tris=torch.as_tensor(walk[1], device=device),
               rpl=int(arrays["bvh_rpl"]),
               fused_nodes=bool(arrays["bvh_fused_nodes"]),
               depth=tree_depth(skip, count), slot_order=slot_order)
