"""Pack a host `rfx_torch.bvh.FlatBVH` into the fused kernel's device tables.

The counterpart of rfx/ops/pallas_trace.py:_pack_bvh. Node boxes are the
builder's `aabb_min` / `aabb_max` themselves (the TPU tables store center and
half extent, and `c - h` can round one ulp inside the true box); face ids are
int32, so there is no 2^24 limit. The TPU's node padding for speculative
windows and its 128-row triangle blocks are not carried over.

Two node tables come from one tree: the preorder table (`nodes`), which the
stackless walk reads, and, for a binary tree, the child-pair table
(`pairs`), which the near-first walk of the fused kernel reads (layouts in
rfx_torch/csrc/bvh_walk.cuh).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rfx_torch.bvh import FlatBVH
from rfx_torch.utils.profiling import set_gauge, spanned


#: Bits of a node's `leaf` lane that hold tri_count; tri_start takes the rest.
COUNT_BITS = 6
MAX_LEAF_TRIS = (1 << COUNT_BITS) - 1
#: Keeps every `leaf` pattern below 0x7F800000, a finite float32: a NaN
#: pattern's payload need not survive a copy that treats the row as floats.
MAX_PADDED_TRIS = 0x7F800000 >> COUNT_BITS
#: Entries of the near-first walk's per-thread stack (bvh_walk.cuh's
#: kNearFirstStack). A tree of `max_depth` levels needs `max_depth - 1`:
#: one entry at most for each internal node above the one being visited.
STACK_CAPACITY = 32


@dataclass
class PackedBVH:
    """Device tables of one scene's BVH (layouts documented in
    rfx_torch/csrc/bvh_walk.cuh). A node is one 32-byte row: its box, and in
    the two lanes a box leaves free the int32 bit patterns of its skip
    pointer and of `tri_start << COUNT_BITS | tri_count` (0 for an internal
    node), so that a visit reads one sector."""

    nodes: torch.Tensor  # (n_nodes, 8) f32: lo xyz, skip bits, hi xyz, leaf bits
    tri: torch.Tensor  # (P, 12) f32: v0, e1, e2, unit normal
    tri_face: torch.Tensor  # (P,) i32: original face id, -1 for padding
    leaf_size: int = 8  # the builder's pad quantum: no leaf holds more triangles
    # (n_internal, 16) f32: per internal node in preorder, each child's lo xyz,
    # ref bits, hi xyz, 0; None where the tree is not binary or is one leaf.
    pairs: torch.Tensor | None = None
    max_depth: int = 1  # levels of the tree, the root's included

    @property
    def near_first(self) -> bool:
        """Whether the fused kernel walks this tree nearer child first: it has
        a child-pair table and the stack holds its depth."""
        return self.pairs is not None and self.max_depth - 1 <= STACK_CAPACITY

    @property
    def n_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def n_padded_tris(self) -> int:
        return int(self.tri.shape[0])

    @property
    def skip(self) -> torch.Tensor:
        """(n_nodes,) i32 skip pointers, read back from the nodes' lane 3."""
        return self.nodes.view(torch.int32)[:, 3]

    @property
    def tri_start(self) -> torch.Tensor:
        """(n_nodes,) i32 first padded triangle of each leaf (0 for internal nodes)."""
        return self.nodes.view(torch.int32)[:, 7] >> COUNT_BITS

    @property
    def tri_count(self) -> torch.Tensor:
        """(n_nodes,) i32 triangles of each leaf; 0 marks an internal node."""
        return self.nodes.view(torch.int32)[:, 7] & MAX_LEAF_TRIS


def child_pairs(nodes: np.ndarray, skip: np.ndarray, internal: np.ndarray) -> np.ndarray | None:
    """The child-pair table of a binary preorder tree from its packed
    preorder rows `nodes` ((n, 8), `pack_bvh`'s): record k is the k-th
    internal node in preorder, its left child (node i+1) in lanes 0-7 and its
    right child (node skip[i+1]) in lanes 8-15, each as lo xyz, ref bits, hi
    xyz, 0. A child's ref is `tri_start << COUNT_BITS | tri_count` for a
    leaf and `k' << COUNT_BITS` for the internal node of record k' (a count
    of 0 marks it). None where a node has other than two children or the
    root is a leaf."""
    parent = np.flatnonzero(internal)
    if parent.size == 0:
        return None
    left = parent + 1
    right = skip[left]
    if np.any(right >= skip[parent]) or np.any(skip[right] != skip[parent]):
        return None
    # Each internal node's record; a binary tree has fewer internal nodes
    # than padded triangles, so every ref is below 0x7F800000 (`pack_bvh`
    # bounds those).
    record = np.cumsum(internal) - 1
    bits = nodes.view(np.int32)
    ref = np.where(internal, record << COUNT_BITS, bits[:, 7]).astype(np.int32)
    out = np.zeros((parent.size, 16), np.float32)
    for half, child in ((0, left), (8, right)):
        out[:, half:half + 8] = nodes[child]
        out.view(np.int32)[:, half + 3] = ref[child]
        out[:, half + 7] = 0.0
    return out


@spanned("rfx.bvh.pack")
def pack_bvh(flat: FlatBVH, device: torch.device) -> PackedBVH:
    """The device tables of `flat` on `device`, in the span `rfx.bvh.pack`;
    sets the gauge `bvh_table_bytes` of `profiling.counters()`."""
    n = flat.n_nodes
    if n == 0 or flat.n_padded_tris == 0:
        raise ValueError("cannot pack an empty BVH")
    skip = np.asarray(flat.skip, np.int64)
    if np.any(skip <= np.arange(n)) or np.any(skip > n):
        raise ValueError("BVH skip pointers must point forward and end at n_nodes")
    count = np.asarray(flat.tri_count, np.int64)
    if int(count.max()) > flat.leaf_size:
        raise ValueError("a BVH leaf holds more triangles than its leaf_size")
    if int(count.max()) > MAX_LEAF_TRIS or flat.n_padded_tris > MAX_PADDED_TRIS:
        raise ValueError(f"the packed node holds at most {MAX_LEAF_TRIS} triangles per leaf and "
                         f"{MAX_PADDED_TRIS} padded triangles, got {int(count.max())} and "
                         f"{flat.n_padded_tris}")
    start = np.where(count > 0, np.asarray(flat.tri_start, np.int64), 0)
    nodes = np.zeros((n, 8), np.float32)
    nodes[:, 0:3] = flat.aabb_min
    nodes[:, 4:7] = flat.aabb_max
    bits = nodes.view(np.int32)
    bits[:, 3] = skip
    bits[:, 7] = start << COUNT_BITS | count

    nrm = np.cross(flat.tri_e1, flat.tri_e2)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    tri = np.concatenate([flat.tri_v0, flat.tri_e1, flat.tri_e2, nrm], axis=1).astype(np.float32)

    pairs = child_pairs(nodes, skip, count == 0)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    packed = PackedBVH(dev(nodes), dev(tri), dev(np.asarray(flat.tri_face, np.int32)),
                       int(flat.leaf_size), None if pairs is None else dev(pairs),
                       flat.max_depth())
    set_gauge("bvh_table_bytes", table_bytes(packed))
    return packed


def table_bytes(packed: PackedBVH) -> int:
    """The bytes of a packed tree's device tables, from the tensors' sizes."""
    tables = (packed.nodes, packed.tri, packed.tri_face, packed.pairs)
    return sum(t.nbytes for t in tables if t is not None)
