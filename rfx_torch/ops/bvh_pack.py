"""Pack a host `rfx_torch.bvh.FlatBVH` into the fused kernel's device tables.

The counterpart of rfx/ops/pallas_trace.py:_pack_bvh. Node boxes are the
builder's `aabb_min` / `aabb_max` themselves (the TPU tables store center and
half extent, and `c - h` can round one ulp inside the true box); face ids are
int32, so there is no 2^24 limit. The TPU's node padding for speculative
windows and its 128-row triangle blocks are not carried over.
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

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    packed = PackedBVH(dev(nodes), dev(tri), dev(np.asarray(flat.tri_face, np.int32)),
                       int(flat.leaf_size))
    set_gauge("bvh_table_bytes", packed.nodes.nbytes + packed.tri.nbytes + packed.tri_face.nbytes)
    return packed
