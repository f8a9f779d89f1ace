"""Pack a host `rfx.bvh.FlatBVH` into the fused kernel's device tables.

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

from rfx.bvh import FlatBVH


@dataclass
class PackedBVH:
    """Device tables of one scene's BVH (layouts documented in
    rfx_torch/csrc/fused_trace.cu)."""

    node_box: torch.Tensor  # (n_nodes, 8) f32: lo xyz, 0, hi xyz, 0
    node_meta: torch.Tensor  # (n_nodes, 4) i32: tri_start, tri_count (0 = internal), skip, 0
    tri: torch.Tensor  # (P, 12) f32: v0, e1, e2, unit normal
    tri_face: torch.Tensor  # (P,) i32: original face id, -1 for padding

    @property
    def n_nodes(self) -> int:
        return int(self.node_box.shape[0])

    @property
    def n_padded_tris(self) -> int:
        return int(self.tri.shape[0])


def pack_bvh(flat: FlatBVH, device: torch.device) -> PackedBVH:
    n = flat.n_nodes
    if n == 0 or flat.n_padded_tris == 0:
        raise ValueError("cannot pack an empty BVH")
    skip = np.asarray(flat.skip, np.int64)
    if np.any(skip <= np.arange(n)) or np.any(skip > n):
        raise ValueError("BVH skip pointers must point forward and end at n_nodes")
    node_box = np.zeros((n, 8), np.float32)
    node_box[:, 0:3] = flat.aabb_min
    node_box[:, 4:7] = flat.aabb_max
    node_meta = np.zeros((n, 4), np.int32)
    node_meta[:, 0] = flat.tri_start
    node_meta[:, 1] = flat.tri_count
    node_meta[:, 2] = flat.skip

    nrm = np.cross(flat.tri_e1, flat.tri_e2)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    tri = np.concatenate([flat.tri_v0, flat.tri_e1, flat.tri_e2, nrm], axis=1).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PackedBVH(dev(node_box), dev(node_meta), dev(tri),
                     dev(np.asarray(flat.tri_face, np.int32)))
