"""Stackless BVH walk in plain PyTorch (port of rfx/ops/bvh_traverse.py).

All rays advance in lockstep through the flat preorder / skip-pointer layout
of rfx_torch.bvh: each ray keeps its own node cursor; a box that is hit
sends an internal node's ray to node i+1, a missed box to skip[i]; a leaf
whose box is hit tests its fixed `leaf_size` block of padded triangles
(padding rows are degenerate and never hit) and goes to skip[i]. The slab
test is `t_near <= min(t_far, t_best) & t_far >= T_MIN_EPS`, a leaf's
candidate is the first minimum of its block, and it replaces the best hit
only on a strict `<`: ties go to the lowest padded index. Rays that have
left the tree drop out of the loop, which ends when none is left.

That is the order and the arithmetic of the CUDA walk
(rfx_torch/csrc/bvh_walk.cuh: the same products and sums, each rounded
once), so `walk_closest_hit` serves three things:

- the `bvh` backend of `make_env_intersector` and of the facade
  (`make_bvh_env_hit`), with the reference's custom gradient through
  rfx_torch.ops.intersect's one `differentiable_hit`: with
  `differentiable_tris` the cotangent of t reaches the caller's v0, e1, e2;
- an independent reference for the kernels on meshes too large for brute
  force (another tree, another leaf size, the same closest hits off ties);
- with `count=True`, the plain version of the fused kernel's walk counters:
  per ray, the nodes visited, the leaves whose box was hit and the
  triangles tested, integer for integer what the kernel counts.

Node boxes are host-built constants: if vertices move, hit selection uses
the stale bounds while t stays exact for the selected face; rebuild the BVH
when vertex updates are large.
"""

from __future__ import annotations

import torch

from rfx_torch.bvh import LEAF_SIZE, resolve_flat_bvh
from rfx_torch.device import resolve_device
from rfx_torch.ops.bvh_pack import COUNT_BITS, MAX_LEAF_TRIS, PackedBVH, pack_bvh
from rfx_torch.ops.bvh_trace import live_tri, mt_block
from rfx_torch.ops.intersect import (
    MISS,
    T_MIN_EPS,
    differentiable_hit,
    hit_normal_from_edges,
)

__all__ = ["walk_closest_hit", "make_bvh_env_hit"]


def walk_closest_hit(bvh: PackedBVH, o, d, tri=None, *, count: bool = False):
    """Closest hit of (N, 3) f32 rays by the stackless walk: (t (N,) f32, idx
    (N,) int64 padded index), MISS and -1 on a miss. `tri` (P, 12) replaces
    the packed triangle table. With `count`, also an (N, 3) int64 tensor of
    each ray's nodes visited, leaves entered and triangles tested. No
    autograd: see `make_bvh_env_hit`."""
    tri = bvh.tri if tri is None else tri
    dev = o.device
    n = o.shape[0]
    n_nodes = bvh.n_nodes
    lanes = torch.arange(bvh.leaf_size, device=dev)
    last_row = bvh.n_padded_tris - 1
    ok = d.abs() > 1e-30
    inv_d = torch.where(ok, 1.0 / torch.where(ok, d, torch.ones_like(d)),
                        torch.full((), MISS, dtype=d.dtype, device=dev))
    t_best = torch.full((n,), MISS, dtype=o.dtype, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros((n, 3), dtype=torch.int64, device=dev) if count else None
    cursor = torch.zeros(n, dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)  # the rays still inside the tree

    while act.numel() > 0:
        node = cursor[act]
        box = bvh.nodes[node]
        packed = box.view(torch.int32)[:, 7].long()  # tri_start << COUNT_BITS | tri_count
        oa, ia = o[act], inv_d[act]
        lo = (box[:, 0:3] - oa) * ia
        hi = (box[:, 4:7] - oa) * ia
        t_near = torch.minimum(lo, hi).amax(dim=1)
        t_far = torch.maximum(lo, hi).amin(dim=1)
        box_hit = (t_near <= torch.minimum(t_far, t_best[act])) & (t_far >= T_MIN_EPS)
        n_tri = packed & MAX_LEAF_TRIS
        leaf = n_tri > 0

        at_leaf = torch.nonzero(box_hit & leaf).flatten()
        if at_leaf.numel() > 0:
            rows = act[at_leaf]
            block = ((packed[at_leaf, None] >> COUNT_BITS) + lanes[None, :]).clamp_max(last_row)
            t_leaf = mt_block(o[rows], d[rows], tri[block])
            t_leaf = torch.where(lanes[None, :] < n_tri[at_leaf, None], t_leaf,
                                 torch.full((), MISS, dtype=t_leaf.dtype, device=dev))
            arg = torch.argmin(t_leaf, dim=1, keepdim=True)  # first minimum
            l_t = torch.gather(t_leaf, 1, arg)[:, 0]
            better = l_t < t_best[rows]
            t_best[rows] = torch.where(better, l_t, t_best[rows])
            best[rows] = torch.where(better, torch.gather(block, 1, arg)[:, 0], best[rows])
            if count:
                counts[rows, 1] += 1
                counts[rows, 2] += n_tri[at_leaf]
        if count:
            counts[act, 0] += 1

        nxt = torch.where(box_hit & ~leaf, node + 1, box.view(torch.int32)[:, 3].long())
        cursor[act] = nxt
        act = act[nxt < n_nodes]
    return (t_best, best, counts) if count else (t_best, best)


def make_bvh_env_hit(bvh_or_mesh, *, differentiable_tris: bool = False, device="cuda"):
    """env_hit(o, d, v0, e1, e2) -> (t, face, nrm) through the plain
    stackless walk (rfx/ops/bvh_traverse.py:make_bvh_env_hit), from a
    PackedBVH, a FlatBVH or a TriangleMesh (built at the default leaf size),
    differentiable through `differentiable_hit`. The normal is
    unit(cross(e1[f], e2[f])), differentiable in the edges.

    Hit selection ignores the caller's (v0, e1, e2): the BVH carries its own
    leaf-ordered copy. With `differentiable_tris` that copy is gathered from
    them at every call, and the gradient of t reaches them at the hit's
    original face id; without, it reaches o and d only."""
    if isinstance(bvh_or_mesh, PackedBVH):
        bvh = bvh_or_mesh
    else:
        bvh = pack_bvh(resolve_flat_bvh(bvh_or_mesh, leaf_size=LEAF_SIZE), resolve_device(device))
    no_face = torch.full((), -1, dtype=torch.int32, device=bvh.tri_face.device)

    def face_of(idx):
        return torch.where(idx >= 0, bvh.tri_face[idx.clamp_min(0)], no_face)

    if differentiable_tris:
        def select(o, d, v0, e1, e2):
            t, idx = walk_closest_hit(bvh, o, d, live_tri(bvh, v0, e1, e2))
            return t, face_of(idx)

        def env_hit(o, d, v0, e1, e2):
            t, face = differentiable_hit(select, o, d, v0, e1, e2)
            return t, face, hit_normal_from_edges(e1, e2, face)
    else:
        baked = (bvh.tri[:, 0:3], bvh.tri[:, 3:6], bvh.tri[:, 6:9])

        def select(o, d, *_):
            t, idx = walk_closest_hit(bvh, o, d)
            return t, idx, face_of(idx)

        def env_hit(o, d, v0, e1, e2):
            t, _idx, face = differentiable_hit(select, o, d, *baked)
            return t, face, hit_normal_from_edges(e1, e2, face)

    env_hit.bvh = bvh
    return env_hit
