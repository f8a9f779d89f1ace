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

`near_first_closest_hit` is the plain version of the fused kernel's other
walk, the near-first walk over the child-pair table (bvh_walk.cuh): per ray
the same records, slab tests against the best t widened by `NEAR_SLACK`,
child order, stack and drops, and the update by the smaller (t, padded
index), so that a test can hold the kernel's walk to the stackless one and
to brute force on CPU tensors.

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

__all__ = ["walk_closest_hit", "near_first_closest_hit", "make_bvh_env_hit", "NEAR_SLACK"]


def _inv_dir(d):
    """1 / d where |d| > 1e-30, MISS elsewhere (bvh_walk.cuh:inv_dir)."""
    ok = d.abs() > 1e-30
    return torch.where(ok, 1.0 / torch.where(ok, d, torch.ones_like(d)),
                       torch.full((), MISS, dtype=d.dtype, device=d.device))


def _slab(lo, hi, o, inv_d, t_best):
    """The walks' slab test of boxes (lo, hi) (C, 3): (t_near, hit), hit
    where `t_near <= min(t_far, t_best) & t_far >= T_MIN_EPS` (`t_best` the
    near-first walk's widened best t)."""
    a = (lo - o) * inv_d
    b = (hi - o) * inv_d
    t_near = torch.minimum(a, b).amax(dim=1)
    t_far = torch.maximum(a, b).amin(dim=1)
    return t_near, (t_near <= torch.minimum(t_far, t_best)) & (t_far >= T_MIN_EPS)


def _leaf_best(bvh: PackedBVH, tri, o, d, packed):
    """The first smallest t of each ray (C, 3) over its leaf's block of
    `leaf_size` padded triangles (`packed` (C,): tri_start << COUNT_BITS |
    tri_count), rows past tri_count masked: (t (C,), padded index (C,))."""
    lanes = torch.arange(bvh.leaf_size, device=o.device)
    n_tri = packed & MAX_LEAF_TRIS
    block = ((packed[:, None] >> COUNT_BITS) + lanes[None, :]).clamp_max(bvh.n_padded_tris - 1)
    t_leaf = mt_block(o, d, tri[block])
    t_leaf = torch.where(lanes[None, :] < n_tri[:, None], t_leaf,
                         torch.full((), MISS, dtype=t_leaf.dtype, device=o.device))
    arg = torch.argmin(t_leaf, dim=1, keepdim=True)  # first minimum
    return torch.gather(t_leaf, 1, arg)[:, 0], torch.gather(block, 1, arg)[:, 0]


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
    inv_d = _inv_dir(d)
    t_best = torch.full((n,), MISS, dtype=o.dtype, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros((n, 3), dtype=torch.int64, device=dev) if count else None
    cursor = torch.zeros(n, dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)  # the rays still inside the tree

    while act.numel() > 0:
        node = cursor[act]
        box = bvh.nodes[node]
        packed = box.view(torch.int32)[:, 7].long()  # tri_start << COUNT_BITS | tri_count
        _, box_hit = _slab(box[:, 0:3], box[:, 4:7], o[act], inv_d[act], t_best[act])
        n_tri = packed & MAX_LEAF_TRIS
        leaf = n_tri > 0

        at_leaf = torch.nonzero(box_hit & leaf).flatten()
        if at_leaf.numel() > 0:
            rows = act[at_leaf]
            l_t, l_idx = _leaf_best(bvh, tri, o[rows], d[rows], packed[at_leaf])
            better = l_t < t_best[rows]
            t_best[rows] = torch.where(better, l_t, t_best[rows])
            best[rows] = torch.where(better, l_idx, best[rows])
            if count:
                counts[rows, 1] += 1
                counts[rows, 2] += n_tri[at_leaf]
        if count:
            counts[act, 0] += 1

        nxt = torch.where(box_hit & ~leaf, node + 1, box.view(torch.int32)[:, 3].long())
        cursor[act] = nxt
        act = act[nxt < n_nodes]
    return (t_best, best, counts) if count else (t_best, best)


_DONE = -1  # bvh_walk.cuh's kWalkDone: no ref
#: The near-first walk cuts a box only where the ray enters it after the
#: best t times this (bvh_walk.cuh's kNearSlack, 1 + 2^-16): a box's f32 slab
#: entry can round above the f32 t of a triangle inside it.
NEAR_SLACK = 1.0 + 2.0**-16


def near_first_closest_hit(bvh: PackedBVH, o, d):
    """Closest hit of (N, 3) f32 rays by the near-first walk over the
    child-pair table `bvh.pairs`, each ray's visits in the kernel's order:
    (t (N,) f32, idx (N,) int64 padded index), MISS and -1 on a miss. The
    rays step in lockstep, one visit (a record or a leaf) each a step. No
    autograd, no counters."""
    if bvh.pairs is None:
        raise ValueError("the near-first walk needs a child-pair table: a binary tree")
    dev = o.device
    n = o.shape[0]
    pairs = bvh.pairs
    refs = pairs.view(torch.int32)[:, [3, 11]].long()
    inv_d = _inv_dir(d)
    t_best = torch.full((n,), MISS, dtype=o.dtype, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    depth = max(bvh.max_depth - 1, 1)
    stack_t = torch.zeros((n, depth), dtype=o.dtype, device=dev)
    stack_ref = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    ref = torch.zeros(n, dtype=torch.int64, device=dev)  # the root's record
    act = torch.arange(n, device=dev)  # the rays still walking

    while act.numel() > 0:
        r = ref[act]
        inner = (r & MAX_LEAF_TRIS) == 0
        pops = [act[~inner]]  # after a leaf, the walk pops

        rows, rec_i = act[inner], r[inner] >> COUNT_BITS
        if rows.numel() > 0:
            rec = pairs[rec_i]
            oa, ia, bound = o[rows], inv_d[rows], t_best[rows] * NEAR_SLACK
            near0, hit0 = _slab(rec[:, 0:3], rec[:, 4:7], oa, ia, bound)
            near1, hit1 = _slab(rec[:, 8:11], rec[:, 12:15], oa, ia, bound)
            ref0, ref1 = refs[rec_i].unbind(1)
            both = hit0 & hit1
            left_first = near0 <= near1
            pushed, top = rows[both], sp[rows[both]]
            stack_t[pushed, top] = torch.where(left_first, near1, near0)[both]
            stack_ref[pushed, top] = torch.where(left_first, ref1, ref0)[both]
            sp[pushed] += 1
            ref[rows] = torch.where(both, torch.where(left_first, ref0, ref1),
                                    torch.where(hit0, ref0, ref1))
            pops.append(rows[~(hit0 | hit1)])

        rows = pops[0]
        if rows.numel() > 0:
            l_t, l_idx = _leaf_best(bvh, bvh.tri, o[rows], d[rows], r[~inner])
            tb, bi = t_best[rows], best[rows]
            better = (l_t < tb) | ((l_t == tb) & (l_idx < bi))
            t_best[rows] = torch.where(better, l_t, tb)
            best[rows] = torch.where(better, l_idx, bi)

        # Pop each: the first entry down the stack whose box the ray enters
        # at or before its widened best t; _DONE when none is left.
        popping = torch.cat(pops)
        ref[popping] = _DONE
        while popping.numel() > 0:
            popping = popping[sp[popping] > 0]
            sp[popping] -= 1
            top = sp[popping]
            keep = stack_t[popping, top] <= t_best[popping] * NEAR_SLACK
            ref[popping[keep]] = stack_ref[popping[keep], top[keep]]
            popping = popping[~keep]
        act = act[ref[act] != _DONE]
    return t_best, best


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
