"""Per-query BVH closest hit with the reference's custom gradients (port of
rfx/ops/pallas_trace.py).

`closest_hit` answers one closest-hit query per ray, from arbitrary
origins, with the CUDA kernel rfx_torch/csrc/closest_hit.cu on a CUDA tensor
and its plain PyTorch version `closest_hit_plain` on a CPU tensor. The
kernel walks the same BVH with the same function (csrc/bvh_walk.cuh) as the
fused bounce-loop kernel, and the two share one plain version: brute force
over the packed triangles in padded order, the first minimum winning, which
is what the walks' update by the smaller (t, padded index) gives.

`make_kernel_env_hit` wraps it as the tracers' `env_hit(o, d, v0, e1, e2)
-> (t, face, nrm)`, whose backward is the reference's custom VJP
(:757-858) through rfx_torch.ops.intersect's one `differentiable_hit`: on
the baked triangles the selected row of the table, with cotangents to o and
d only. With `differentiable_tris`, the triangles are repacked from the
caller's (v0, e1, e2) every call (`live_tri`), the cotangent of t is
scatter-added into them at the original face id, and the normal of a hit is
unit(cross(e1[f], e2[f])), the live table's bits, differentiable by
autograd. Hit selection still uses the host-built node boxes: rebuild the
BVH when vertices move materially (the reference's caveat, :735-738).

The reference's `optimization_barrier`s work around XLA-TPU fusion faults
and have no counterpart here; the sanitization is mathematics and stays.
The TPU kernel's cone table, tile-uniform walk, node windows and streaming
are not carried over. The BVH is K1's leaf-8 build (the reference's kernel
uses leaf 16): the closest hit does not depend on the layout except on exact
ties.
"""

from __future__ import annotations

import torch

from rfx_torch.bvh import resolve_flat_bvh
from rfx_torch.device import resolve_device
from rfx_torch.ops._build import CudaKernel, I, P
from rfx_torch.ops.bvh_pack import PackedBVH, pack_bvh
from rfx_torch.ops.intersect import (
    MISS,
    T_MIN_EPS,
    _unit,
    cross3,
    differentiable_hit,
    hit_normal_from_edges,
)
from rfx_torch.utils.profiling import spanned

__all__ = ["CLOSEST_HIT_KERNEL", "CLOSEST_HIT_COUNTED_KERNEL", "closest_hit", "closest_hit_plain", "live_tri",
           "make_kernel_env_hit", "mt_block"]

CLOSEST_HIT_KERNEL = CudaKernel(
    "closest_hit.cu", "rfx_closest_hit",
    [P, P, I, P, I, P, P, P, P, P, P, P],
)
# The same kernel with the walk's counters (one more output).
CLOSEST_HIT_COUNTED_KERNEL = CudaKernel(
    "closest_hit.cu", "rfx_closest_hit_counted",
    [P, P, I, P, I, P, P, P, P, P, P, P, P],
)

# Upper bound on rays x padded triangles per brute-force chunk of the plain
# version (each of its ~25 intermediates is this many f32 values).
_PLAIN_PAIRS = 1 << 22


def mt_block(o, d, tri):
    """Moller-Trumbore t of rays (C, 3) against triangle rows `tri` (C or 1,
    L, 12), with the kernels' algebra (csrc/bvh_walk.cuh: every dot product
    summed x + y + z): (C, L) t, MISS where a row is not hit."""
    v0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    dx, dy, dz = d[:, None, 0], d[:, None, 1], d[:, None, 2]
    px = e2z * dy - e2y * dz
    py = e2x * dz - e2z * dx
    pz = e2y * dx - e2x * dy
    det = e1x * px + e1y * py + e1z * pz
    valid = torch.abs(det) > 1e-12
    zero = torch.zeros((), dtype=det.dtype, device=det.device)
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, torch.ones_like(det)), zero)
    tvx = o[:, None, 0] - v0[..., 0]
    tvy = o[:, None, 1] - v0[..., 1]
    tvz = o[:, None, 2] - v0[..., 2]
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN_EPS)
    return torch.where(ok, t, torch.full((), MISS, dtype=t.dtype, device=t.device))


def _mt_padded(o, d, tri):
    """Closest hit of rays (C, 3) over all padded triangles (P, 12): (t (C,),
    index (C,) int64), MISS and the index of the first minimum (0) on a
    miss."""
    t = mt_block(o, d, tri[None])
    idx = torch.argmin(t, dim=1)  # first minimum: the lowest padded index
    return torch.gather(t, 1, idx[:, None])[:, 0], idx


def padded_closest_hit(o, d, tri):
    """`_mt_padded` chunked over rays: (t (N,), padded index (N,) int64, the
    first minimum's index on a miss)."""
    n = o.shape[0]
    chunk = max(1, _PLAIN_PAIRS // max(tri.shape[0], 1))
    if n == 0:
        return o.new_empty((0,)), torch.empty((0,), dtype=torch.int64, device=o.device)
    ts, idxs = [], []
    for s in range(0, n, chunk):
        t, i = _mt_padded(o[s:s + chunk], d[s:s + chunk], tri)
        ts.append(t)
        idxs.append(i)
    return torch.cat(ts), torch.cat(idxs)


def closest_hit_plain(bvh: PackedBVH, o, d, tri=None):
    """Plain PyTorch version of the kernel: (t (N,) f32, idx (N,) i32 padded
    index, face (N,) i32 original id, nrm (N, 3) f32), with 1e30 / -1 / -1 /
    0 on a miss."""
    tri = bvh.tri if tri is None else tri
    t, best = padded_closest_hit(o, d, tri)
    hit = t < MISS
    zero = torch.zeros((), dtype=tri.dtype, device=tri.device)
    idx = torch.where(hit, best, torch.full_like(best, -1)).to(torch.int32)
    face = torch.where(hit, bvh.tri_face[best], torch.full_like(idx, -1)).to(torch.int32)
    nrm = torch.where(hit[:, None], tri[best, 9:12], zero)
    return t, idx, face, nrm


def _check_rays(o, d):
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3):
        raise ValueError(f"origins and directions must be (N, 3), got {tuple(o.shape)} "
                         f"and {tuple(d.shape)}")
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError("origins and directions must be float32")
    if o.device != d.device:
        raise ValueError("origins and directions must be on one device")
    if n >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rays per launch, got {n}")


def closest_hit(bvh: PackedBVH, o, d, tri=None, *, count: bool = False):
    """Closest hit of (N, 3) f32 rays over the packed BVH: (t, idx, face,
    nrm) as `closest_hit_plain`. `tri` (P, 12) replaces the packed triangle
    table (a `live_tri` repack). With `count`, a fifth output: (N, 3) int64,
    per query the nodes visited, the leaves entered and the triangles tested
    (the counted entry point of the kernel; on a CPU tensor the counters of
    the plain walk, rfx_torch.ops.bvh_traverse). A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel, or raises. No autograd: see
    `make_kernel_env_hit`."""
    _check_rays(o, d)
    tri = bvh.tri if tri is None else tri
    dev = o.device
    if tri.shape != bvh.tri.shape or tri.dtype != torch.float32:
        raise ValueError(f"triangle table must be {tuple(bvh.tri.shape)} float32")
    if bvh.tri.device != dev or tri.device != dev:
        raise ValueError(f"BVH tables are on {bvh.tri.device}, rays on {dev}")
    if dev.type == "cpu":
        out = closest_hit_plain(bvh, o, d, tri)
        if count:
            from rfx_torch.ops.bvh_traverse import walk_closest_hit

            out += (walk_closest_hit(bvh, o, d, tri, count=True)[2],)
        return out
    if dev.type != "cuda":
        raise ValueError(f"no closest-hit query for device {dev}")
    o, d, tri = o.contiguous(), d.contiguous(), tri.contiguous()
    if tri.data_ptr() % 16:
        raise ValueError("the triangle table must be 16-byte aligned (float4 loads)")
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    face = torch.empty(n, dtype=torch.int32, device=dev)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((n, 3), dtype=torch.int32, device=dev) if count else None
    if n > 0:
        args = (o.data_ptr(), d.data_ptr(), n, bvh.nodes.data_ptr(), bvh.n_nodes, tri.data_ptr(),
                bvh.tri_face.data_ptr(), t.data_ptr(), idx.data_ptr(), face.data_ptr(),
                nrm.data_ptr())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if count:
                CLOSEST_HIT_COUNTED_KERNEL.launch(*args, counts.data_ptr(), stream)
            else:
                CLOSEST_HIT_KERNEL.launch(*args, stream)
    return (t, idx, face, nrm, counts.long()) if count else (t, idx, face, nrm)


def live_tri(bvh: PackedBVH, v0, e1, e2):
    """(P, 12) triangle table repacked from original-order (F, 3) v0, e1, e2
    through `tri_face`, with the unit normal unit(cross(e1, e2)); padding
    rows stay zero (degenerate, never hit). The counterpart of
    rfx/ops/pallas_trace.py:live_trif."""
    pad = (bvh.tri_face < 0)[:, None]
    sel = bvh.tri_face.clamp_min(0).long()
    zero = torch.zeros((), dtype=v0.dtype, device=v0.device)
    lv0 = torch.where(pad, zero, v0[sel])
    le1 = torch.where(pad, zero, e1[sel])
    le2 = torch.where(pad, zero, e2[sel])
    return torch.cat([lv0, le1, le2, _unit(cross3(le1, le2))], dim=1).contiguous()


def make_kernel_env_hit(bvh_or_mesh, *, differentiable_tris: bool = False, device="cuda"):
    """env_hit(o, d, v0, e1, e2) -> (t, face, nrm) through the per-query
    kernel, from a PackedBVH (shared with a FusedTracer), a FlatBVH or a
    TriangleMesh (built at leaf 8), differentiable through
    `differentiable_hit`. On the baked triangles the gradient of t reaches o
    and d, and the normal is the table's; with `differentiable_tris` the
    kernel walks the triangles repacked from the caller's (v0, e1, e2)
    (`live_tri`), t's cotangent reaches them at the hit's original face id,
    and the normal on a hit is unit(cross(e1[f], e2[f])), the table's bits,
    differentiable in the edges."""
    if isinstance(bvh_or_mesh, PackedBVH):
        bvh = bvh_or_mesh
    else:
        bvh = pack_bvh(resolve_flat_bvh(bvh_or_mesh, leaf_size=8), resolve_device(device))

    if differentiable_tris:
        def select(o, d, v0, e1, e2):
            t, _idx, face, nrm = closest_hit(bvh, o, d, live_tri(bvh, v0, e1, e2))
            return t, face, nrm

        @spanned("rfx.ops.env_hit")
        def env_hit(o, d, v0, e1, e2):
            t, face, nrm = differentiable_hit(select, o, d, v0, e1, e2)
            # A miss keeps the kernel's zero normal.
            return t, face, torch.where((face >= 0)[:, None], hit_normal_from_edges(e1, e2, face),
                                        nrm)
    else:
        baked = (bvh.tri[:, 0:3], bvh.tri[:, 3:6], bvh.tri[:, 6:9])

        def select(o, d, *_):
            return closest_hit(bvh, o, d)

        @spanned("rfx.ops.env_hit")
        def env_hit(o, d, v0, e1, e2):
            t, _idx, face, nrm = differentiable_hit(select, o, d, *baked)
            return t, face, nrm

    env_hit.bvh = bvh
    return env_hit
