"""Fused multi-bounce trace and its differentiable replay (port of
rfx/ops/pallas_fused.py).

`fused_trace` runs the whole bounce loop of every ray in one CUDA kernel
(rfx_torch/csrc/fused_trace.cu) on a CUDA tensor, and its plain PyTorch
version `fused_trace_plain` on a CPU tensor. The receiver is the analytic
sphere. Semantics are those of rfx.tracer.trace_to_rx(rx_mode="analytic"),
with the algebraic s-pol Fresnel factor of the TPU kernel (no arccos or
arcsin), equal to rfx.physics.fresnel_bounce_amplitude within f32 rounding.
With `record_faces` it also returns the (B, N) int32 table of the original
face each ray hit at each bounce where it env-bounced (-1 elsewhere).

On the card a launch of at least `ORDER_MIN_RAYS` rays is walked in
direction-cell order: `rfx_torch.ops.ray_order` sorts the ray indices by
the octahedral cell of each direction (a counting sort on the card), the
kernel's thread i traces ray order[i] and leaves its outputs (and face
record) in slot i of a scratch, and a second kernel gathers each ray's
outputs back to the ray's own index. A ray's trace depends on nothing but
its own direction, the scene and the scalars, so every output keeps the
bits of the caller's order; what changes is that a warp's 32 walks leave
the transmitter inside one small cone. Every call orders its own rays. The
counted instantiation keeps the caller's order, since its `warp_steps` is
defined over 32 consecutive caller rays.

`make_diff_fused_tracer` is the differentiable fused path: the forward is
the kernel with `record_faces`, the backward replays the captured rays on
their recorded faces in closed form (`replay_from_faces`, plain PyTorch
under autograd), with no BVH walk.

With `count_stats` it also returns the walk counters, a (B, 4) int64 tensor
whose row b sums over the rays of bounce b: `nodes` (iterations of the
walk's loop), `leaves` (leaf nodes whose box was hit), `tris` (triangles
tested) and `warp_steps` (over each group of 32 consecutive rays, the
largest `nodes` of any of them: the steps a warp spends, so that
`nodes / (32 * warp_steps)` is the share of the SIMT width the walk uses).
Bounces that no ray reached read 0. The counters are the card's counterpart
of the TPU kernel's per-tile windows and leaf visits; on a CUDA tensor they
come from the counted instantiation of the kernel, on a CPU tensor from
`fused_trace_walk_plain`, the same bounce loop on the plain stackless walk
(rfx_torch.ops.bvh_traverse), which visits the same nodes in the same order.

The TPU tuning knobs (tile_rays, k_spec, pack, cone_filter, force_stream,
stream_depth, arity) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from rfx_torch import physics
from rfx_torch.bvh import resolve_flat_bvh
from rfx_torch.device import resolve_device
from rfx_torch.ops._build import CudaKernel, F, I, P
from rfx_torch.ops.bvh_pack import PackedBVH, pack_bvh
from rfx_torch.ops.bvh_trace import padded_closest_hit
from rfx_torch.ops.bvh_traverse import walk_closest_hit
from rfx_torch.ops.intersect import (
    MISS_THRESHOLD,
    closed_form_t,
    cross3,
    dot3,
    ray_sphere_hit,
    sphere_t,
)
from rfx_torch.ops.ray_order import ray_order
from rfx_torch.tracer import TraceResult
from rfx_torch.utils import profiling
from rfx_torch.utils.profiling import spanned

__all__ = ["FusedTracer", "make_fused_tracer", "fused_trace", "fused_trace_plain",
           "fused_trace_walk_plain", "replay_from_faces", "make_diff_fused_tracer",
           "FUSED_TRACE_KERNEL", "FUSED_TRACE_COUNTED_KERNEL", "WARP", "ORDER_MIN_RAYS"]

_TRACE_ARGS = [P, I, P, I, P, P, F, F, F, F, F, F, F, F, F, I, P, P, P, P, P]
# The arguments, then the cell order, its rank, the walk's (N, 4) records and
# (B, N) faces (all null in the caller's order), and the stream.
FUSED_TRACE_KERNEL = CudaKernel("fused_trace.cu", "rfx_fused_trace", [*_TRACE_ARGS, P, P, P, P, P])
# The counted instantiation: the same arguments, then the (B, 4) counters.
FUSED_TRACE_COUNTED_KERNEL = CudaKernel("fused_trace.cu", "rfx_fused_trace_counted",
                                        [*_TRACE_ARGS, P, P])

#: Rays per group of the `warp_steps` counter: the card's warp width.
WARP = 32

#: The kernel walks the rays of a launch of at least this many rays in
#: direction-cell order (`rfx_torch.ops.ray_order`), and below it in the
#: caller's: the crossover measured on the card, where ordering costs what
#: it gains. On an NVIDIA H100 80GB HBM3 (700 W; scripts/torch_bench_kernels.py
#: --only order, i.i.d. rays on the bench terrain, two rounds), the caller's
#: order against ordering (sort, walk and put-back together): 0.245 / 0.257
#: ms at 262,144 rays, 0.268-0.270 / 0.258-0.268 at 327,680, 0.290-0.295 /
#: 0.273-0.275 at 393,216, 0.622-0.625 / 0.402-0.408 at 1,048,576.
ORDER_MIN_RAYS = 393_216


def _scalars(tx_pos, rx_pos, rx_radius, n1, n2):
    """The kernel's f32 scalars: tx (3), rx (3), r^2, n1, n2, with r^2
    rounded in f32 as the reference computes it."""
    host = lambda a: torch.as_tensor(a, dtype=torch.float32).detach().cpu().numpy()  # noqa: E731
    tx = host(tx_pos).reshape(3)
    rx = host(rx_pos).reshape(3)
    r = np.float32(host(rx_radius))
    return tx, rx, np.float32(r * r), np.float32(n1), np.float32(n2)


def _fresnel_algebraic(w, n1, n2):
    """s-pol Fresnel power factor from w = d.n (pallas_fused.py:535-549);
    n1, n2 are 0-dim tensors so every division is a true IEEE division."""
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    aw = torch.abs(w)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - aw * aw, 0.0))
    sr = (n2 * sin_t) / n1
    cos_i = torch.sqrt(torch.clamp_min(1.0 - sr * sr, 0.0))
    num = n2 * cos_i - n1 * aw
    den = n2 * cos_i + n1 * aw
    den_ok = den != 0.0
    ratio = num / torch.where(den_ok, den, torch.ones_like(den))
    return torch.where((sr <= 1.0) & den_ok, torch.clamp_max(ratio * ratio, 1.0), zero)


def _extras(result, faces, stats):
    """(result[, faces][, stats]): the reference's return convention
    (rfx/ops/pallas_fused.py:802-812)."""
    out = [result] + [x for x in (faces, stats) if x is not None]
    return out[0] if len(out) == 1 else tuple(out)


def _bounce_loop_plain(bvh, directions, tx_pos, rx_pos, rx_radius, n1, n2, max_bounces,
                       closest):
    """The fused kernel's bounce loop in plain PyTorch over `closest(o, d) ->
    (t, padded index, per-ray walk counts (A, 3) or None)`: the same receiver
    sphere, capture fold, reflection and algebraic Fresnel, one Python
    iteration per bounce over the rays still alive. Returns (TraceResult,
    (B, N) int32 faces, (B, 4) int64 counters)."""
    dev = directions.device
    f32 = torch.float32
    tx, rx, r2, n1s, n2s = _scalars(tx_pos, rx_pos, rx_radius, n1, n2)
    as_dev = lambda a: torch.as_tensor(a, dtype=f32, device=dev)  # noqa: E731
    rx_t, r2_t, n1_t, n2_t = as_dev(rx), as_dev(r2), as_dev(n1s), as_dev(n2s)
    n = directions.shape[0]
    tri = bvh.tri

    o = as_dev(tx)[None, :].expand(n, 3).contiguous()
    d = directions.to(f32).clone()  # updated in place below
    amp = torch.ones(n, dtype=f32, device=dev)
    dist = torch.zeros(n, dtype=f32, device=dev)
    captured = torch.zeros(n, dtype=torch.bool, device=dev)
    cap_amp = torch.zeros(n, dtype=f32, device=dev)
    cap_dist = torch.zeros(n, dtype=f32, device=dev)
    nb = torch.zeros(n, dtype=torch.int32, device=dev)
    faces = torch.full((max_bounces, n), -1, dtype=torch.int32, device=dev)
    stats = torch.zeros((max_bounces, 4), dtype=torch.int64, device=dev)
    alive = torch.arange(n, device=dev)  # indices of the rays still bouncing

    for b in range(max_bounces):
        if alive.numel() == 0:
            break
        oa, da = o[alive], d[alive]
        t_env, best, walked = closest(oa, da)
        if walked is not None:
            stats[b, :3] = walked.sum(dim=0)
            nodes = torch.zeros(-(-n // WARP) * WARP, dtype=torch.int64, device=dev)
            nodes[alive] = walked[:, 0]
            stats[b, 3] = nodes.view(-1, WARP).amax(dim=1).sum()
        t_rx = sphere_t(oa, da, rx_t, r2_t)
        rx_win = (t_rx < MISS_THRESHOLD) & (t_env > t_rx)
        env_b = ~rx_win & (t_env < MISS_THRESHOLD)

        won = alive[rx_win]
        captured[won] = True
        cap_amp[won] = amp[won]
        cap_dist[won] = dist[won] + t_rx[rx_win]

        go = alive[env_b]
        faces[b, go] = bvh.tri_face[best[env_b]]
        t_adv = t_env[env_b]
        nrm = tri[best[env_b], 9:12]
        db = da[env_b]
        w = dot3(db, nrm)
        d_out = db - 2.0 * w[:, None] * nrm
        fres = _fresnel_algebraic(w, n1_t, n2_t)
        o[go] = oa[env_b] + db * t_adv[:, None]
        d[go] = d_out
        amp[go] = amp[go] * fres
        dist[go] = dist[go] + t_adv
        nb[go] += 1
        alive = go

    return TraceResult(captured, cap_amp, cap_dist, nb), faces, stats


def fused_trace_plain(bvh: PackedBVH, directions: torch.Tensor, tx_pos, rx_pos, rx_radius,
                      n1=5.0, n2=1.0, *, max_bounces: int, record_faces: bool = False):
    """Plain PyTorch version of the fused kernel: brute-force closest hit over
    the packed triangles in padded order (ties to the lowest index, as the
    kernel's preorder walk gives them), chunked over rays to bound the
    intermediates. Returns a TraceResult, or (TraceResult, (B, N) int32
    faces) with `record_faces`. It cannot count: see `fused_trace_walk_plain`."""
    result, faces, _ = _bounce_loop_plain(
        bvh, directions, tx_pos, rx_pos, rx_radius, n1, n2, max_bounces,
        lambda o, d: (*padded_closest_hit(o, d, bvh.tri), None))
    return _extras(result, faces if record_faces else None, None)


def fused_trace_walk_plain(bvh: PackedBVH, directions: torch.Tensor, tx_pos, rx_pos, rx_radius,
                           n1=5.0, n2=1.0, *, max_bounces: int, record_faces: bool = False,
                           count_stats: bool = False):
    """Plain PyTorch version of the counted fused kernel: the same bounce
    loop on the plain stackless walk (rfx_torch.ops.bvh_traverse), which
    visits the nodes the kernel's walk visits in the same order. Returns
    (TraceResult[, (B, N) int32 faces][, (B, 4) int64 counters]); the trace
    equals `fused_trace_plain`'s."""
    result, faces, stats = _bounce_loop_plain(
        bvh, directions, tx_pos, rx_pos, rx_radius, n1, n2, max_bounces,
        lambda o, d: walk_closest_hit(bvh, o, d, count=True))
    return _extras(result, faces if record_faces else None, stats if count_stats else None)


def fused_trace(bvh: PackedBVH, directions: torch.Tensor, tx_pos, rx_pos, rx_radius,
                n1=5.0, n2=1.0, *, max_bounces: int, record_faces: bool = False,
                count_stats: bool = False):
    """Trace (N, 3) f32 directions from tx_pos through `max_bounces` bounces
    against the packed scene: TraceResult of (N,) captured, amplitude,
    distance, num_bounces; with `record_faces` also the (B, N) int32
    per-bounce face table; with `count_stats` also the (B, 4) int64 walk
    counters (nodes, leaves, tris, warp_steps per bounce). A CPU tensor runs
    the plain versions (`fused_trace_plain`, or `fused_trace_walk_plain` to
    count); a CUDA tensor launches the kernel, or its counted instantiation,
    or raises. No autograd: see `make_diff_fused_tracer`."""
    dev = directions.device
    if directions.ndim != 2 or directions.shape[1] != 3:
        raise ValueError(f"directions must be (N, 3), got {tuple(directions.shape)}")
    if directions.dtype != torch.float32:
        raise TypeError("directions must be float32")
    if bvh.tri.device != dev:
        raise ValueError(f"BVH tables are on {bvh.tri.device}, directions on {dev}")
    if dev.type == "cpu":
        if count_stats:
            return fused_trace_walk_plain(bvh, directions, tx_pos, rx_pos, rx_radius, n1, n2,
                                          max_bounces=max_bounces, record_faces=record_faces,
                                          count_stats=True)
        return fused_trace_plain(bvh, directions, tx_pos, rx_pos, rx_radius, n1, n2,
                                 max_bounces=max_bounces, record_faces=record_faces)
    if dev.type != "cuda":
        raise ValueError(f"no fused trace for device {dev}")
    return _fused_launch(bvh, directions, tx_pos, rx_pos, rx_radius, n1, n2,
                         max_bounces=max_bounces, record_faces=record_faces,
                         count_stats=count_stats)


@spanned("rfx.tracer.fused")
def _fused_launch(bvh: PackedBVH, directions: torch.Tensor, tx_pos, rx_pos, rx_radius, n1, n2, *,
                  max_bounces: int, record_faces: bool, count_stats: bool):
    """`fused_trace`'s CUDA branch: the kernel's arguments and its launch."""
    dev = directions.device
    tx, rx, r2, n1s, n2s = _scalars(tx_pos, rx_pos, rx_radius, n1, n2)
    d = directions.contiguous()
    n = d.shape[0]
    if n >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rays per launch, got {n}")
    if count_stats and max(bvh.n_nodes, bvh.n_padded_tris) >= 2**27:
        # A warp sums its 32 lanes' counts of one bounce in 32 bits.
        raise ValueError("count_stats takes at most 2^27 - 1 nodes and padded triangles")
    captured = torch.empty(n, dtype=torch.bool, device=dev)
    cap_amp = torch.empty(n, dtype=torch.float32, device=dev)
    cap_dist = torch.empty(n, dtype=torch.float32, device=dev)
    nb = torch.empty(n, dtype=torch.int32, device=dev)
    faces = (torch.empty((max_bounces, n), dtype=torch.int32, device=dev)
             if record_faces else None)
    stats = (torch.zeros((max_bounces, 4), dtype=torch.int64, device=dev)
             if count_stats else None)
    result = TraceResult(captured, cap_amp, cap_dist, nb)
    if n == 0:
        return _extras(result, faces, stats)
    # The counted walk keeps the caller's order: its `warp_steps` is defined
    # over 32 consecutive caller rays.
    ordered = not count_stats and n >= ORDER_MIN_RAYS
    profiling.tally("rays_fused", n)
    profiling.tally("rays_ordered", n if ordered else 0)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (d.data_ptr(), n, bvh.nodes.data_ptr(), bvh.n_nodes, bvh.tri.data_ptr(),
                ptr(bvh.tri_face if record_faces else None),
                *map(float, tx), *map(float, rx), float(r2), float(n1s), float(n2s),
                int(max_bounces), captured.data_ptr(), cap_amp.data_ptr(), cap_dist.data_ptr(),
                nb.data_ptr(), ptr(faces))
        if count_stats:
            FUSED_TRACE_COUNTED_KERNEL.launch(*args, stats.data_ptr(), stream)
        elif ordered:
            cells = ray_order(d)
            walked = torch.empty((n, 4), dtype=torch.float32, device=dev)
            walked_faces = torch.empty_like(faces) if record_faces else None
            FUSED_TRACE_KERNEL.launch(*args, cells.order.data_ptr(), cells.rank.data_ptr(),
                                      walked.data_ptr(), ptr(walked_faces), stream)
        else:
            FUSED_TRACE_KERNEL.launch(*args, None, None, None, None, stream)
    return _extras(result, faces, stats)


class FusedTracer:
    """Fused tracer bound to one scene's BVH on one device.

    fused(directions (N, 3), tx (3,), rx (3,), rx_radius, n1, n2)
      -> TraceResult (captured, amplitude, distance, num_bounces), each (N,);
    with record_faces=True, (TraceResult, (B, N) int32 face table); built
    with count_stats=True, the (B, 4) int64 walk counters come last, as
    rfx.ops.pallas_fused.FusedTracer returns its own.
    """

    def __init__(self, flat, *, max_bounces: int, count_stats: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.bvh = pack_bvh(resolve_flat_bvh(flat), self.device)
        self.max_bounces = int(max_bounces)
        self.count_stats = bool(count_stats)

    def __call__(self, directions, tx_pos, rx_pos, rx_radius, n1=5.0, n2=1.0,
                 record_faces: bool = False):
        d = torch.as_tensor(directions, dtype=torch.float32, device=self.device)
        return fused_trace(self.bvh, d, tx_pos, rx_pos, rx_radius, n1, n2,
                           max_bounces=self.max_bounces, record_faces=record_faces,
                           count_stats=self.count_stats)


def make_fused_tracer(mesh_or_flat, *, max_bounces: int, leaf_size: int = 8,
                      count_stats: bool = False, device="cuda") -> FusedTracer:
    """FusedTracer from a prebuilt FlatBVH, or from a TriangleMesh through
    `rfx_torch.bvh.build_bvh(method="auto")` at `leaf_size`."""
    return FusedTracer(resolve_flat_bvh(mesh_or_flat, leaf_size=leaf_size),
                       max_bounces=max_bounces, count_stats=count_stats, device=device)


def replay_from_faces(vertices, faces_tbl, tx_pos, directions, rx_pos, rx_radius,
                      bounce_faces, captured, num_bounces, *, n1=5.0, n2=1.0):
    """Differentiable closed-form replay of a recorded fused trace
    (rfx/ops/pallas_fused.py:815-874): per bounce, the closed-form
    Moller-Trumbore t on the recorded face, the edge-derived normal, the
    specular reflection and the Fresnel factor; at the capture step, the
    analytic sphere hit. Hit selection is frozen (straight-through); there is
    no BVH walk. Returns (amplitude, distance), each (N,), differentiable in
    vertices, tx_pos, directions, rx_pos and rx_radius."""
    f32 = torch.float32
    d = directions.to(f32)
    dev = d.device
    n = d.shape[0]
    zero = torch.zeros((), dtype=f32, device=dev)
    tx = torch.as_tensor(tx_pos, dtype=f32, device=dev)
    o = tx[None, :].expand(n, 3)
    amp = torch.ones(n, dtype=f32, device=dev)
    dist = torch.zeros(n, dtype=f32, device=dev)
    cap_amp = torch.zeros(n, dtype=f32, device=dev)
    cap_dist = torch.zeros(n, dtype=f32, device=dev)
    ftbl = torch.as_tensor(faces_tbl, device=dev).long()
    v0_all = vertices[ftbl[:, 0]]
    e1_all = vertices[ftbl[:, 1]] - v0_all
    e2_all = vertices[ftbl[:, 2]] - v0_all
    rx = torch.as_tensor(rx_pos, dtype=f32, device=dev)

    for b in range(bounce_faces.shape[0]):
        env_b = bounce_faces[b] >= 0
        cap_b = captured & (num_bounces == b)
        t_rx = ray_sphere_hit(o, d, rx, rx_radius)
        t_rx_safe = torch.where(cap_b & (t_rx < MISS_THRESHOLD), t_rx, zero)
        cap_amp = torch.where(cap_b, amp, cap_amp)
        cap_dist = torch.where(cap_b, dist + t_rx_safe, cap_dist)
        f = bounce_faces[b].clamp_min(0).long()
        fv0, fe1, fe2 = v0_all[f], e1_all[f], e2_all[f]
        t_adv = torch.where(env_b, closed_form_t(o, d, fv0, fe1, fe2), zero)
        nrm = cross3(fe1, fe2)
        nrm = nrm / torch.linalg.norm(nrm, dim=1, keepdim=True).clamp_min(1e-30)
        d_out = physics.reflect(d, nrm)
        fres = physics.fresnel_bounce_amplitude(physics.bend_angle(d, d_out), n1, n2)
        o = torch.where(env_b[:, None], o + d * t_adv[:, None], o)
        d = torch.where(env_b[:, None], d_out, d)
        amp = torch.where(env_b, amp * fres, amp)
        dist = dist + t_adv
    # A captured ray was captured at a bounce below B (the kernel's loop runs
    # B iterations), so its capture step is always inside the loop above.
    return cap_amp, cap_dist


class _DiffFused(torch.autograd.Function):
    """The fused kernel with `record_faces` forward; the replay backward on
    the captured rays (rfx/ops/pallas_fused.py:913-966)."""

    @staticmethod
    def forward(ctx, vertices, tx_pos, directions, rx_pos, rx_radius, cfg):
        result, bf = cfg["fused"](directions, tx_pos, rx_pos, rx_radius, n1=cfg["n1"],
                                  n2=cfg["n2"], record_faces=True)
        ctx.mark_non_differentiable(result.captured, result.num_bounces)
        ctx.save_for_backward(vertices, tx_pos, directions, rx_pos, rx_radius, bf,
                              result.captured, result.num_bounces)
        ctx.cfg = cfg
        return tuple(result[:4])

    @staticmethod
    def backward(ctx, _g_cap, g_amp, g_dist, _g_nb):
        vertices, tx_pos, directions, rx_pos, rx_radius, bf, cap, nb = ctx.saved_tensors
        cfg = ctx.cfg
        want = ctx.needs_input_grad[:5]
        grads = [torch.zeros_like(a) if w else None
                 for a, w in zip((vertices, tx_pos, directions, rx_pos, rx_radius), want)]
        if not any(want):
            return (*grads, None)
        cap_idx = torch.nonzero(cap).flatten()
        zero = torch.zeros((), dtype=torch.float32, device=cap.device)
        g_amp = zero.expand(cap.shape) if g_amp is None else g_amp
        g_dist = zero.expand(cap.shape) if g_dist is None else g_dist
        args = [vertices, tx_pos, directions[cap_idx], rx_pos, rx_radius]
        args = [a.detach().requires_grad_(w) for a, w in zip(args, want)]
        with torch.enable_grad():
            amp, dist = replay_from_faces(
                args[0], cfg["faces_tbl"], args[1], args[2], args[3], args[4],
                bf[:, cap_idx], torch.ones_like(cap_idx, dtype=torch.bool), nb[cap_idx],
                n1=cfg["n1"], n2=cfg["n2"])
            live = [a for a, w in zip(args, want) if w]
            outs = [(y, gy[cap_idx]) for y, gy in ((amp, g_amp), (dist, g_dist))
                    if y.requires_grad]
            got = iter(torch.autograd.grad([y for y, _ in outs], live, [gy for _, gy in outs],
                                           allow_unused=True) if outs else [None] * len(live))
        for i, w in enumerate(want):
            if not w:
                continue
            g = next(got)
            if g is None:
                continue
            if i == 2:  # directions: scatter the captured rows back
                grads[i].index_add_(0, cap_idx, g)
            else:
                grads[i] = g
        return (*grads, None)


def make_diff_fused_tracer(flat_or_mesh, faces_tbl, *, max_bounces: int, n1=5.0, n2=1.0,
                           device="cuda"):
    """Differentiable fused tracer: the fused kernel's forward with the face
    record, and the closed-form replay backward (no BVH walk).

    Returns diff_trace(vertices, tx_pos, directions, rx_pos, rx_radius) ->
    TraceResult. Gradients reach the arguments that require them through
    `replay_from_faces`; capture, bounce counts and faces are
    straight-through. The backward replays only the captured rays and
    scatters the direction cotangent back. `faces_tbl` is the scene's (F, 3)
    face table; the BVH is built once from `flat_or_mesh`, so a caller that
    moves vertices materially rebuilds it."""
    fused = make_fused_tracer(flat_or_mesh, max_bounces=max_bounces, device=device)
    dev = fused.device
    cfg = dict(fused=fused, faces_tbl=torch.as_tensor(faces_tbl, device=dev).long(), n1=n1, n2=n2)

    def diff_trace(vertices, tx_pos, directions, rx_pos, rx_radius) -> TraceResult:
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        out = _DiffFused.apply(as_t(vertices), as_t(tx_pos), as_t(directions), as_t(rx_pos),
                               as_t(rx_radius), cfg)
        return TraceResult(*out)

    return diff_trace
