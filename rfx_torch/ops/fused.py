"""Fused multi-bounce forward trace (port of rfx/ops/pallas_fused.py).

`fused_trace` runs the whole bounce loop of every ray in one CUDA kernel
(rfx_torch/csrc/fused_trace.cu) on a CUDA tensor, and its plain PyTorch
version `fused_trace_plain` on a CPU tensor. The receiver is the analytic
sphere. Semantics are those of rfx.tracer.trace_to_rx(rx_mode="analytic"),
with the algebraic s-pol Fresnel factor of the TPU kernel (no arccos or
arcsin), equal to rfx.physics.fresnel_bounce_amplitude within f32 rounding.

Not ported yet: `record_faces` (per-bounce face ids, for the differentiable
replay) and `count_stats` (walk counters); see ROADMAP B1. The TPU tuning
knobs (tile_rays, k_spec, pack, cone_filter, force_stream, stream_depth,
arity) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from rfx.bvh import FlatBVH, build_bvh
from rfx_torch.device import resolve_device
from rfx_torch.ops._build import CudaKernel, F, I, P
from rfx_torch.ops.bvh_pack import PackedBVH, pack_bvh
from rfx_torch.ops.intersect import MISS, MISS_THRESHOLD, T_MIN_EPS, dot3, sphere_t
from rfx_torch.tracer import TraceResult

__all__ = ["FusedTracer", "make_fused_tracer", "fused_trace", "fused_trace_plain",
           "FUSED_TRACE_KERNEL"]

FUSED_TRACE_KERNEL = CudaKernel(
    "fused_trace.cu", "rfx_fused_trace",
    [P, I, P, P, I, P, F, F, F, F, F, F, F, F, F, I, P, P, P, P, P],
)

# Upper bound on rays x padded triangles per brute-force chunk of the plain
# version (each of its ~25 intermediates is this many f32 values).
_PLAIN_PAIRS = 1 << 22


def _scalars(tx_pos, rx_pos, rx_radius, n1, n2):
    """The kernel's f32 scalars: tx (3), rx (3), r^2, n1, n2, with r^2
    rounded in f32 as the reference computes it."""
    tx = np.asarray(torch.as_tensor(tx_pos, dtype=torch.float32).cpu(), np.float32).reshape(3)
    rx = np.asarray(torch.as_tensor(rx_pos, dtype=torch.float32).cpu(), np.float32).reshape(3)
    r = np.float32(torch.as_tensor(rx_radius, dtype=torch.float32).cpu())
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


def _closest_hit_plain(o, d, tri):
    """Closest hit of rays (C, 3) over all padded triangles (P, 12), with the
    kernel's Moller-Trumbore algebra: (t (C,), index (C,) int64), MISS and
    the index of the first minimum (0) on a miss."""
    v0, e1, e2 = tri[None, :, 0:3], tri[None, :, 3:6], tri[None, :, 6:9]
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
    t = torch.where(ok, t, torch.full((), MISS, dtype=t.dtype, device=t.device))
    idx = torch.argmin(t, dim=1)  # first minimum: the lowest padded index
    return torch.gather(t, 1, idx[:, None])[:, 0], idx


def fused_trace_plain(bvh: PackedBVH, directions: torch.Tensor, tx_pos, rx_pos, rx_radius,
                      n1=5.0, n2=1.0, *, max_bounces: int) -> TraceResult:
    """Plain PyTorch version of the fused kernel: brute-force closest hit over
    the packed triangles in padded order (ties to the lowest index, as the
    kernel's preorder walk gives them), the same receiver sphere, capture
    fold, reflection and algebraic Fresnel, one Python iteration per bounce
    over the rays still alive. Chunked over rays to bound the intermediates."""
    dev = directions.device
    f32 = torch.float32
    tx, rx, r2, n1s, n2s = _scalars(tx_pos, rx_pos, rx_radius, n1, n2)
    as_dev = lambda a: torch.as_tensor(a, dtype=f32, device=dev)  # noqa: E731
    rx_t, r2_t, n1_t, n2_t = as_dev(rx), as_dev(r2), as_dev(n1s), as_dev(n2s)
    n = directions.shape[0]
    tri = bvh.tri
    chunk = max(1, _PLAIN_PAIRS // bvh.n_padded_tris)

    o = as_dev(tx)[None, :].expand(n, 3).contiguous()
    d = directions.to(f32).clone()  # updated in place below
    amp = torch.ones(n, dtype=f32, device=dev)
    dist = torch.zeros(n, dtype=f32, device=dev)
    captured = torch.zeros(n, dtype=torch.bool, device=dev)
    cap_amp = torch.zeros(n, dtype=f32, device=dev)
    cap_dist = torch.zeros(n, dtype=f32, device=dev)
    nb = torch.zeros(n, dtype=torch.int32, device=dev)
    alive = torch.arange(n, device=dev)  # indices of the rays still bouncing

    for _ in range(max_bounces):
        if alive.numel() == 0:
            break
        oa, da = o[alive], d[alive]
        ts, idxs = [], []
        for s in range(0, alive.numel(), chunk):
            t, i = _closest_hit_plain(oa[s:s + chunk], da[s:s + chunk], tri)
            ts.append(t)
            idxs.append(i)
        t_env, best = torch.cat(ts), torch.cat(idxs)
        t_rx = sphere_t(oa, da, rx_t, r2_t)
        rx_win = (t_rx < MISS_THRESHOLD) & (t_env > t_rx)
        env_b = ~rx_win & (t_env < MISS_THRESHOLD)

        won = alive[rx_win]
        captured[won] = True
        cap_amp[won] = amp[won]
        cap_dist[won] = dist[won] + t_rx[rx_win]

        go = alive[env_b]
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

    return TraceResult(captured, cap_amp, cap_dist, nb)


def fused_trace(bvh: PackedBVH, directions: torch.Tensor, tx_pos, rx_pos, rx_radius,
                n1=5.0, n2=1.0, *, max_bounces: int) -> TraceResult:
    """Trace (N, 3) f32 directions from tx_pos through `max_bounces` bounces
    against the packed scene: TraceResult of (N,) captured, amplitude,
    distance, num_bounces. A CPU tensor runs `fused_trace_plain`; a CUDA
    tensor launches the kernel, or raises."""
    dev = directions.device
    if directions.ndim != 2 or directions.shape[1] != 3:
        raise ValueError(f"directions must be (N, 3), got {tuple(directions.shape)}")
    if directions.dtype != torch.float32:
        raise TypeError("directions must be float32")
    if bvh.tri.device != dev:
        raise ValueError(f"BVH tables are on {bvh.tri.device}, directions on {dev}")
    if dev.type == "cpu":
        return fused_trace_plain(bvh, directions, tx_pos, rx_pos, rx_radius, n1, n2,
                                 max_bounces=max_bounces)
    if dev.type != "cuda":
        raise ValueError(f"no fused trace for device {dev}")
    tx, rx, r2, n1s, n2s = _scalars(tx_pos, rx_pos, rx_radius, n1, n2)
    d = directions.contiguous()
    n = d.shape[0]
    if n >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rays per launch, got {n}")
    captured = torch.empty(n, dtype=torch.bool, device=dev)
    cap_amp = torch.empty(n, dtype=torch.float32, device=dev)
    cap_dist = torch.empty(n, dtype=torch.float32, device=dev)
    nb = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return TraceResult(captured, cap_amp, cap_dist, nb)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        FUSED_TRACE_KERNEL.launch(
            d.data_ptr(), n, bvh.node_box.data_ptr(), bvh.node_meta.data_ptr(), bvh.n_nodes,
            bvh.tri.data_ptr(), *map(float, tx), *map(float, rx), float(r2), float(n1s),
            float(n2s), int(max_bounces), captured.data_ptr(), cap_amp.data_ptr(),
            cap_dist.data_ptr(), nb.data_ptr(), stream)
    return TraceResult(captured, cap_amp, cap_dist, nb)


class FusedTracer:
    """Fused tracer bound to one scene's BVH on one device.

    fused(directions (N, 3), tx (3,), rx (3,), rx_radius, n1, n2)
      -> TraceResult (captured, amplitude, distance, num_bounces), each (N,).
    """

    def __init__(self, flat: FlatBVH, *, max_bounces: int, device="cuda"):
        self.device = resolve_device(device)
        self.bvh = pack_bvh(flat, self.device)
        self.max_bounces = int(max_bounces)

    def __call__(self, directions, tx_pos, rx_pos, rx_radius, n1=5.0, n2=1.0) -> TraceResult:
        d = torch.as_tensor(directions, dtype=torch.float32, device=self.device)
        return fused_trace(self.bvh, d, tx_pos, rx_pos, rx_radius, n1, n2,
                           max_bounces=self.max_bounces)


def make_fused_tracer(mesh_or_flat, *, max_bounces: int, leaf_size: int = 8,
                      device="cuda") -> FusedTracer:
    """FusedTracer from a prebuilt FlatBVH, or from a TriangleMesh through the
    numpy SAH builder (`method="numpy"`: the native builder's loader goes
    through rfx.ops, which imports JAX)."""
    if isinstance(mesh_or_flat, FlatBVH):
        flat = mesh_or_flat
    else:
        flat = build_bvh(mesh_or_flat, leaf_size=leaf_size, method="numpy")
    return FusedTracer(flat, max_bounces=max_bounces, device=device)
