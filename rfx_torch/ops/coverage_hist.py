"""Exact coverage histograms: every receiver's hard impulse response from
the segments of one environment trace (port of
rfx/ops/pallas_coverage.py:coverage_hist_pallas).

`coverage_hist` launches the CUDA kernels of rfx_torch/csrc/coverage_hist.cu
on CUDA tensors and runs their plain PyTorch version, `coverage_hist_plain`,
on CPU tensors. Both take segments whose amplitude the caller has already
scaled by tx_power / num_rays, and give the IRs of the map engine's hard,
analytic branch (rfx_torch.coverage), the same nonzero bins and the same
values up to the order of each receiver's sum.

On the card the rays are cut into slabs (`coverage_slabs`, a function of the
ray count alone: chunks of 128 rays dealt out in turn): `rfx_coverage_hist`
fills one (M, nbins) plane per slab, each warp adding alone to its receivers'
rows, and `rfx_coverage_hist_reduce` adds the planes per bin in slab order
(its plain version is `reduce_planes_plain`). A receiver's IR is therefore
the same bits from run to run and whether it is computed alone or in any
group of receivers; so the wrapper may take the receivers in groups that keep
the planes under `PLANES_BYTES`.

`coverage_phasor` gives the phasor metric's (dBm, cancellation ratio, delay
spread) of every receiver from the same segments (rfx/coverage.py:229-246
under the vmap of :350): a per-bin table (`rfx_phasor_table`, plain version
`phasor_table_plain`), one walk (`rfx_coverage_phasor`: the walk and capture
rule of `rfx_coverage_hist` with per-receiver sums in place of the histogram,
which also lists each capture's weight and delay), then
rfx_torch.cir.phasor_metric on the sums, whose spread about each receiver's
mean delay `rfx_coverage_phasor_spread` takes over the lists. A receiver's
sums have an order fixed by the ray count alone, as its IR's. Its forward
runs on CUDA tensors only; the metric's plain version, which a CPU tensor
runs, is rfx_torch.coverage._dbm_cancel_plain (per-path sums, the same
`phasor_metric`). It is differentiable in the segments' amplitude, as rfx's
metric is under jax.grad (the bins are integer casts and the capture a
boolean, so nothing else has a gradient): the backward folds the cotangents
into per-receiver coefficients (`phasor_coefficients`) and launches
`rfx_coverage_phasor_backward`, one thread a ray adding each capture's term
over the receivers in ascending order; its plain version is
`phasor_backward_plain`, which a CPU tensor runs.

The coverage histogram has no backward, as rfx's batched engine has none: on
the card it refuses an input that requires grad (the map engine,
rfx_torch.coverage with engine="map", is differentiable).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from rfx_torch.cir import _DB_PER_POWER, phasor_metric
from rfx_torch.ops._build import CudaKernel, F, I, P
from rfx_torch.ops.intersect import is_hit, sphere_t
from rfx_torch.tracer import EnvSegments

__all__ = ["COVERAGE_HIST_KERNEL", "COVERAGE_PHASOR_KERNEL", "COVERAGE_REDUCE_KERNEL",
           "COVERAGE_SPREAD_KERNEL", "PHASOR_BACKWARD_KERNEL", "PHASOR_TABLE_KERNEL", "PhasorWalk",
           "coverage_hist", "coverage_hist_plain", "coverage_phasor", "coverage_slabs",
           "first_captures", "phasor_backward", "phasor_backward_plain", "phasor_coefficients", "phasor_lists_spent",
           "phasor_spread_plain", "phasor_table", "phasor_table_plain", "slab_of_ray", "reduce_planes",
           "reduce_planes_plain"]

COVERAGE_HIST_KERNEL = CudaKernel(
    "coverage_hist.cu", "rfx_coverage_hist",
    [P, P, P, P, P, P, I, I, P, I, F, F, F, I, I, P, P],
)
COVERAGE_REDUCE_KERNEL = CudaKernel(
    "coverage_hist.cu", "rfx_coverage_hist_reduce", [P, I, ctypes.c_longlong, P, P],
)
PHASOR_TABLE_KERNEL = CudaKernel("coverage_hist.cu", "rfx_phasor_table", [I, F, F, P, P])
COVERAGE_PHASOR_KERNEL = CudaKernel(
    "coverage_hist.cu", "rfx_coverage_phasor",
    [P, P, P, P, P, P, I, I, P, I, F, F, F, I, P, I, I, I, P, P, P, P, P],
)
COVERAGE_SPREAD_KERNEL = CudaKernel(
    "coverage_hist.cu", "rfx_coverage_phasor_spread",
    [P, P, P, P, P, P, I, I, P, I, F, F, F, I, P, I, I, I, P, P, P, P, P, P],
)
PHASOR_BACKWARD_KERNEL = CudaKernel(
    "coverage_hist.cu", "rfx_coverage_phasor_backward",
    [P, P, P, P, P, P, I, I, P, I, F, F, F, I, F, F, P, P, P, P, P],
)
#: Rays of one block of the backward's live-ray scan (kScanRays of
#: coverage_hist.cu): its scratch holds an offset per block.
PHASOR_BACKWARD_SCAN_RAYS = 1024
#: The phasor sums of the first pass, per receiver (kSumFields of coverage_hist.cu).
PHASOR_FIELDS = ("re", "im", "s_max", "any", "w2", "w2t")
#: The first pass's capture lists: chunks of PHASOR_CHUNK (w^2, t_k) pairs
#: from a pool of PHASOR_CHUNKS_A_REGION chunks per (slab, receiver) and
#: PHASOR_SPARE_CHUNKS more. On the 2,048-receiver sweeps of chip_smoke.py a
#: region holds 63 captures at the median and 6,810 at most (room), and the
#: pool is never spent there; a region that finds it spent is walked again.
PHASOR_CHUNK = 256
PHASOR_CHUNKS_A_REGION = 2
PHASOR_SPARE_CHUNKS = 4096
#: The lists of one launch take at most about this much device memory; more
#: receivers go in several launches.
PHASOR_LISTS_BYTES = 2 << 30

#: Rays of one chunk: the 32 lanes of a warp times the segments a lane holds
#: (kRays of coverage_hist.cu).
CHUNK_RAYS = 128
#: One slab per MIN_SLAB_RAYS rays (rounded up), at most MAX_SLABS.
MIN_SLAB_RAYS = 32_768
MAX_SLABS = 12
#: The slabs' planes of one launch take at most this much device memory;
#: more receivers than fit go in several launches.
PLANES_BYTES = 2 << 30


def coverage_slabs(num_rays: int) -> int:
    """The number of slabs the rays are cut into: chunk j (the rays
    [j * CHUNK_RAYS, (j + 1) * CHUNK_RAYS)) belongs to slab j % n_slabs. A
    function of the ray count alone, never of the receivers, so that a
    receiver's sum has one order."""
    return max(1, min(MAX_SLABS, -(-int(num_rays) // MIN_SLAB_RAYS)))


def slab_of_ray(num_rays: int) -> torch.Tensor:
    """(num_rays,) int64: the slab of each ray under `coverage_slabs`."""
    return (torch.arange(int(num_rays)) // CHUNK_RAYS) % coverage_slabs(num_rays)


def _centers(rx_centers, device) -> torch.Tensor:
    return torch.as_tensor(rx_centers, dtype=torch.float32, device=device).reshape(-1, 3)


def first_captures(segs: EnvSegments, t_rx: torch.Tensor) -> torch.Tensor:
    """(R, B, N) bool: a receiver captures a live segment it hits (t_rx, (R,
    B, N), below the miss sentinel) before the environment does, and its
    first capture along the bounce axis ends its view of the ray."""
    win = segs.alive & is_hit(t_rx) & (segs.t_env > t_rx)
    win_i = win.to(torch.int32)
    return win & (torch.cumsum(win_i, dim=1) - win_i == 0)


def _first_wins(segs: EnvSegments, batch: torch.Tensor, rx_radius, *, nbins: int,
                light_speed_mps: float, sample_rate_hz: float):
    """(bins, valid), each (R, B, N), of R receivers: a receiver wins a live
    segment it hits before the environment does, its first win along the
    bounce axis counts, in bin int((dist + t_rx) / c * rate), dropped outside
    [0, nbins)."""
    dev = segs.t_env.device
    b, n = segs.t_env.shape
    o = segs.origin.reshape(b * n, 3)
    d = segs.direction.reshape(b * n, 3)
    r = torch.as_tensor(rx_radius, dtype=torch.float32, device=dev)
    c = torch.tensor(light_speed_mps, dtype=torch.float32, device=dev)
    rate = torch.tensor(sample_rate_hz, dtype=torch.float32, device=dev)
    t_rx = sphere_t(o, d, batch[:, None, :], r * r).reshape(-1, b, n)
    first = first_captures(segs, t_rx)
    bins = ((segs.distance + t_rx) / c * rate).to(torch.int32)
    return bins, first & (bins >= 0) & (bins < nbins)


def coverage_hist_plain(segs: EnvSegments, rx_centers, rx_radius, *, nbins: int,
                        light_speed_mps: float, sample_rate_hz: float,
                        rx_batch: int = 64) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (M, nbins) f32. Receivers go
    `rx_batch` at a time through one broadcast sphere test over the B x N
    segments, the first capture along the bounce axis, and one `index_add_`
    into the batch's flattened (R * nbins) rows."""
    dev = segs.t_env.device
    centers = _centers(rx_centers, dev)
    out = torch.zeros((centers.shape[0], nbins), dtype=torch.float32, device=dev)
    for s in range(0, centers.shape[0], rx_batch):
        batch = centers[s:s + rx_batch]
        bins, valid = _first_wins(segs, batch, rx_radius, nbins=nbins,
                                  light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz)
        row = torch.arange(batch.shape[0], device=dev)[:, None, None] * nbins
        out[s:s + batch.shape[0]].view(-1).index_add_(
            0, (row + bins)[valid], segs.amplitude.expand_as(bins)[valid])
    return out


def _check_segments(segs: EnvSegments):
    b, n = segs.t_env.shape
    for name, shape in (("origin", (b, n, 3)), ("direction", (b, n, 3)), ("amplitude", (b, n)),
                        ("distance", (b, n)), ("alive", (b, n))):
        if tuple(getattr(segs, name).shape) != shape:
            raise ValueError(f"segments: {name} must be {shape}, got "
                             f"{tuple(getattr(segs, name).shape)}")
    for name in ("origin", "direction", "t_env", "amplitude", "distance"):
        if getattr(segs, name).dtype != torch.float32:
            raise TypeError(f"segments: {name} must be float32")
    if segs.alive.dtype != torch.bool:
        raise TypeError("segments: alive must be bool")
    if len({t.device for t in segs}) != 1:
        raise ValueError("segments must lie on one device")


def coverage_hist(segs: EnvSegments, rx_centers, rx_radius, *, nbins: int,
                  light_speed_mps: float, sample_rate_hz: float,
                  rx_batch: int = 64) -> torch.Tensor:
    """(M, nbins) hard impulse responses of M receiver spheres of one radius
    from the env segments `segs` (amplitude pre-scaled). A CPU tensor runs
    `coverage_hist_plain` (`rx_batch` receivers at a time); a CUDA tensor
    launches the kernel, or raises. Forward only, as rfx's batched engine: on
    the card an input that requires grad, under grad mode, raises."""
    _check_segments(segs)
    if nbins < 1:
        raise ValueError("nbins must be at least 1")
    dev = segs.t_env.device
    if dev.type == "cuda" and torch.is_grad_enabled() and any(
            isinstance(v, torch.Tensor) and v.requires_grad for v in (*segs, rx_centers, rx_radius)):
        raise RuntimeError("rfx_coverage_hist (the coverage kernel) has no backward, as rfx's "
                           "batched engine has none: detach the segments, or take engine=\"map\" "
                           "for a gradient")
    if dev.type == "cpu":
        return coverage_hist_plain(segs, rx_centers, rx_radius, nbins=nbins,
                                   light_speed_mps=light_speed_mps,
                                   sample_rate_hz=sample_rate_hz, rx_batch=rx_batch)
    if dev.type != "cuda":
        raise ValueError(f"no coverage histogram for device {dev}")
    centers = _centers(rx_centers, dev).contiguous()
    m = centers.shape[0]
    b, n = segs.t_env.shape
    if n >= 2**31 or b >= 2**31 or m >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rays, bounces and receivers, got {n}, {b}, {m}")
    if nbins >= 2**31:
        raise ValueError(f"at most 2^31 - 1 bins, got {nbins}")
    if m == 0 or n == 0 or b == 0:
        return torch.zeros((m, nbins), dtype=torch.float32, device=dev)
    n_slabs = coverage_slabs(n)
    planes = [t.contiguous() for t in (segs.origin, segs.direction, segs.t_env,
                                       segs.amplitude, segs.distance, segs.alive)]
    group = max(1, PLANES_BYTES // (4 * n_slabs * nbins))
    out = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(0, m, group):
            mine = centers[s:s + group]
            partial = torch.zeros((n_slabs, mine.shape[0], nbins), dtype=torch.float32, device=dev)
            COVERAGE_HIST_KERNEL.launch(
                *(t.data_ptr() for t in planes), b, n, mine.data_ptr(), mine.shape[0],
                float(rx_radius), float(light_speed_mps), float(sample_rate_hz), nbins, n_slabs,
                partial.data_ptr(), stream)
            out.append(partial[0] if n_slabs == 1 else reduce_planes(partial))
    return out[0] if len(out) == 1 else torch.cat(out)


def reduce_planes_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the slab reduction: planes[0] + planes[1] +
    ... in that order."""
    out = planes[0].clone()
    for h in range(1, planes.shape[0]):
        out += planes[h]
    return out


def reduce_planes(planes: torch.Tensor) -> torch.Tensor:
    """Sum of (H, ...) f32 planes over H in plane order. A CPU tensor runs
    `reduce_planes_plain`; a CUDA tensor launches the kernel, or raises."""
    if planes.ndim < 2 or planes.shape[0] < 1 or planes.dtype != torch.float32:
        raise ValueError(f"planes must be (H >= 1, ...) float32, got {tuple(planes.shape)} "
                         f"{planes.dtype}")
    dev = planes.device
    if dev.type == "cpu":
        return reduce_planes_plain(planes)
    if dev.type != "cuda":
        raise ValueError(f"no plane reduction for device {dev}")
    planes = planes.contiguous()
    out = torch.empty(planes.shape[1:], dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        COVERAGE_REDUCE_KERNEL.launch(planes.data_ptr(), planes.shape[0], out.numel(),
                                      out.data_ptr(), stream)
    return out


def _phasor_constants(nbins: int, sample_window_s: float, carrier_hz: float):
    """(step, omega) of the phasor metric, as rfx_torch.cir.rx_power_dbm_phasor
    rounds them: window / (nbins - 1) and 2 pi f in Python floats, each to
    f32 once."""
    step = float(torch.tensor(sample_window_s / (nbins - 1), dtype=torch.float32))
    omega = float(torch.tensor(2.0 * math.pi * carrier_hz, dtype=torch.float32))
    return step, omega


def phasor_table_plain(nbins: int, step: float, omega: float, device="cpu") -> torch.Tensor:
    """Plain PyTorch version of the phasor table kernel: (nbins, 4) f32, row
    k (sqrt s_k, cos(omega t_k), sin(omega t_k), t_k), the per-capture
    quantities of rfx_torch.cir.rx_power_dbm_phasor for bin k (t_k = k *
    step, s_k = min(k + hi + 1, nbins)) in its f32 expressions."""
    f32 = torch.float32
    bins = torch.arange(nbins, dtype=torch.int32, device=device)
    t_k = bins.to(f32) * torch.tensor(step, dtype=f32, device=device)
    hi = nbins - 1 - (nbins - 1) // 2
    s_k = torch.clamp_max(bins + hi + 1, nbins).to(f32)
    phase = torch.tensor(omega, dtype=f32, device=device) * t_k
    return torch.stack([torch.sqrt(s_k), torch.cos(phase), torch.sin(phase), t_k], dim=1)


def phasor_table(nbins: int, step: float, omega: float, device) -> torch.Tensor:
    """The phasor metric's per-bin table, (nbins, 4) f32 (`phasor_table_plain`'s
    rows): on the CPU the plain version, on a CUDA device one launch of
    `rfx_phasor_table`, whose cosf / sinf may differ from PyTorch's by
    rounding."""
    device = torch.device(device)
    if nbins < 1 or nbins >= 2**31:
        raise ValueError(f"nbins must be in [1, 2^31), got {nbins}")
    if device.type == "cpu":
        return phasor_table_plain(nbins, step, omega)
    if device.type != "cuda":
        raise ValueError(f"no phasor table kernel for device {device}")
    table = torch.empty((nbins, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        PHASOR_TABLE_KERNEL.launch(nbins, step, omega, table.data_ptr(),
                                   torch.cuda.current_stream(device).cuda_stream)
    return table


class PhasorWalk(NamedTuple):
    """What the phasor kernel's first pass leaves for the spread, for one
    group of receivers: the launch's arguments up to the table, the capture
    lists (`pool`, and `ints`: the pool's count of chunks taken, the chunks'
    links, then per (slab, receiver) region its first chunk, its captures
    and whether its list was lost) and the pool's size in chunks."""
    args: tuple
    n_slabs: int
    n_chunks: int
    pool: torch.Tensor
    ints: torch.Tensor

    def regions(self, k: int) -> torch.Tensor:
        """(n_slabs, m) int32 field k of the regions: 0 first chunk, 1
        captures, 2 lost."""
        r = self.n_slabs * self.args[9]
        at = 1 + self.n_chunks + k * r
        return self.ints[at:at + r].view(self.n_slabs, -1)


def phasor_lists_spent(walks) -> tuple:
    """(captures, regions whose list was lost) of a first pass's walks: the
    second is the number of (slab, receiver) pairs whose tile the spread
    walks again."""
    return (sum(int(w.regions(1).sum()) for w in walks),
            sum(int(w.regions(2).sum()) for w in walks))


def _phasor_sums(segs: EnvSegments, centers: torch.Tensor, rx_radius, *, nbins: int,
                 light_speed_mps: float, sample_rate_hz: float, sample_window_s: float,
                 carrier_hz: float):
    """The phasor kernel's first pass on CUDA tensors: ((M, 6) f32 sums in
    PHASOR_FIELDS order (sum w cos, sum w sin, max s_k, any capture as 1.0,
    sum w^2, sum w^2 t_k; w = amp sqrt(s_k), the quantities of
    rfx_torch.cir.rx_power_dbm_phasor, amp already scaled), [PhasorWalk] for
    `_phasor_spread`). One launch of the table, then one of
    `rfx_coverage_phasor` a group of receivers: each receiver's sums per
    slab, the slabs combined in slab order, and its captures' (w^2, t_k) in
    each slab's walk order."""
    dev = segs.t_env.device
    if dev.type != "cuda":
        raise ValueError(f"the phasor kernel runs on CUDA tensors, got {dev}; the metric's plain "
                         "version is rfx_torch.coverage._dbm_cancel_plain")
    m = centers.shape[0]
    b, n = segs.t_env.shape
    if n >= 2**31 or b >= 2**31 or m >= 2**26 or nbins >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rays, bounces and bins and 2^26 - 1 receivers, got "
                         f"{n}, {b}, {nbins}, {m}")
    sums = torch.zeros((m, len(PHASOR_FIELDS)), dtype=torch.float32, device=dev)
    if not (m and n and b):
        return sums, []
    step, omega = _phasor_constants(nbins, sample_window_s, carrier_hz)
    table = phasor_table(nbins, step, omega, dev)
    n_slabs = coverage_slabs(n)
    planes = [t.contiguous() for t in (segs.origin, segs.direction, segs.t_env,
                                       segs.amplitude, segs.distance, segs.alive)]
    per_rx = n_slabs * (PHASOR_CHUNKS_A_REGION * PHASOR_CHUNK * 8 + 4 * (4 + len(PHASOR_FIELDS)))
    group = max(1, PHASOR_LISTS_BYTES // per_rx)
    walks = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s in range(0, m, group):
            mine = centers[s:s + group]
            g = mine.shape[0]
            regions = n_slabs * g
            n_chunks = PHASOR_CHUNKS_A_REGION * regions + PHASOR_SPARE_CHUNKS
            pool = torch.empty(2 * n_chunks * PHASOR_CHUNK, dtype=torch.float32, device=dev)
            ints = torch.empty(1 + n_chunks + 3 * regions, dtype=torch.int32, device=dev)
            partials = torch.empty(regions * len(PHASOR_FIELDS), dtype=torch.float32, device=dev)
            args = (*(t.data_ptr() for t in planes), b, n, mine.data_ptr(), g, float(rx_radius),
                    float(light_speed_mps), float(sample_rate_hz), nbins, table.data_ptr(),
                    n_slabs, PHASOR_CHUNK, n_chunks, pool.data_ptr(), ints.data_ptr())
            COVERAGE_PHASOR_KERNEL.launch(*args, partials.data_ptr(), sums[s:s + g].data_ptr(),
                                          stream)
            # The walk's inputs stay referenced until the spread has run.
            walks.append(PhasorWalk(args + ((planes, mine, table),), n_slabs, n_chunks, pool,
                                    ints))
    return sums, walks


def _phasor_spread(walks, t_mean: torch.Tensor) -> torch.Tensor:
    """(M,) f32 sum w^2 (t_k - t_mean)^2 per receiver, from the first pass's
    lists (`_phasor_sums`) about `t_mean` (M,): one launch of
    `rfx_coverage_phasor_spread` a group of receivers. Each slab's list is
    added in its recorded order, the tiles of lost lists walk again, and the
    slabs are combined in slab order: the sums of a second walk, bit for
    bit."""
    mean = t_mean.to(torch.float32).contiguous()
    out = torch.zeros(mean.shape[0], dtype=torch.float32, device=mean.device)
    s = 0
    with torch.cuda.device(mean.device):
        stream = torch.cuda.current_stream(mean.device).cuda_stream
        for w in walks:
            g = w.args[9]
            dev_partials = torch.empty(w.n_slabs * g, dtype=torch.float32, device=mean.device)
            COVERAGE_SPREAD_KERNEL.launch(*w.args[:-1], mean[s:s + g].data_ptr(),
                                          dev_partials.data_ptr(), out[s:s + g].data_ptr(),
                                          stream)
            s += g
    return out


def phasor_spread_plain(segs: EnvSegments, rx_centers, rx_radius, t_mean: torch.Tensor, *,
                        nbins: int, light_speed_mps: float, sample_rate_hz: float,
                        sample_window_s: float, carrier_hz: float,
                        rx_batch: int = 64) -> torch.Tensor:
    """Plain PyTorch version of the spread (`_phasor_spread`): (M,) f32 sum
    w^2 (t_k - t_mean)^2 over each receiver's first captures (amp already
    scaled), w = amp sqrt(s_k) and t_k from `phasor_table_plain`, `rx_batch`
    receivers a broadcast sphere test, on either device."""
    dev = segs.t_env.device
    centers = _centers(rx_centers, dev)
    table = phasor_table_plain(nbins, *_phasor_constants(nbins, sample_window_s, carrier_hz), dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = []
    for s in range(0, centers.shape[0], rx_batch):
        bins, valid = _first_wins(segs, centers[s:s + rx_batch], rx_radius, nbins=nbins,
                                  light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz)
        rows = table[bins.clamp(0, nbins - 1)]
        aw = segs.amplitude * rows[..., 0]
        dt = rows[..., 3] - t_mean[s:s + rx_batch, None, None]
        out.append(torch.sum(torch.where(valid, aw * aw * (dt * dt), zero), dim=(1, 2)))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float32, device=dev)


def phasor_coefficients(sums: torch.Tensor, spread: torch.Tensor, g_dbm=None, g_ratio=None,
                        g_spread=None) -> torch.Tensor:
    """The backward's (M, 8) f32 per-receiver coefficients (re, im, A, B, S,
    t_mean, var, 0) from the forward's sums (`_phasor_sums`' fields), its
    spread and the cotangents of (dBm, ratio, spread), each (M,) or None. With
    C = re^2 + im^2, W = w2 and var = spread^2, a capture of amplitude a with
    (w, cos, sin, t) from the table adds to d / d a

        w (re cos + im sin) A + a w^2 (B + S ((t - t_mean)^2 - var)),

    A = g_dbm 20 / (ln 10 C) + g_ratio 2 / W, B = -g_ratio 2 C / W^2 and S =
    g_spread / (spread W): the derivatives of rfx.cir.rx_power_dbm_phasor's
    dBm, ratio and spread. A part whose cotangent is zero is 0 (and the
    capture's term skips it), never a product with it: jax.grad prunes a zero
    cotangent, so an unused ratio or spread must not turn 0 * inf into NaN. A
    receiver with no capture gets zeros."""
    f32 = torch.float32
    dev = sums.device
    re, im, _, any_f, w2, w2t = sums.to(f32).unbind(1)
    zero = torch.zeros((), dtype=f32, device=dev)
    hit = any_f > 0
    coherent = re * re + im * im
    spread = spread.to(f32)

    def part(g, value):
        if g is None:
            return torch.zeros_like(re)
        g = g.to(f32)
        return torch.where(hit & (g != 0), value(g), zero)

    db_per_power = torch.tensor(_DB_PER_POWER, dtype=f32, device=dev)
    a = (part(g_dbm, lambda g: g * db_per_power / coherent)
         + part(g_ratio, lambda g: g * 2.0 / w2))
    b = part(g_ratio, lambda g: -(g * 2.0) * (coherent / w2) / w2)
    s = part(g_spread, lambda g: g / (spread * w2))
    t_mean = torch.where(hit, w2t / w2, zero)
    return torch.stack([re, im, a, b, s, t_mean, spread * spread, torch.zeros_like(re)],
                       dim=1).contiguous()


def _phasor_terms(coef: torch.Tensor, rows: torch.Tensor, amp: torch.Tensor) -> torch.Tensor:
    """Each capture's term of d / d amplitude (`phasor_coefficients`), from
    its receiver's coefficients (K, 8), its table row (K, 4) and its
    amplitude (K,), in the f32 expressions of the backward kernel."""
    re, im, a, b, s, t_mean, var, _ = coef.unbind(1)
    w, cos, sin, t = rows.unbind(1)
    zero = torch.zeros((), dtype=torch.float32, device=coef.device)
    dt = t - t_mean
    u = b + torch.where(s != 0, s * (dt * dt - var), zero)
    return (torch.where(a != 0, w * (re * cos + im * sin) * a, zero)
            + torch.where((b != 0) | (s != 0), amp * w * w * u, zero))


def phasor_backward_plain(segs: EnvSegments, rx_centers, rx_radius, coef: torch.Tensor, *,
                          nbins: int, light_speed_mps: float, sample_rate_hz: float,
                          sample_window_s: float, carrier_hz: float,
                          rx_batch: int = 64) -> torch.Tensor:
    """Plain PyTorch version of the phasor backward kernel, on either device:
    (B, N) f32 d / d amplitude of the segments (amp already scaled) given the
    per-receiver coefficients `coef` (`phasor_coefficients`). Receivers go
    `rx_batch` at a time through the broadcast sphere test and first-capture
    rule of `coverage_hist_plain`; each batch's captures are listed
    (receiver, then segment) and their terms added to their segments with
    `index_add_`, which on the CPU adds them in that order, receivers
    ascending, as the kernel does."""
    dev = segs.t_env.device
    centers = _centers(rx_centers, dev)
    table = phasor_table_plain(nbins, *_phasor_constants(nbins, sample_window_s, carrier_hz), dev)
    b, n = segs.t_env.shape
    amp = segs.amplitude.reshape(-1).to(torch.float32)
    coef = coef.to(torch.float32)
    out = torch.zeros(b * n, dtype=torch.float32, device=dev)
    for s in range(0, centers.shape[0], rx_batch):
        bins, valid = _first_wins(segs, centers[s:s + rx_batch], rx_radius, nbins=nbins,
                                  light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz)
        r, at = valid.reshape(valid.shape[0], -1).nonzero(as_tuple=True)
        rows = table[bins.reshape(bins.shape[0], -1)[r, at]]
        out.index_add_(0, at, _phasor_terms(coef[s + r], rows, amp[at]))
    return out.view(b, n)


def phasor_backward(segs: EnvSegments, rx_centers, rx_radius, coef: torch.Tensor, *, nbins: int,
                    light_speed_mps: float, sample_rate_hz: float, sample_window_s: float,
                    carrier_hz: float, rx_batch: int = 64) -> torch.Tensor:
    """(B, N) f32 d / d amplitude of the phasor metric given the coefficients
    `coef` (`phasor_coefficients`). A CUDA tensor launches
    `rfx_coverage_phasor_backward` once for all receivers (`_phasor_backward_launch`):
    the forward's captures (its device code and per-bin table), each
    segment's terms added in ascending receiver order, the same bits from
    run to run. A CPU tensor runs `phasor_backward_plain` (`rx_batch`
    receivers at a time)."""
    kw = dict(nbins=nbins, light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
              sample_window_s=sample_window_s, carrier_hz=carrier_hz)
    dev = segs.t_env.device
    if dev.type == "cpu":
        return phasor_backward_plain(segs, rx_centers, rx_radius, coef, rx_batch=rx_batch, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no phasor backward kernel for device {dev}")
    return _phasor_backward_launch(segs, rx_centers, rx_radius, coef, **kw)[0]


def _phasor_backward_launch(segs: EnvSegments, rx_centers, rx_radius, coef: torch.Tensor, *,
                            nbins: int, light_speed_mps: float, sample_rate_hz: float,
                            sample_window_s: float, carrier_hz: float):
    """One launch of `rfx_coverage_phasor_backward` on CUDA tensors: (g_amp,
    the number of live rays its scan listed as a 0-dim int32 tensor on the
    card)."""
    dev = segs.t_env.device
    centers = _centers(rx_centers, dev).contiguous()
    m = centers.shape[0]
    b, n = segs.t_env.shape
    if n >= 2**31 or b >= 2**31 or m >= 2**31 or nbins >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rays, bounces, receivers and bins, got {n}, {b}, {m}, "
                         f"{nbins}")
    if not (m and n and b):
        return (torch.zeros((b, n), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    if tuple(coef.shape) != (m, 8):
        raise ValueError(f"coef must be ({m}, 8), got {tuple(coef.shape)}")
    planes = [t.detach().contiguous() for t in (segs.origin, segs.direction, segs.t_env,
                                                segs.amplitude, segs.distance, segs.alive)]
    coef = coef.to(torch.float32).contiguous()
    g_amp = torch.empty((b, n), dtype=torch.float32, device=dev)
    # The kernel's scratch: the per-bin table, then the live rays, the scan
    # blocks' offsets and the live rays' count.
    table = torch.empty((nbins, 4), dtype=torch.float32, device=dev)
    ints = torch.empty(n + -(-n // PHASOR_BACKWARD_SCAN_RAYS) + 1, dtype=torch.int32, device=dev)
    step, omega = _phasor_constants(nbins, sample_window_s, carrier_hz)
    with torch.cuda.device(dev):
        PHASOR_BACKWARD_KERNEL.launch(
            *(t.data_ptr() for t in planes), b, n, centers.data_ptr(), m, float(rx_radius),
            float(light_speed_mps), float(sample_rate_hz), nbins, step, omega, coef.data_ptr(),
            table.data_ptr(), ints.data_ptr(), g_amp.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return g_amp, ints[-1]


class _Phasor(torch.autograd.Function):
    """(dBm, ratio, spread) of the phasor metric from segments whose
    amplitude is pre-scaled, differentiable in the amplitude alone (the other
    segment fields ride in `segs` and get no gradient, as in rfx). The
    forward keeps the segments, the centers, the first pass's sums and the
    spread; never an (R, B, N) tensor."""

    @staticmethod
    def forward(ctx, amplitude, segs, centers, rx_radius, kw):
        ctx.set_materialize_grads(False)
        segs = EnvSegments(*(t.detach() for t in segs._replace(amplitude=amplitude)))
        sums, walks = _phasor_sums(segs, centers, rx_radius, **kw)
        re, im, s_max, any_f, w2, w2t = sums.unbind(1)
        dbm, ratio, spread = phasor_metric(re, im, s_max, any_f > 0, w2, w2t,
                                           lambda t_mean: _phasor_spread(walks, t_mean))
        ctx.save_for_backward(*segs, centers, sums, spread)
        ctx.rx_radius, ctx.kw = rx_radius, kw
        return dbm, ratio, spread

    @staticmethod
    def backward(ctx, g_dbm, g_ratio, g_spread):
        *planes, centers, sums, spread = ctx.saved_tensors
        if g_dbm is None and g_ratio is None and g_spread is None:
            return None, None, None, None, None
        coef = phasor_coefficients(sums, spread, g_dbm, g_ratio, g_spread)
        g_amp = phasor_backward(EnvSegments(*planes), centers, ctx.rx_radius, coef, **ctx.kw)
        return g_amp, None, None, None, None


def coverage_phasor(segs: EnvSegments, rx_centers, rx_radius, *, nbins: int,
                    light_speed_mps: float, sample_rate_hz: float, sample_window_s: float,
                    carrier_hz: float = 2.4e9):
    """((M,) dBm, (M,) coherent / incoherent power ratio, (M,) power-weighted
    delay spread in s) of M receiver spheres of one radius from the env
    segments `segs` (amplitude pre-scaled) on CUDA tensors: the phasor
    kernel's first pass (`_phasor_sums`), rfx_torch.cir.phasor_metric on its
    sums, which hands each receiver's mean delay to the spread over the
    first pass's capture lists (`_phasor_spread`). -inf dBm, ratio 1 and
    spread 0 where nothing was captured. Differentiable in
    `segs.amplitude` (`_Phasor`): the backward launches
    `rfx_coverage_phasor_backward` once. A tensor off the card raises."""
    _check_segments(segs)
    centers = _centers(rx_centers, segs.t_env.device).contiguous()
    kw = dict(nbins=nbins, light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
              sample_window_s=sample_window_s, carrier_hz=carrier_hz)
    return _Phasor.apply(segs.amplitude, segs, centers, rx_radius, kw)
