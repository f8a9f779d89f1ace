"""Exact coverage histograms: every receiver's hard impulse response from
the segments of one environment trace (port of
rfx/ops/pallas_coverage.py:coverage_hist_pallas).

`coverage_hist` launches the CUDA kernel rfx_torch/csrc/coverage_hist.cu on
CUDA tensors and runs its plain PyTorch version, `coverage_hist_plain`, on
CPU tensors. Both take segments whose amplitude the caller has already
scaled by tx_power / num_rays, and give the IRs of the map engine's hard,
analytic branch (rfx_torch.coverage), the same nonzero bins and the same
values up to the order of each receiver's sum: the kernel sums in ray order,
the plain version in (bounce, ray) order. The kernel's IRs are
bit-identical from run to run.
"""

from __future__ import annotations

import torch

from rfx_torch.ops._build import CudaKernel, F, I, P
from rfx_torch.ops.intersect import is_hit, sphere_t
from rfx_torch.tracer import EnvSegments

__all__ = ["COVERAGE_HIST_KERNEL", "coverage_hist", "coverage_hist_plain"]

COVERAGE_HIST_KERNEL = CudaKernel(
    "coverage_hist.cu", "rfx_coverage_hist",
    [P, P, P, P, P, P, I, I, P, I, F, F, F, I, I, P, P],
)


def _centers(rx_centers, device) -> torch.Tensor:
    return torch.as_tensor(rx_centers, dtype=torch.float32, device=device).reshape(-1, 3)


def coverage_hist_plain(segs: EnvSegments, rx_centers, rx_radius, *, nbins: int,
                        light_speed_mps: float, sample_rate_hz: float,
                        rx_batch: int = 64) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (M, nbins) f32. Receivers go
    `rx_batch` at a time through one broadcast sphere test over the B x N
    segments, the first capture along the bounce axis, and one `index_add_`
    into the batch's flattened (R * nbins) rows."""
    dev = segs.t_env.device
    centers = _centers(rx_centers, dev)
    b, n = segs.t_env.shape
    o = segs.origin.reshape(b * n, 3)
    d = segs.direction.reshape(b * n, 3)
    r = torch.as_tensor(rx_radius, dtype=torch.float32, device=dev)
    c = torch.tensor(light_speed_mps, dtype=torch.float32, device=dev)
    rate = torch.tensor(sample_rate_hz, dtype=torch.float32, device=dev)
    out = torch.zeros((centers.shape[0], nbins), dtype=torch.float32, device=dev)
    for s in range(0, centers.shape[0], rx_batch):
        batch = centers[s:s + rx_batch]
        t_rx = sphere_t(o, d, batch[:, None, :], r * r).reshape(-1, b, n)
        win = segs.alive & is_hit(t_rx) & (segs.t_env > t_rx)
        win_i = win.to(torch.int32)
        first = win & (torch.cumsum(win_i, dim=1) - win_i == 0)
        bins = ((segs.distance + t_rx) / c * rate).to(torch.int32)
        valid = first & (bins >= 0) & (bins < nbins)
        row = torch.arange(batch.shape[0], device=dev)[:, None, None] * nbins
        out[s:s + batch.shape[0]].view(-1).index_add_(
            0, (row + bins)[valid], segs.amplitude.expand_as(t_rx)[valid])
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
    launches the kernel, or raises. Forward only."""
    _check_segments(segs)
    if nbins < 1:
        raise ValueError("nbins must be at least 1")
    dev = segs.t_env.device
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
    kern = COVERAGE_HIST_KERNEL
    with torch.cuda.device(dev):
        max_rpb = kern.symbol_of("rfx_coverage_hist_receivers_per_block")(nbins)
        if max_rpb < 1:
            raise ValueError(f"the coverage kernel holds at most "
                             f"{kern.symbol_of('rfx_coverage_hist_max_bins')()} bins per "
                             f"receiver in shared memory on this card, got {nbins}")
        if m == 0 or n == 0 or b == 0:
            return torch.zeros((m, nbins), dtype=torch.float32, device=dev)
        # Enough blocks to fill the card before a block takes more
        # receivers: each block reads every segment, so fewer blocks read less.
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rpb = max(1, min(max_rpb, -(-m // sms)))
        planes = [t.contiguous() for t in (segs.origin, segs.direction, segs.t_env,
                                           segs.amplitude, segs.distance, segs.alive)]
        out = torch.empty((m, nbins), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        kern.launch(*(t.data_ptr() for t in planes), b, n, centers.data_ptr(), m,
                    float(rx_radius), float(light_speed_mps), float(sample_rate_hz), nbins, rpb,
                    out.data_ptr(), stream)
    return out
