"""Coverage engine: one trace, every receiver (port of rfx/coverage.py, the
map engine).

The environment is traced once (`rfx_torch.tracer.trace_env`), and each
receiver sphere is then intersected with the recorded segments: exactly the
per-receiver trace, since a receiver never alters the environment path and
capture only truncates that receiver's own view of it. Receivers go in
batches of `rx_batch`: one broadcast sphere test over the B x N segments for
the whole batch, the first capture along the bounce axis, then each
receiver's IR through the histogram Function of rfx_torch.cir (the IR
histogram kernel on a CUDA tensor). Hard or soft binning, analytic or
icosphere receiver; differentiable throughout, which the inverse solver
needs.

Not ported yet: the `batched` engine on the coverage kernel (ROADMAP B4),
and `coverage_dbm_fast` / `coverage_dbm_hybrid` (ROADMAP A9).
"""

from __future__ import annotations

import numpy as np
import torch

from rfx_torch.cir import bin_impulse_response, rx_power_dbm
from rfx_torch.ops.intersect import is_hit, ray_mesh_closest_hit_brute, ray_sphere_hit
from rfx_torch.tracer import EnvSegments, Scene, icosphere_soa, trace_env

__all__ = ["make_grid", "coverage_irs", "coverage_dbm"]


def make_grid(x_range, y_range, z_range) -> np.ndarray:
    """(M, 3) f32 receiver grid, x slowest and z fastest (rfx/coverage.py:30)."""
    pts = [(x, y, z) for x in x_range for y in y_range for z in z_range]
    return np.asarray(pts, dtype=np.float32)


def _t_rx(segs: EnvSegments, centers: torch.Tensor, rx_radius, rx_mode: str) -> torch.Tensor:
    """(R, B, N) receiver-hit distance of every segment for R centers."""
    b, n = segs.t_env.shape
    o = segs.origin.reshape(b * n, 3)
    d = segs.direction.reshape(b * n, 3)
    if rx_mode == "analytic":
        return ray_sphere_hit(o, d, centers[:, None, :], rx_radius).reshape(-1, b, n)
    if rx_mode == "icosphere":
        ts = []
        for c in centers:
            v0, e1, e2 = icosphere_soa(c, rx_radius)
            ts.append(ray_mesh_closest_hit_brute(o, d, v0, e1, e2)[0].reshape(b, n))
        return torch.stack(ts)
    raise ValueError(f"unknown rx_mode: {rx_mode}")


def _check_engine(engine: str) -> None:
    if engine in ("auto", "map"):
        return  # 'auto' takes the coverage kernel once it is ported (B4)
    if engine == "batched":
        raise NotImplementedError(
            "engine='batched' needs the coverage kernel, which is not ported yet (ROADMAP B4)")
    raise ValueError(f"unknown coverage engine: {engine}")


def _irs_from_segments(segs: EnvSegments, rx_centers, rx_radius, *, nbins: int,
                       num_rays: int, light_speed_mps: float, sample_rate_hz: float,
                       tx_power, rx_batch: int, soft: bool, rx_mode: str) -> torch.Tensor:
    """(M, nbins) impulse responses of M receivers from shared env segments
    (rfx/coverage.py:56-81, :155-191)."""
    dev = segs.t_env.device
    centers = torch.as_tensor(rx_centers, dtype=torch.float32, device=dev).reshape(-1, 3)
    scale = torch.as_tensor(tx_power, dtype=torch.float32, device=dev) / num_rays
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    irs = []
    for s in range(0, centers.shape[0], rx_batch):
        t_rx = _t_rx(segs, centers[s:s + rx_batch], rx_radius, rx_mode)  # (R, B, N)
        # The receiver wins a segment iff it is hit and t_env > t_rx
        # (a miss compares as the 1e30 sentinel); dead segments are gated.
        win = segs.alive & is_hit(t_rx) & (segs.t_env > t_rx)
        win_i = win.to(torch.int32)
        first = win & (torch.cumsum(win_i, dim=1) - win_i == 0)
        amp = torch.where(first, segs.amplitude, zero) * scale
        dist = torch.where(first, segs.distance + t_rx, zero)
        for r in range(t_rx.shape[0]):
            irs.append(bin_impulse_response(
                amp[r].reshape(-1), dist[r].reshape(-1), first[r].reshape(-1), nbins=nbins,
                light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz, soft=soft))
    if not irs:
        return torch.zeros((0, nbins), dtype=torch.float32, device=dev)
    return torch.stack(irs)


def coverage_irs(scene: Scene, tx_pos, directions: torch.Tensor, rx_centers, rx_radius, *,
                 max_bounces: int, nbins: int, num_rays: int,
                 light_speed_mps: float = 2.998e8, sample_rate_hz: float = 100e9,
                 tx_power=1.0, n1=5.0, n2=1.0, rx_batch: int = 64, env_hit=None,
                 active=None, soft: bool = False, engine: str = "auto",
                 rx_mode: str = "analytic") -> torch.Tensor:
    """(M, nbins) impulse responses for M receiver spheres from one trace
    (rfx/coverage.py:91-143). `soft=True` bins linearly between neighbouring
    bins, so the IRs have a gradient in the path lengths (the inverse
    solver's mode). engine: 'map' (this one) or 'auto' (= 'map' until the
    coverage kernel is ported); 'batched' raises (ROADMAP B4)."""
    _check_engine(engine)
    segs = trace_env(scene, tx_pos, directions, max_bounces=max_bounces, n1=n1, n2=n2,
                     env_hit=env_hit, active=active)
    return _irs_from_segments(segs, rx_centers, rx_radius, nbins=nbins, num_rays=num_rays,
                              light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                              tx_power=tx_power, rx_batch=rx_batch, soft=soft, rx_mode=rx_mode)


def coverage_dbm(scene: Scene, tx_pos, directions, rx_centers, rx_radius, *,
                 sample_window_s: float, sample_rate_hz: float = 100e9,
                 carrier_hz: float = 2.4e9, **kwargs) -> torch.Tensor:
    """(M,) received power in dBm per receiver (rfx/coverage.py:206-226)."""
    nbins = int(sample_window_s * sample_rate_hz)
    irs = coverage_irs(scene, tx_pos, directions, rx_centers, rx_radius, nbins=nbins,
                       sample_rate_hz=sample_rate_hz, **kwargs)
    dbm, _ = rx_power_dbm(irs, sample_window_s, carrier_hz)
    return dbm
