"""Coverage engine: one trace, every receiver (port of rfx/coverage.py).

The environment is traced once (`rfx_torch.tracer.trace_env`), and each
receiver sphere is then intersected with the recorded segments: exactly the
per-receiver trace, since a receiver never alters the environment path and
capture only truncates that receiver's own view of it.

Two engines build the impulse responses:

- `map`: receivers in batches of `rx_batch`, the receiver test over the B x
  N segments per batch, the first capture along the bounce axis, then the
  batch's IRs in one call of the IR histogram (one row a receiver, bounces
  and rays flattened). Hard or soft binning, analytic or icosphere
  receiver; differentiable, which the inverse solver needs. A batch is one
  call of rfx_torch.ops.map_capture.map_irs (the capture kernel, the IR
  histogram's record entry and, in the backward, the capture backward
  kernel on a CUDA tensor, each in its icosphere instantiation for the
  icosphere; their plain versions on a CPU tensor). `_first_capture` is
  the plain composition they are held against (the broadcast sphere test or
  the icosphere's plain closest hit, and the first captures).
- `batched`: the coverage kernel (rfx_torch.ops.coverage_hist) on a CUDA
  tensor, its plain version on a CPU tensor. Hard binning and the analytic
  receiver only; forward only, as rfx's batched engine: on the card an input
  that requires grad raises (take `map` for a gradient).

`auto` takes `batched` on a CUDA tensor for hard, analytic coverage and
`map` otherwise (the reference's rule, with CUDA where it says TPU).

The phasor metric (`coverage_dbm_fast`) gives each receiver's dBm from its
captured paths without an IR: on a CUDA tensor through the phasor kernel
(rfx_torch.ops.coverage_hist.coverage_phasor, K3's walk with per-receiver
sums, differentiable in the paths' amplitudes through its backward kernel),
on a CPU tensor through its plain version, a broadcast sphere test
`rx_batch` receivers at a time. `coverage_dbm` (soft binning or the map
engine) and `coverage_dbm_fast` differentiate on either device as rfx's do
under jax.grad; the hybrid does not, as rfx's host-side hybrid does not. The hybrid metric
(`coverage_dbm_hybrid`) re-evaluates exactly the receivers whose phasor
diagnostics flag cancellation or delay spread, or every receiver when too
many are flagged.
"""

from __future__ import annotations

import numpy as np
import torch

from rfx_torch.cir import rx_power_dbm, rx_power_dbm_phasor
from rfx_torch.ops.coverage_hist import coverage_hist, coverage_phasor, first_captures
from rfx_torch.ops.intersect import ray_sphere_hit
from rfx_torch.ops.map_capture import ico_hit_plain, map_irs
from rfx_torch.tracer import EnvSegments, Scene, trace_env

__all__ = ["make_grid", "coverage_irs", "coverage_dbm", "coverage_dbm_fast",
           "coverage_dbm_hybrid"]


def make_grid(x_range, y_range, z_range) -> np.ndarray:
    """(M, 3) f32 receiver grid, x slowest and z fastest (rfx/coverage.py:30)."""
    pts = [(x, y, z) for x in x_range for y in y_range for z in z_range]
    return np.asarray(pts, dtype=np.float32)


def _t_rx(segs: EnvSegments, centers: torch.Tensor, rx_radius, rx_mode: str) -> torch.Tensor:
    """(R, B, N) receiver-hit distance of every segment for R centers: the
    sphere hit, or each icosphere's plain closest hit (no kernel, on either
    device)."""
    b, n = segs.t_env.shape
    o = segs.origin.reshape(b * n, 3)
    d = segs.direction.reshape(b * n, 3)
    if rx_mode == "analytic":
        return ray_sphere_hit(o, d, centers[:, None, :], rx_radius).reshape(-1, b, n)
    if rx_mode == "icosphere":
        return torch.stack([ico_hit_plain(o, d, c, rx_radius)[0].reshape(b, n) for c in centers])
    raise ValueError(f"unknown rx_mode: {rx_mode}")


def _first_capture(segs: EnvSegments, centers: torch.Tensor, rx_radius, rx_mode: str):
    """(t_rx, first), each (R, B, N): a receiver wins a segment iff it is hit
    and t_env > t_rx (a miss compares as the 1e30 sentinel), dead segments
    are gated, and the first win along the bounce axis ends its view."""
    t_rx = _t_rx(segs, centers, rx_radius, rx_mode)
    return t_rx, first_captures(segs, t_rx)


def _amp_scale(tx_power, num_rays: int, device) -> torch.Tensor:
    """tx_power / num_rays as an f32 0-dim tensor, divided on the host (a
    CUDA division by a Python scalar multiplies by its reciprocal)."""
    return (torch.as_tensor(tx_power, dtype=torch.float32).cpu() / num_rays).to(device)


def _resolve_engine(engine: str, *, soft: bool, rx_mode: str, device: torch.device) -> str:
    if engine == "auto":
        batched = device.type == "cuda" and not soft and rx_mode == "analytic"
        return "batched" if batched else "map"
    if engine not in ("map", "batched"):
        raise ValueError(f"unknown coverage engine: {engine}")
    if engine == "batched" and soft:
        raise ValueError("engine='batched' supports hard binning only")
    if engine == "batched" and rx_mode != "analytic":
        raise ValueError("engine='batched' supports the analytic receiver only")
    return engine


def _irs_from_segments(segs: EnvSegments, rx_centers, rx_radius, *, nbins: int,
                       num_rays: int, light_speed_mps: float, sample_rate_hz: float,
                       tx_power, rx_batch: int, soft: bool, rx_mode: str,
                       engine: str = "auto") -> torch.Tensor:
    """(M, nbins) impulse responses of M receivers from shared env segments
    (rfx/coverage.py:56-81, :155-191). The map engine takes `rx_batch`
    receivers a call of `map_irs` (the map capture kernels on the card),
    either receiver."""
    dev = segs.t_env.device
    centers = torch.as_tensor(rx_centers, dtype=torch.float32, device=dev).reshape(-1, 3)
    engine = _resolve_engine(engine, soft=soft, rx_mode=rx_mode, device=dev)
    if engine == "batched":
        scaled = segs._replace(amplitude=segs.amplitude * _amp_scale(tx_power, num_rays, dev))
        return coverage_hist(scaled, centers, rx_radius, nbins=nbins,
                             light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                             rx_batch=rx_batch)
    hist_kw = dict(nbins=nbins, light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                   soft=soft, rx_mode=rx_mode)
    # map_irs reads the scale on the host: kept there, it costs no wait.
    scale = _amp_scale(tx_power, num_rays, torch.device("cpu"))
    irs = [map_irs(segs, centers[s:s + rx_batch], rx_radius, scale=scale, **hist_kw)
           for s in range(0, centers.shape[0], rx_batch)]
    if not irs:
        return torch.zeros((0, nbins), dtype=torch.float32, device=dev)
    return torch.cat(irs)


def coverage_irs(scene: Scene, tx_pos, directions: torch.Tensor, rx_centers, rx_radius, *,
                 max_bounces: int, nbins: int, num_rays: int,
                 light_speed_mps: float = 2.998e8, sample_rate_hz: float = 100e9,
                 tx_power=1.0, n1=5.0, n2=1.0, rx_batch: int = 64, env_hit=None,
                 active=None, soft: bool = False, engine: str = "auto",
                 rx_mode: str = "analytic") -> torch.Tensor:
    """(M, nbins) impulse responses for M receiver spheres from one trace
    (rfx/coverage.py:91-143). `soft=True` bins linearly between neighbouring
    bins, so the IRs have a gradient in the path lengths (the inverse
    solver's mode). engine: 'map', 'batched' (the coverage kernel; hard
    binning, analytic receiver) or 'auto' (see the module docstring)."""
    _resolve_engine(engine, soft=soft, rx_mode=rx_mode, device=directions.device)
    segs = trace_env(scene, tx_pos, directions, max_bounces=max_bounces, n1=n1, n2=n2,
                     env_hit=env_hit, active=active)
    return _irs_from_segments(segs, rx_centers, rx_radius, nbins=nbins, num_rays=num_rays,
                              light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                              tx_power=tx_power, rx_batch=rx_batch, soft=soft, rx_mode=rx_mode,
                              engine=engine)


def coverage_dbm(scene: Scene, tx_pos, directions, rx_centers, rx_radius, *,
                 sample_window_s: float, sample_rate_hz: float = 100e9,
                 carrier_hz: float = 2.4e9, **kwargs) -> torch.Tensor:
    """(M,) received power in dBm per receiver (rfx/coverage.py:206-226)."""
    nbins = int(sample_window_s * sample_rate_hz)
    irs = coverage_irs(scene, tx_pos, directions, rx_centers, rx_radius, nbins=nbins,
                       sample_rate_hz=sample_rate_hz, **kwargs)
    dbm, _ = rx_power_dbm(irs, sample_window_s, carrier_hz)
    return dbm


def _dbm_cancel_from_segments(segs: EnvSegments, rx_centers, rx_radius, *, num_rays: int,
                              sample_window_s: float, sample_rate_hz: float, carrier_hz: float,
                              light_speed_mps: float, tx_power, rx_batch: int):
    """((M,) dBm, (M,) cancellation ratio, (M,) delay spread in s) of the
    phasor metric from shared env segments (rfx/coverage.py:229-246,
    :336-351). A CPU tensor runs `_dbm_cancel_plain` (differentiable by
    autograd); a CUDA tensor the phasor kernel, whose autograd Function's
    backward is the phasor backward kernel."""
    dev = segs.t_env.device
    if dev.type == "cpu":
        return _dbm_cancel_plain(segs, rx_centers, rx_radius, num_rays=num_rays,
                                 sample_window_s=sample_window_s, sample_rate_hz=sample_rate_hz,
                                 carrier_hz=carrier_hz, light_speed_mps=light_speed_mps,
                                 tx_power=tx_power, rx_batch=rx_batch)
    scaled = segs._replace(amplitude=segs.amplitude * _amp_scale(tx_power, num_rays, dev))
    return coverage_phasor(scaled, rx_centers, rx_radius,
                           nbins=int(sample_window_s * sample_rate_hz),
                           light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                           sample_window_s=sample_window_s, carrier_hz=carrier_hz)


def _dbm_cancel_plain(segs: EnvSegments, rx_centers, rx_radius, *, num_rays: int,
                      sample_window_s: float, sample_rate_hz: float, carrier_hz: float,
                      light_speed_mps: float, tx_power, rx_batch: int):
    """Plain PyTorch version of the phasor kernel's metric, on either device
    and differentiable: `rx_batch` receivers per broadcast sphere test, then
    rfx_torch.cir.rx_power_dbm_phasor on their first captures."""
    dev = segs.t_env.device
    centers = torch.as_tensor(rx_centers, dtype=torch.float32, device=dev).reshape(-1, 3)
    nbins = int(sample_window_s * sample_rate_hz)
    scale = _amp_scale(tx_power, num_rays, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = []
    for s in range(0, centers.shape[0], rx_batch):
        t_rx, first = _first_capture(segs, centers[s:s + rx_batch], rx_radius, "analytic")
        r = t_rx.shape[0]
        amp = torch.where(first, segs.amplitude, zero).reshape(r, -1) * scale
        dist = torch.where(first, segs.distance + t_rx, zero).reshape(r, -1)
        out.append(rx_power_dbm_phasor(
            amp, dist, first.reshape(r, -1), sample_window_s=sample_window_s, nbins=nbins,
            light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
            carrier_hz=carrier_hz, return_cancellation=True))
    if not out:
        empty = torch.zeros(0, dtype=torch.float32, device=dev)
        return empty, empty, empty
    return tuple(torch.cat(x) for x in zip(*out))


def coverage_dbm_fast(scene: Scene, tx_pos, directions, rx_centers, rx_radius, *,
                      max_bounces: int, num_rays: int, sample_window_s: float,
                      sample_rate_hz: float = 100e9, carrier_hz: float = 2.4e9,
                      light_speed_mps: float = 2.998e8, tx_power=1.0, n1=5.0, n2=1.0,
                      rx_batch: int = 64, env_hit=None, active=None) -> torch.Tensor:
    """(M,) dBm per receiver from the shared env segments through the phasor
    identity (rx_power_dbm_phasor): no per-receiver IR, no histogram. It
    departs from the exact metric where paths cancel (the reference measured
    a median of 0.27 dB and a maximum of 20 dB, rfx/coverage.py:279-285);
    `coverage_dbm_hybrid` bounds that."""
    segs = trace_env(scene, tx_pos, directions, max_bounces=max_bounces, n1=n1, n2=n2,
                     env_hit=env_hit, active=active)
    dbm, _, _ = _dbm_cancel_from_segments(
        segs, rx_centers, rx_radius, num_rays=num_rays, sample_window_s=sample_window_s,
        sample_rate_hz=sample_rate_hz, carrier_hz=carrier_hz, light_speed_mps=light_speed_mps,
        tx_power=tx_power, rx_batch=rx_batch)
    return dbm


def coverage_dbm_hybrid(scene: Scene, tx_pos, directions, rx_centers, rx_radius, *,
                        max_bounces: int, num_rays: int, sample_window_s: float,
                        sample_rate_hz: float = 100e9, carrier_hz: float = 2.4e9,
                        light_speed_mps: float = 2.998e8, tx_power=1.0, n1=5.0, n2=1.0,
                        rx_batch: int = 64, env_hit=None, active=None,
                        cancel_threshold: float = 0.5, spread_threshold_s: float = 10e-9,
                        exact_fallback_frac: float = 0.15):
    """((M,) dBm, n_flagged): the phasor metric, with the exact metric (IR
    and convolution, engine 'auto') for the receivers it cannot trust
    (rfx/coverage.py:361-454): coherent / incoherent ratio below
    `cancel_threshold` (destructive interference) or delay spread above
    `spread_threshold_s` (well-separated arrivals). When more than
    `exact_fallback_frac` of the receivers are flagged, every receiver is
    re-evaluated exactly. The scene is traced once; both passes share its
    segments. Exactly the flagged receivers are evaluated (the reference
    pads them to a power of two to reuse a compilation)."""
    segs = trace_env(scene, tx_pos, directions, max_bounces=max_bounces, n1=n1, n2=n2,
                     env_hit=env_hit, active=active)
    dev = segs.t_env.device
    centers = torch.as_tensor(rx_centers, dtype=torch.float32, device=dev).reshape(-1, 3)
    kw = dict(num_rays=num_rays, light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
              tx_power=tx_power, rx_batch=rx_batch)
    dbm, ratio, spread = _dbm_cancel_from_segments(
        segs, centers, rx_radius, sample_window_s=sample_window_s, carrier_hz=carrier_hz, **kw)
    flagged = torch.nonzero((ratio < cancel_threshold) | (spread > spread_threshold_s)).flatten()
    n_flagged = int(flagged.shape[0])
    nbins = int(sample_window_s * sample_rate_hz)
    if n_flagged > exact_fallback_frac * centers.shape[0]:
        # Above this flag rate the subset costs about as much as everyone.
        flagged = torch.arange(centers.shape[0], device=dev)
    if flagged.shape[0]:
        irs = _irs_from_segments(segs, centers[flagged], rx_radius, nbins=nbins, soft=False,
                                 rx_mode="analytic", **kw)
        exact, _ = rx_power_dbm(irs, sample_window_s, carrier_hz)
        dbm = dbm.index_put((flagged,), exact)
    return dbm, n_flagged
