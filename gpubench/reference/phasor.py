"""Plain reference of the phasor coverage metric: rfx's `--metric fast`.

Written from the semantics of rfx's phasor identity (`rfx/cir.py:204-274`,
each receiver's first captures as the coverage engine gives them,
`rfx/coverage.py:229-246`), in plain PyTorch, float64 by default, and
independent of the port: it imports nothing of `rfx_torch` or `rfx`. The
environment trace and each receiver's first captures come from
`reference/trace.py`, as the exact metric's reference takes them.

For each receiver, over its first captures (amplitude amp_k, path length
len_k) whose bin b_k = int(len_k / c * rate) lies in [0, nbins):

    t_k = b_k * window / (nbins - 1)
    s_k = min(b_k + hi + 1, nbins),   hi = nbins - 1 - floor((nbins - 1) / 2)
    A   = sum_k amp_k * tx_power / rays * sqrt(s_k) * exp(-i omega t_k)
    P   = |A|^2 / (2 max(max_k s_k, 1))

in dBm, 10 log10(P / 1e-3), P clamped below at 1e-300; -inf where no capture
lies in the window. No impulse response is formed.

Departures from rfx's arithmetic, each a rounding: rfx computes the bin,
t_k and the phase in float32 (window / (nbins - 1) and 2 pi f each rounded
to float32 once), here they are float64, so a path whose delay lies within a
float32 ulp of a bin's edge may fall in the neighbouring bin, and the phase
(~1,500 rad at 100 ns) carries no float32 error; rfx's 1e-300 clamp rounds to
0 in float32, where an exactly cancelled sum reads -inf dBm, and here it
does not. The sign of the phase does not change |A|.

`dtype` follows the captures: float64 is the reference; bfloat16 is the
control the comparison must reject (its bin is floored in float64 from the
bfloat16 delay, as `trace.histogram` floors it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.reference.trace import first_captures, sphere_t

__all__ = ["phasor_dbm", "receiver_phasor_dbm"]

#: Receiver-ray pairs of one batch of the receivers' sphere test.
_PAIRS = 1 << 27


def phasor_dbm(row, amp, dist, *, rows: int, scale: float, nbins: int, light_speed_mps: float,
               sample_rate_hz: float, sample_window_s: float, carrier_hz: float) -> torch.Tensor:
    """(rows,) float64 dBm of the captures (row, amplitude, path length),
    the sums in amp's dtype (see the module docstring)."""
    dt, dev = amp.dtype, amp.device
    bins = torch.floor((dist / light_speed_mps * sample_rate_hz).double()).long()
    ok = (bins >= 0) & (bins < nbins)
    row, bins, amp = row[ok], bins[ok], amp[ok]
    hi = nbins - 1 - (nbins - 1) // 2
    support = torch.clamp_max(bins + hi + 1, nbins)
    t_k = bins.to(dt) * (sample_window_s / (nbins - 1))
    phase = (2.0 * math.pi * carrier_hz) * t_k
    w = amp * scale * torch.sqrt(support.to(dt))
    re = torch.zeros(rows, dtype=dt, device=dev).index_add_(0, row, w * torch.cos(phase))
    im = torch.zeros(rows, dtype=dt, device=dev).index_add_(0, row, -w * torch.sin(phase))
    s_max = torch.zeros(rows, dtype=torch.int64, device=dev).scatter_reduce_(0, row, support,
                                                                            "amax")
    hit = torch.zeros(rows, dtype=torch.bool, device=dev)
    hit[row] = True
    re, im = re.double(), im.double()
    power = (re * re + im * im) / (2.0 * s_max.clamp_min(1).double())
    dbm = 10.0 * torch.log10(power.clamp_min(1e-300) / 1e-3)
    return torch.where(hit, dbm, torch.full_like(dbm, -math.inf))


def receiver_phasor_dbm(segs: list[dict], centers, radius: float, *, scale: float, nbins: int,
                        light_speed_mps: float, sample_rate_hz: float, sample_window_s: float,
                        carrier_hz: float, batch: int = 64) -> torch.Tensor:
    """(M,) float64 dBm of M analytic receiver spheres from the environment
    trace `segs` (`trace.env_trace`): each receiver's first captures, then
    `phasor_dbm`. At most `batch` receivers, and at most `_PAIRS`
    receiver-ray pairs, go together."""
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    m = centers.shape[0]
    if not segs:
        return torch.full((m,), -math.inf, dtype=torch.float64)
    dev, dt = segs[0]["o"].device, segs[0]["o"].dtype
    batch = max(1, min(batch, _PAIRS // max(1, segs[0]["ray"].numel())))
    out = []
    for s0 in range(0, m, batch):
        c = torch.as_tensor(centers[s0:s0 + batch], device=dev).to(dt)[:, None, :]
        row, _, amp, dist, _ = first_captures(segs, lambda o, d: sphere_t(o, d, c, radius),
                                              c.shape[0])
        out.append(phasor_dbm(row, amp, dist, rows=c.shape[0], scale=scale, nbins=nbins,
                              light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                              sample_window_s=sample_window_s, carrier_hz=carrier_hz))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64, device=dev)
