"""Impulse-response assembly and RX-power metric (port of rfx/cir.py).

`bin_impulse_response` runs the IR histogram kernel
(rfx_torch/csrc/histogram.cu) on a CUDA tensor and its plain version,
`histogram_plain` (a masked `index_add_`), on a CPU tensor. Soft binning is
two hard histograms, the low and the high half, through the same kernel.

Both branches go through one `torch.autograd.Function`, so the IR carries
the same gradient on either device: the backward is plain PyTorch (the
reference's gradient is XLA's autodiff of the binning, not a kernel) and
reads back the bins the forward used. Hard binning is piecewise constant in
the distance; soft binning is linear in it between bin centres.

`rx_power_dbm` is a direct convolution, so exact zeros stay zero: the metric
averages over the nonzero samples only, and an FFT would fill them with
roundoff. `rx_power_dbm_phasor` is the coverage engine's fast metric: the
same power from the paths' phasors, with no impulse response.
"""

from __future__ import annotations

import math

import torch

from rfx_torch.ops._build import CudaKernel, F, I, P

__all__ = ["bin_impulse_response", "cir_from_trace", "histogram_plain",
           "rx_power_dbm", "rx_power_dbm_phasor", "to_dbm", "HISTOGRAM_KERNEL"]

HARD, SOFT_LO, SOFT_HI = 0, 1, 2

HISTOGRAM_KERNEL = CudaKernel(
    "histogram.cu", "rfx_ir_histogram",
    [P, P, P, I, F, F, I, I, I, I, P, P, P],
)

# Pass 1 of the kernel uses at most this many blocks, each over a fixed,
# contiguous range of rays; the grid depends only on the ray count, so the
# summation order (and the result) does not change from run to run or card
# to card.
_MAX_BLOCKS = 256
_MIN_RAYS_PER_BLOCK = 4096


def _check_inputs(amplitude, distance, captured):
    n = amplitude.shape[0]
    if amplitude.dtype != torch.float32 or distance.dtype != torch.float32:
        raise TypeError("amplitude and distance must be float32")
    if captured.dtype != torch.bool:
        raise TypeError("captured must be bool")
    if amplitude.shape != (n,) or distance.shape != (n,) or captured.shape != (n,):
        raise ValueError("amplitude, distance and captured must be (N,) each")
    if not (amplitude.device == distance.device == captured.device):
        raise ValueError("amplitude, distance and captured must be on one device")


def histogram_plain(amplitude, distance, captured, *, nbins: int, light_speed_mps: float,
                    sample_rate_hz: float, mode: int = HARD) -> torch.Tensor:
    """Plain PyTorch version of the histogram kernel: (nbins,) f32. The
    divisors are 0-dim tensors on the data's device, so the bins come from a
    true IEEE division, as in the kernel (a Python-scalar divisor would let
    PyTorch's CUDA path multiply by its reciprocal)."""
    dev = amplitude.device
    c = torch.tensor(light_speed_mps, dtype=torch.float32, device=dev)
    rate = torch.tensor(sample_rate_hz, dtype=torch.float32, device=dev)
    delay = distance / c * rate
    if mode == HARD:
        bins = delay.to(torch.int32)
        w = amplitude
    else:
        lo = torch.floor(delay)
        frac = delay - lo
        bins = lo.to(torch.int32) + (1 if mode == SOFT_HI else 0)
        w = amplitude * frac if mode == SOFT_HI else amplitude * (1.0 - frac)
    valid = captured & (bins >= 0) & (bins < nbins)
    ir = torch.zeros(nbins, dtype=torch.float32, device=dev)
    return ir.index_add_(0, bins[valid].long(), w[valid])


def _launch(amplitude, distance, captured, *, nbins: int, light_speed_mps: float,
            sample_rate_hz: float, mode: int) -> torch.Tensor:
    """One histogram of `mode`: the kernel on a CUDA tensor, the plain
    version on a CPU tensor; no autograd."""
    dev = amplitude.device
    if dev.type == "cpu":
        return histogram_plain(amplitude, distance, captured, nbins=nbins,
                               light_speed_mps=light_speed_mps,
                               sample_rate_hz=sample_rate_hz, mode=mode)
    if dev.type != "cuda":
        raise ValueError(f"no histogram for device {dev}")
    kern = HISTOGRAM_KERNEL
    max_bins = kern.symbol_of("rfx_ir_histogram_max_bins")()
    if nbins > max_bins:
        raise ValueError(f"the histogram kernel holds at most {max_bins} bins in shared "
                         f"memory on this card, got {nbins}")
    amplitude, distance, captured = (t.contiguous() for t in (amplitude, distance, captured))
    n = amplitude.shape[0]
    if n >= 2**31:
        raise ValueError(f"at most 2^31 - 1 paths per launch, got {n}")
    nblocks = max(1, min(_MAX_BLOCKS, -(-n // _MIN_RAYS_PER_BLOCK)))
    rays_per_block = -(-n // nblocks)
    partials = torch.empty((nblocks, nbins), dtype=torch.float32, device=dev)
    out = torch.empty(nbins, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kern.launch(amplitude.data_ptr(), distance.data_ptr(), captured.data_ptr(), n,
                    float(light_speed_mps), float(sample_rate_hz), nbins, mode, nblocks,
                    rays_per_block, partials.data_ptr(), out.data_ptr(), stream)
    return out


class _Histogram(torch.autograd.Function):
    """Sum of the histograms of `modes` ((HARD,) or (SOFT_LO, SOFT_HI)), with
    the gradient of rfx.cir.bin_impulse_response (method="scatter"):

    - hard: g_amp = g[bin] where the path is valid, else 0; g_dist = 0;
    - soft, with delay = distance / c * rate and w = delay - floor(delay):
      g_amp = (1 - w) g[lo] valid_lo + w g[hi] valid_hi,
      g_dist = amp (g[hi] valid_hi - g[lo] valid_lo) rate / c.
    """

    @staticmethod
    def forward(ctx, amplitude, distance, captured, nbins, light_speed_mps, sample_rate_hz,
                modes):
        kw = dict(nbins=nbins, light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz)
        ir = _launch(amplitude, distance, captured, mode=modes[0], **kw)
        for mode in modes[1:]:
            ir = ir + _launch(amplitude, distance, captured, mode=mode, **kw)
        ctx.save_for_backward(amplitude, distance, captured)
        ctx.kw = kw
        ctx.modes = modes
        return ir

    @staticmethod
    def backward(ctx, g):
        amplitude, distance, captured = ctx.saved_tensors
        nbins = ctx.kw["nbins"]
        dev = amplitude.device
        c = torch.tensor(ctx.kw["light_speed_mps"], dtype=torch.float32, device=dev)
        rate = torch.tensor(ctx.kw["sample_rate_hz"], dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        delay = distance / c * rate

        def g_at(bins):
            valid = captured & (bins >= 0) & (bins < nbins)
            return torch.where(valid, g[bins.clamp(0, nbins - 1).long()], zero)

        g_amp = torch.zeros_like(amplitude)
        slope = None  # d(weight)/d(delay) / amplitude, summed over the soft halves
        lo = torch.floor(delay)
        w = delay - lo
        lo_i = lo.to(torch.int32)
        for mode in ctx.modes:
            if mode == HARD:
                g_amp = g_amp + g_at(delay.to(torch.int32))
            elif mode == SOFT_LO:
                g_lo = g_at(lo_i)
                g_amp = g_amp + (1.0 - w) * g_lo
                slope = -g_lo if slope is None else slope - g_lo
            else:
                g_hi = g_at(lo_i + 1)
                g_amp = g_amp + w * g_hi
                slope = g_hi if slope is None else slope + g_hi
        g_dist = (torch.zeros_like(distance) if slope is None
                  else amplitude * slope * rate / c)
        return g_amp, g_dist, None, None, None, None, None


def bin_impulse_response(amplitude, distance, captured, *, nbins: int, light_speed_mps: float,
                         sample_rate_hz: float, soft: bool = False) -> torch.Tensor:
    """Scatter per-path amplitudes into delay bins, (nbins,) f32,
    differentiable in amplitude and distance. Hard mode is the reference's
    bin = int(distance / c * rate), out-of-window paths dropped; soft mode
    splits each amplitude linearly between the two neighbouring bins, so the
    IR has a gradient in the distance.

    A CPU tensor goes to `histogram_plain`; a CUDA tensor launches the
    kernel, which is bit-identical from run to run."""
    _check_inputs(amplitude, distance, captured)
    if nbins < 1:
        raise ValueError("nbins must be at least 1")
    return _Histogram.apply(amplitude, distance, captured, nbins, light_speed_mps,
                            sample_rate_hz, (SOFT_LO, SOFT_HI) if soft else (HARD,))


def cir_from_trace(result, *, tx_power, num_rays: int, nbins: int, light_speed_mps: float,
                   sample_rate_hz: float, soft: bool = False) -> torch.Tensor:
    """TraceResult -> impulse response; a path's amplitude starts at
    tx_power / num_rays (f32) times its Fresnel product."""
    scale = torch.as_tensor(tx_power, dtype=torch.float32).cpu() / num_rays
    amp = result.amplitude * scale.to(result.amplitude.device)
    return bin_impulse_response(amp, result.distance, result.captured, nbins=nbins,
                                light_speed_mps=light_speed_mps,
                                sample_rate_hz=sample_rate_hz, soft=soft)


def to_dbm(power: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(power / 1e-3)


def _carrier(nbins: int, sample_window_s: float, carrier_hz: float, device) -> torch.Tensor:
    """sin(2 pi f t) on the reference's grid t = linspace(0, window, nbins),
    in f32 as rfx's compiled linspace rounds it: t_i = (window / (nbins-1))
    * i, the last sample = window (other groupings move about a quarter of
    the samples by an ulp, which the 2.4 GHz carrier turns into 2.4e-4)."""
    stop = torch.tensor(sample_window_s, dtype=torch.float32, device=device)
    if nbins > 1:
        dt = stop / torch.tensor(nbins - 1, dtype=torch.float32, device=device)
        t = torch.cat([dt * torch.arange(nbins - 1, dtype=torch.float32, device=device),
                       stop[None]])
    else:
        t = torch.zeros(nbins, dtype=torch.float32, device=device)
    return torch.sin(2.0 * math.pi * carrier_hz * t)


# Nonzero IR bins per step of the gathered convolution (rows x nbins values).
_CONV_ROWS = 256


def rx_power_dbm(impulse_response: torch.Tensor, sample_window_s: float,
                 carrier_hz: float = 2.4e9):
    """Reference RX-power metric (ref main.py:46-55): convolve the IR with a
    carrier sine ('same' mode), mean square over the nonzero samples, dBm.

    A direct convolution over the IR's nonzero bins only: each nonzero bin k
    adds ir[k] * carrier[j + lo - k] to output sample j, summed by an
    elementwise product and a sum over a (rows x nbins) gather (no matmul,
    so TF32 cannot apply). Accepts (nbins,) or (M, nbins); returns (dBm,
    convolved signal), with -inf dBm where nothing was received."""
    squeeze = impulse_response.ndim == 1
    ir = impulse_response.reshape(-1, impulse_response.shape[-1]).to(torch.float32)
    m, nbins = ir.shape
    dev = ir.device
    kern = _carrier(nbins, sample_window_s, carrier_hz, dev)
    lo = (nbins - 1) // 2
    j = torch.arange(nbins, device=dev)
    out = torch.zeros((m, nbins), dtype=torch.float32, device=dev)
    for r in range(m):
        nz = torch.nonzero(ir[r]).flatten()
        for s in range(0, nz.shape[0], _CONV_ROWS):
            k = nz[s:s + _CONV_ROWS]
            idx = j[None, :] + lo - k[:, None]
            inside = (idx >= 0) & (idx < nbins)
            taps = torch.where(inside, kern[idx.clamp(0, nbins - 1)], torch.zeros((), device=dev))
            out[r] += (ir[r, k][:, None] * taps).sum(dim=0)
    nzmask = out != 0.0
    count = nzmask.sum(dim=1)
    sq = torch.where(nzmask, out * out, torch.zeros((), device=dev)).sum(dim=1)
    power = torch.where(count > 0, sq / count.clamp_min(1), torch.zeros((), device=dev))
    dbm = torch.where(count > 0, to_dbm(power.clamp_min(1e-300)),
                      torch.full_like(power, -math.inf))
    if squeeze:
        return dbm[0], out[0]
    return dbm, out


def rx_power_dbm_phasor(amplitude, distance, captured, *, sample_window_s: float, nbins: int,
                        light_speed_mps: float, sample_rate_hz: float,
                        carrier_hz: float = 2.4e9, return_cancellation: bool = False):
    """RX power without the impulse response (rfx/cir.py:204-274), reduced
    over the last axis of (..., K) paths: the carrier-convolved IR is one
    sinusoid, so its mean square is |A|^2 / 2 with A = sum_k amp_k sqrt(s_k)
    e^{-i w t_k}, s_k the 'same'-mode support of bin k, normalised by the
    largest support. Returns dBm (-inf where nothing was captured) or, with
    `return_cancellation`, (dBm, coherent / incoherent power ratio, power-
    weighted delay spread in s), the hybrid metric's two trust diagnostics.

    Rounded as the reference rounds: the bin is distance / c * rate with
    0-dim f32 divisors; window / (nbins - 1) and 2 pi f are Python-float
    quotient and product, each rounded to f32 once, then multiplied with the
    f32 tensors (the phase reaches ~1,500 rad at 100 ns, so every rounding
    shows)."""
    dev = amplitude.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    c = torch.tensor(light_speed_mps, dtype=f32, device=dev)
    rate = torch.tensor(sample_rate_hz, dtype=f32, device=dev)
    delay_bins = (distance / c * rate).to(torch.int32)
    valid = captured & (delay_bins >= 0) & (delay_bins < nbins)
    amp = torch.where(valid, amplitude, zero)
    t_k = delay_bins.to(f32) * torch.tensor(sample_window_s / (nbins - 1), dtype=f32, device=dev)
    phase = torch.tensor(2.0 * math.pi * carrier_hz, dtype=f32, device=dev) * t_k
    hi = nbins - 1 - (nbins - 1) // 2
    s_k = torch.where(valid, torch.clamp_max(delay_bins + hi + 1, nbins).to(f32), zero)
    w_k = torch.sqrt(s_k)
    a_re = torch.sum(amp * w_k * torch.cos(phase), dim=-1)
    a_im = torch.sum(amp * w_k * torch.sin(phase), dim=-1)
    if s_k.shape[-1]:
        n_nz = torch.clamp_min(torch.amax(s_k, dim=-1), 1.0)
    else:
        n_nz = torch.ones(s_k.shape[:-1], dtype=f32, device=dev)
    coherent = a_re * a_re + a_im * a_im
    power = 0.5 * coherent / n_nz
    any_hit = valid.any(dim=-1)
    dbm = torch.where(any_hit, to_dbm(torch.clamp_min(power, 1e-300)),
                      torch.full_like(power, -math.inf))
    if not return_cancellation:
        return dbm
    # 1e-300 rounds to 0 in f32, as in the reference: a receiver with no
    # path gives 0 / 0 here and takes the where's other branch.
    aw = amp * w_k
    wgt = aw * aw
    incoherent = torch.sum(wgt, dim=-1)
    ratio = torch.where(any_hit, coherent / torch.clamp_min(incoherent, 1e-300),
                        torch.ones_like(coherent))
    wsum = torch.clamp_min(torch.sum(wgt, dim=-1), 1e-300)
    t_mean = torch.sum(wgt * t_k, dim=-1) / wsum
    dt = t_k - t_mean[..., None]
    spread = torch.sqrt(torch.clamp_min(torch.sum(wgt * (dt * dt), dim=-1) / wsum, 0.0))
    spread = torch.where(any_hit, spread, torch.zeros_like(spread))
    return dbm, ratio, spread
