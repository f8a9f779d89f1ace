"""Impulse-response assembly and RX-power metric (port of rfx/cir.py).

`bin_impulse_response` bins one row of paths, `(n,)`, or a batch of rows,
`(R, n)`, in one call: the IR histogram kernel (rfx_torch/csrc/histogram.cu)
on a CUDA tensor, one launch whatever R, and its plain version,
`histogram_plain` (an `index_add_` over the captured paths), on a CPU
tensor. Soft binning is two hard histograms, the low and the high half: two
planes of the same launch, added afterwards. `histogram_record` is the
kernel's other entry, for the map engine: it bins a first-capture record
(rfx_torch.ops.map_capture) with the segments it indexes, the dense rows'
bits without the dense rows.

Both branches go through one `torch.autograd.Function`, so the IR carries
the same gradient on either device: the backward is plain PyTorch (the
reference's gradient is XLA's autodiff of the binning, not a kernel). It
works on the list of captured paths that the forward saved and writes their
gradients into zeros, so its temporaries have the size of the captures, not
of the inputs. Hard binning is piecewise constant in the distance; soft
binning is linear in it between bin centres.

`rx_power_dbm` is a direct convolution over each IR's nonzero bins, so exact
zeros stay zero: the metric averages over the nonzero samples only, and an
FFT would fill them with roundoff. Where a gradient is wanted, both devices
go through one `torch.autograd.Function` (without one, its forward alone
runs). On a CUDA tensor the forward launches the RX-power kernel
(rfx_torch/csrc/rx_power.cu), one call whatever the rows, the dBm and each
row's count and sum of squares included, on a carrier made once per size
(`carrier_cached`), and the backward launches its backward kernel
(`rx_power_backward`); on a CPU tensor the forward is its plain version's
(`rx_power_dbm_plain`) and the backward `rx_power_backward_plain`. The
gradient is jax.grad's of rfx.cir.rx_power_dbm: the transposed 'same'
convolution, dense in the bins. `rx_power_dbm_phasor` is the coverage
engine's fast metric: the same power from the paths' phasors, with no
impulse response.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rfx_torch.ops._build import CudaKernel, F, I, P
from rfx_torch.tracer import icosphere_tris

__all__ = ["bin_impulse_response", "carrier_cached", "cir_from_trace", "convolve_carrier_plain",
           "histogram_plain", "histogram_record", "histogram_rows", "mask_tiles", "phasor_metric",
           "rx_power_backward", "rx_power_backward_plain", "rx_power_dbm", "rx_power_dbm_phasor",
           "rx_power_dbm_plain", "to_dbm", "HISTOGRAM_KERNEL", "HISTOGRAM_RECORD_ICO_KERNEL",
           "HISTOGRAM_RECORD_KERNEL",
           "RX_POWER_BACKWARD_KERNEL", "RX_POWER_KERNEL"]

HARD, SOFT_LO, SOFT_HI = 0, 1, 2

HISTOGRAM_KERNEL = CudaKernel(
    "histogram.cu", "rfx_ir_histogram",
    [P, P, P, I, I, F, F, I, I, I, P, P, P, ctypes.c_longlong, P],
)
# The record entry: the map engine's first-capture record binned with the
# segments it indexes (rfx_torch.ops.map_capture.map_irs).
HISTOGRAM_RECORD_KERNEL = CudaKernel(
    "histogram.cu", "rfx_ir_histogram_record",
    [P, I, I, I, P, P, P, P, P, F, F, F, F, I, I, I, P, P, P, ctypes.c_longlong, P],
)
# Its instantiation for the icosphere receiver's record: t_rx recomputed as
# the closest hit over each receiver's 80 faces.
HISTOGRAM_RECORD_ICO_KERNEL = CudaKernel(
    "histogram.cu", "rfx_ir_histogram_record_ico",
    [P, I, I, I, P, P, P, P, P, P, F, F, F, I, I, I, P, P, P, ctypes.c_longlong, P],
)
RX_POWER_KERNEL = CudaKernel("rx_power.cu", "rfx_rx_power", [P, P, I, I, P, P, P, P, P, P])
RX_POWER_BACKWARD_KERNEL = CudaKernel("rx_power.cu", "rfx_rx_power_backward",
                                      [P, P, P, P, P, I, I, P, P, P, P, P])

# The kernel's constants (csrc/histogram.cu): a warp counts a tile of 128
# 16-byte words of mask; a block sorts a chunk of 2,048 captures.
_TILE_WORDS = 128
_CHUNK = 2048
_CTRL_INTS = 4


def mask_tiles(n: int) -> int:
    """Tiles a row of n mask bytes can span: its first 16-byte word may start
    up to 15 bytes before the row."""
    return -(-((n + 30) // 16) // _TILE_WORDS)


def _check_inputs(amplitude, distance, captured):
    if amplitude.dtype != torch.float32 or distance.dtype != torch.float32:
        raise TypeError("amplitude and distance must be float32")
    if captured.dtype != torch.bool:
        raise TypeError("captured must be bool")
    if amplitude.ndim not in (1, 2) or not (amplitude.shape == distance.shape == captured.shape):
        raise ValueError("amplitude, distance and captured must be (N,) or (R, N) each")
    if not (amplitude.device == distance.device == captured.device):
        raise ValueError("amplitude, distance and captured must be on one device")


def _rows(t: torch.Tensor) -> int:
    return 1 if t.ndim == 1 else t.shape[0]


def _capture_list(captured: torch.Tensor) -> torch.Tensor:
    """Flat indices of the captured paths, in row-major (ray) order."""
    return captured.reshape(-1).nonzero().squeeze(1)


def _plain_from_list(amplitude, distance, flat, *, nbins: int, light_speed_mps: float,
                     sample_rate_hz: float, mode: int) -> torch.Tensor:
    """`histogram_plain` given the capture list `flat`."""
    dev = amplitude.device
    rows, n = _rows(amplitude), amplitude.shape[-1]
    c = torch.tensor(light_speed_mps, dtype=torch.float32, device=dev)
    rate = torch.tensor(sample_rate_hz, dtype=torch.float32, device=dev)
    delay = distance.reshape(-1)[flat] / c * rate
    w = amplitude.reshape(-1)[flat]
    if mode == HARD:
        bins = delay.to(torch.int32)
    else:
        lo = torch.floor(delay)
        frac = delay - lo
        bins = lo.to(torch.int32) + (1 if mode == SOFT_HI else 0)
        w = w * frac if mode == SOFT_HI else w * (1.0 - frac)
    valid = (bins >= 0) & (bins < nbins)
    row = torch.div(flat, max(n, 1), rounding_mode="floor")
    ir = torch.zeros(rows * nbins, dtype=torch.float32, device=dev)
    ir.index_add_(0, (row * nbins + bins)[valid], w[valid])
    return ir.reshape(nbins) if amplitude.ndim == 1 else ir.reshape(rows, nbins)


def histogram_plain(amplitude, distance, captured, *, nbins: int, light_speed_mps: float,
                    sample_rate_hz: float, mode: int = HARD) -> torch.Tensor:
    """Plain PyTorch version of the histogram kernel: (nbins,) f32 of (N,)
    inputs, (R, nbins) of (R, N). The divisors are 0-dim tensors on the
    data's device, so the bins come from a true IEEE division, as in the
    kernel (a Python-scalar divisor would let PyTorch's CUDA path multiply
    by its reciprocal). Only the captured paths are gathered and binned."""
    return _plain_from_list(amplitude, distance, _capture_list(captured), nbins=nbins,
                            light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                            mode=mode)


def _launch_on(kernel: CudaKernel, dev: torch.device, args: tuple):
    """Launch `kernel` with `args` on `dev`'s current stream."""
    if torch.cuda.current_device() == dev.index:  # spare a single-row call the context's host time
        kernel.launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            kernel.launch(*args, torch.cuda.current_stream(dev).cuda_stream)


def _histogram_buffer(rows: int, nbins: int, planes: int, tiles: int, dev) -> tuple:
    """One buffer for a launch of either entry over `rows` rows of `tiles`
    tiles each: the histograms, behind them the kernel's counters (one
    memset zeroes both), then its scratch (tile counts, offsets, the rows'
    chunk counts, and before them 4 uint16 slots a tile), all 4-byte words.
    Returns (buffer, the kernel's pointer arguments (scratch, out, ctrl,
    bytes to zero), the plane's size)."""
    n_plane = rows * nbins
    n_out = planes * n_plane
    n_zero = n_out + _CTRL_INTS + planes * rows
    n_zero += n_zero & 1  # the scratch starts on 8 bytes
    buf = torch.empty(n_zero + rows * (4 * tiles + 2) + 1, dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    return buf, (ptr + 4 * n_zero, ptr, ptr + 4 * n_out, 4 * n_zero), n_plane


def _check_launch(rows: int, row_len: int, tiles: int, nbins: int, planes: int):
    if row_len > 2**31 - 64 or nbins >= 2**31 - 1:
        raise ValueError(f"at most 2^31 - 64 paths a row and 2^31 - 2 bins, got {row_len} and {nbins}")
    if planes * rows * -(-row_len // _CHUNK) >= 2**31 or rows * (tiles + 1) >= 2**31:
        raise ValueError(f"too many paths for one launch: {rows} rows of {row_len}")


def _launch(amplitude, distance, captured, *, nbins: int, light_speed_mps: float,
            sample_rate_hz: float, soft: bool) -> list:
    """One launch of the kernel on (N,) or (R, N) CUDA tensors, R, N > 0: the
    histograms, (nbins,) or (R, nbins) each, one in hard mode, the low and
    the high half in soft mode; no autograd."""
    dev = amplitude.device
    if dev.type != "cuda":
        raise ValueError(f"no histogram kernel for device {dev}")
    amplitude, distance, captured = amplitude.contiguous(), distance.contiguous(), captured.contiguous()
    rows, n = _rows(amplitude), amplitude.shape[-1]
    planes = 2 if soft else 1
    tmax = mask_tiles(n)
    _check_launch(rows, n, tmax, nbins, planes)
    buf, (scratch, out, ctrl, zero), n_plane = _histogram_buffer(rows, nbins, planes, tmax, dev)
    _launch_on(HISTOGRAM_KERNEL, dev, (
        amplitude.data_ptr(), distance.data_ptr(), captured.data_ptr(), n, rows,
        float(light_speed_mps), float(sample_rate_hz), nbins, int(soft), tmax, scratch, out, ctrl,
        zero))
    shape = amplitude.shape[:-1] + (nbins,)
    return [buf.narrow(0, h * n_plane, n_plane).view(shape) for h in range(planes)]


def histogram_record(record: torch.Tensor, segments, centers: torch.Tensor, radius: float,
                     scale: float, *, nbins: int, light_speed_mps: float, sample_rate_hz: float,
                     soft: bool, rx_mode: str = "analytic", tris=None) -> torch.Tensor:
    """(R, nbins) IRs of the map engine's first-capture record (R, N) uint8
    (0xFF: no capture, else the bounce of the receiver's first capture
    along the ray) on CUDA tensors, one launch of the record entry, hard or
    soft (the low and the high half added); no autograd. `segments` is the
    env trace's (origin, direction, t_env, amplitude, distance, alive), its
    B <= 254 bounces of N rays; `centers` (R, 3) f32. Row r bins the list
    `histogram_rows` bins from the map engine's dense rows of r: amplitude
    * scale and distance + t_rx at each capture, in (b, n) order, t_rx the
    capture pass's; so the IRs are those rows' bits. rx_mode 'icosphere':
    the record of the icosphere receivers whose (R, 80, 9) faces are `tris`
    (rfx_torch.tracer.icosphere_tris of centers and radius, computed here
    where None), one launch of the record entry's icosphere instantiation."""
    dev = record.device
    if dev.type != "cuda":
        raise ValueError(f"no histogram record kernel for device {dev}")
    origin, direction, _, amplitude, distance, _ = (t.detach().contiguous() for t in segments)
    b, n = amplitude.shape
    rows = record.shape[0]
    if record.dtype != torch.uint8 or tuple(record.shape) != (rows, n):
        raise ValueError(f"record must be ({rows}, {n}) uint8, got {tuple(record.shape)} "
                         f"{record.dtype}")
    if b > 254:
        raise ValueError(f"the record holds at most 254 bounces, got {b}")
    if rows == 0 or n == 0 or b == 0:
        return torch.zeros((rows, nbins), dtype=torch.float32, device=dev)
    planes = 2 if soft else 1
    tmax = mask_tiles(n)
    _check_launch(rows, b * n, b * tmax, nbins, planes)
    centers = centers.detach().to(torch.float32).contiguous()
    record = record.contiguous()
    buf, (scratch, out, ctrl, zero), n_plane = _histogram_buffer(rows, nbins, planes, b * tmax, dev)
    head = (record.data_ptr(), n, rows, b, origin.data_ptr(), direction.data_ptr(),
            amplitude.data_ptr(), distance.data_ptr(), centers.data_ptr())
    tail = (float(scale), float(light_speed_mps), float(sample_rate_hz), nbins, int(soft), tmax,
            scratch, out, ctrl, zero)
    if rx_mode == "analytic":
        _launch_on(HISTOGRAM_RECORD_KERNEL, dev, (*head, float(radius), *tail))
    elif rx_mode == "icosphere":
        if tris is None:
            tris = icosphere_tris(centers, float(radius))
        if tris.shape != (rows, 80, 9) or tris.dtype != torch.float32:
            raise ValueError(f"tris must be ({rows}, 80, 9) float32, got {tuple(tris.shape)}")
        tris = tris.detach().contiguous()
        _launch_on(HISTOGRAM_RECORD_ICO_KERNEL, dev, (*head, tris.data_ptr(), *tail))
    else:
        raise ValueError(f"unknown rx_mode: {rx_mode}")
    halves = [buf.narrow(0, h * n_plane, n_plane).view(rows, nbins) for h in range(planes)]
    return halves[0] + halves[1] if soft else halves[0]


def histogram_rows(amplitude, distance, captured, *, nbins: int, light_speed_mps: float,
                   sample_rate_hz: float, soft: bool, flat=None) -> torch.Tensor:
    """The histogram of (N,) or (R, N) paths without autograd, hard or soft
    (the low and the high half added): `histogram_plain` on a CPU tensor
    (given the capture list `flat` where the caller has it), one launch of
    the kernel on a CUDA tensor."""
    kw = dict(nbins=nbins, light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz)
    dev = amplitude.device
    if dev.type == "cpu":
        flat = _capture_list(captured) if flat is None else flat
        modes = (SOFT_LO, SOFT_HI) if soft else (HARD,)
        halves = [_plain_from_list(amplitude, distance, flat, mode=m, **kw) for m in modes]
    elif _rows(amplitude) * amplitude.shape[-1] == 0:
        halves = [torch.zeros(amplitude.shape[:-1] + (nbins,), dtype=torch.float32, device=dev)]
    else:
        halves = _launch(amplitude, distance, captured, soft=soft, **kw)
    return halves[0] + halves[1] if len(halves) == 2 else halves[0]


class _Histogram(torch.autograd.Function):
    """The histogram of (N,) or (R, N) paths, hard or soft (the sum of the
    low and the high half), with the gradient of rfx.cir.bin_impulse_response
    (method="scatter"):

    - hard: g_amp = g[bin] where the path is valid, else 0; g_dist = 0;
    - soft, with delay = distance / c * rate and w = delay - floor(delay):
      g_amp = (1 - w) g[lo] valid_lo + w g[hi] valid_hi,
      g_dist = amp (g[hi] valid_hi - g[lo] valid_lo) rate / c.
    """

    @staticmethod
    def forward(ctx, amplitude, distance, captured, nbins, light_speed_mps, sample_rate_hz,
                soft):
        kw = dict(nbins=nbins, light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz)
        needs_grad = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        flat = _capture_list(captured) if needs_grad or amplitude.device.type == "cpu" else None
        if needs_grad:
            ctx.save_for_backward(amplitude, distance, flat)
        ctx.kw = kw
        ctx.soft = soft
        return histogram_rows(amplitude, distance, captured, soft=soft, flat=flat, **kw)

    @staticmethod
    def backward(ctx, g):
        amplitude, distance, flat = ctx.saved_tensors
        nbins = ctx.kw["nbins"]
        dev = amplitude.device
        n = amplitude.shape[-1]
        c = torch.tensor(ctx.kw["light_speed_mps"], dtype=torch.float32, device=dev)
        rate = torch.tensor(ctx.kw["sample_rate_hz"], dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        # Everything below has one entry per captured path.
        amp = amplitude.reshape(-1)[flat]
        delay = distance.reshape(-1)[flat] / c * rate
        first_bin = torch.div(flat, max(n, 1), rounding_mode="floor") * nbins
        g_bins = g.reshape(-1)

        def g_at(bins):
            valid = (bins >= 0) & (bins < nbins)
            return torch.where(valid, g_bins[first_bin + bins.clamp(0, nbins - 1)], zero)

        def scattered(values):
            out = torch.zeros(amplitude.shape, dtype=torch.float32, device=dev)
            out.reshape(-1)[flat] = values
            return out

        if not ctx.soft:
            g_amp = g_at(delay.to(torch.int32))
            g_dist = None
        else:
            lo = torch.floor(delay)
            w = delay - lo
            lo_i = lo.to(torch.int32)
            g_lo, g_hi = g_at(lo_i), g_at(lo_i + 1)
            g_amp = (1.0 - w) * g_lo + w * g_hi
            g_dist = amp * (g_hi - g_lo) * rate / c
        return (scattered(g_amp) if ctx.needs_input_grad[0] else None,
                None if not ctx.needs_input_grad[1]
                else torch.zeros_like(distance) if g_dist is None else scattered(g_dist),
                None, None, None, None, None)


def bin_impulse_response(amplitude, distance, captured, *, nbins: int, light_speed_mps: float,
                         sample_rate_hz: float, soft: bool = False) -> torch.Tensor:
    """Scatter per-path amplitudes into delay bins, differentiable in
    amplitude and distance: (nbins,) f32 of (N,) inputs, or (R, nbins) of
    (R, N) inputs, each row binned on its own. Hard mode is the reference's
    bin = int(distance / c * rate), out-of-window paths dropped; soft mode
    splits each amplitude linearly between the two neighbouring bins, so the
    IR has a gradient in the distance.

    A CPU tensor goes to `histogram_plain`; a CUDA tensor launches the
    kernel, once for all rows and both soft halves. The kernel's result is
    bit-identical from run to run, and a row's IR is the same bits alone or
    in a batch."""
    _check_inputs(amplitude, distance, captured)
    if nbins < 1:
        raise ValueError("nbins must be at least 1")
    return _Histogram.apply(amplitude, distance, captured, nbins, light_speed_mps,
                            sample_rate_hz, bool(soft))


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


@functools.lru_cache(maxsize=16)
def carrier_cached(nbins: int, sample_window_s: float, carrier_hz: float,
                   device: torch.device) -> torch.Tensor:
    """`_carrier`'s tensor, made once per (nbins, window, carrier, device):
    the RX-power kernel reads it on every call, and making it is a handful
    of launches. Callers must not write to it."""
    return _carrier(nbins, sample_window_s, carrier_hz, device)


# Nonzero IR bins per step of the gathered convolution (rows x nbins values).
_CONV_ROWS = 256
# The RX-power kernel's bins a segment of the nonzero list (kSeg of
# csrc/rx_power.cu), and the bound on its bins (ceil(nbins / 256) <= 65535).
_POWER_SEGMENT = 1024
_POWER_TILE = 256


def _gathered_taps(x: torch.Tensor, kern: torch.Tensor, reflect: bool) -> torch.Tensor:
    """Rows of sum_p x[r, p] * kern[i + lo - p] (reflect=False: the 'same'
    convolution) or sum_p x[r, p] * kern[p + lo - i] (reflect=True: its
    adjoint), over each row's nonzero p with the kernel index in range: an
    elementwise product and a sum over a (rows x nbins) gather per step of
    _CONV_ROWS nonzero p (no matmul, so TF32 cannot apply)."""
    m, nbins = x.shape
    dev = x.device
    lo = (nbins - 1) // 2
    i = torch.arange(nbins, device=dev)
    out = torch.zeros((m, nbins), dtype=x.dtype, device=dev)
    for r in range(m):
        nz = torch.nonzero(x[r]).flatten()
        for s in range(0, nz.shape[0], _CONV_ROWS):
            p = nz[s:s + _CONV_ROWS]
            idx = p[:, None] + lo - i[None, :] if reflect else i[None, :] + lo - p[:, None]
            inside = (idx >= 0) & (idx < nbins)
            taps = torch.where(inside, kern[idx.clamp(0, nbins - 1)],
                               torch.zeros((), dtype=kern.dtype, device=dev))
            out[r] += (x[r, p][:, None] * taps).sum(dim=0)
    return out


class _ConvolveCarrier(torch.autograd.Function):
    """`convolve_carrier_plain` with the gradient of a dense convolution, as
    rfx.cir.rx_power_dbm's lax.conv has it: d out[j] / d ir[k] = carrier[j +
    lo - k] for every bin k, zero or not (the forward skips the zero bins,
    so autograd through it would give them none). The adjoint runs in float64."""

    @staticmethod
    def forward(ctx, ir, kern):
        ctx.save_for_backward(kern)
        return _gathered_taps(ir, kern, reflect=False)

    @staticmethod
    def backward(ctx, g):
        (kern,) = ctx.saved_tensors
        g_ir = _gathered_taps(g.double(), kern.double(), reflect=True).to(g.dtype)
        return g_ir, None


def convolve_carrier_plain(ir: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the RX-power kernel's convolution: (M, nbins)
    f32 rows, out[r, j] = sum_k ir[r, k] * kern[j + lo - k] over the row's
    nonzero bins k, lo = (nbins - 1) // 2; differentiable in `ir`."""
    return _ConvolveCarrier.apply(ir, kern)


def _power_sums_plain(out: torch.Tensor):
    """(count, sum of squares) of each row's nonzero samples."""
    nzmask = out != 0.0
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    return nzmask.sum(dim=1), torch.where(nzmask, out * out, zero).sum(dim=1)


def _dbm_of_sums(count: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """Mean square over the nonzero samples in dBm, -inf where there is none."""
    zero = torch.zeros((), dtype=sq.dtype, device=sq.device)
    power = torch.where(count > 0, sq / count.clamp_min(1), zero)
    return torch.where(count > 0, to_dbm(power.clamp_min(1e-300)),
                       torch.full_like(power, -math.inf))


def _rows_of(impulse_response: torch.Tensor) -> torch.Tensor:
    return impulse_response.reshape(-1, impulse_response.shape[-1]).to(torch.float32)


def rx_power_dbm_plain(impulse_response: torch.Tensor, sample_window_s: float,
                       carrier_hz: float = 2.4e9):
    """Plain PyTorch version of `rx_power_dbm`, on either device and
    differentiable in the IR: (dBm, convolved signal) of (nbins,) or
    (M, nbins) IRs, the convolution by `convolve_carrier_plain`."""
    ir = _rows_of(impulse_response)
    out = convolve_carrier_plain(ir, _carrier(ir.shape[1], sample_window_s, carrier_hz, ir.device))
    dbm = _dbm_of_sums(*_power_sums_plain(out))
    if impulse_response.ndim == 1:
        return dbm[0], out[0]
    return dbm, out


def _power_scratch(m: int, nbins: int, dev) -> torch.Tensor:
    """The RX-power kernel's scratch: each row's (k, value) pairs, two words
    a bin, and the segments' counts."""
    return torch.empty(2 * m * nbins + m * -(-nbins // _POWER_SEGMENT), dtype=torch.int32,
                       device=dev)


def _check_power_launch(m: int, nbins: int):
    if -(-nbins // _POWER_TILE) > 65535:
        raise ValueError(f"at most {65535 * _POWER_TILE} bins, got {nbins}")
    if m * -(-nbins // 128) >= 2**31:  # the blocks of the narrowest tiling
        raise ValueError(f"too many rows for one launch: {m} of {nbins} bins")


def _rx_power_launch(ir: torch.Tensor, kern: torch.Tensor):
    """One launch sequence of the RX-power kernel on (M, nbins) CUDA rows:
    (out, dBm, (M, 2) sums: each row's sum of squares and count of nonzero
    samples); no autograd."""
    dev = ir.device
    m, nbins = ir.shape
    if m == 0 or nbins == 0:
        return (torch.zeros((m, nbins), dtype=torch.float32, device=dev),
                torch.full((m,), -math.inf, dtype=torch.float32, device=dev),
                torch.zeros((m, 2), dtype=torch.float32, device=dev))
    _check_power_launch(m, nbins)
    ir = ir.contiguous()
    # The signal, the dBm and the sums (on 8 bytes) in one buffer; the
    # kernel's scratch in another, so that a kept signal does not keep it.
    at_sums = m * nbins + m + ((m * nbins + m) & 1)
    res = torch.empty(at_sums + 2 * m, dtype=torch.float32, device=dev)
    scratch = _power_scratch(m, nbins, dev)
    ptr, sp = res.data_ptr(), scratch.data_ptr()
    _launch_on(RX_POWER_KERNEL, dev, (ir.data_ptr(), kern.data_ptr(), m, nbins, ptr,
                                      ptr + 4 * m * nbins, ptr + 4 * at_sums, sp,
                                      sp + 8 * m * nbins))
    return (res[:m * nbins].view(m, nbins), res[m * nbins:m * nbins + m],
            res[at_sums:].view(m, 2))


# 20 / ln 10: d dBm / d sum of squares, times the sum of squares, over 1/2.
_DB_PER_POWER = 20.0 / math.log(10.0)


def _effective_cotangent(g_dbm, g_signal, signal: torch.Tensor, sums: torch.Tensor):
    """g_eff of the backward, f32 (M, nbins): g_signal + g_dbm (20 / ln 10) /
    sq * signal, the second term only where the row has a nonzero sample,
    g_dbm != 0 and the sample is nonzero (a zero cotangent is skipped, not
    multiplied: jax.grad prunes it). The kernel forms the same f32
    expressions."""
    zero = torch.zeros((), dtype=torch.float32, device=signal.device)
    g_eff = (torch.zeros_like(signal) if g_signal is None
             else g_signal.to(torch.float32).expand_as(signal))
    if g_dbm is not None:
        g = g_dbm.to(torch.float32).reshape(-1)
        k = torch.tensor(_DB_PER_POWER, dtype=torch.float32, device=signal.device)
        scale = torch.where((g != 0) & (sums[:, 1] > 0), g * k / sums[:, 0], zero)
        term = torch.where((scale[:, None] != 0) & (signal != 0), scale[:, None] * signal, zero)
        g_eff = g_eff + term
    return g_eff


def rx_power_backward_plain(g_dbm, g_signal, signal: torch.Tensor, sums: torch.Tensor,
                            kern: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the RX-power backward kernel, on either
    device: g_ir (M, nbins) f32 from the cotangents g_dbm (M,) and g_signal
    (M, nbins), either None for none, the forward's signal (M, nbins) and sums
    (M, 2) (sum of squares, count) and the carrier. g_ir[r, k] = sum_j
    g_eff[r, j] carrier[j + lo - k] (`_effective_cotangent`), the 'same'
    convolution's adjoint, dense in k, summed in float64."""
    g_eff = _effective_cotangent(g_dbm, g_signal, signal, sums)
    return _gathered_taps(g_eff.double(), kern.double(), reflect=True).to(torch.float32)


@functools.lru_cache(maxsize=16)
def _reversed_carrier_cached(nbins: int, sample_window_s: float, carrier_hz: float,
                             device: torch.device) -> torch.Tensor:
    """The carrier back to front, made once per key: the backward kernel's
    convolution runs the forward's on it (rfx_torch/csrc/rx_power.cu)."""
    return carrier_cached(nbins, sample_window_s, carrier_hz, device).flip(0).contiguous()


# The backward kernel's tiling (csrc/rx_power.cu): a block takes 8 rows (1
# where there are fewer) and 512 outputs; a launch of fewer blocks than
# _BACK_SPLIT_BELOW (four an SM of an H100) is split over the 1,024-bin
# segments, where the partials take at most _BACK_PARTIALS_BYTES.
_BACK_ROWS = 8
_BACK_TILE = 512
_BACK_SPLIT_BELOW = 4 * 132
_BACK_PARTIALS_BYTES = 256 << 20


def _backward_partials(m: int, nbins: int) -> int:
    """Floats of the backward's split partials for (m, nbins), 0 where the
    launch is not split."""
    rows = _BACK_ROWS if m >= _BACK_ROWS else 1
    tiles = -(-nbins // _BACK_TILE)
    n = m * -(-nbins // _POWER_SEGMENT) * tiles * _BACK_TILE
    return n if -(-m // rows) * tiles < _BACK_SPLIT_BELOW and 4 * n <= _BACK_PARTIALS_BYTES else 0


def _rx_power_backward_launch(g_dbm, g_signal, signal: torch.Tensor, sums: torch.Tensor,
                              reversed_carrier: torch.Tensor) -> torch.Tensor:
    """One launch sequence of the backward kernel on CUDA tensors: g_ir."""
    dev = signal.device
    m, nbins = signal.shape
    if m == 0 or nbins == 0 or (g_dbm is None and g_signal is None):
        return torch.zeros((m, nbins), dtype=torch.float32, device=dev)
    _check_power_launch(m, nbins)
    # Kept referenced until the launch is enqueued.
    g_dbm = None if g_dbm is None else g_dbm.to(torch.float32).reshape(m).contiguous()
    g_signal = None if g_signal is None else g_signal.to(torch.float32).expand(m, nbins).contiguous()
    signal, sums = signal.contiguous(), sums.contiguous()
    g_ir = torch.empty((m, nbins), dtype=torch.float32, device=dev)
    # Scratch: g_eff padded to whole segments, the segments' flags, and the
    # partials (on 16 bytes) of a split launch.
    n_seg = -(-nbins // _POWER_SEGMENT)
    n_flags = -(-m * n_seg // 4) * 4
    split = _backward_partials(m, nbins)
    scratch = torch.empty(m * n_seg * _POWER_SEGMENT + n_flags + split, dtype=torch.float32,
                          device=dev)
    sp = scratch.data_ptr()
    at_flags = sp + 4 * m * n_seg * _POWER_SEGMENT
    _launch_on(RX_POWER_BACKWARD_KERNEL, dev, (
        None if g_dbm is None else g_dbm.data_ptr(),
        None if g_signal is None else g_signal.data_ptr(), signal.data_ptr(), sums.data_ptr(),
        reversed_carrier.data_ptr(), m, nbins, g_ir.data_ptr(), sp, at_flags,
        at_flags + 4 * n_flags if split else None))
    return g_ir


def rx_power_backward(g_dbm, g_signal, signal: torch.Tensor, sums: torch.Tensor,
                      sample_window_s: float, carrier_hz: float = 2.4e9) -> torch.Tensor:
    """The gradient of `rx_power_dbm` in the (M, nbins) IRs, from the
    cotangents of its dBm (M,) and signal (M, nbins) (either None) and what
    its forward kept: the signal and the (M, 2) sums. A CUDA tensor launches
    the backward kernel, once for all rows (the same bits from run to run,
    and a row's the same alone or in a batch); a CPU tensor runs
    `rx_power_backward_plain`."""
    dev = signal.device
    kern = carrier_cached(signal.shape[1], sample_window_s, carrier_hz, dev)
    if dev.type == "cpu":
        return rx_power_backward_plain(g_dbm, g_signal, signal, sums, kern)
    if dev.type != "cuda":
        raise ValueError(f"no RX-power backward kernel for device {dev}")
    return _rx_power_backward_launch(
        g_dbm, g_signal, signal, sums,
        _reversed_carrier_cached(signal.shape[1], sample_window_s, carrier_hz, dev))


def _rx_power_forward(ir: torch.Tensor, sample_window_s: float, carrier_hz: float):
    """(signal, dBm, (M, 2) sums) of (M, nbins) IRs, no autograd: the kernel
    on a CUDA tensor, the plain version's arithmetic on a CPU tensor."""
    dev = ir.device
    if dev.type == "cpu":
        out = _gathered_taps(ir, _carrier(ir.shape[1], sample_window_s, carrier_hz, dev),
                             reflect=False)
        count, sq = _power_sums_plain(out)
        return out, _dbm_of_sums(count, sq), torch.stack([sq, count.to(sq.dtype)], dim=1)
    return _rx_power_launch(ir, carrier_cached(ir.shape[1], sample_window_s, carrier_hz, dev))


class _RxPower(torch.autograd.Function):
    """(dBm, signal) of (M, nbins) IRs, with the gradient of
    rfx.cir.rx_power_dbm: the RX-power kernel and its backward on a CUDA
    tensor, the plain versions on a CPU tensor. The forward keeps the signal
    and each row's sum of squares and count (never re-derived from the dBm)."""

    @staticmethod
    def forward(ctx, ir, sample_window_s, carrier_hz):
        ctx.set_materialize_grads(False)
        out, dbm, sums = _rx_power_forward(ir, sample_window_s, carrier_hz)
        ctx.save_for_backward(out, sums)
        ctx.window, ctx.carrier_hz = sample_window_s, carrier_hz
        return dbm, out

    @staticmethod
    def backward(ctx, g_dbm, g_out):
        out, sums = ctx.saved_tensors
        if g_dbm is None and g_out is None:
            return None, None, None
        return rx_power_backward(g_dbm, g_out, out, sums, ctx.window, ctx.carrier_hz), None, None


def rx_power_dbm(impulse_response: torch.Tensor, sample_window_s: float,
                 carrier_hz: float = 2.4e9):
    """Reference RX-power metric (ref main.py:46-55): convolve the IR with a
    carrier sine ('same' mode), mean square over the nonzero samples, dBm.
    Accepts (nbins,) or (M, nbins); returns (dBm, convolved signal), with
    -inf dBm where nothing was received; differentiable in the IR as
    rfx.cir.rx_power_dbm is under jax.grad.

    A CUDA tensor launches the RX-power kernel, once for all rows, and its
    backward kernel, once for all rows: the same bits from run to run, and a
    row's the same alone or in a batch. A CPU tensor runs
    `rx_power_dbm_plain` and `rx_power_backward_plain`."""
    ir = _rows_of(impulse_response)
    dev = ir.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no RX-power kernel for device {dev}")
    if torch.is_grad_enabled() and ir.requires_grad:
        dbm, out = _RxPower.apply(ir, sample_window_s, carrier_hz)
    else:  # the same forward, without the Function's host time (a lone IR is host-bound)
        out, dbm, _ = _rx_power_forward(ir, sample_window_s, carrier_hz)
    if impulse_response.ndim == 1:
        return dbm[0], out[0]
    return dbm, out


def phasor_metric(re, im, s_max, any_hit, w2=None, w2t=None, deviation=None):
    """The phasor metric from its per-receiver sums, shared by
    `rx_power_dbm_phasor` and the phasor kernel's wrapper
    (rfx_torch.ops.coverage_hist.coverage_phasor). From Re A, Im A, max s_k and
    `any_hit` (bool): dBm, -inf where nothing was captured. Given also w2 =
    sum (amp w)^2, w2t = sum (amp w)^2 t_k and `deviation`, a function of the
    mean delay t_mean giving sum (amp w)^2 (t_k - t_mean)^2: (dBm, coherent /
    incoherent power ratio, power-weighted delay spread in s), ratio 1 and
    spread 0 where nothing was captured."""
    coherent = re * re + im * im
    power = 0.5 * coherent / torch.clamp_min(s_max, 1.0)
    dbm = torch.where(any_hit, to_dbm(torch.clamp_min(power, 1e-300)),
                      torch.full_like(power, -math.inf))
    if deviation is None:
        return dbm
    # 1e-300 rounds to 0 in f32, as in the reference: a receiver with no
    # path gives 0 / 0 here and takes the where's other branch.
    wsum = torch.clamp_min(w2, 1e-300)
    ratio = torch.where(any_hit, coherent / wsum, torch.ones_like(coherent))
    spread = torch.sqrt(torch.clamp_min(deviation(w2t / wsum) / wsum, 0.0))
    return dbm, ratio, torch.where(any_hit, spread, torch.zeros_like(spread))


def rx_power_dbm_phasor(amplitude, distance, captured, *, sample_window_s: float, nbins: int,
                        light_speed_mps: float, sample_rate_hz: float,
                        carrier_hz: float = 2.4e9, return_cancellation: bool = False):
    """RX power without the impulse response (rfx/cir.py:204-274), reduced
    over the last axis of (..., K) paths: the carrier-convolved IR is one
    sinusoid, so its mean square is |A|^2 / 2 with A = sum_k amp_k sqrt(s_k)
    e^{-i w t_k}, s_k the 'same'-mode support of bin k, normalised by the
    largest support. Returns dBm (-inf where nothing was captured) or, with
    `return_cancellation`, (dBm, coherent / incoherent power ratio, power-
    weighted delay spread in s), the hybrid metric's two trust diagnostics
    (`phasor_metric` on the sums).

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
    aw = amp * torch.sqrt(s_k)
    a_re = torch.sum(aw * torch.cos(phase), dim=-1)
    a_im = torch.sum(aw * torch.sin(phase), dim=-1)
    if s_k.shape[-1]:
        s_max = torch.amax(s_k, dim=-1)
    else:
        s_max = torch.zeros(s_k.shape[:-1], dtype=f32, device=dev)
    any_hit = valid.any(dim=-1)
    if not return_cancellation:
        return phasor_metric(a_re, a_im, s_max, any_hit)
    wgt = aw * aw

    def deviation(t_mean):
        dt = t_k - t_mean[..., None]
        return torch.sum(wgt * (dt * dt), dim=-1)

    return phasor_metric(a_re, a_im, s_max, any_hit, torch.sum(wgt, dim=-1),
                         torch.sum(wgt * t_k, dim=-1), deviation)
