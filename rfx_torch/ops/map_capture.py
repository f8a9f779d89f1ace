"""The map engine's capture pass: the impulse responses of a chunk of
receiver spheres from the segments of one environment trace, differentiable
in the segments, the centers, the amplitude scale and the radius (port of
the XLA program of
rfx/coverage.py:56-81 under the vmap / lax.map of :185-203, with the
receiver sphere's custom VJP, rfx/ops/intersect.py:206-251).

`map_irs` is one autograd Function (`_MapIRs`) on either device. Its forward
finds each receiver's first capture along each ray's bounces and writes the
first-capture record, (R, N) uint8: the bounce of the receiver's first
capture along the ray, 0xFF for none. The IR histogram's record entry
(rfx_torch.cir.histogram_record) bins it, one launch for the chunk: each
capture's amp * scale and dist + t_rx in the (b, n) order of the B x N
segments, the list the plain map engine's dense rows hold, so the IRs are
its bits. The record is all the backward keeps of the forward: it adds each
capture's terms to its segment, over the receivers in ascending order (the
gradient of the histogram's scatter, of the capture's `where`s and of the
sphere's implicit-function derivative).

On a CUDA tensor the forward launches `rfx_map_capture`
(rfx_torch/csrc/map_capture.cu) and `rfx_ir_histogram_record`
(rfx_torch/csrc/histogram.cu), and the backward `rfx_map_capture_backward`;
on a CPU tensor their plain versions run: `map_record_plain` (the broadcast
sphere test and first-capture rule of the plain map engine),
`histogram_record_plain` (the record expanded to the plain map engine's
rows, `map_capture_plain`'s bits, then the plain histogram) and
`map_capture_backward_plain` (the backward's arithmetic written out per
receiver, finding the captures again). Nothing falls back: a build or
launch failure raises.

`rx_mode="icosphere"` takes the reference's 80-face receiver about each
center (rfx/coverage.py:38-54) through the same record: on the card the
icosphere instantiations `rfx_map_capture_ico`, `rfx_ir_histogram_record_ico`
and `rfx_map_capture_backward_ico` (the closest hit over the receiver's faces
behind a bounding-sphere cull, and the VJP of the selected face's
closed-form t), on the CPU the same plain versions over `ico_hit_plain`.
"""

from __future__ import annotations

import torch

from rfx_torch import cir
from rfx_torch.ops._build import CudaKernel, F, I, P
from rfx_torch.ops.coverage_hist import _check_segments, first_captures
from rfx_torch.ops.intersect import (
    T_MAX,
    T_MIN_EPS,
    _brute_forward,
    closed_form_t_vjp,
    dot3,
    sphere_t,
)
from rfx_torch.tracer import EnvSegments, icosphere_soa, icosphere_tris, unit_icosphere_tris

__all__ = ["MAP_CAPTURE_BACKWARD_ICO_KERNEL", "MAP_CAPTURE_BACKWARD_KERNEL",
           "MAP_CAPTURE_ICO_KERNEL", "MAP_CAPTURE_KERNEL", "NO_CAPTURE", "RX_MODES",
           "histogram_record_plain", "ico_hit_plain", "map_capture_backward",
           "map_capture_backward_plain", "map_capture_plain", "map_irs", "map_record",
           "map_record_plain", "record_rows"]

MAP_CAPTURE_KERNEL = CudaKernel("map_capture.cu", "rfx_map_capture",
                                [P, P, P, P, I, I, P, I, F, P, P])
MAP_CAPTURE_BACKWARD_KERNEL = CudaKernel(
    "map_capture.cu", "rfx_map_capture_backward",
    [P, P, P, P, P, I, I, P, I, F, F, F, F, I, I, F, P, P, P, P, P, P, P, P, P, P],
)
# The icosphere receiver's instantiations: the cull and the 80-face closest
# hit of brute_hit.cuh in place of the analytic sphere.
MAP_CAPTURE_ICO_KERNEL = CudaKernel("map_capture.cu", "rfx_map_capture_ico",
                                    [P, P, P, P, I, I, P, I, F, P, P, P])
MAP_CAPTURE_BACKWARD_ICO_KERNEL = CudaKernel(
    "map_capture.cu", "rfx_map_capture_backward_ico",
    [P, P, P, P, P, I, I, P, I, F, F, F, I, I, P, P, P, P, P, P, P, P, P, P, P, P],
)

RX_MODES = ("analytic", "icosphere")

NO_CAPTURE = 0xFF  # the record's byte where a receiver captures nothing along a ray
MAX_BOUNCES = 254  # the bounces a record byte can name


def _radius(rx_radius, device) -> torch.Tensor:
    return torch.as_tensor(rx_radius, dtype=torch.float32).to(device)


def _check_mode(rx_mode: str):
    if rx_mode not in RX_MODES:
        raise ValueError(f"unknown rx_mode: {rx_mode}")


def ico_hit_plain(o: torch.Tensor, d: torch.Tensor, center: torch.Tensor, rx_radius):
    """(t, face) of (..., 3) rays against the 80-face icosphere of radius
    rx_radius about `center` (3,): the brute closest hit's plain version
    (`_brute_forward`) on `icosphere_soa`'s faces, every ray tested."""
    v0, e1, e2 = icosphere_soa(center, rx_radius)
    t, face = _brute_forward(o.reshape(-1, 3), d.reshape(-1, 3), v0, e1, e2, T_MIN_EPS, T_MAX,
                             None)
    return t.reshape(o.shape[:-1]), face.reshape(o.shape[:-1])


def _check_sizes(b: int, n: int, m: int, nbins: int = 1):
    if max(n, b, m, nbins) >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rays, bounces, receivers and bins, got {n}, {b}, {m} "
                         f"and {nbins}")
    if b > MAX_BOUNCES:
        raise ValueError(f"the first-capture record holds at most {MAX_BOUNCES} bounces, got {b}")


def _plain_captures(segs: EnvSegments, centers: torch.Tensor, rx_radius,
                    rx_mode: str = "analytic") -> tuple:
    """(t_rx, first), each (R, B, N), of the (R, 3) centers: the broadcast
    sphere test (analytic) or each receiver's 80-face closest hit
    (`ico_hit_plain`, icosphere), and the first-capture rule of the plain
    map engine."""
    b, n = segs.t_env.shape
    if rx_mode == "analytic":
        r = _radius(rx_radius, segs.t_env.device)
        t_rx = sphere_t(segs.origin.reshape(b * n, 3), segs.direction.reshape(b * n, 3),
                        centers[:, None, :], r * r).reshape(-1, b, n)
    else:
        _check_mode(rx_mode)
        t_rx = (torch.stack([ico_hit_plain(segs.origin, segs.direction, c, rx_radius)[0]
                             for c in centers]) if centers.shape[0]
                else segs.t_env.new_empty((0, b, n)))
    return t_rx, first_captures(segs, t_rx)


def map_capture_plain(segs: EnvSegments, centers: torch.Tensor, rx_radius, scale: float,
                      rx_mode: str = "analytic"):
    """The plain map engine's dense rows: (amp, dist, captured), each (R, B *
    N), for the (R, 3) centers: amp * scale and dist + t_rx at the first
    captures, 0 elsewhere. What the IR histogram bins; the record's
    reference."""
    dev = segs.t_env.device
    t_rx, first = _plain_captures(segs, centers, rx_radius, rx_mode)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rows = t_rx.shape[0]
    amp = torch.where(first, segs.amplitude, zero) * torch.tensor(scale, dtype=torch.float32,
                                                                   device=dev)
    dist = torch.where(first, segs.distance + t_rx, zero)
    return amp.reshape(rows, -1), dist.reshape(rows, -1), first.reshape(rows, -1)


def map_record_plain(segs: EnvSegments, centers: torch.Tensor, rx_radius,
                     rx_mode: str = "analytic") -> torch.Tensor:
    """Plain PyTorch version of `rfx_map_capture` (analytic) and
    `rfx_map_capture_ico` (icosphere): the (R, N) uint8 first-capture record
    of the (R, 3) centers, the bounce of each receiver's first capture along
    each ray (`first_captures`), NO_CAPTURE where there is none."""
    dev = segs.t_env.device
    b, n = segs.t_env.shape
    _check_sizes(b, n, centers.shape[0])
    centers = centers.to(torch.float32)
    none = torch.full((), NO_CAPTURE, dtype=torch.int32, device=dev)
    if b == 0:
        return none.expand(centers.shape[0], n).to(torch.uint8)
    _, first = _plain_captures(segs, centers, rx_radius, rx_mode)
    bounce = torch.arange(b, dtype=torch.int32, device=dev)[None, :, None]
    return torch.where(first, bounce, none).amin(dim=1).to(torch.uint8)


def _t_at(segs: EnvSegments, centers: torch.Tensor, rx_radius, rx_mode: str, k, bb, i):
    """t_rx of receiver k[j] on segment (bb[j], i[j]), with the elementwise
    arithmetic of `_plain_captures`."""
    o, d = segs.origin[bb, i], segs.direction[bb, i]
    if rx_mode == "analytic":
        r = _radius(rx_radius, o.device)
        return sphere_t(o, d, centers[k], r * r)
    t = torch.empty(k.shape, dtype=torch.float32, device=o.device)
    for j in range(centers.shape[0]):
        sel = (k == j).nonzero().squeeze(1)
        if sel.numel():
            t[sel] = ico_hit_plain(o[sel], d[sel], centers[j], rx_radius)[0]
    return t


def record_rows(record: torch.Tensor, segs: EnvSegments, centers: torch.Tensor, rx_radius,
                scale: float, rx_mode: str = "analytic"):
    """The record expanded to the plain map engine's rows, `map_capture_plain`'s
    (amp, dist, captured) bit for bit: t_rx recomputed at the captures
    alone, with the same elementwise arithmetic."""
    _check_mode(rx_mode)
    dev = segs.t_env.device
    b, n = segs.t_env.shape
    rows = record.shape[0]
    first = record.to(torch.int32)[:, None, :] == torch.arange(b, dtype=torch.int32,
                                                                device=dev)[None, :, None]
    k, bb, i = first.nonzero(as_tuple=True)
    t_rx = _t_at(segs, centers.to(torch.float32), rx_radius, rx_mode, k, bb, i)
    amp = torch.zeros((rows, b, n), dtype=torch.float32, device=dev)
    dist = torch.zeros_like(amp)
    amp[k, bb, i] = segs.amplitude[bb, i] * torch.tensor(scale, dtype=torch.float32, device=dev)
    dist[k, bb, i] = segs.distance[bb, i] + t_rx
    return amp.reshape(rows, -1), dist.reshape(rows, -1), first.reshape(rows, -1)


def histogram_record_plain(record: torch.Tensor, segs: EnvSegments, centers: torch.Tensor,
                           rx_radius, scale: float, *, nbins: int, light_speed_mps: float,
                           sample_rate_hz: float, soft: bool,
                           rx_mode: str = "analytic") -> torch.Tensor:
    """Plain PyTorch version of `rfx_ir_histogram_record` (analytic) and
    `rfx_ir_histogram_record_ico` (icosphere): the record expanded to rows
    (`record_rows`), then `histogram_plain`, hard or the two soft halves
    added."""
    rows = record_rows(record, segs, centers, rx_radius, scale, rx_mode)
    kw = dict(nbins=nbins, light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz)
    modes = (cir.SOFT_LO, cir.SOFT_HI) if soft else (cir.HARD,)
    halves = [cir.histogram_plain(*rows, mode=m, **kw) for m in modes]
    return halves[0] + halves[1] if soft else halves[0]


def _planes(segs: EnvSegments) -> list:
    return [t.detach().contiguous() for t in segs]


def _backward_scratch_rows(n: int) -> int:
    """The rows of the backward's scratch for n rays (a row a block, then a
    row a chunk of blocks), as map_capture.cu decides them."""
    fn = MAP_CAPTURE_BACKWARD_KERNEL.symbol_of("rfx_map_capture_backward_blocks")
    fn.argtypes, fn.restype = [I], I
    return int(fn(n))


def map_record(segs: EnvSegments, centers: torch.Tensor, rx_radius,
               rx_mode: str = "analytic", tris: torch.Tensor | None = None) -> torch.Tensor:
    """The (R, N) uint8 first-capture record of `map_record_plain`: on a CPU
    tensor that plain version, on a CUDA tensor one launch of
    `rfx_map_capture` or, for the icosphere, `rfx_map_capture_ico` (the same
    bytes). `tris`: the icosphere's faces, `icosphere_tris(centers,
    rx_radius)`, computed here where None."""
    _check_mode(rx_mode)
    dev = segs.t_env.device
    if dev.type == "cpu":
        return map_record_plain(segs, centers, rx_radius, rx_mode)
    if dev.type != "cuda":
        raise ValueError(f"no map capture kernel for device {dev}")
    b, n = segs.t_env.shape
    m = centers.shape[0]
    _check_sizes(b, n, m)
    if -(-n // 256) * -(-m // 32) >= 2**31:
        raise ValueError(f"too many rays x receivers for one launch: {n} x {m}")
    record = torch.empty((m, n), dtype=torch.uint8, device=dev)  # the kernel writes every byte
    if m and n and b:
        origin, direction, t_env, _, _, alive = _planes(segs)
        centers = centers.detach().to(torch.float32).contiguous()
        args = (origin.data_ptr(), direction.data_ptr(), t_env.data_ptr(), alive.data_ptr(), b, n,
                centers.data_ptr(), m, float(rx_radius))
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            if rx_mode == "analytic":
                MAP_CAPTURE_KERNEL.launch(*args, record.data_ptr(), stream)
            else:
                tris = _ico_tris(centers, rx_radius, tris)
                MAP_CAPTURE_ICO_KERNEL.launch(*args, tris.data_ptr(), record.data_ptr(), stream)
    elif m and n:
        record.fill_(NO_CAPTURE)
    return record


def _ico_tris(centers: torch.Tensor, rx_radius, tris) -> torch.Tensor:
    """`tris`, or the (R, 80, 9) faces of the icospheres about `centers`."""
    if tris is None:
        tris = icosphere_tris(centers, float(rx_radius))
    if tris.shape != (centers.shape[0], 80, 9) or tris.dtype != torch.float32:
        raise ValueError(f"tris must be ({centers.shape[0]}, 80, 9) float32, got "
                         f"{tuple(tris.shape)} {tris.dtype}")
    return tris.detach().contiguous()


def _g_at(g_row: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """g_row[bins] where 0 <= bins < nbins, else 0."""
    nbins = g_row.shape[0]
    valid = (bins >= 0) & (bins < nbins)
    return torch.where(valid, g_row[bins.clamp(0, nbins - 1)],
                       torch.zeros((), dtype=g_row.dtype, device=g_row.device))


def map_capture_backward_plain(segs: EnvSegments, centers: torch.Tensor, rx_radius,
                               g: torch.Tensor, *, scale: float, nbins: int,
                               light_speed_mps: float, sample_rate_hz: float, soft: bool,
                               centers_grad: bool = True, scalars_grad: bool = True,
                               rx_mode: str = "analytic"):
    """Plain PyTorch version of `rfx_map_capture_backward` and, for the
    icosphere, `rfx_map_capture_backward_ico`, on either device:
    (g_origin (B, N, 3), g_direction (B, N, 3), g_amplitude (B, N),
    g_distance (B, N), g_centers (R, 3), g_scale (), g_radius ()) of the IRs'
    cotangent g (R, nbins); g_centers is None unless `centers_grad`, g_scale
    and g_radius None unless `scalars_grad`. A receiver at a time, in
    ascending order, finds its first captures and adds their terms to the
    segments (the expressions of the kernel, in its order):

    - hard: g_a = g[r, int(delay)], 0 outside the window; nothing else;
    - soft, lo = floor(delay), w = delay - lo: g_a = (1 - w) g[r, lo] + w
      g[r, lo + 1], g_dist = amp scale (g[r, lo + 1] - g[r, lo]) rate / c;
      analytic: with q = o + t_rx d - C and q.d clamped at 1e-6 max(radius,
      1e-6), gg = g_dist / q.d: g_origin += -gg q, g_direction += -(gg t_rx)
      q, and the receiver's center gains gg q (summed over its segments);
      icosphere: the VJP of the selected face's closed-form t for g_dist
      (`closed_form_t_vjp`): g_origin += g_o, g_direction += g_d, the center
      gains g_v0 and the radius g_v0.unit_v0 + g_e1.unit_e1 + g_e2.unit_e2
      (v0 = unit_v0 r + C, e1 = unit_e1 r, e2 = unit_e2 r);

    g_amplitude += g_a scale, g_distance += g_dist, with delay = (dist +
    t_rx) / c * rate. g_scale is the sum of g_a amp over every capture, and
    g_radius that of gg times the radius (analytic: dt/dr = r / q.d) or of
    the icosphere's radius terms; each sum adds its f32 terms in double and
    rounds once."""
    _check_mode(rx_mode)
    ico = rx_mode == "icosphere"
    dev = segs.t_env.device
    f32 = torch.float32
    segs = EnvSegments(*(t.detach() for t in segs))
    b, n = segs.t_env.shape
    r = _radius(rx_radius, dev)
    r2 = r * r
    qd_floor = 1e-6 * r.clamp_min(1e-6)
    c = torch.tensor(light_speed_mps, dtype=f32, device=dev)
    rate = torch.tensor(sample_rate_hz, dtype=f32, device=dev)
    k_scale = torch.tensor(scale, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    o, d = segs.origin, segs.direction
    g_o = torch.zeros((b, n, 3), dtype=f32, device=dev)
    g_d = torch.zeros((b, n, 3), dtype=f32, device=dev)
    g_a = torch.zeros((b, n), dtype=f32, device=dev)
    g_dist = torch.zeros((b, n), dtype=f32, device=dev)
    g_c = torch.zeros((centers.shape[0], 3), dtype=f32, device=dev) if centers_grad else None
    f64 = torch.float64
    sum_amp = torch.zeros((), dtype=f64, device=dev)
    sum_gg = torch.zeros((), dtype=f64, device=dev)
    g = g.to(f32)
    unit = unit_icosphere_tris(dev) if ico else None
    for k in range(centers.shape[0]):
        ctr = centers[k].detach().to(f32)
        if ico:
            t_rx, face = ico_hit_plain(o, d, ctr, r)
        else:
            t_rx = sphere_t(o, d, ctr, r2)
        first = first_captures(segs, t_rx[None])[0]
        t = torch.where(first, t_rx, zero)
        delay = (segs.distance + t) / c * rate
        if not soft:
            ga = _g_at(g[k], delay.to(torch.int32))
            g_a = g_a + torch.where(first, ga * k_scale, zero)
            sum_amp = sum_amp + torch.where(first, ga * segs.amplitude, zero).to(f64).sum()
            continue
        lo = torch.floor(delay)
        w = delay - lo
        lo_i = lo.to(torch.int32)
        g_lo, g_hi = _g_at(g[k], lo_i), _g_at(g[k], lo_i + 1)
        ga = (1.0 - w) * g_lo + w * g_hi
        gd = segs.amplitude * k_scale * (g_hi - g_lo) * rate / c
        cap = first[..., None]
        if ico:
            sel = face.clamp_min(0).long()
            v0, e1, e2 = icosphere_soa(ctr, r)
            go, gdir, gv0, ge1, ge2 = closed_form_t_vjp(o, d, v0[sel], e1[sel], e2[sel], gd)
            u = unit[sel]
            g_r = (dot3(gv0, u[..., 0:3]) + dot3(ge1, u[..., 3:6])) + dot3(ge2, u[..., 6:9])
            gc = gv0
        else:
            q = o + t[..., None] * d - ctr
            qd = dot3(q, d)
            mag = torch.maximum(qd.abs(), qd_floor)
            gg = gd / torch.where(qd < 0.0, -mag, mag)
            go, gdir, g_r, gc = -gg[..., None] * q, -(gg * t)[..., None] * q, gg, gg[..., None] * q
        g_a = g_a + torch.where(first, ga * k_scale, zero)
        g_dist = g_dist + torch.where(first, gd, zero)
        g_o = g_o + torch.where(cap, go, zero)
        g_d = g_d + torch.where(cap, gdir, zero)
        sum_amp = sum_amp + torch.where(first, ga * segs.amplitude, zero).to(f64).sum()
        sum_gg = sum_gg + torch.where(first, g_r, zero).to(f64).sum()
        if centers_grad:
            g_c[k] = torch.where(cap, gc, zero).sum(dim=(0, 1))
    if not scalars_grad:
        return g_o, g_d, g_a, g_dist, g_c, None, None
    g_radius = sum_gg.to(f32) if ico else sum_gg.to(f32) * r
    return g_o, g_d, g_a, g_dist, g_c, sum_amp.to(f32), g_radius


def map_capture_backward(segs: EnvSegments, centers: torch.Tensor, rx_radius, g: torch.Tensor,
                         record: torch.Tensor, *, scale: float, nbins: int,
                         light_speed_mps: float, sample_rate_hz: float, soft: bool,
                         centers_grad: bool = True, scalars_grad: bool = True,
                         rx_mode: str = "analytic", tris: torch.Tensor | None = None):
    """The tuple of `map_capture_backward_plain`: that plain version on a CPU
    tensor (it finds the captures again), one call of
    `rfx_map_capture_backward` (or, for the icosphere,
    `rfx_map_capture_backward_ico`, given the faces `tris` or computing them)
    on a CUDA tensor, which reads where the captures are from `record`, the
    forward's first-capture record of these segments and centers
    (`map_record`): each segment's sums over the receivers in ascending
    order, the same bits from run to run; the centers' gradient and the
    scale's and radius's sums, where asked for, in a fixed order."""
    kw = dict(scale=scale, nbins=nbins, light_speed_mps=light_speed_mps,
              sample_rate_hz=sample_rate_hz, soft=soft, centers_grad=centers_grad,
              scalars_grad=scalars_grad, rx_mode=rx_mode)
    dev = segs.t_env.device
    if dev.type == "cpu":
        return map_capture_backward_plain(segs, centers, rx_radius, g, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no map capture backward kernel for device {dev}")
    b, n = segs.t_env.shape
    m = centers.shape[0]
    _check_sizes(b, n, m, nbins)
    if tuple(g.shape) != (m, nbins):
        raise ValueError(f"g must be ({m}, {nbins}), got {tuple(g.shape)}")
    if record.dtype != torch.uint8 or tuple(record.shape) != (m, n):
        raise ValueError(f"record must be ({m}, {n}) uint8, got {tuple(record.shape)} "
                         f"{record.dtype}")
    f32 = torch.float32
    r = _radius(rx_radius, "cpu")
    shapes = ((b, n, 3), (b, n, 3), (b, n), (b, n))
    if not (m and n and b):
        zeros = [torch.zeros(x, dtype=f32, device=dev) for x in (*shapes, (m, 3), (), ())]
        return (*zeros[:4], zeros[4] if centers_grad else None,
                *(zeros[5:] if scalars_grad else (None, None)))
    # The kernel writes every element of its outputs.
    outs = [torch.empty(x, dtype=f32, device=dev) for x in shapes]
    rows = _backward_scratch_rows(n)
    g_c = gc_partials = sums = sums_partials = None
    if centers_grad:
        g_c = torch.empty((m, 3), dtype=f32, device=dev)
        gc_partials = torch.empty((rows, m, 3), dtype=f32, device=dev)
    if scalars_grad:
        sums = torch.empty(2, dtype=f32, device=dev)
        sums_partials = torch.empty((rows, 2), dtype=torch.float64, device=dev)
    origin, direction, _, amplitude, distance, _ = _planes(segs)
    centers = centers.detach().to(f32).contiguous()
    g = g.detach().to(f32).contiguous()
    record = record.contiguous()
    head = (origin.data_ptr(), direction.data_ptr(), amplitude.data_ptr(), distance.data_ptr(),
            record.data_ptr(), b, n, centers.data_ptr(), m)
    tail = (g.data_ptr(), *(t.data_ptr() for t in outs),
            *(None if t is None else t.data_ptr() for t in (gc_partials, g_c, sums_partials, sums)),
            torch.cuda.current_stream(dev).cuda_stream)
    rates = (float(light_speed_mps), float(sample_rate_hz), nbins, int(soft))
    with torch.cuda.device(dev):
        if rx_mode == "analytic":
            qd_floor = float(1e-6 * r.clamp_min(1e-6))
            MAP_CAPTURE_BACKWARD_KERNEL.launch(*head, float(r), float(scale), *rates, qd_floor,
                                               *tail)
        else:
            tris = _ico_tris(centers, float(r), tris)
            unit = unit_icosphere_tris(dev).contiguous()
            MAP_CAPTURE_BACKWARD_ICO_KERNEL.launch(*head, float(scale), *rates, tris.data_ptr(),
                                                   unit.data_ptr(), *tail)
    if not scalars_grad:
        return (*outs, g_c, None, None)
    return (*outs, g_c, sums[0], sums[1] if rx_mode == "icosphere" else sums[1] * r)


class _MapIRs(torch.autograd.Function):
    """(R, nbins) IRs of R receivers from the segments, hard or soft, with
    the gradient of the plain map engine in origin, direction, amplitude,
    distance, the centers, the scale and the radius (0-dim tensors; t_env
    and alive enter comparisons only). The forward keeps the segments, the
    centers, the (R, N) first-capture record and, for the icosphere on the
    card, the receivers' (R, 80, 9) faces; never an (R, B, N) tensor."""

    @staticmethod
    def forward(ctx, origin, direction, t_env, amplitude, distance, alive, centers, scale, radius,
                kw):
        segs = EnvSegments(origin, direction, t_env, amplitude, distance, alive)
        mode = kw["rx_mode"]
        on_card = origin.device.type == "cuda"
        tris = (icosphere_tris(centers.detach(), kw["radius"]).contiguous()
                if on_card and mode == "icosphere" else None)
        record = map_record(segs, centers, kw["radius"], mode, tris)
        hkw = dict(nbins=kw["nbins"], light_speed_mps=kw["light_speed_mps"],
                   sample_rate_hz=kw["sample_rate_hz"], soft=kw["soft"], rx_mode=mode)
        if on_card:
            irs = cir.histogram_record(record, segs, centers, kw["radius"], kw["scale"], tris=tris,
                                       **hkw)
        else:
            irs = histogram_record_plain(record, segs, centers, kw["radius"], kw["scale"], **hkw)
        ctx.save_for_backward(origin, direction, t_env, amplitude, distance, alive, centers, record)
        ctx.kw = kw
        ctx.tris = tris
        ctx.scalars = scale, radius
        return irs

    @staticmethod
    def backward(ctx, g):
        *planes, centers, record = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need[k] for k in (0, 1, 3, 4, 6, 7, 8)):
            return (None,) * 10
        kw = dict(ctx.kw)
        radius = kw.pop("radius")
        if ctx.tris is not None:
            kw["tris"] = ctx.tris
        g_o, g_d, g_a, g_dist, g_c, g_scale, g_radius = map_capture_backward(
            EnvSegments(*planes), centers, radius, g, record, centers_grad=need[6],
            scalars_grad=need[7] or need[8], **kw)
        scale, radius = ctx.scalars
        return (g_o if need[0] else None, g_d if need[1] else None, None,
                g_a if need[3] else None, g_dist if need[4] else None, None, g_c,
                g_scale.to(scale.device) if need[7] else None,
                g_radius.to(radius.device) if need[8] else None, None)


def map_irs(segs: EnvSegments, rx_centers, rx_radius, *, scale, nbins: int,
            light_speed_mps: float, sample_rate_hz: float, soft: bool = False,
            rx_mode: str = "analytic") -> torch.Tensor:
    """(R, nbins) impulse responses of R receiver spheres of one radius from
    the env segments `segs` (amplitude unscaled; `scale` = tx_power /
    num_rays as an f32 value, rfx_torch.coverage._amp_scale), hard or soft
    binning: the map engine's chunk, differentiable in the segments' origin,
    direction, amplitude and distance, in the centers, and in `scale` and
    `rx_radius` where they are tensors (0-dim; on the host, they cost the
    card no wait). `rx_mode`: 'analytic' (the exact sphere) or 'icosphere'
    (the reference's 80-face receiver about each center). A CPU tensor runs
    the plain versions, a CUDA tensor the kernels: one launch of the capture
    pass and one of the histogram's record entry (their icosphere
    instantiations for the icosphere). At most 254 bounces (the record's
    byte)."""
    _check_mode(rx_mode)
    _check_segments(segs)
    if nbins < 1:
        raise ValueError("nbins must be at least 1")
    b, n = segs.t_env.shape
    dev = segs.t_env.device
    centers = torch.as_tensor(rx_centers, dtype=torch.float32, device=dev).reshape(-1, 3)
    _check_sizes(b, n, centers.shape[0], nbins)
    scale = torch.as_tensor(scale, dtype=torch.float32).reshape(())
    radius = torch.as_tensor(rx_radius, dtype=torch.float32).reshape(())
    kw = dict(scale=float(scale.detach()), radius=float(radius.detach()), nbins=int(nbins),
              light_speed_mps=float(light_speed_mps), sample_rate_hz=float(sample_rate_hz),
              soft=bool(soft), rx_mode=rx_mode)
    return _MapIRs.apply(*segs, centers, scale, radius, kw)
