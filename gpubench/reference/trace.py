"""Plain reference of the RF trace the benchmark's cells time.

Written from the reference's semantics (the original `main.py` / `tracer.py`
of the rfx reference, as `SURVEY.md` describes them), in plain PyTorch,
float64 by default, and independent of the port: it imports nothing of
`rfx_torch` or `rfx` and takes nothing the port has made. It works on the
scene arrays and the direction sets the benchmark made itself.

Semantics:

- Rays start at the transmitter with amplitude 1 and path length 0. Each
  bounce intersects the environment (Moller-Trumbore, the nearest hit with
  1e-4 < t < 1e6, ties to the lowest face) and the receiver (the analytic
  sphere: the smallest root above 1e-4, a tangent ray misses; or the 80-face
  icosphere through the same triangle test). The receiver wins a segment iff
  it is hit before the environment (an environment miss is infinitely far);
  the ray then ends, captured, with its amplitude and its path length to
  the receiver's surface. An environment hit advances the ray, reflects it
  specularly about the face's unit normal and multiplies its amplitude by the
  reference's Fresnel factor of the bend angle; a double miss ends it.
- Since a receiver never alters the environment path, `env_trace` traces
  the environment once for a direction set and `first_captures` reads each
  receiver's captures off the recorded segments.
- An IR bins amplitude * tx_power / rays at int(length / c * rate); the
  RX power is the mean square of the IR's 'same' convolution with sin(2 pi f
  t) on t = linspace(0, window, nbins), over the output samples that some
  nonzero bin reaches, in dBm (-inf with none).

The environment's closest hit walks a grid of vertical columns over the
scene's xy extent (the scenes here are heightfields over xy or small boxes);
meshes of at most `BRUTE_MAX_FACES` faces are tested whole.

`dtype` selects the arithmetic of the physics (positions, directions,
distances, amplitudes, the triangle tests and the IR). float64 is the
reference; bfloat16 is the control that the comparison must reject. The
column walk's bookkeeping stays in float64 either way, since it only decides
which triangles are tested; bfloat16 has no FFT in PyTorch, so the control's
convolution runs in float32 on bfloat16-rounded inputs and is rounded back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.reference.geometry import icosphere

__all__ = ["RefScene", "env_trace", "sphere_t", "ico_t", "ico_faces", "first_captures",
           "histogram", "receiver_irs", "rx_power_dbm", "T_MIN", "T_MAX"]

T_MIN = 1e-4
T_MAX = 1e6
BRUTE_MAX_FACES = 256
_PAIRS = 1 << 24  # rays x triangles per chunk of a triangle test


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore t of rays (..., 3) against triangles broadcast to
    them; +inf where the triangle is missed."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok = det.abs() > 1e-12
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN) & (t < T_MAX)
    return torch.where(ok, t, torch.full_like(t, math.inf))


def _nearest(t, ids):
    """(t_min, lowest id among the minima) over the last axis; id -1 on a miss."""
    tmin = t.min(dim=-1).values
    big = torch.iinfo(torch.int64).max
    face = torch.where((t == tmin[..., None]) & torch.isfinite(t), ids,
                       torch.full_like(ids, big)).min(dim=-1).values
    return tmin, torch.where(face == big, torch.full_like(face, -1), face)


class RefScene:
    """A triangle mesh on `device` in `dtype`, with the column grid of its
    closest-hit walk (`columns` cells across the larger xy side, the grid
    offset by half a cell)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray, *, device, dtype=torch.float64,
                 columns: int = 127):
        tri = np.asarray(vertices, np.float64)[np.asarray(faces, np.int64)]  # (F, 3, 3)
        self.device, self.dtype = torch.device(device), dtype
        t = torch.as_tensor(tri, device=self.device).to(dtype)
        self.v0, self.e1, self.e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
        n = _cross(self.e1, self.e2)
        self.normal = n / torch.sqrt(_dot(n, n))[:, None]
        self.num_faces = tri.shape[0]
        self.lo, self.hi = tri.reshape(-1, 3).min(0), tri.reshape(-1, 3).max(0)
        if self.num_faces > BRUTE_MAX_FACES:
            self._build_columns(tri, columns)

    def _build_columns(self, tri: np.ndarray, columns: int):
        span = float(max(self.hi[0] - self.lo[0], self.hi[1] - self.lo[1]))
        h = span / columns
        self.h = h
        self.x0, self.y0 = self.lo[0] - 0.5 * h, self.lo[1] - 0.5 * h
        self.nx = int(math.floor((self.hi[0] - self.x0) / h)) + 1
        self.ny = int(math.floor((self.hi[1] - self.y0) / h)) + 1
        eps = 1e-6 * h
        bmin, bmax = tri.min(1), tri.max(1)
        i0 = np.clip(np.floor((bmin[:, 0] - eps - self.x0) / h), 0, self.nx - 1).astype(np.int64)
        i1 = np.clip(np.floor((bmax[:, 0] + eps - self.x0) / h), 0, self.nx - 1).astype(np.int64)
        j0 = np.clip(np.floor((bmin[:, 1] - eps - self.y0) / h), 0, self.ny - 1).astype(np.int64)
        j1 = np.clip(np.floor((bmax[:, 1] + eps - self.y0) / h), 0, self.ny - 1).astype(np.int64)
        cols, ids = [], []
        for di in range(int((i1 - i0).max()) + 1):
            for dj in range(int((j1 - j0).max()) + 1):
                m = (i0 + di <= i1) & (j0 + dj <= j1)
                cols.append((i0[m] + di) * self.ny + (j0[m] + dj))
                ids.append(np.nonzero(m)[0])
        cols, ids = np.concatenate(cols), np.concatenate(ids)
        order = np.lexsort((ids, cols))
        cols, ids = cols[order], ids[order]
        counts = np.bincount(cols, minlength=self.nx * self.ny)
        k = int(counts.max())
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(cols.size) - start[cols]
        table = np.full((self.nx * self.ny, k), -1, np.int64)
        table[cols, slot] = ids
        self.table = torch.as_tensor(table, device=self.device)

    # -- closest hit -----------------------------------------------------

    def closest_hit(self, o: torch.Tensor, d: torch.Tensor):
        """(t (n,), face (n,) int64) of rays (n, 3) in this scene's dtype:
        +inf and -1 on a miss."""
        n = o.shape[0]
        if self.num_faces <= BRUTE_MAX_FACES:
            chunk = max(1, _PAIRS // self.num_faces)
            ids = torch.arange(self.num_faces, device=self.device)
            ts, fs = [], []
            for s in range(0, n, chunk):
                t = _mt(o[s:s + chunk, None], d[s:s + chunk, None], self.v0, self.e1, self.e2)
                tm, f = _nearest(t, ids.expand(t.shape))
                ts.append(tm)
                fs.append(f)
            if not ts:
                return o.new_empty((0,)), torch.empty((0,), dtype=torch.int64, device=o.device)
            return torch.cat(ts), torch.cat(fs)
        t_out = torch.full((n,), math.inf, dtype=o.dtype, device=o.device)
        f_out = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        chunk = max(1, (_PAIRS * 4) // self.table.shape[1])
        for s in range(0, n, chunk):
            t, f = self._walk(o[s:s + chunk], d[s:s + chunk])
            t_out[s:s + chunk], f_out[s:s + chunk] = t, f
        return t_out, f_out

    def _walk(self, o: torch.Tensor, d: torch.Tensor):
        """The column walk: the columns a ray's xy projection crosses, in
        order, each one's triangles tested; a hit inside the column ends it."""
        n, dev = o.shape[0], o.device
        o64, d64 = o.double(), d.double()
        lo = torch.as_tensor(self.lo, device=dev) - 1e-6
        hi = torch.as_tensor(self.hi, device=dev) + 1e-6
        inside = (o64 >= lo) & (o64 <= hi)
        nz = d64 != 0
        inv = 1.0 / torch.where(nz, d64, torch.ones_like(d64))
        ta, tb = (lo - o64) * inv, (hi - o64) * inv
        inf = torch.full_like(ta, math.inf)
        t_lo = torch.where(nz, torch.minimum(ta, tb), torch.where(inside, -inf, inf))
        t_hi = torch.where(nz, torch.maximum(ta, tb), torch.where(inside, inf, -inf))
        t_enter = t_lo.max(dim=1).values.clamp_min(0.0)
        t_exit = t_hi.min(dim=1).values.clamp_max(T_MAX)
        p = o64 + d64 * t_enter[:, None]
        ix = torch.floor((p[:, 0] - self.x0) / self.h).clamp(0, self.nx - 1).long()
        iy = torch.floor((p[:, 1] - self.y0) / self.h).clamp(0, self.ny - 1).long()
        sx = torch.where(d64[:, 0] > 0, 1, -1)
        sy = torch.where(d64[:, 1] > 0, 1, -1)

        def next_t(i, pos0, comp, step, origin):
            edge = origin + (i + (step > 0).long()).double() * self.h
            return torch.where(nz[:, comp], (edge - pos0) * inv[:, comp], inf[:, 0])

        tnx = next_t(ix, o64[:, 0], 0, sx, self.x0)
        tny = next_t(iy, o64[:, 1], 1, sy, self.y0)
        dtx = torch.where(nz[:, 0], self.h * inv[:, 0].abs(), inf[:, 0])
        dty = torch.where(nz[:, 1], self.h * inv[:, 1].abs(), inf[:, 1])
        t_best = torch.full((n,), math.inf, dtype=o.dtype, device=dev)
        face = torch.full((n,), -1, dtype=torch.int64, device=dev)
        act = (t_enter <= t_exit).nonzero().squeeze(1)
        for _ in range(self.nx + self.ny + 4):
            if act.numel() == 0:
                break
            tris = self.table[ix[act] * self.ny + iy[act]]  # (m, K)
            safe = tris.clamp_min(0)
            t = _mt(o[act, None], d[act, None], self.v0[safe], self.e1[safe], self.e2[safe])
            t = torch.where(tris >= 0, t, torch.full_like(t, math.inf))
            tm, f = _nearest(t, tris)
            t_cell = torch.minimum(tnx[act], tny[act])
            tm64 = tm.double()
            hit = torch.isfinite(tm64) & (tm64 <= t_cell + 1e-9 * (1.0 + t_cell.abs()))
            t_best[act[hit]], face[act[hit]] = tm[hit], f[hit]
            go_x = tnx[act] < tny[act]
            ax, ay = act[go_x], act[~go_x]
            ix[ax] += sx[ax]
            tnx[ax] += dtx[ax]
            iy[ay] += sy[ay]
            tny[ay] += dty[ay]
            alive = ~hit & (t_cell <= t_exit[act]) & (ix[act] >= 0) & (ix[act] < self.nx) \
                & (iy[act] >= 0) & (iy[act] < self.ny)
            act = act[alive]
        return t_best, face


def _fresnel(d_in, d_out, n1, n2):
    """The reference's s-polarised Fresnel power factor of a bend between
    two unit directions, with its swapped-media convention and guards."""
    angle = torch.arccos(torch.clamp(_dot(d_in, d_out), -1.0 + 1e-6, 1.0 - 1e-6))
    theta = (math.pi / 2.0) - angle / 2.0
    sin_ratio = (n2 * torch.sin(theta)) / n1
    valid = sin_ratio.abs() <= 1.0
    theta_i = torch.arcsin(torch.clamp(sin_ratio, -1.0 + 1e-7, 1.0 - 1e-7))
    num = n2 * torch.cos(theta_i) - n1 * torch.cos(theta)
    den = n2 * torch.cos(theta_i) + n1 * torch.cos(theta)
    r = (num / torch.where(den != 0, den, torch.ones_like(den))) ** 2
    out = torch.clamp_max(r, 1.0)
    keep = valid & (den != 0) & ~torch.isnan(angle)
    return torch.where(keep, out, torch.zeros_like(out))


def env_trace(scene: RefScene, tx, directions: torch.Tensor, *, bounces: int, n1: float,
              n2: float = 1.0) -> list[dict]:
    """The environment trace of every ray: a list, one entry a bounce, of the
    live segments (`ray` ids, `o`, `d`, `t_env` (+inf where it escapes) and
    its `face` (-1), `amp`, `dist` at the segment's start)."""
    dev, dt = scene.device, scene.dtype
    d = directions.to(device=dev).to(dt)
    n = d.shape[0]
    tx = tx.detach() if torch.is_tensor(tx) else torch.as_tensor(np.asarray(tx, np.float64))
    o = tx.to(device=dev, dtype=dt).expand(n, 3).clone()
    ray = torch.arange(n, device=dev)
    amp = torch.ones(n, dtype=dt, device=dev)
    dist = torch.zeros(n, dtype=dt, device=dev)
    segs = []
    for _ in range(bounces):
        if ray.numel() == 0:
            break
        t, face = scene.closest_hit(o, d)
        segs.append(dict(ray=ray, o=o, d=d, t_env=t, amp=amp, dist=dist, face=face))
        hit = face >= 0
        ray, o, d, t, face = ray[hit], o[hit], d[hit], t[hit], face[hit]
        nrm = scene.normal[face]
        o = o + d * t[:, None]
        w = _dot(d, nrm)
        d_out = d - 2.0 * w[:, None] * nrm
        amp = amp[hit] * _fresnel(d, d_out, n1, n2)
        dist = dist[hit] + t
        d = d_out
    return segs


def sphere_t(o, d, center, radius):
    """Smallest t > T_MIN of unit rays with the sphere; +inf on a miss (a
    tangent ray misses). Rays (n, 3) against centers (R, 1, 3) give (R, n)."""
    oc = o - center
    b = _dot(oc, d)
    c = _dot(oc, oc) - radius * radius
    disc = b * b - c
    hit = disc > 0
    s = torch.sqrt(torch.where(hit, disc, torch.ones_like(disc)))
    t0, t1 = -b - s, -b + s
    inf = torch.full_like(t0, math.inf)
    t = torch.where(t0 > T_MIN, t0, torch.where(t1 > T_MIN, t1, inf))
    return torch.where(hit, t, inf)


def ico_t(o, d, tris):
    """Nearest hit of rays with an icosphere receiver's faces `tris` =
    (v0, e1, e2), each (80, 3); +inf on a miss. Only rays whose line passes
    within the circumscribed sphere are tested."""
    v0, e1, e2 = tris
    center = (v0 + (v0 + e1) + (v0 + e2)).mean(dim=0) / 3.0
    radius = torch.sqrt(_dot(v0 - center, v0 - center)).max() * 1.001
    w = center - o
    along = _dot(w, d)
    near = (_dot(w, w) - along * along <= radius * radius) & (along > -radius)
    out = torch.full(o.shape[:1], math.inf, dtype=o.dtype, device=o.device)
    idx = near.nonzero().squeeze(1)
    if idx.numel():
        t = _mt(o[idx, None], d[idx, None], v0, e1, e2)
        out[idx] = t.min(dim=1).values
    return out


def first_captures(segs: list[dict], t_rx_of, rows: int):
    """The captures of `rows` receivers along the segments: (row, ray id,
    amplitude, path length, bounce) of each (receiver, captured ray), the
    receivers' t taken from `t_rx_of(o, d) -> (rows, n)`."""
    n = segs[0]["ray"].numel() if segs else 0
    dev = segs[0]["o"].device if segs else "cpu"
    taken = torch.zeros((rows, n), dtype=torch.bool, device=dev)
    out = []
    for b, s in enumerate(segs):
        t_rx = t_rx_of(s["o"], s["d"])
        win = ~taken[:, s["ray"]] & torch.isfinite(t_rx) & (t_rx < s["t_env"])
        row, k = win.nonzero(as_tuple=True)
        ray = s["ray"][k]
        taken[row, ray] = True
        out.append((row, ray, s["amp"][k], s["dist"][k] + t_rx[row, k], torch.full_like(k, b)))
    if not out:
        e = torch.empty(0, device=dev)
        return e.long(), e.long(), e, e, e.long()
    return tuple(torch.cat(x) for x in zip(*out))


def histogram(row, amp, dist, *, rows: int, scale: float, nbins: int, light_speed_mps: float,
              sample_rate_hz: float) -> torch.Tensor:
    """(rows, nbins) IRs: amp * scale summed at (row, int(dist / c * rate))
    inside the window, in amp's dtype."""
    delay = dist / light_speed_mps * sample_rate_hz
    bins = torch.floor(delay.double()).long()
    ok = (bins >= 0) & (bins < nbins)
    ir = torch.zeros(rows * nbins, dtype=amp.dtype, device=amp.device)
    ir.index_add_(0, (row * nbins + bins)[ok], amp[ok] * scale)
    return ir.reshape(rows, nbins)


def rx_power_dbm(irs: torch.Tensor, sample_window_s: float, carrier_hz: float) -> torch.Tensor:
    """(M,) float64 dBm of (M, nbins) IRs (see the module docstring)."""
    irs = irs.reshape(-1, irs.shape[-1])
    m, nbins = irs.shape
    dev, dt = irs.device, irs.dtype
    work = torch.float64 if dt == torch.float64 else torch.float32
    t = torch.linspace(0.0, sample_window_s, nbins, dtype=torch.float64, device=dev)
    kern = torch.sin(2.0 * math.pi * carrier_hz * t).to(dt)
    size = 1 << (2 * nbins - 1).bit_length()
    full = torch.fft.irfft(torch.fft.rfft(irs.to(work), size) * torch.fft.rfft(kern.to(work), size),
                           size)
    lo = (nbins - 1) // 2
    out = full[:, lo:lo + nbins].to(dt).double()
    # Output j sums bins k with 1 <= j + lo - k <= nbins - 1 (the carrier's
    # first sample is sin(0) = 0): it is nonzero iff one such bin is.
    nz = torch.cat([torch.zeros((m, 1), dtype=torch.int64, device=dev),
                    torch.cumsum((irs != 0).long(), dim=1)], dim=1)  # nz[:, k] = count below k
    j = torch.arange(nbins, device=dev)
    hi = (j + lo - 1).clamp(-1, nbins - 1) + 1
    lo_k = (j + lo - (nbins - 1)).clamp(0, nbins)
    reach = (nz[:, hi] - nz[:, lo_k]) > 0
    count = reach.sum(dim=1)
    sq = torch.where(reach, out * out, torch.zeros_like(out)).sum(dim=1)
    power = sq / count.clamp_min(1)
    dbm = 10.0 * torch.log10(power.clamp_min(1e-300) / 1e-3)
    return torch.where(count > 0, dbm, torch.full_like(dbm, -math.inf))


def ico_faces(center, radius, dtype, device):
    """(v0, e1, e2), each (80, 3), of the reference receiver's icosphere (one
    subdivision of the icosahedron) about `center`."""
    v, f = icosphere(center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=1)
    tri = torch.as_tensor(np.asarray(v, np.float64)[f], device=device)
    c = torch.as_tensor(np.asarray(center, np.float64), device=device)
    tri = tri * float(radius) + c
    tri = tri.to(dtype)
    return tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]


def receiver_irs(segs: list[dict], centers, radius: float, *, rx_mode: str, scale: float,
                 nbins: int, light_speed_mps: float, sample_rate_hz: float, batch: int = 64):
    """(irs (M, nbins), traced (M,) int64): each receiver's IR from the
    environment trace, and the ray-bounces a per-receiver trace makes (the
    live segments up to and including each ray's capture). At most `batch`
    receivers, and at most `_PAIRS * 8` receiver-ray pairs, go together."""
    dev, dt = segs[0]["o"].device, segs[0]["o"].dtype
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    m = centers.shape[0]
    batch = max(1, min(batch, (_PAIRS * 8) // max(1, segs[0]["ray"].numel())))
    irs, traced = [], []
    alive = [s["ray"] for s in segs]
    for s0 in range(0, m, batch):
        c = centers[s0:s0 + batch]
        rows = c.shape[0]
        if rx_mode == "analytic":
            ct = torch.as_tensor(c, device=dev).to(dt)[:, None, :]
            t_rx_of = lambda o, d: sphere_t(o, d, ct, radius)  # noqa: E731
        elif rx_mode == "icosphere":
            faces = [ico_faces(ci, radius, dt, dev) for ci in c]
            t_rx_of = lambda o, d: torch.stack([ico_t(o, d, f) for f in faces])  # noqa: E731
        else:
            raise ValueError(f"unknown rx_mode {rx_mode!r}")
        row, ray, amp, dist, bounce = first_captures(segs, t_rx_of, rows)
        irs.append(histogram(row, amp, dist, rows=rows, scale=scale, nbins=nbins,
                             light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz))
        total = sum(a.numel() for a in alive)
        cut = torch.zeros(rows, dtype=torch.int64, device=dev)
        for b in range(1, len(segs)):
            later = bounce < b
            gone = torch.isin(ray[later], alive[b])
            cut.index_add_(0, row[later][gone], torch.ones_like(row[later][gone]))
        traced.append(total - cut)
    if not irs:
        return torch.zeros((0, nbins), dtype=dt, device=dev), torch.zeros(0, dtype=torch.int64)
    return torch.cat(irs), torch.cat(traced)
