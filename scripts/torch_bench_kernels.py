#!/usr/bin/env python3
"""Time the port's hand-written kernels at the shapes of their main paths on
one NVIDIA GPU, and hold them against another checkout's kernels.

    python3 scripts/torch_bench_kernels.py [--other DIR] [--only k1,k1i,order,k3,kf,ks,...]
                                           [--reps N]
                                           [--out build/bench_kernels.json]

The scenes, transmitters, receivers and sizes are those of chip_smoke.py (the
bench terrain, the coverage sweeps) and of scripts/torch_bench_large_mesh.py
(the 1,045,458-triangle terrain), imported from there. What it runs (CUDA
events, the mean of `--reps` calls after one warm-up):

- K1, the fused trace, 5,242,880 Morton rays x 4 bounces on both terrains,
  with the counted instantiation and the face record beside it, and the
  Morton rays in the caller's order (`morton_caller_ms`); then the CIR
  cells' i.i.d. rays (gpubench's `direction_pool`, seed 0) in the
  checkout's own order (`iid_ms`: direction-cell order, ordering included)
  and in the caller's (`iid_caller_ms`), whether the two give the same bits,
  and the same two ways with the face record at the scan gradient's
  2,621,440 i.i.d. rays (`faces_iid_ms`, `faces_iid_caller_ms`);
- K1 with the icosphere receiver (`k1i`): the CIR cells' 5,242,880 i.i.d.
  rays on the bench terrain in direction-cell order, radius 0.1 and 1.0,
  each kernel's device time beside the analytic receiver's on the same
  rays, the caller's order, the bound, the plain version on 65,536 of the
  rays (bit for bit), the scan tracer with the icosphere receiver on the
  same rays, and the facade's request through each (a checkout without the
  icosphere K1 times only the scan tracer and its request);
- the direction-cell order (`order`, a checkout without it skips the row):
  the ordering kernels alone at 5,242,880 i.i.d. rays on each lattice of 6
  to 10 bits a side (keys and counts against the plain version, the device
  time of each kernel), with K1 on both terrains walking each lattice's
  order (three rounds over the lattices, and each kernel's device time);
  `torch.argsort` of the keys plus a gather of the directions
  (`library_ms`); the bound (36 bytes a ray); and the crossover behind
  `ORDER_MIN_RAYS`: K1 on the bench terrain at 16,384 to 5,242,880 i.i.d.
  rays in the caller's order (`caller_ms`) against ordering, K1 and the
  put-back (`ordered_ms`), two rounds each;
- K2, the per-query closest hit, on the bench terrain at 65,536, 1,048,576
  and 2,621,440 rays from tx (the shapes of the checks, of the solver and
  the coverage trace, of the scan gradient path) and on their second-bounce
  queries, and on the large terrain at 16,384 and 1,048,576 rays; each set
  again through the counted entry point, which gives its bound (the formula
  of chip_smoke.py), the mean and the maximum of the nodes a query visits
  and the mean of the per-warp maximum; at 1,048,576 rays also the
  second-bounce queries left in place among parked lanes (as the tracers
  pass them) and compacted and sorted by a Morton code of their origins;
- K3, the coverage histogram, 2,048 receivers x 2 bounces x 1,048,576 rays x
  10,000 bins on the room and on the bench terrain;
- K-H, the IR histogram, 20,000 bins, hard and soft: the forward shape
  (5,242,880 rays of the bench workload, one row) and the solver's shapes
  (the plain map engine's dense rows of 1,048,576 rays x 4 bounces for the
  64 receivers of chip_smoke.py's inverse solve: 4,194,304 entries a row;
  one row, and all 64 in one call), each with the plain version's time,
  `index_add_` on ready-made bins and weights, and two bounds: 9 bytes an
  entry plus the bins, and the bytes the function needs (the mask, 8 bytes a
  capture by 32-byte sector, the bins). `*_ms` is the CUDA-event time of
  back-to-back calls of the wrapper, `*_device_ms` the device's own time a
  call under torch.profiler: where the first is the larger, the call is
  bound by the host that enqueues it;
- K-P, rx_power_dbm, on K3's IRs of both coverage sweeps (2,048 x 10,000
  bins) and on the bench workload's IR (20,000 bins), the call's time and
  its device time, with the plain version's time, conv1d's (the flipped
  carrier, 'same' padding, no TF32) and the bound of chip_smoke.py (two
  operations per in-range tap);
- K-F, the phasor metric of both coverage sweeps from their segments
  (rfx_torch.coverage._dbm_cancel_from_segments), with the plain version's
  time and the bound of chip_smoke.py (one sphere test per live segment and
  receiver, as K3's);
- K-P's backward (`kpb`), rx_power_backward with g_dbm = 1 on K-P's rows
  (the forward's signal and row sums from the kernel), with its device time,
  the plain version's time on 16 of the rows, conv1d's (g_eff with the
  carrier, no TF32) and chip_smoke.py's bound (two operations per in-range
  tap of the nonzero g_eff);
- K-F's backward (`kfb`), phasor_backward with g_dbm = 1 on both coverage
  sweeps' segments, with the plain version's time and the forward walk's
  bound. A checkout without the backwards skips these two rows;
- the map engine's capture pass (`ks`): `map_irs`, hard and soft, on
  chip_smoke.py phase 11's segments (the inverse solve: 1,048,576 rays x 4
  bounces on the bench terrain, 64 receivers of radius 1.0, 20,000 bins),
  the call's time and its device time, and the capture pass alone
  (`map_record`, or a checkout's dense-rows `map_capture`);
- its backward (`ksb`), `map_capture_backward` on the same segments for a
  seeded (64, 20,000) cotangent (numpy seed 3), soft, the segments'
  gradients alone and with the centers', scale's and radius's (given K-S's
  record where the checkout's backward takes one). A checkout without the
  capture pass skips these two rows;
- the icosphere's capture pass (`ksi`), `map_record(rx_mode="icosphere")`
  (K-S/ico), and its record entry (`khi`), `histogram_record(rx_mode=
  "icosphere")` hard and soft, on the first 64 receivers of chip_smoke.py
  phase 17's sweeps (`icosphere_workload`: 2 bounces x 1,048,576 rays on the
  room and the bench terrain, radius 0.5, 10,000 bins), each with
  `queued_ms` (calls queued behind a sleep of the device: the device's own
  time, which the profiler drops for these ctypes launches) and its bound
  (`ico_capture_bound`, `ico_entry_bound`); a checkout whose K-S/ico reads
  the receivers' faces is given them (`icosphere_tris`), and its record
  entry computes t again. A checkout without the icosphere skips them;
- the brute closest hit (`kb`), `intersect.brute_hit` on chip_smoke.py
  phase 17's two shapes (`brute_request_inputs`: the icosphere request's
  5,242,880 rays from tx against the receiver's 80 faces with its cull;
  `brute_env_inputs`: the room sweep's 2,097,152 queries against its 12
  faces, no cull), each with `queued_ms` and chip_smoke.py's bound;
- the icosphere's backward (`ksbi`), `map_capture_backward(rx_mode=
  "icosphere")` (B11/ico) on phase 17's room segments and its 64
  value+grad receivers (`ico_grad_receivers`, `ico_backward_inputs`: K-S/ico's
  record, the seeded cotangent, soft), the segments' gradients alone and
  with the centers', scale's and radius's, each with `queued_ms`, the
  digests of all seven outputs and the bound (`ico_backward_bound`); a
  checkout whose backward takes the receivers' faces is given them
  (`icosphere_tris`), made once outside the timed calls.

`--other DIR` runs every row in a child process on the checkout in DIR
(another commit of this repository, unpacked there), before and after this
checkout's runs, and compares: K1's four outputs bit for bit on both
terrains, K3's and K-H's nonzero bins (and K-P's nonzero samples) exactly
and their values within rtol 1e-5 / atol 1e-12 (a checkout whose histogram
takes one row a call is given the rows one by one), K-P's and K-F's dBm
where finite (a checkout without
the kernels times its host loops under the same names), and every row's
digest of its outputs (`digest_equal_other`: K-P's dBm and signal, K-F's
dBm, ratio and spread, K3's IRs, K1's four outputs, the map engine's IRs
and its backward's segment gradients, the icosphere's record and IRs, K-B's
t and face and B11/ico's seven outputs, which must be bit_identical). Prints
one JSON object
and writes the whole record to `--out`; `card` is nvidia-smi's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "scripts")]
import chip_smoke as smoke  # noqa: E402  (the bench terrain and the coverage sweeps)
import torch_bench_large_mesh as large  # noqa: E402  (the large terrain)

SCENES = {
    "bench": dict(terrain=smoke.BENCH_TERRAIN, tx=smoke.TX, rx=smoke.RX, radius=smoke.RX_RADIUS),
    "large": dict(terrain=dict(grid=large.GRID, extent=large.EXTENT, seed=0), tx=large.TX,
                  rx=large.RX, radius=large.RX_RADIUS),
}
K2_RAYS = {"bench": (smoke.SUBSET, smoke.SOLVER_RAYS, smoke.GRAD_RAYS),
           "large": (large.N_PARITY, large.N_PERQUERY)}


def _ms(fn, reps):
    import torch

    return large.timed_ms(fn, torch.device("cuda", 0), reps, warm=True)


def _ms_held(fn, reps):
    """`_ms` after two untimed calls whose results are both held: each timed
    call runs while the last one's result is alive, and so finds two
    results' device memory cached instead of allocating in the timed loop."""
    first, second = fn(), fn()
    del first, second
    return _ms(fn, reps)


def _device_ops(fn, reps: int) -> dict:
    """The device's ms a call of `fn`, by kernel, memset or copy (the part of
    its name before the arguments), from torch.profiler's raw records, which
    hold the kernels launched through ctypes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if "CUDA" in str(e.device_type):
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            name = name.split("::")[-1].replace("void ", "").strip()
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


class Workloads:
    """The scenes, rays and segments, built once per process."""

    def __init__(self, dev):
        import torch

        from rfx_torch.bvh import build_bvh
        from rfx_torch.geometry import make_room, make_terrain
        from rfx_torch.ops.bvh_pack import pack_bvh

        self.dev = dev
        self.dirs = large.morton_dirs(smoke.N_RAYS, 0, dev)
        meshes = self.meshes = {name: make_terrain(**s["terrain"]) for name, s in SCENES.items()}
        self.bvh = {name: pack_bvh(build_bvh(mesh, leaf_size=large.LEAF), dev)
                    for name, mesh in meshes.items()}
        cov_meshes = {"room": make_room(), "terrain": meshes["bench"]}
        cov_dirs = large.morton_dirs(smoke.COV_RAYS, 0, dev)
        self.cov = {}
        for name, tx, zs in smoke.COV_SCENES:
            _, grid, _, scaled = smoke.coverage_workload(cov_meshes[name], tx, zs, cov_dirs, dev)
            self.cov[name] = (scaled, torch.as_tensor(grid, device=dev))
        self._solver = None
        self._ico = self._ico_room = None
        self._iid = {}
        torch.cuda.synchronize()

    def iid(self, n: int):
        """n i.i.d. directions drawn as the benchmark's CIR cells draw each
        of their sets (gpubench/harness/inputs.py:direction_pool, seed 0)."""
        from gpubench.harness.inputs import direction_pool

        if n not in self._iid:
            self._iid[n] = direction_pool(n, 1, 0, self.dev)[0]
        return self._iid[n]

    def solver(self):
        """chip_smoke.py phase 11's segments of tx and its 64 receivers."""
        import torch

        from rfx_torch.ops.bvh_trace import make_kernel_env_hit
        from rfx_torch.tracer import trace_env

        if self._solver is None:
            scene, dirs, centers = smoke.solver_inputs(self.meshes["bench"], self.dev)
            with torch.no_grad():
                segs = trace_env(scene, torch.tensor(smoke.TX, device=self.dev), dirs,
                                 max_bounces=smoke.BOUNCES,
                                 env_hit=make_kernel_env_hit(self.bvh["bench"]))
            self._solver = (segs, centers)
        return self._solver


@contextlib.contextmanager
def _order_from(rays: int):
    """Within it, the fused trace walks a launch in direction-cell order from
    `rays` rays up (2**31: every launch in the caller's order, as a checkout
    without the direction-cell order always does; 0: every launch ordered)."""
    from rfx_torch.ops import fused

    before = getattr(fused, "ORDER_MIN_RAYS", None)
    if before is not None:
        fused.ORDER_MIN_RAYS = rays
    try:
        yield
    finally:
        if before is not None:
            fused.ORDER_MIN_RAYS = before


CALLER = 2**31


@contextlib.contextmanager
def _lattice(bits: int):
    """Within it, the direction-cell order takes the lattice of `bits`."""
    from rfx_torch.ops import ray_order

    before = ray_order.cell_bits
    ray_order.cell_bits = lambda n: bits
    try:
        yield
    finally:
        ray_order.cell_bits = before


def run_k1(w: Workloads, reps: int, keep: dict) -> dict:
    """K1 on Morton rays (as before) and on the cells' i.i.d. rays, the
    latter in the checkout's own order (`iid_ms`) and in the caller's
    (`iid_caller_ms`), each with its digest; with the face record at the
    scan gradient's 2,621,440 i.i.d. rays the same two ways."""
    import torch

    from rfx_torch.ops.fused import fused_trace

    out = {}
    kw = dict(max_bounces=smoke.BOUNCES)
    iid = w.iid(smoke.N_RAYS)
    grad_iid = iid[:smoke.GRAD_RAYS].contiguous()
    for name, bvh in w.bvh.items():
        s = SCENES[name]
        args = (bvh, w.dirs, s["tx"], s["rx"], s["radius"], 5.0, 1.0)
        res, ms = _ms(lambda: fused_trace(*args, **kw), reps)
        (cres, stats), cms = _ms(lambda: fused_trace(*args, count_stats=True, **kw), reps)
        (fres, faces), fms = _ms(lambda: fused_trace(*args, record_faces=True, **kw), reps)
        with _order_from(CALLER):
            _, morton_caller_ms = _ms(lambda: fused_trace(*args, **kw), reps)
        out[name] = {"ms": ms, "counted_ms": cms, "record_faces_ms": fms,
                     "morton_caller_ms": morton_caller_ms,
                     "digest": _digest(res[:4]), "counted_digest": _digest(cres[:4]),
                     "faces_digest": _digest([*fres[:4], faces]),
                     "counters": stats.tolist(), "captured": int(res.captured.sum())}
        keep[f"k1_{name}"] = [t.cpu() for t in res[:4]]
        iargs = (bvh, iid, *args[2:])
        ires, out[name]["iid_ms"] = _ms(lambda: fused_trace(*iargs, **kw), reps)
        out[name]["iid_device_ms"] = _device_ops(lambda: fused_trace(*iargs, **kw), reps)
        with _order_from(CALLER):
            cres, out[name]["iid_caller_ms"] = _ms(lambda: fused_trace(*iargs, **kw), reps)
        out[name]["iid_digest"] = _digest(ires[:4])
        out[name]["iid_equal_caller"] = all(map(torch.equal, ires[:4], cres[:4]))
        keep[f"k1_{name}_iid"] = [t.cpu() for t in ires[:4]]
        gargs = (bvh, grad_iid, *args[2:])
        (gres, gfaces), out[name]["faces_iid_ms"] = _ms(
            lambda: fused_trace(*gargs, record_faces=True, **kw), reps)
        out[name]["faces_iid_device_ms"] = _device_ops(
            lambda: fused_trace(*gargs, record_faces=True, **kw), reps)
        with _order_from(CALLER):
            (cres, cfaces), out[name]["faces_iid_caller_ms"] = _ms(
                lambda: fused_trace(*gargs, record_faces=True, **kw), reps)
        out[name]["faces_iid_equal_caller"] = all(
            map(torch.equal, [*gres[:4], gfaces], [*cres[:4], cfaces]))
    return out


def run_k1i(w: Workloads, reps: int) -> dict:
    """K1 with the icosphere receiver (a checkout without it times only the
    scan tracer) on the bench terrain at the CIR cells' 5,242,880 i.i.d. rays
    in direction-cell order, radius 0.1 (the cells') and 1.0: the call
    (`ms`), each kernel's device time (`device_ms`), the call in the caller's
    order (`caller_ms`) and whether it gives the same bits, the analytic
    receiver's call and device times on the same rays, the bound
    (chip_smoke.py's `fused_ico_bound`), the plain version's time on the
    first 65,536 of the rays and whether the kernel equals it bit for bit
    (`plain_equal`), the scan tracer with the icosphere receiver (K2, K-B:
    what recorded paths run) on the same rays (`scan_ms`), and the facade's
    request (`compute_cir` without recorded paths, the histogram included)
    through each (`request_ms`, `scan_request_ms`)."""
    import torch

    from rfx_torch.api import Tracer
    from rfx_torch.ops import fused
    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.tracer import Scene, trace_to_rx

    bvh, s = w.bvh["bench"], SCENES["bench"]
    iid = w.iid(smoke.N_RAYS)
    sub = iid[:smoke.SUBSET].contiguous()
    kw = dict(max_bounces=smoke.BOUNCES)
    has_ico = hasattr(fused, "FUSED_TRACE_ICO_KERNEL")
    scene = Scene.from_mesh(w.meshes["bench"], w.dev)
    env_hit = make_kernel_env_hit(bvh)
    tracer = Tracer(w.meshes["bench"], smoke.C, smoke.RATE, smoke.WINDOW,
                    max_bounces=smoke.BOUNCES, tx_num_rays=smoke.N_RAYS, rx_mode="icosphere",
                    device=w.dev)
    out = {}
    for radius in (0.1, 1.0):
        args = (s["tx"], s["rx"], radius, 5.0, 1.0)
        row = out[f"r{radius:g}"] = {}

        def scan():
            return trace_to_rx(scene, s["tx"], iid, s["rx"], radius, rx_mode="icosphere",
                               env_hit=env_hit, **kw)

        with torch.no_grad():
            _, row["scan_ms"] = _ms(scan, reps)
            _, row["scan_request_ms"] = _ms(lambda: tracer._cir(scan(), 1.0).cpu(), reps)
        _, row["request_ms"] = _ms(lambda: tracer.compute_cir(
            s["tx"], 1.0, s["rx"], radius, directions=iid, record_paths=False), reps)
        if not has_ico:
            continue
        ico = dict(kw, rx_mode="icosphere")
        res, row["ms"] = _ms(lambda: fused.fused_trace(bvh, iid, *args, **ico), reps)
        row["device_ms"] = _device_ops(lambda: fused.fused_trace(bvh, iid, *args, **ico), reps)
        with _order_from(CALLER):
            cres, row["caller_ms"] = _ms(lambda: fused.fused_trace(bvh, iid, *args, **ico), reps)
        row["equal_caller"] = all(map(torch.equal, res[:4], cres[:4]))
        _, row["analytic_ms"] = _ms(lambda: fused.fused_trace(bvh, iid, *args, **kw), reps)
        row["analytic_device_ms"] = _device_ops(lambda: fused.fused_trace(bvh, iid, *args, **kw),
                                                reps)
        row["bound"] = smoke.fused_ico_bound(bvh, iid, s["tx"], s["rx"], radius)
        p, row["plain_ms"] = _ms(lambda: fused.fused_trace_plain(bvh, sub, *args, **ico), 1)
        k = fused.fused_trace(bvh, sub, *args, **ico)
        row["plain_equal"] = all(map(torch.equal, k[:4], p[:4]))
        row["captured"], row["digest"] = int(res.captured.sum()), _digest(res[:4])
    return out


def run_order(w: Workloads, reps: int) -> dict:
    """The direction-cell order (a checkout without it skips this row): the
    ordering kernels alone at the cells' 5,242,880 i.i.d. rays, on each
    lattice of 6 to 10 bits a side, with K1 on both terrains walking that
    lattice's order; `torch.argsort` of the same keys plus a gather of the
    directions as the yardstick (`library_ms`); and the crossover: on the
    bench terrain at 16,384 to 5,242,880 i.i.d. rays, K1 in the caller's order
    against the ordering kernels and K1 in cell order (`ordered_ms`)."""
    import torch

    try:
        from rfx_torch.ops import ray_order as ro
    except ImportError:
        return {}
    from rfx_torch.ops.fused import fused_trace

    kw = dict(max_bounces=smoke.BOUNCES)
    iid = w.iid(smoke.N_RAYS)
    n = iid.shape[0]
    out = {"rays": n, "default_bits": ro.cell_bits(n), "lattices": {}}
    lattices = range(ro.MIN_BITS, ro.MAX_BITS + 1)
    for bits in lattices:
        cells, ms = _ms(lambda: ro.ray_order(iid, bits), reps)
        plain = ro.cell_keys_plain(iid, bits)
        out["lattices"][bits] = {
            "order_ms": ms, "order_device_ms": _device_ops(lambda: ro.ray_order(iid, bits), reps),
            "keys_equal_plain": torch.equal(cells.keys, plain),
            "counts_equal_plain": torch.equal(cells.counts, torch.bincount(
                plain, minlength=1 << (2 * bits)).to(torch.int32)),
            "largest_cell": int(cells.counts.max()), "empty_cells": int((cells.counts == 0).sum())}
    for name, bvh in w.bvh.items():
        s = SCENES[name]

        def trace(bvh=bvh, s=s):
            return fused_trace(bvh, iid, s["tx"], s["rx"], s["radius"], 5.0, 1.0, **kw)

        for _ in range(3):  # rounds over the lattices, so that drift shows as spread
            for bits in lattices:
                with _lattice(bits):
                    out["lattices"][bits].setdefault(f"k1_{name}_ms", []).append(_ms(trace, reps)[1])
        for bits in lattices:
            with _lattice(bits):
                out["lattices"][bits][f"k1_{name}_device_ms"] = _device_ops(trace, reps)
    keys = ro.cell_keys_plain(iid, ro.cell_bits(n))
    _, out["library_ms"] = _ms(lambda: iid[torch.argsort(keys)], reps)
    out["bound_ms"] = 36 * n / smoke.PEAK_BYTES_PER_S * 1e3
    s = SCENES["bench"]
    cross = {}
    for m in (16_384, 65_536, 131_072, 262_144, 327_680, 393_216, 524_288, 786_432, 1_048_576,
              2_621_440, n):
        d = iid[:m].contiguous()

        def call(d=d):
            return fused_trace(w.bvh["bench"], d, s["tx"], s["rx"], s["radius"], 5.0, 1.0, **kw)

        row = cross[m] = {"bits": ro.cell_bits(m)}
        for _ in range(2):
            with _order_from(CALLER):
                row.setdefault("caller_ms", []).append(_ms(call, reps)[1])
            with _order_from(0):
                row.setdefault("ordered_ms", []).append(_ms(call, reps)[1])
        row["order_ms"] = _ms(lambda: ro.ray_order(d), reps)[1]
    out["crossover"] = cross
    return out


def _morton_order(o):
    """Order of (N, 3) points along a 30-bit Morton curve over their box."""
    import torch

    lo, hi = o.min(0).values, o.max(0).values
    q = ((o - lo) / (hi - lo + 1e-9) * 1023).long().clamp(0, 1023)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return torch.argsort(spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2))


def _k2_set(bvh, o, d, reps: int) -> dict:
    """Time one query set, and count it where the checkout has the counted
    entry point."""
    import inspect

    from rfx_torch.ops.bvh_trace import closest_hit

    (t, idx, _, _), ms = _ms(lambda: closest_hit(bvh, o, d), reps)
    out = {"queries": int(o.shape[0]), "ms": ms, "hits": int((t < 1e29).sum()),
           "digest": _digest([t, idx])}
    if "count" in inspect.signature(closest_hit).parameters:
        out.update(smoke.closest_hit_stats(bvh, o, d))
    return out


def run_k2(w: Workloads, reps: int) -> dict:
    import torch

    from rfx_torch.ops.bvh_trace import closest_hit
    from rfx_torch.ops.intersect import dot3

    out = {}
    for name, sizes in K2_RAYS.items():
        bvh, s = w.bvh[name], SCENES[name]
        for n in sizes:
            d = w.dirs[:: smoke.N_RAYS // n][:n].contiguous()
            o = torch.tensor(s["tx"], device=w.dev).expand(n, 3).contiguous()
            t, _, _, nrm = closest_hit(bvh, o, d)
            hit = t < 1e29
            parked = torch.full((), 1e9, device=w.dev)
            o2 = torch.where(hit[:, None], o + d * t[:, None], parked)
            d2 = d - 2.0 * dot3(d, nrm)[:, None] * nrm
            oc, dc = o2[hit].contiguous(), d2[hit].contiguous()
            out[f"{name}, {n} rays from tx"] = _k2_set(bvh, o, d, reps)
            out[f"{name}, {int(hit.sum())} second-bounce queries"] = _k2_set(bvh, oc, dc, reps)
            if n == smoke.SOLVER_RAYS:
                out[f"{name}, {n} second-bounce queries in place, misses parked"] = _k2_set(
                    bvh, o2.contiguous(), d2.contiguous(), reps)
                order = _morton_order(oc)
                out[f"{name}, {int(hit.sum())} second-bounce queries sorted by origin"] = _k2_set(
                    bvh, oc[order].contiguous(), dc[order].contiguous(), reps)
    return out


def run_k3(w: Workloads, reps: int, keep: dict) -> dict:
    import torch

    from rfx_torch.ops.coverage_hist import coverage_hist

    out = {}
    kw = dict(nbins=smoke.COV_BINS, light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE)
    for name, (segs, centers) in w.cov.items():
        irs, ms = _ms(lambda: coverage_hist(segs, centers, smoke.COV_RADIUS, **kw), reps)
        alone = coverage_hist(segs, centers[777:778], smoke.COV_RADIUS, **kw)
        out[name] = {"ms": ms, "digest": _digest([irs]), "nonzero": int((irs != 0).sum()),
                     "alone_equals_grouped": bool(torch.equal(alone[0], irs[777])),
                     "live_segments": int(segs.alive.sum())}
        keep[f"k3_{name}"] = irs.cpu()
    return out


def _rows_fn(cir, fn):
    """`fn` (bin_impulse_response or histogram_plain) over (R, n) rows; a
    checkout whose histogram takes one row a call gets them one by one."""
    import torch

    if hasattr(cir, "mask_tiles"):
        return fn
    return lambda amp, dist, cap, **kw: torch.stack(
        [fn(a, d, c, **kw) for a, d, c in zip(amp, dist, cap)])


def run_kh(w: Workloads, reps: int, keep: dict) -> dict:
    import torch

    from rfx_torch import cir
    from rfx_torch.coverage import _amp_scale, _first_capture, make_grid
    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.ops.fused import fused_trace
    from rfx_torch.tracer import Scene, trace_env
    import numpy as np

    nbins = smoke.NBINS
    kw = dict(nbins=nbins, light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE)
    zero = torch.zeros((), device=w.dev)
    r = fused_trace(w.bvh["bench"], w.dirs, smoke.TX, smoke.RX, smoke.RX_RADIUS, 5.0, 1.0,
                    max_bounces=smoke.BOUNCES)
    shapes = {"forward": (r.amplitude[None] * (1.0 / smoke.N_RAYS), r.distance[None],
                          r.captured[None])}
    # The inverse solve's dense rows (chip_smoke.py phase 11), as the plain
    # map engine writes them: bounces and rays flattened, one row a receiver.
    n = smoke.SOLVER_RAYS
    mesh = w.meshes["bench"]
    scene = Scene.from_mesh(mesh, w.dev)
    segs = trace_env(scene, smoke.TX, large.morton_dirs(n, 1, w.dev), max_bounces=smoke.BOUNCES,
                     env_hit=make_kernel_env_hit(w.bvh["bench"]))
    axis = np.linspace(-20.0, 20.0, 8)
    centers = torch.as_tensor(make_grid(axis, axis, [8.0]), device=w.dev)
    t_rx, first = _first_capture(segs, centers, 1.0, "analytic")
    rows = centers.shape[0]
    amp = (torch.where(first, segs.amplitude, zero) * _amp_scale(1.0, n, w.dev)).reshape(rows, -1)
    dist = torch.where(first, segs.distance + t_rx, zero).reshape(rows, -1)
    first = first.reshape(rows, -1)
    del t_rx, segs
    lit = int(first.sum(dim=1).argmax())
    shapes["solver, one receiver"] = (amp[lit:lit + 1], dist[lit:lit + 1], first[lit:lit + 1])
    shapes[f"solver, {rows} receivers"] = (amp, dist, first)

    out = {}
    bin_rows = _rows_fn(cir, cir.bin_impulse_response)
    plain_rows = _rows_fn(cir, cir.histogram_plain)
    for name, (a, d, c) in shapes.items():
        res = {"rows": a.shape[0], "entries_per_row": a.shape[1], "captured": int(c.sum())}
        for soft in (False, True):
            tag = "soft" if soft else "hard"
            ir, res[f"{tag}_ms"] = _ms(lambda: bin_rows(a, d, c, soft=soft, **kw), reps)
            res[f"{tag}_device_ms"] = smoke.device_ms(lambda: bin_rows(a, d, c, soft=soft, **kw), reps)
            again = bin_rows(a, d, c, soft=soft, **kw)
            res[f"{tag}_run_to_run_equal"] = bool(torch.equal(ir, again))
            res[f"{tag}_digest"] = _digest([ir])
            keep[f"kh_{name}_{tag}"] = ir.cpu()
        for tag, modes in (("hard", (cir.HARD,)), ("soft", (cir.SOFT_LO, cir.SOFT_HI))):
            _, res[f"{tag}_plain_ms"] = _ms(
                lambda: sum(plain_rows(a, d, c, mode=m, **kw) for m in modes), max(1, reps // 5))
        # The library's call for the same sums: `index_add_` on ready-made
        # flat bins and masked weights (hard mode), not deterministic.
        raw = (d / torch.tensor(smoke.C, device=w.dev) * torch.tensor(smoke.RATE, device=w.dev)).long()
        weight = torch.where(c & (raw >= 0) & (raw < nbins), a, zero).reshape(-1)
        key = (raw.clamp_(0, nbins - 1)
               + nbins * torch.arange(a.shape[0], device=w.dev)[:, None]).reshape(-1)
        _, res["index_add_ms"] = _ms(
            lambda: torch.zeros(a.shape[0] * nbins, device=w.dev).index_add_(0, key, weight), reps)
        del raw, weight, key
        res["bounds_hard"] = smoke.histogram_bounds(c, nbins, planes=1)
        res["bounds_soft"] = smoke.histogram_bounds(c, nbins, planes=2)
        out[name] = res
    return out


def _power_irs(w: Workloads, keep: dict) -> dict:
    """(IRs, window) of K-P's rows: K3's IRs of the coverage sweeps (kept by
    run_k3) and the bench workload's IR, all on the card."""
    import torch

    from rfx_torch import cir
    from rfx_torch.ops.fused import fused_trace

    r = fused_trace(w.bvh["bench"], w.dirs, smoke.TX, smoke.RX, smoke.RX_RADIUS, 5.0, 1.0,
                    max_bounces=smoke.BOUNCES)
    ir = cir.bin_impulse_response(r.amplitude * (torch.tensor(1.0) / smoke.N_RAYS).to(w.dev),
                                  r.distance, r.captured, nbins=smoke.NBINS,
                                  light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE)
    out = {name: (keep[f"k3_{name}"].to(w.dev), smoke.COV_WINDOW) for name in w.cov}
    out["bench IR"] = (ir, smoke.WINDOW)
    return out


def run_kp(w: Workloads, reps: int, keep: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from rfx_torch import cir

    kernel = hasattr(cir, "rx_power_dbm_plain")  # else a checkout whose rx_power_dbm loops on the host
    out = {}
    for name, (irs, window) in _power_irs(w, keep).items():
        (dbm, sig), ms = _ms(lambda: cir.rx_power_dbm(irs, window),
                             reps if kernel or irs.ndim == 1 else 2)
        res = {"ms": ms, "nonzero_bins": int((irs != 0).sum()), "digest": _digest([dbm, sig])}
        keep[f"kp_{name}"] = dbm.reshape(-1).cpu()
        keep[f"kpsignal_{name}"] = sig.cpu()
        if kernel:
            res["device_ms"] = smoke.device_ms(lambda: cir.rx_power_dbm(irs, window), reps)
            _, res["plain_ms"] = _ms(lambda: cir.rx_power_dbm_plain(irs, window), 1)
            rows = irs.reshape(-1, irs.shape[-1])
            nbins = rows.shape[1]
            flipped = cir._carrier(nbins, window, 2.4e9, w.dev).flip(0)[None, None]
            hi = nbins - 1 - (nbins - 1) // 2
            _, res["library_ms"] = _ms(
                lambda: F.conv1d(rows[:, None], flipped, padding=hi)[:, 0, :nbins], 3)
            res["taps"] = smoke.rx_power_taps(rows)
            res["bound"] = smoke._bound(8 * rows.numel() + 4 * nbins + 4 * rows.shape[0],
                                        2 * res["taps"])
        out[name] = res
        torch.cuda.empty_cache()
    return out


def run_kf(w: Workloads, reps: int, keep: dict) -> dict:
    from rfx_torch import coverage

    kw = dict(num_rays=1, sample_window_s=smoke.COV_WINDOW, sample_rate_hz=smoke.RATE,
              carrier_hz=2.4e9, light_speed_mps=smoke.C, tx_power=1.0, rx_batch=64)
    out = {}
    for name, (segs, centers) in w.cov.items():
        def call():  # the amplitude is scaled already: tx_power / num_rays = 1
            return coverage._dbm_cancel_from_segments(segs, centers, smoke.COV_RADIUS, **kw)

        kernel = hasattr(coverage, "_dbm_cancel_plain")  # else the plain sweep is the call
        res_out, ms = _ms(call, reps if kernel else 1)
        res = {"ms": ms, "digest": _digest(res_out)}
        keep[f"kf_{name}"] = res_out[0].cpu()
        if kernel:
            _, res["plain_ms"] = _ms(
                lambda: coverage._dbm_cancel_plain(segs, centers, smoke.COV_RADIUS, **kw), 1)
            seg_bytes = sum(int(t.numel() * t.element_size()) for t in segs)
            m = centers.shape[0]
            res["bound"] = smoke._bound(seg_bytes + 12 * m + 12 * m,
                                        17 * m * int(segs.alive.sum()))
        out[name] = res
    return out


def run_kpb(w: Workloads, reps: int, keep: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from rfx_torch import cir

    if not hasattr(cir, "rx_power_backward"):
        return {}
    out = {}
    for name, (irs, window) in _power_irs(w, keep).items():
        rows = irs.reshape(-1, irs.shape[-1])
        m, nbins = rows.shape
        kern = cir.carrier_cached(nbins, window, 2.4e9, w.dev)
        sig, _, sums = cir._rx_power_launch(rows, kern)
        g_dbm = torch.ones(m, dtype=torch.float32, device=w.dev)
        g_ir, ms = _ms(lambda: cir.rx_power_backward(g_dbm, None, sig, sums, window), reps)
        pick = torch.linspace(0, m - 1, min(m, 16), device=w.dev).round().long().unique()
        _, plain_ms = _ms(lambda: cir.rx_power_backward_plain(g_dbm[pick], None, sig[pick],
                                                              sums[pick], kern), 1)
        g_eff = cir._effective_cotangent(g_dbm, None, sig, sums)
        lo, hi = (nbins - 1) // 2, nbins - 1 - (nbins - 1) // 2
        _, lib_ms = _ms(lambda: F.conv1d(F.pad(g_eff[:, None], (lo, hi)), kern[None, None]), 3)
        taps = smoke.rx_power_taps(g_eff, lo=hi)
        out[name] = {"ms": ms, "digest": _digest([g_ir]), "plain_ms": plain_ms,
                     "plain_rows": int(pick.numel()), "library_ms": lib_ms, "taps": taps,
                     # On many rows the call is device-bound and the
                     # profiler's window dropped kernel records: CUDA events.
                     "device_ms": smoke.device_ms(
                         lambda: cir.rx_power_backward(g_dbm, None, sig, sums, window), reps)
                     if m == 1 else None,
                     "bound": smoke._bound(8 * rows.numel() + 12 * m + 4 * nbins, 2 * taps)}
        del sig, sums, g_ir, g_eff
        torch.cuda.empty_cache()
    return out


def run_kfb(w: Workloads, reps: int, keep: dict) -> dict:
    import torch

    from rfx_torch.ops import coverage_hist as ch

    if not hasattr(ch, "phasor_backward"):
        return {}
    kw = dict(nbins=smoke.COV_BINS, light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE,
              sample_window_s=smoke.COV_WINDOW, carrier_hz=2.4e9)
    out = {}
    for name, (segs, centers) in w.cov.items():
        sums, _ = ch._phasor_sums(segs, centers, smoke.COV_RADIUS, **kw)
        spread = ch.coverage_phasor(segs, centers, smoke.COV_RADIUS, **kw)[2]
        coef = ch.phasor_coefficients(sums, spread, torch.ones(centers.shape[0], device=w.dev))
        g, ms = _ms(lambda: ch.phasor_backward(segs, centers, smoke.COV_RADIUS, coef, **kw), reps)
        _, plain_ms = _ms(lambda: ch.phasor_backward_plain(segs, centers, smoke.COV_RADIUS, coef,
                                                           **kw), 1)
        seg_bytes = sum(int(t.numel() * t.element_size()) for t in segs)
        m = centers.shape[0]
        out[name] = {"ms": ms, "digest": _digest([g]), "plain_ms": plain_ms,
                     "bound": smoke._bound(seg_bytes + 44 * m + 4 * segs.t_env.numel(),
                                           17 * m * int(segs.alive.sum()))}
    return out


def _map_kw(soft: bool) -> dict:
    import torch

    from rfx_torch.coverage import _amp_scale

    return dict(scale=float(_amp_scale(1.0, smoke.SOLVER_RAYS, torch.device("cpu"))), soft=soft,
                nbins=smoke.NBINS, light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE)


def run_ks(w: Workloads, reps: int, keep: dict) -> dict:
    try:
        from rfx_torch.ops import map_capture as mc
    except ImportError:
        return {}
    segs, centers = w.solver()
    out = {}
    for soft in (False, True):
        tag = "soft" if soft else "hard"
        kw = _map_kw(soft)
        irs, ms = _ms_held(lambda: mc.map_irs(segs, centers, 1.0, **kw), reps)
        out[tag] = {"ms": ms, "digest": _digest([irs]), "nonzero": int((irs != 0).sum()),
                    "device_ms": smoke.device_ms(lambda: mc.map_irs(segs, centers, 1.0, **kw), reps)}
        keep[f"ks_{tag}"] = irs.cpu()
    if hasattr(mc, "map_record"):
        _, out["capture_pass_ms"] = _ms_held(lambda: mc.map_record(segs, centers, 1.0), reps)
    else:  # a checkout whose capture pass writes the dense rows
        _, out["capture_pass_ms"] = _ms_held(
            lambda: mc.map_capture(segs, centers, 1.0, _map_kw(True)["scale"]), reps)
    return out


def run_ksb(w: Workloads, reps: int, keep: dict) -> dict:
    import inspect

    import numpy as np
    import torch

    try:
        from rfx_torch.ops import map_capture as mc
    except ImportError:
        return {}
    segs, centers = w.solver()
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(centers.shape[0], smoke.NBINS)).astype(np.float32)).to(w.dev)
    extra = ()
    if "record" in inspect.signature(mc.map_capture_backward).parameters:
        extra = (mc.map_record(segs, centers, 1.0),)
    kw = _map_kw(True)

    def call(full):
        return lambda: mc.map_capture_backward(segs, centers, 1.0, g, *extra, centers_grad=full,
                                               scalars_grad=full, **kw)

    grads, ms = _ms_held(call(False), reps)
    full, full_ms = _ms_held(call(True), reps)
    for name, t in zip(("origin", "direction", "amplitude", "distance"), grads[:4]):
        keep[f"ksb_{name}"] = t.cpu()
    for name, t in zip(("centers", "scale", "radius"), full[4:]):
        keep[f"ksb_{name}"] = t.reshape(-1).cpu()
    return {"segments": {"ms": ms, "digest": _digest(grads[:4]),
                         "device_ms": smoke.device_ms(call(False), reps)},
            "all": {"ms": full_ms, "digest": _digest(full[4:]),
                    "device_ms": smoke.device_ms(call(True), reps)}}


def _ico_inputs(w: Workloads) -> dict:
    """{scene: (segments, the first 64 receivers)} of phase 17's icosphere
    sweeps (chip_smoke.icosphere_workload), built once; `w._ico_room` keeps
    the room's scene and its (2,048, 3) receiver grid on the card."""
    import torch

    from rfx_torch.geometry import make_room

    if w._ico is None:
        dirs = smoke.icosphere_dirs(w.dev)
        meshes = {"room": make_room(), "terrain": w.meshes["bench"]}
        w._ico = {}
        for name, tx, zs in smoke.COV_SCENES:
            tracer, grid, segs, few = smoke.icosphere_workload(meshes[name], tx, zs, dirs, w.dev)
            w._ico[name] = (segs, few)
            if name == "room":
                w._ico_room = (tracer.scene, torch.as_tensor(grid, device=w.dev))
    return w._ico


def _ico_record_call(mc, segs, few):
    """K-S/ico's call on this checkout: (a function that launches it and
    returns the record first, the record entry/ico's extra keywords given
    what it returned). A checkout whose kernels read the receivers' faces
    gets them made once, outside the timed calls."""
    import inspect

    from rfx_torch.ops.intersect import icosphere_tris

    if "t_first" in inspect.signature(mc.map_record).parameters:
        return (lambda: mc.map_record(segs, few, smoke.COV_RADIUS, "icosphere", t_first=True),
                lambda got: {"t_first": got[1]})
    tris = icosphere_tris(few, smoke.COV_RADIUS).contiguous()
    return (lambda: (mc.map_record(segs, few, smoke.COV_RADIUS, "icosphere", tris),),
            lambda got: {"tris": tris})


def run_ksi(w: Workloads, reps: int, keep: dict) -> dict:
    from rfx_torch.ops import map_capture as mc

    if not hasattr(mc, "MAP_CAPTURE_ICO_KERNEL"):
        return {}
    out = {}
    for name, (segs, few) in _ico_inputs(w).items():
        call, extra = _ico_record_call(mc, segs, few)
        got = call()
        record = got[0]
        captured = record != mc.NO_CAPTURE
        keep[f"ksi_{name}"] = record.cpu()
        live = int(segs.alive.sum())
        passes = smoke._cull_passes(segs.origin[segs.alive], segs.direction[segs.alive], few,
                                    smoke.COV_RADIUS)
        out[name] = {"ms": _ms_held(call, reps)[1], "queued_ms": smoke.queued_ms(call, 20),
                     "digest": _digest([record]), "captured": int(captured.sum()),
                     "writes_t_first": "t_first" in extra(got), "live_segments": live,
                     "cull_passes": passes,
                     "bound": smoke.ico_capture_bound(segs.t_env.numel(), live, passes,
                                                      int(captured.sum()))}
    return out


def run_khi(w: Workloads, reps: int, keep: dict) -> dict:
    import torch

    from rfx_torch import cir
    from rfx_torch.coverage import _amp_scale
    from rfx_torch.ops import map_capture as mc

    if not hasattr(mc, "MAP_CAPTURE_ICO_KERNEL"):
        return {}
    scale = float(_amp_scale(1.0, smoke.COV_RAYS, torch.device("cpu")))
    hkw = dict(nbins=smoke.COV_BINS, light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE,
               rx_mode="icosphere")
    out = {}
    for name, (segs, few) in _ico_inputs(w).items():
        call, extra_of = _ico_record_call(mc, segs, few)
        got = call()
        record, extra = got[0], extra_of(got)
        captured = int((record != mc.NO_CAPTURE).sum())
        out[name] = {"captured": captured}
        for soft in (False, True):
            tag = "soft" if soft else "hard"

            def entry(soft=soft):
                return cir.histogram_record(record, segs, few, smoke.COV_RADIUS, scale, soft=soft,
                                            **extra, **hkw)

            irs, ms = _ms_held(entry, reps)
            keep[f"khi_{name}_{tag}"] = irs.cpu()
            out[name][tag] = {"ms": ms, "queued_ms": smoke.queued_ms(entry, 20),
                              "digest": _digest([irs]),
                              "bound": smoke.ico_entry_bound(captured, 2 if soft else 1)}
    return out


def run_kb(w: Workloads, reps: int, keep: dict) -> dict:
    from rfx_torch.ops import intersect

    if not hasattr(intersect, "BRUTE_HIT_KERNEL"):
        return {}
    room_segs = _ico_inputs(w)["room"][0]
    cases = {"request": smoke.brute_request_inputs(w.dirs),
             "room_env": smoke.brute_env_inputs(w._ico_room[0], room_segs)}
    out = {}
    for name, (o, d, v0, e1, e2, cull) in cases.items():
        def call(o=o, d=d, v0=v0, e1=e1, e2=e2, cull=cull):
            return intersect.brute_hit(o, d, v0, e1, e2, cull=cull)

        t, face = call()
        keep[f"kb_{name}_t"], keep[f"kb_{name}_face"] = t.cpu(), face.cpu()
        n = int(o.shape[0])
        passes = n if cull is None else int(intersect.cull_pass(o, d, cull).sum())
        out[name] = {"ms": _ms(call, reps)[1], "queued_ms": smoke.queued_ms(call, 20),
                     "digest": _digest([t, face]), "queries": n, "faces": int(v0.shape[0]),
                     "cull_passes": passes, "hits": int((face >= 0).sum()),
                     "bound": smoke._brute_bound(n, passes, int(v0.shape[0]), cull is not None)}
    return out


def run_ksbi(w: Workloads, reps: int, keep: dict) -> dict:
    import inspect

    from rfx_torch.ops import map_capture as mc
    from rfx_torch.ops.intersect import icosphere_tris

    if not hasattr(mc, "MAP_CAPTURE_BACKWARD_ICO_KERNEL"):
        return {}
    segs = _ico_inputs(w)["room"][0]
    few = smoke.ico_grad_receivers(w._ico_room[1])
    record, g, bkw = smoke.ico_backward_inputs(segs, few)
    if "tris" in inspect.signature(mc.map_capture_backward).parameters:
        bkw["tris"] = icosphere_tris(few, smoke.COV_RADIUS).contiguous()

    def call(full):
        return lambda: mc.map_capture_backward(segs, few, smoke.COV_RADIUS, g, record,
                                               centers_grad=full, scalars_grad=full, **bkw)

    captured = int((record != mc.NO_CAPTURE).sum())
    out = {"captured": captured,
           "bound": smoke.ico_backward_bound(segs.t_env.numel(), captured)}
    names = ("origin", "direction", "amplitude", "distance", "centers", "scale", "radius")
    for tag, full in (("segments", False), ("all", True)):
        got, ms = _ms_held(call(full), reps)
        outs = got if full else got[:4]
        for name, t in zip(names, outs):
            keep[f"ksbi_{tag}_{name}"] = t.reshape(-1).cpu()
        out[tag] = {"ms": ms, "queued_ms": smoke.queued_ms(call(full), 20),
                    "digest": _digest(outs)}
    return out


ROWS = ("k1", "k1i", "order", "k2", "k3", "kh", "kp", "kf", "kpb", "kfb", "ks", "ksb", "ksi",
        "khi", "kb", "ksbi")
KS_ROWS = ("ks", "ksb", "ksi", "khi", "kb", "ksbi")  # printed whole


def _run_all(w: Workloads, reps: int, keep: dict, only=ROWS) -> dict:
    """The rows named in `only` (K-P's rows and its backward's take K3's IRs:
    "kp" and "kpb" run "k3")."""
    runs = {"k1": lambda: run_k1(w, reps, keep), "k1i": lambda: run_k1i(w, reps),
            "order": lambda: run_order(w, reps),
            "k2": lambda: run_k2(w, reps),
            "k3": lambda: run_k3(w, reps, keep), "kh": lambda: run_kh(w, reps, keep),
            "kp": lambda: run_kp(w, reps, keep), "kf": lambda: run_kf(w, reps, keep),
            "kpb": lambda: run_kpb(w, reps, keep), "kfb": lambda: run_kfb(w, reps, keep),
            "ks": lambda: run_ks(w, reps, keep), "ksb": lambda: run_ksb(w, reps, keep),
            "ksi": lambda: run_ksi(w, reps, keep), "khi": lambda: run_khi(w, reps, keep),
            "kb": lambda: run_kb(w, reps, keep), "ksbi": lambda: run_ksbi(w, reps, keep)}
    only = set(only) | ({"k3"} if {"kp", "kpb"} & set(only) else set())
    return {row: runs[row]() for row in ROWS if row in only}


def child(args) -> int:
    """Run every row on the checkout at --root; save times and outputs."""
    import torch

    sys.path.insert(0, args.root)
    import rfx_torch

    if os.path.realpath(os.path.dirname(rfx_torch.__file__)) != os.path.realpath(
            os.path.join(args.root, "rfx_torch")):
        raise AssertionError(f"imported rfx_torch from {rfx_torch.__file__}, not from {args.root}")
    w = Workloads(torch.device("cuda", 0))
    keep = {}
    out = _run_all(w, args.reps, keep, args.only)
    torch.save({"times": out, "outputs": keep}, args.dump)
    return 0


def _run_other(root_other: str, reps: int, only) -> dict:
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "other.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--root", root_other,
                        "--dump", dump, "--reps", str(reps), "--only", ",".join(only)],
                       check=True, cwd=HERE, timeout=1500)
        return torch.load(dump)


def _compare(mine: dict, other: dict) -> dict:
    import torch

    out = {}
    for key, theirs in other.items():
        ours = mine[key]
        if key.startswith(("ksi_", "khi_", "kb_", "ksbi_")):  # the same bits
            out[key] = {"bit_identical": bool(torch.equal(ours, theirs))}
        elif key.startswith("k1_"):
            out[key] = {name: bool(torch.equal(a, b)) for name, a, b in zip(
                ("captured", "amplitude", "distance", "num_bounces"), ours, theirs)}
        elif key.startswith(("kp_", "kf_")):  # dBm, -inf where nothing arrived
            fin = torch.isfinite(theirs)
            out[key] = {"same_finite": bool(torch.equal(torch.isfinite(ours), fin)),
                        "bit_identical": bool(torch.equal(ours, theirs)),
                        "max_abs_diff_db": float((ours[fin] - theirs[fin]).abs().max())}
        else:  # K3's IRs, K-H's and K-P's signal
            out[key] = {"same_nonzero_bins": bool(torch.equal(ours != 0, theirs != 0)),
                        "allclose_rtol_1e-5": bool(torch.allclose(ours, theirs, rtol=1e-5, atol=1e-12)),
                        "bit_identical": bool(torch.equal(ours, theirs)),
                        "max_abs_diff": float((ours - theirs).abs().max())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of this repository to compare with")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", type=lambda v: tuple(v.split(",")), default=ROWS,
                    help=f"rows to run, comma-separated, of {','.join(ROWS)}")
    ap.add_argument("--out", default="build/bench_kernels.json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.child:
        return child(args)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": card, "torch": torch.__version__, "reps": args.reps}
    t0 = time.perf_counter()
    if args.other:
        other = _run_other(os.path.abspath(args.other), args.reps, args.only)
        out["other_first"] = other["times"]
    w = Workloads(torch.device("cuda", 0))
    keep = {}
    out["here"] = _run_all(w, args.reps, keep, args.only)
    if args.other:
        out["here_vs_other"] = _compare(keep, other["outputs"])
        out["other_last"] = _run_other(os.path.abspath(args.other), args.reps, args.only)["times"]
    out["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)

    def brief(r):
        return {k: {s: v["ms"] for s, v in r[k].items() if isinstance(v, dict)} for k in r
                if k in ("k1", "k2", "k3", "kp", "kf", "kpb", "kfb", "ks", "ksb")}

    def kh(r):
        return {s: {k: v for k, v in t.items() if not k.endswith("digest")}
                for s, t in r.get("kh", {}).items()}

    def digests(mine, theirs):
        return {k: {s: t.get("digest") == theirs.get(k, {}).get(s, {}).get("digest")
                    for s, t in mine[k].items() if isinstance(t, dict)}
                for k in ("k1", "k3", "kp", "kf", "kpb", "kfb", "ks", "ksb") if k in mine}

    def ico_digests(mine, theirs):
        same = {}
        for scene, v in mine.get("ksi", {}).items():
            same[f"ksi_{scene}"] = v["digest"] == theirs.get("ksi", {}).get(scene, {}).get("digest")
        for scene, v in mine.get("khi", {}).items():
            for tag in ("hard", "soft"):
                same[f"khi_{scene}_{tag}"] = v[tag]["digest"] == theirs.get("khi", {}).get(
                    scene, {}).get(tag, {}).get("digest")
        for row, tags in (("kb", ("request", "room_env")), ("ksbi", ("segments", "all"))):
            for tag in tags:
                if tag in mine.get(row, {}):
                    same[f"{row}_{tag}"] = mine[row][tag]["digest"] == theirs.get(row, {}).get(
                        tag, {}).get("digest")
        return same

    print(json.dumps({"card": card, "here": brief(out["here"]), "kh": kh(out["here"]),
                      "digest_equal_other": digests(out["here"], out.get("other_first", {})),
                      "ico_digest_equal_other": ico_digests(out["here"],
                                                            out.get("other_first", {})),
                      "kh_other_first": kh(out.get("other_first", {})),
                      "kh_other_last": kh(out.get("other_last", {})),
                      "k2_walks": {s: {k: v for k, v in t.items() if k not in ("ms", "digest")}
                                   for s, t in out["here"].get("k2", {}).items()},
                      "k1_counted_ms": {s: v["counted_ms"]
                                        for s, v in out["here"].get("k1", {}).items()},
                      "k1_iid": {s: {k: v for k, v in t.items() if k.startswith(("iid", "faces_iid",
                                                                                 "morton"))}
                                 for s, t in out["here"].get("k1", {}).items()},
                      "order": out["here"].get("order"),
                      "k1i": out["here"].get("k1i"), "k1i_other": out.get("other_first", {}).get(
                          "k1i"),
                      "kp_kf": {k: {s: {f: v for f, v in t.items() if f != "digest"}
                                    for s, t in out["here"].get(k, {}).items()}
                                for k in ("kp", "kf", "kpb", "kfb")},
                      "ks": {k: out["here"].get(k) for k in KS_ROWS},
                      "ks_other_first": {k: out.get("other_first", {}).get(k) for k in KS_ROWS},
                      "ks_other_last": {k: out.get("other_last", {}).get(k) for k in KS_ROWS},
                      "other_first": brief(out.get("other_first", {})),
                      "other_last": brief(out.get("other_last", {})),
                      "vs_other": out.get("here_vs_other"), "seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
