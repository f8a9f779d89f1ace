#!/usr/bin/env python3
"""Drive the PyTorch port's forward CIR path, its gradient path, its coverage
path and its large-mesh path once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize() so a fault shows where it
happened, and none catching its own failure:

1. the card's name and power limit (nvidia-smi);
2. build the nine CUDA sources of rfx_torch/csrc/ (twenty-three C entry
   points that launch kernels: the fused trace, its icosphere and its
   counted instantiations share a source, so do the closest hit and its counted
   instantiation, the coverage histogram, its slab reduction and the phasor
   metric's table, walk, spread and backward, the RX power and its
   backward, the IR histogram and its record entries, and the map engine's
   capture pass and its backward, each of these last three also
   instantiated for the icosphere receiver; the brute closest hit and the
   rays' direction-cell order have their own) and the native C++ BVH
   builder into build/rfx_torch/, one compiler
   each, all started together;
3. the bench workload (bench.py): make_terrain(grid=128, extent=60, seed=0),
   32,258 triangles, 5,242,880 Morton-ordered rays, 4 bounces, a 20,000-bin
   IR, tx (10, 0, 25), rx (-10, 0, 8), rx radius 1.0;
4. the fused-trace kernel against its plain PyTorch version on 65,536 of
   those rays (every 80th): identical capture masks and bounce counts,
   amplitude within rtol 2e-5 / atol 1e-7, distance within rtol 1e-5 /
   atol 1e-4 (tests/test_fused.py:15-26); then the direction-cell order
   (rfx_ray_order) of 5,242,880 i.i.d. and of the Morton rays against its
   plain version (the same keys and cell counts, an order that is a
   permutation with `rank` its inverse, the keys along it the plain stable
   sort's), timed beside the plain version, argsort with a gather and its
   bound; the fused trace in cell order against its plain version on the
   first ORDER_MIN_RAYS i.i.d. rays, the smallest launch it orders (the same
   bars, the face record identical), and at 5,242,880 i.i.d. and Morton rays
   (the face record at 2,621,440) the same bits as the caller's order;
5. the IR histogram kernel against its plain version on the full trace's
   outputs (rtol 1e-4, atol 1e-9, the same nonzero bins), hard and soft, and
   bit-identical across two runs, beside `index_add_`, `bincount` and two
   bounds (every input read once; the bytes this run's captures need);
6. the forward path: rfx_torch.api.Tracer(...).compute_cir answers three
   requests, the tx raised by 1 m each time, and rx_power_dbm reads each IR
   through the RX-power kernel. The launch counts are reset just before and
   must be > 0 after, the order's one a request as the fused trace's; the
   first IR must equal phase 5's bit for bit. Then the RX-power kernel against
   its plain version on that IR (20,000 bins: the same nonzero samples, the
   signal within rtol 1e-5 and an absolute floor of 1e-5 of its largest
   sample, dBm within 1e-4 dB, two runs the same bits), beside conv1d; and its
   backward with g_dbm = 1 against its plain version (rtol 1e-4, an absolute
   floor of 1e-5 of the largest entry, two runs the same bits, the same bits
   as the IR's row in a 64-row batch: the lone IR's launch is split over its
   segments, the batch's is not), beside conv1d of the effective cotangent;
7. the per-query closest-hit kernel against its plain version on the bench
   scene: the 65,536 rays of phase 4 from tx, their reflected second-bounce
   queries from the terrain, and 1,024 parked rays; identical t, indices,
   faces and normals; the first two sets again with a live triangle table
   (`live_tri`, the differentiable-tris route's repack); then the counted
   entry point on the first two sets against the plain walk: the same hits,
   counters integer for integer, and from them each set's bound, the mean
   and the maximum of the nodes a query visits and the per-warp maximum;
8. the fused-trace kernel's face record against its plain version on the
   phase-4 rays: identical face tables (and an unchanged trace);
9. the gradient path at scripts/bench_gradients.py's width (2,621,440 Morton
   rays, 4 bounces, 20,000 soft bins, loss sum(ir^2) * 1e12): d loss / d tx
   through the scan tracer on the closest-hit kernel and through the
   differentiable fused tracer; both finite and nonzero, capture flips
   between them <= max(4, N/500), relative gradient difference < 0.06
   (that script's bars, :95-112); CUDA-event times and peak memory;
10. the gradient checks of tests/test_tpu_compiled.py:170-376 on the card:
    room vertex FD through differentiable-tris closest hit (8%), room tx FD
    on a linear loss (8%), room soft-IR tx gradient kernel vs brute (3%),
    terrain n1 FD (5%), differentiable-tris vs baked n1 (2%), terrain vertex
    gradient differentiable-tris vs the brute intersector's backward (2% of
    the norm);
11. the inverse solve: first three steps in the room of
    tests/test_torch_solver.py, where the parameters move, on the card
    through the closest-hit kernel, each held against the same step on the
    CPU through its plain version from the card's parameters and Adam state:
    loss and gradients within rtol 1e-4, updated parameters within atol
    1e-5; then, at full width, the histogram kernel on the planes the map
    engine hands it (64 rows x 4,194,304 entries in one launch, and one row)
    against its plain version, hard and soft: the same nonzero bins, rtol
    1e-5, bit-identical across runs, a row alone == the row in the batch ==
    the CPU's plain version; then the map engine's capture kernel (K-S) and
    its backward at that shape against their plain versions on the segments
    of tx: the capture rows bit for bit, the IRs (soft) the plain map
    engine's bits, the backward for a seeded (64, 20,000) cotangent within
    rtol 1e-5 of its plain version (an absolute floor of 1e-6 of the
    largest entry), the centers' gradient too, each the same bits in two
    runs, with their times and bounds; then five steps at full width: the
    terrain, 1,048,576 Morton rays, 4 bounces, 64 receivers on an 8x8 grid
    at z = 8 over x, y in [-20, 20], radius 1.0, 20,000 bins at 100 GHz,
    target energies from tx (10, 0, 25), start (12, -2, 26), lr 0.05: finite
    losses, finite nonzero gradients, time per step and peak memory (printed
    with the card's name and power limit), at most 10 histogram launches in
    the five steps, one launch of K-S and of its backward a step, and no
    call of the plain first-capture composition;
12. the facade: compute_cir(record_paths=True) at 262,144 rays through the
    closest-hit kernel (paths start at tx, captures within the flip budget
    of the fused kernel's), and compute_coverage of 16 receivers;
13. coverage (scripts/coverage_exact_tpu.py, scripts/hybrid_coverage_r5.py):
    2,048 receivers of radius 0.5, 1,048,576 Morton rays, 2 bounces, 10,000
    bins at 100 GHz, on the room (tx (3, 2, 2), z 0..14) and the terrain
    (tx (10, 0, 25), z 10..24): the coverage kernel against its plain version
    on the card's segments (the same nonzero bins, rtol 1e-5 / atol 1e-12,
    bit-identical across runs, receiver 777 alone the same bits as in the
    group) and its slab reduction against its plain version on (12, 2048,
    10,000) random planes (bit for bit); the RX-power kernel against its
    plain version on all 2,048 IRs (phase 6's bars, row 777 alone the same
    bits) and the phasor kernel against its plain version on all 2,048
    receivers (dBm 1e-3 dB, ratio and spread rtol 1e-4, the flagged set
    alike away from the thresholds, two runs and receiver 777 alone the same
    bits), its per-bin table against the table's torch form and its spread
    over the walk's capture lists against the spread's plain version (with
    the capture lists' counts: captures a (slab, receiver) region, regions
    lost and walked again), each on the card; both kernels' backwards with
    g_dbm = 1 on all rows / receivers against their plain versions (K-P's on
    16 of the rows; K-F's rtol 1e-4 with an absolute floor of 1e-6 of the
    largest entry), two runs the same bits, K-F's with the live rays its
    scan listed beside the segments' live share, with their times; the exact
    metric through
    `rfx_torch.cli.main(["coverage", ...])` (room), whose saved dBm must equal
    the facade's and be finite exactly where an IR is nonzero, with
    rx_power_dbm bit-identical across two card runs and within 1e-3 dB of the
    CPU on all 2,048 IRs; the fast and hybrid metrics through the facade, the
    fast one's dBm (1e-3 dB), ratio and spread (rtol 1e-4) held against the
    CPU on the same segments, the hybrid's flagged set against the CPU's (bar
    receivers within 1e-4 of a threshold), the hybrid the exact sweep's bits
    where it re-evaluated and fast elsewhere; wall and CUDA-event times of
    each metric;
14. the large-mesh path (scripts/torch_bench_large_mesh.py, whose legs this
    phase calls): make_terrain(grid=724, extent=120, seed=0), 1,045,458
    triangles, the native builder at leaf 8 (asserted, with its seconds,
    nodes, padded triangles and bytes on the card), tx (10, 0, 30), rx (-15,
    5, 12), radius 2.0. Against the plain versions, on 8,192 of the 5,242,880
    Morton rays: the fused kernel == the brute plain version (phase 4's bars),
    the counted kernel's trace == the uncounted kernel's bit for bit, its (4,
    4) int64 counters == `fused_trace_walk_plain`'s integer for integer, and
    that plain walk's trace == the brute plain version's; the same counter
    check on phase 4's 65,536 rays of the bench terrain; the fused kernel in
    cell order at 5,242,880 i.i.d. and Morton rays, the same bits as the
    caller's order. Then the path itself, counted on its own: the 16,384-ray
    parity leg of the closest-hit kernel against the plain walk of an
    independent leaf-16 tree; three compute_cir requests at 5,242,880 rays x 4
    bounces x 20,000 bins (CUDA events, Mrays/s; the first again,
    bit-identical); the walk counters at full width with the counted trace ==
    the uncounted one bit for bit, and the SIMT efficiency nodes / (32 *
    warp_steps); the per-query cross-check at 1,048,576 rays, and the counted
    closest hit on those rays and their second-bounce queries. The same
    counters and times on the bench terrain beside them. Last, the vote
    micro-kernel (scripts/torch_micro_vote.py): each style's carry == the
    plain version's after 2,000 bodies, then ns per body at 50,000 bodies,
    counted on its own;
15. the sharded paths (rfx_torch.parallel). One rank in this process (NCCL
    where torch has it, else gloo): sharded_cir == trace_to_rx +
    cir_from_trace bit for bit at phase 3's width through the closest-hit
    kernel, hard and soft, both timed, and the all-reduce of (20,000,) and
    (32, 20,000) f32. Then four ranks on this card over gloo (NCCL refuses
    two ranks on one card), worker processes of
    scripts/torch_multiproc_worker.py that load the kernels built in phase
    2, each held against this process's unsharded run: sharded_cir on
    {'rays': 4} at phase 3's width (the same nonzero bins, rtol 1e-5 / atol
    1e-12; the ranks and two runs bit-identical), sharded_coverage_irs on
    {'rays': 2, 'rx': 2} through the coverage kernel at phase 13's room
    shape (tiles assembled in rank order, the same bars), one inverse-solve
    step on {'rays': 2, 'rx': 2} from phase 11's start (loss rtol 1e-4, the
    tx and log_n1 gradients within 1e-4 of their largest entry, the
    parameters the same bits on every rank, at most 2 IR-sized and 2 small
    all-reduces a step); per-rank times and peak memory. The four ranks
    time-slice one card: their times measure the protocol, not scaling.
16. (run after 13) the coverage metrics' value+grad at full width, loss the
    mean of the finite dBm, d / d (log n1, tx): the fast metric
    (rfx_torch.coverage.coverage_dbm_fast) on phase 13's room and terrain
    (2,048 receivers, 1,048,576 rays, 2 bounces): d / d tx exactly 0 (only
    the amplitudes carry a gradient), d / d log n1 within 1% of a central
    difference of step 2e-3 (on the terrain both are exactly 0: every path
    inside the 100 ns window is direct), the K-F backward's g_amplitude
    against phasor_backward_plain on the same forward, two runs the same
    bits; the exact metric with soft binning (coverage_dbm(soft=True),
    engine "map") on 64 of the room's receivers: d / d tx finite and
    nonzero, the same central difference in log n1, K-P's g_ir against
    rx_power_backward_plain on all 64 rows, two runs the same bits, K-S and
    its backward once each and never the plain first-capture composition;
    times and peak memory.
17. (run after 16) the reference's 80-face icosphere receiver at full
    width. The request: Tracer(bench terrain, rx_mode="icosphere")
    .compute_cir on phase 3's workload at radius 1.0 and 0.1 (the fused
    trace with the icosphere receiver, K1/ico, one launch, in direction-cell
    order; K-H), timed (CUDA events, seven runs), the IR the same bits in
    eight runs and within rtol 1e-4 of the scan tracer's (K2, and K-B once a
    bounce: what recorded paths run; counted too); K1/ico ==
    fused_trace_plain(rx_mode="icosphere") bit for bit, the face record
    too, on every 80th ray (the caller's order) and on the first
    ORDER_MIN_RAYS i.i.d. rays (cell order), the plain receiver testing
    every ray at every bounce; at 5,242,880 i.i.d. rays cell order == the
    caller's order, and at radius 0.1 its time and bound; K-B alone on the
    first bounce's 5,242,880 rays == `_brute_forward`. Coverage: the facade's
    compute_coverage with rx_mode="icosphere" on phase 13's room (its
    environment through K-B, held against its plain version) and terrain
    (2,048 receivers x 1,048,576 rays x 2 bounces x 10,000 bins, one
    launch of K-S/ico and of the record entry/ico a 64-receiver batch, no
    plain call; three sweeps the same bits); on the first 64 receivers
    K-S/ico's record == map_record_plain's byte for byte, its t_first bit
    for bit at every capture, and the record entry/ico's IRs == the plain
    composition's (`_first_capture` and the dense histogram) bit for bit,
    hard and soft, the composition timed once as the "before". Value+grad:
    coverage_dbm(soft=True, rx_mode="icosphere", engine "map") on 64 room
    receivers as phase 16's exact leg (K-S/ico, the record entry/ico,
    B11/ico, K-P and its backward once each), and B11/ico against its plain
    version (rtol 1e-5, a floor of 1e-6 of the largest entry), two runs the
    same bits; times, bounds and peak memory.
Each main-path run is counted on its own: every launch count is set to 0
just before it and read just after, and each kernel the path runs must have
launched (the forward requests: fused trace, histogram and RX power; the
large-mesh path: fused trace, counted fused trace, closest hit, counted
closest hit and histogram; the micro-kernel's timed launches: micro vote;
the scan value+grad: closest hit and histogram; the five full-width solver
steps: closest hit, histogram, the map capture and its backward; the fused
value+grad: fused trace and histogram; the coverage
CLI's exact sweep: the coverage kernel, its slab reduction and RX power;
each hybrid sweep: the phasor metric's table, walk and spread, the same
three, and on the terrain the closest hit; each fast sweep: the table, the
walk and the spread once each, on the terrain the closest hit, and never the
coverage kernel; each fast value+grad: those three and the phasor backward
once each, on the terrain the closest hit; the exact value+grad: the
map capture, the histogram, RX power and their backwards (the histogram's
in the map capture's backward) once each; each rank's sharded CIR, coverage
and solver step: closest hit and histogram, on the coverage the coverage
kernel and the map capture, on the solver step the map capture and its
backward; the room's sweeps and value+grads: the brute closest hit; the
icosphere requests: the fused trace's icosphere entry point, the order and
the histogram, one launch each, and never the brute or the per-query closest
hit; the same requests through the scan tracer: the brute closest hit, one
launch a bounce, the closest hit and the histogram; each icosphere sweep:
the icosphere capture pass and record entry, one launch each a receiver
batch, on the room the brute closest hit, on the terrain the closest hit;
the icosphere value+grad: the
icosphere capture pass, record entry and backward, RX power and its
backward, once each, and the brute closest hit). The comparisons with the
plain versions, the
checks of phase 10 and the facade are not counted.

Prints CUDA-event times of the kernels beside their plain versions, JSON
lines of what the paths measured, one JSON line of the kernels (each with its
launches, its time at the main path's shape, its plain version's time, the
least time the card could take for the same work, `bound_ms`, from the bytes
the function must move at 3.35 TB/s and the f32 operations this run's data
needs at 67 TFLOP/s, and the time of one PyTorch call that computes the same
function where there is one), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, where CUDA is unavailable or the port's
sources are missing.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_RAYS = 5_242_880
SUBSET = 65_536
BOUNCES = 4
TX = (10.0, 0.0, 25.0)
RX = (-10.0, 0.0, 8.0)
RX_RADIUS = 1.0
C = 2.998e8
RATE = 100e9
WINDOW = 200e-9
NBINS = int(WINDOW * RATE)
GRAD_RAYS = 2_621_440
SOLVER_RAYS = 1_048_576
FACADE_RAYS = 262_144
COV_RAYS = 1_048_576
COV_WINDOW = 100e-9
COV_BINS = int(COV_WINDOW * RATE)
COV_RADIUS = 0.5
BENCH_TERRAIN = dict(grid=128, extent=60.0, seed=0)
# The coverage sweeps: (scene, tx, the receiver grid's heights); the grid is
# 16 x 16 in x and y, 2,048 receivers.
COV_SCENES = (("room", (3.0, 2.0, 2.0), range(0, 16, 2)),
              ("terrain", (10.0, 0.0, 25.0), range(10, 26, 2)))
# Phase 13 holds rx_power_dbm against the CPU on all 2,048 IRs (about 20 s
# of CPU time) and the fast metric on every CPU_FAST_STRIDE-th receiver: all
# 2,048 would add about 60 s of CPU time per configuration.
CPU_FAST_STRIDE = 32
LARGE_SUBSET = 8_192
# Launch counts are kept per C entry point (CudaKernel.symbol).
K_FUSED = "rfx_fused_trace"
K_FUSED_ICO = "rfx_fused_trace_ico"
K_COUNTED = "rfx_fused_trace_counted"
K_HIT = "rfx_closest_hit"
K_HIT_COUNTED = "rfx_closest_hit_counted"
K_HIST = "rfx_ir_histogram"
K_HIST_RECORD = "rfx_ir_histogram_record"
K_COV = "rfx_coverage_hist"
K_REDUCE = "rfx_coverage_hist_reduce"
K_VOTE = "rfx_micro_vote"
K_POWER = "rfx_rx_power"
K_PHASOR = "rfx_coverage_phasor"
K_SPREAD = "rfx_coverage_phasor_spread"
K_TABLE = "rfx_phasor_table"
K_POWER_BACKWARD = "rfx_rx_power_backward"
K_PHASOR_BACKWARD = "rfx_coverage_phasor_backward"
K_MAP = "rfx_map_capture"
K_MAP_BACKWARD = "rfx_map_capture_backward"
K_BRUTE = "rfx_brute_hit"
K_MAP_ICO = "rfx_map_capture_ico"
K_HIST_RECORD_ICO = "rfx_ir_histogram_record_ico"
K_MAP_BACKWARD_ICO = "rfx_map_capture_backward_ico"
K_ORDER = "rfx_ray_order"
# The phasor metric's three entry points, each launched once a sweep.
PHASOR_NEEDS = (K_TABLE, K_PHASOR, K_SPREAD)
# One H100 SXM's published peaks: HBM bytes/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 operations as written in rfx_torch/csrc/bvh_walk.cuh and fused_trace.cu:
# one slab test (6 sub, 6 mul, 6 min/max, 4 to fold them, min, 2 compares),
# one Moller-Trumbore test (two cross products, four dot products, one
# division, three scalings, the sum u + v, six compares), one bounce's
# receiver sphere, reflection, Fresnel factor and advance.
SLAB_FLOPS = 25
MT_FLOPS = 51
# The brute closest hit (brute_hit.cuh): a Moller-Trumbore test in the plain
# version's order; the icosphere's cull, per (ray, receiver), and |d|^2 once
# a ray.
MT_TEST_FLOPS = 54
CULL_FLOPS = 24
RAY_NORM_FLOPS = 5
ICO_FACES = 80
ICO_TRI_BYTES = 36 * ICO_FACES  # a receiver's (80, 9) f32 faces; the unit icosphere's too
ICO_RADII = (1.0, 0.1)  # the request's: the bench's and the config's default
BOUNCE_FLOPS = 60
# The direction-cell order (ray_order.cu), a ray: the direction read (12
# bytes), its key and place in its cell written and read again (16), the
# order and the rank written (8); the key's |x| + |y| + |z|, two divisions,
# the fold and the two columns.
ORDER_BYTES = 36
ORDER_FLOPS = 15
NODE_BYTES = 32  # two float4: the box, with skip and leaf in its w lanes
TRI_BYTES = 48  # three float4


def _sync():
    import torch

    torch.cuda.synchronize()


def _cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of `fn` over `reps` back-to-back calls."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """CUDA-event time of one of `reps` back-to-back calls of `fn` queued
    behind a sleep of the device, so that the host's time to enqueue them is
    hidden: the device's own time a call, where `fn` never waits for the
    device."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the device's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call of `fn`: the kernels', memsets' and copies' own
    time under torch.profiler, summed and divided by the calls. Beside the
    CUDA-event time of back-to-back calls it says whether a small kernel's
    call is bound by the device or by the host that enqueues it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return busy_us / 1e3 / reps


def _require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def _flip_budget(n: int) -> int:
    return max(4, n // 500)


def _bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: bytes at the memory rate against
    f32 operations at the peak rate; the larger bounds the kernel."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(n_bytes), "bound_flops": int(flops)}


def _walk_bound(bvh, nodes: int, tris: int, io_bytes: int, extra_flops: int = 0) -> dict:
    """Bound of a BVH-walking kernel from this run's walk counters: the
    tables count once, and no more of them than the visits can have touched;
    `io_bytes` are the per-ray inputs and outputs."""
    tables = sum(int(t.numel() * t.element_size()) for t in (bvh.nodes, bvh.tri))
    touched = min(tables, nodes * NODE_BYTES + tris * TRI_BYTES)
    return _bound(io_bytes + touched, nodes * SLAB_FLOPS + tris * MT_FLOPS + extra_flops)


def closest_hit_stats(bvh, o, d) -> dict:
    """The counted closest hit on one query set: the walk's totals, the bound
    they give (24 bytes of origin and direction in, 24 of t, index, face and
    normal out per query, and the face ids), and what says whether the tail
    or the mean sets the kernel's time: the mean and the maximum of the nodes
    a query visits, the mean over warps of the warp's maximum, and the share
    of the warps' steps that do work (nodes / (32 x the warps' maxima))."""
    import torch

    from rfx_torch.ops.bvh_trace import closest_hit

    counts = closest_hit(bvh, o, d, count=True)[4]
    n = counts.shape[0]
    nodes, leaves, tris = (int(v) for v in counts.sum(dim=0))
    per_query = counts[:, 0]
    warp_max = torch.cat([per_query, per_query.new_zeros((-n) % 32)]).reshape(-1, 32).amax(dim=1)
    bound = _walk_bound(bvh, nodes, tris, 48 * n + min(4 * bvh.n_padded_tris, 4 * n))
    return {"nodes": nodes, "leaves": leaves, "tris": tris,
            "nodes_per_query_mean": nodes / max(n, 1), "nodes_per_query_max": int(per_query.max()),
            "warp_max_nodes_mean": float(warp_max.float().mean()),
            "simt_efficiency": nodes / max(32 * int(warp_max.sum()), 1), **bound}


def histogram_bounds(captured, nbins: int, planes: int) -> dict:
    """Two bounds of one histogram call on the (R, n) mask `captured`.
    `bound_ms`: every input read once (9 bytes an entry: amplitude, distance,
    mask) and the bins written once. `needed_bound_ms`: the bytes the
    function needs with this run's data: the mask, the 32-byte sectors of
    amplitude and distance that hold a capture, and the bins. Operations:
    four for each capture and plane."""
    import torch

    entries, rows = captured.numel(), captured.shape[0] if captured.ndim == 2 else 1
    flat = captured.reshape(-1).nonzero().squeeze(1)
    sectors = int(torch.unique(flat // 8).numel())
    out_bytes = 4 * planes * rows * nbins
    flops = 4 * planes * int(flat.numel())
    needed = _bound(entries + 2 * 32 * sectors + out_bytes, flops)
    return {**_bound(9 * entries + out_bytes, flops),
            "needed_bound_ms": needed["bound_ms"], "needed_bound_bytes": needed["bound_bytes"],
            "captured": int(flat.numel())}


def _fused_bound(bvh, counters: dict) -> dict:
    """Bound of one fused trace from `counters_leg`'s numbers: 12 bytes of
    direction in and 13 bytes of result out per ray."""
    n = counters["rays"]
    return _walk_bound(bvh, sum(counters["nodes_per_bounce"]), sum(counters["tris_per_bounce"]),
                       25 * n, BOUNCE_FLOPS * (n + counters["ray_bounces"]))


def _suffixed(d: dict, suffix: str) -> dict:
    return {k + suffix: v for k, v in d.items()}


def _walk_keys(stats: dict) -> dict:
    """The bound of a counted closest-hit set and the counters behind it."""
    keys = ("bound_ms", "bound_by", "bound_bytes", "bound_flops", "nodes", "leaves", "tris",
            "nodes_per_query_mean", "nodes_per_query_max", "warp_max_nodes_mean", "simt_efficiency")
    return {k: stats[k] for k in keys}


def _counted_hit_bound(stats: dict) -> dict:
    """The counted closest hit does the closest hit's work and writes 12
    bytes of counters a query more."""
    return _bound(stats["bound_bytes"] + 12 * stats["queries"], stats["bound_flops"])


def _counted_bound(fused_bound: dict) -> dict:
    """The counted instantiation does the fused trace's work and writes 128
    bytes of counters more."""
    return _bound(fused_bound["bound_bytes"] + 32 * BOUNCES, fused_bound["bound_flops"])


def port_kernels() -> tuple:
    """The port's twenty-three C entry points that launch kernels (rfx_torch/csrc/), each with
    its launch count; the first of each source's that the build starts."""
    from rfx_torch import cir
    from rfx_torch.ops.bvh_trace import CLOSEST_HIT_COUNTED_KERNEL, CLOSEST_HIT_KERNEL
    from rfx_torch.ops.coverage_hist import (
        COVERAGE_HIST_KERNEL,
        COVERAGE_PHASOR_KERNEL,
        COVERAGE_REDUCE_KERNEL,
        COVERAGE_SPREAD_KERNEL,
        PHASOR_BACKWARD_KERNEL,
        PHASOR_TABLE_KERNEL,
    )
    from rfx_torch.ops.fused import (
        FUSED_TRACE_COUNTED_KERNEL,
        FUSED_TRACE_ICO_KERNEL,
        FUSED_TRACE_KERNEL,
    )
    from rfx_torch.ops.intersect import BRUTE_HIT_KERNEL
    from rfx_torch.ops.map_capture import (
        MAP_CAPTURE_BACKWARD_ICO_KERNEL,
        MAP_CAPTURE_BACKWARD_KERNEL,
        MAP_CAPTURE_ICO_KERNEL,
        MAP_CAPTURE_KERNEL,
    )
    from rfx_torch.ops.micro_vote import MICRO_VOTE_KERNEL
    from rfx_torch.ops.ray_order import RAY_ORDER_KERNEL

    return (FUSED_TRACE_KERNEL, CLOSEST_HIT_KERNEL, cir.HISTOGRAM_KERNEL, COVERAGE_HIST_KERNEL,
            MICRO_VOTE_KERNEL, cir.RX_POWER_KERNEL, MAP_CAPTURE_KERNEL, BRUTE_HIT_KERNEL,
            RAY_ORDER_KERNEL, FUSED_TRACE_COUNTED_KERNEL, CLOSEST_HIT_COUNTED_KERNEL, COVERAGE_REDUCE_KERNEL,
            COVERAGE_PHASOR_KERNEL, COVERAGE_SPREAD_KERNEL, PHASOR_TABLE_KERNEL,
            cir.RX_POWER_BACKWARD_KERNEL, PHASOR_BACKWARD_KERNEL, MAP_CAPTURE_BACKWARD_KERNEL,
            cir.HISTOGRAM_RECORD_KERNEL, MAP_CAPTURE_ICO_KERNEL, MAP_CAPTURE_BACKWARD_ICO_KERNEL,
            cir.HISTOGRAM_RECORD_ICO_KERNEL, FUSED_TRACE_ICO_KERNEL)


#: Sources of rfx_torch/csrc/ with a C entry point that launches kernels.
N_SOURCES = 9


def rx_power_taps(irs, lo=None) -> int:
    """The in-range taps of the 'same' convolution of (nbins,) or (M, nbins)
    IRs: for each nonzero bin k, the output samples j with 0 <= j + lo - k <
    nbins (lo = (nbins - 1) // 2). Two f32 operations each. With lo = hi =
    nbins - 1 - (nbins - 1) // 2, the backward's taps over the nonzero
    entries of g_eff (its convolution runs with the offset hi)."""
    nbins = irs.shape[-1]
    lo = (nbins - 1) // 2 if lo is None else lo
    k = irs.reshape(-1, nbins).nonzero()[:, 1]
    return int(((k - lo + nbins - 1).clamp_max(nbins - 1) - (k - lo).clamp_min(0) + 1).sum())


def _rx_power_leg(irs, window: float, what: str) -> dict:
    """K-P against its plain version on the card, on IRs of a main path:
    the same nonzero samples, the signal within rtol 1e-5 (atol 1e-5 of the
    largest sample: the two add a sample's taps in other orders), dBm within
    1e-4 dB, two runs the same bits, a row alone (the 778th, where there are
    that many) the same bits as in the batch. Times: the kernel's call, the
    plain version's, and conv1d's (the flipped carrier, 'same' padding, no
    TF32: the library's call for the same signal, timed here only); the bound
    counts each in-range tap."""
    import torch
    import torch.nn.functional as F

    from rfx_torch import cir

    a = cir.rx_power_dbm(irs, window)
    b = cir.rx_power_dbm(irs, window)
    p = cir.rx_power_dbm_plain(irs, window)
    _sync()
    _require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), f"{what}: two runs differ")
    _require(torch.equal(a[1] != 0, p[1] != 0), f"{what}: nonzero samples differ from plain")
    scale = float(p[1].abs().max())
    _require(torch.allclose(a[1], p[1], rtol=1e-5, atol=1e-5 * scale), f"{what}: signal != plain")
    fin = torch.isfinite(p[0])
    _require(torch.equal(torch.isfinite(a[0]), fin) and bool(fin.any()), f"{what}: -inf pattern")
    dbm_err = float((a[0][fin] - p[0][fin]).abs().max())
    _require(dbm_err < 1e-4, f"{what}: dBm differs from plain by {dbm_err}")
    rows = irs.reshape(-1, irs.shape[-1])
    m, nbins = rows.shape
    if m > 777:
        alone = cir.rx_power_dbm(rows[777], window)
        _require(torch.equal(alone[1], a[1][777]) and torch.equal(alone[0], a[0][777]),
                 f"{what}: row 777 alone differs from it in the batch")
    hi = nbins - 1 - (nbins - 1) // 2
    flipped = cir._carrier(nbins, window, 2.4e9, rows.device).flip(0)[None, None]

    def library():
        return F.conv1d(rows[:, None], flipped, padding=hi)[:, 0, :nbins]

    lib = library()
    out = {"rows": m, "nbins": nbins, "nonzero_bins": int((rows != 0).sum()),
           "max_abs_err": float((a[1] - p[1]).abs().max()), "max_abs_signal": scale,
           "dbm_err_vs_plain": dbm_err, "dbm_bits_differ": int((a[0] != p[0]).sum()),
           "ms": _cuda_ms(lambda: cir.rx_power_dbm(irs, window), 10),
           "device_ms": device_ms(lambda: cir.rx_power_dbm(irs, window), 10),
           "plain_ms": _cuda_ms(lambda: cir.rx_power_dbm_plain(irs, window), 1),
           "library_ms": _cuda_ms(library, 3),
           "library_max_abs_err": float((lib.reshape(a[1].shape) - p[1]).abs().max()),
           "library_nonzero_samples_differ": int(((lib.reshape(a[1].shape) != 0) != (p[1] != 0)).sum()),
           "taps": rx_power_taps(rows)}
    out["bound"] = _bound(8 * rows.numel() + 4 * nbins + 4 * m, 2 * out["taps"])
    print(f"# {what}, {m} x {nbins} bins ({out['nonzero_bins']} nonzero): kernel == plain (max |d| "
          f"{out['max_abs_err']:.3e} of {scale:.3e}, dBm {dbm_err:.3e}), bit-identical across runs"
          f"{' and alone' if m > 777 else ''}; kernel {out['ms']:.4f} ms a call ({out['device_ms']:.4f} "
          f"ms of it on the device), plain {out['plain_ms']:.1f} ms, conv1d "
          f"{out['library_ms']:.3f} ms (max |d| {out['library_max_abs_err']:.3e}, "
          f"{out['library_nonzero_samples_differ']} zeros differ), bound {out['bound']['bound_ms']:.4f} "
          f"ms by {out['bound']['bound_by']} ({out['taps']} taps)", flush=True)
    return out


def _rx_power_backward_leg(irs, window: float, what: str, plain_rows: int = 16) -> dict:
    """K-P's backward against its plain version on the card, on IRs of a main
    path, with g_dbm = 1 on every row (the gradient of the summed dBm): the
    forward's signal and row sums from the kernel, the backward twice (the
    same bits), the plain version on `plain_rows` rows spread over the batch
    (rtol 1e-4, an absolute floor of 1e-5 of the largest entry: float64
    against the kernel's f32 FMA chains), row 777 alone the same bits as in
    the batch, a lone IR the same bits as its row in a 64-row batch. Times: the kernel's call and its device time, the plain
    version's on its rows, and conv1d's (g_eff padded by lo and hi, the
    carrier as the filter, no TF32: the library's call for the same
    gradient, timed here only); the bound counts two operations for each
    in-range tap of the nonzero g_eff, every input read once (g_dbm, the
    signal, the sums, the carrier) and g_ir written once."""
    import torch
    import torch.nn.functional as F

    from rfx_torch import cir

    rows = irs.reshape(-1, irs.shape[-1])
    m, nbins = rows.shape
    dev = rows.device
    kern = cir.carrier_cached(nbins, window, 2.4e9, dev)
    sig, _, sums = cir._rx_power_launch(rows, kern)
    g_dbm = torch.ones(m, dtype=torch.float32, device=dev)

    def call():
        return cir.rx_power_backward(g_dbm, None, sig, sums, window)

    a, b = call(), call()
    pick = torch.linspace(0, m - 1, min(m, plain_rows), device=dev).round().long().unique()
    p = cir.rx_power_backward_plain(g_dbm[pick], None, sig[pick], sums[pick], kern)
    _sync()
    _require(torch.equal(a, b), f"{what}: two backward runs differ")
    scale = float(p.abs().max())
    _require(torch.allclose(a[pick], p, rtol=1e-4, atol=1e-5 * scale),
             f"{what}: backward kernel != plain")
    if m > 777:
        alone = cir.rx_power_backward(g_dbm[777:778], None, sig[777:778], sums[777:778], window)
        _require(torch.equal(alone[0], a[777]), f"{what}: backward row 777 alone differs")
    if m == 1:  # a lone IR's launch is split over the segments, a batch's is not
        batch = torch.stack([rows[0].roll(373 * i) for i in range(64)])
        batch[37] = rows[0]
        sig_b, _, sums_b = cir._rx_power_launch(batch, kern)
        in_batch = cir.rx_power_backward(torch.ones(64, device=dev), None, sig_b, sums_b, window)
        _require(torch.equal(in_batch[37], a[0]),
                 f"{what}: backward of the lone IR differs from its row in a 64-row batch")
    lo, hi = (nbins - 1) // 2, nbins - 1 - (nbins - 1) // 2
    g_eff = cir._effective_cotangent(g_dbm, None, sig, sums)

    def library():
        return F.conv1d(F.pad(g_eff[:, None], (lo, hi)), kern[None, None])[:, 0]

    lib = library()
    taps = rx_power_taps(g_eff, lo=hi)
    out = {"rows": m, "nbins": nbins, "plain_rows": int(pick.numel()),
           "nonzero_g_eff": int((g_eff != 0).sum()), "max_abs_err": float((a[pick] - p).abs().max()),
           "max_abs_g_ir": scale, "ms": _cuda_ms(call, 5),
           # A single row's call is short enough for the profiler's device
           # time to matter; on 2,048 rows it dropped kernel records in some
           # windows, and the call is device-bound (CUDA events).
           "device_ms": device_ms(call, 5) if m == 1 else None,
           "plain_ms": _cuda_ms(lambda: cir.rx_power_backward_plain(
               g_dbm[pick], None, sig[pick], sums[pick], kern), 1),
           "library_ms": _cuda_ms(library, 3),
           "library_max_abs_err": float((lib - a).abs().max()), "taps": taps,
           "bound": _bound(4 * m + 4 * rows.numel() + 8 * m + 4 * nbins + 4 * rows.numel(),
                           2 * taps)}
    on_device = "" if m > 1 else f" ({out['device_ms']:.4f} ms on the device)"
    print(f"# {what} backward, {m} x {nbins} bins (g_eff {out['nonzero_g_eff']} nonzero): kernel "
          f"== plain on {out['plain_rows']} rows (max |d| {out['max_abs_err']:.3e} of {scale:.3e}), "
          f"bit-identical across runs{' and alone' if m > 777 else ''}"
          f"{' and in a 64-row batch' if m == 1 else ''}; kernel {out['ms']:.4f} ms a "
          f"call{on_device}, plain {out['plain_ms']:.1f} ms on its rows, conv1d "
          f"{out['library_ms']:.3f} ms (max |d| {out['library_max_abs_err']:.3e}), "
          f"bound {out['bound']['bound_ms']:.4f} ms by {out['bound']['bound_by']} ({taps} taps)",
          flush=True)
    return out


def _phasor_leg(segs, centers, fkw: dict, what: str) -> dict:
    """K-F against its plain version on all receivers of a sweep, on the
    card's segments: -inf alike, dBm within 1e-3 dB, ratio and spread within
    rtol 1e-4, the flagged set alike away from the thresholds, two runs and
    receiver 777 alone the same bits. Then its parts: the table against its
    torch form (sqrt s_k and t_k bit for bit, cos and sin within 2e-7), the
    first pass's capture lists (captures a (slab, receiver) region, regions
    whose list was lost and walk again, chunks taken), the spread over them
    against its plain version at the kernel's mean delays (rtol 1e-4). The
    bound is the function's work, one sphere test per live segment and
    receiver (17 f32 operations, as K3's) and one read of the segments and
    centers."""
    import torch

    from rfx_torch.coverage import _amp_scale, _dbm_cancel_from_segments, _dbm_cancel_plain
    from rfx_torch.ops import coverage_hist as ch

    def kernel(c=centers):
        return _dbm_cancel_from_segments(segs, c, COV_RADIUS, **fkw)

    k1, k2 = kernel(), kernel()
    p = _dbm_cancel_plain(segs, centers, COV_RADIUS, **fkw)
    _sync()
    _require(all(torch.equal(a, b) for a, b in zip(k1, k2)), f"{what}: two runs differ")
    ok = torch.isfinite(p[0])
    _require(torch.equal(torch.isfinite(k1[0]), ok), f"{what}: -inf pattern")
    dbm_err = float((k1[0][ok] - p[0][ok]).abs().max())
    _require(dbm_err < 1e-3, f"{what}: dBm differs from plain by {dbm_err}")
    for name, a, b in (("ratio", k1[1], p[1]), ("spread", k1[2], p[2])):
        _require(torch.allclose(a, b, rtol=1e-4, atol=0), f"{what}: {name} differs from plain")
    flags_k, flags_p = (k1[1] < 0.5) | (k1[2] > 10e-9), (p[1] < 0.5) | (p[2] > 10e-9)
    edge = ((p[1] - 0.5).abs() <= 1e-4 * 0.5) | ((p[2] - 10e-9).abs() <= 1e-4 * 10e-9)
    _require(torch.equal(flags_k[~edge], flags_p[~edge]), f"{what}: flagged set differs")
    alone = kernel(centers[777:778])
    _require(all(torch.equal(a[0], b[777]) for a, b in zip(alone, k1)),
             f"{what}: receiver 777 alone differs from it in the group")

    # The parts, on the segments as the kernels take them (amplitude scaled).
    scale = _amp_scale(fkw["tx_power"], fkw["num_rays"], segs.t_env.device)
    scaled = segs._replace(amplitude=segs.amplitude * scale)
    kw = dict(nbins=COV_BINS, light_speed_mps=C, sample_rate_hz=RATE,
              sample_window_s=COV_WINDOW, carrier_hz=fkw["carrier_hz"])
    step, omega = ch._phasor_constants(COV_BINS, COV_WINDOW, fkw["carrier_hz"])
    tab, tab_p = ch.phasor_table(COV_BINS, step, omega, segs.t_env.device), ch.phasor_table_plain(
        COV_BINS, step, omega, segs.t_env.device)
    _sync()
    _require(torch.equal(tab[:, 0], tab_p[:, 0]) and torch.equal(tab[:, 3], tab_p[:, 3])
             and float((tab[:, 1:3] - tab_p[:, 1:3]).abs().max()) < 2e-7,
             f"{what}: phasor table != its torch form")
    sums, walks = ch._phasor_sums(scaled, centers, COV_RADIUS, **kw)
    t_mean = sums[:, 5] / sums[:, 4]
    spread = ch._phasor_spread(walks, t_mean)
    spread_p = ch.phasor_spread_plain(scaled, centers, COV_RADIUS, t_mean, **kw)
    _sync()
    hit = sums[:, 3] > 0
    _require(not bool(spread[~hit].any()) and torch.allclose(spread[hit], spread_p[hit], rtol=1e-4,
                                                             atol=0),
             f"{what}: the spread over the lists differs from its plain version")
    # The backward, with g_dbm = 1 on every receiver (the summed dBm), on
    # the coefficients of this forward: twice the same bits, and its plain
    # version (rtol 1e-4, an absolute floor of 1e-6 of the largest entry).
    coef = ch.phasor_coefficients(sums, k1[2], torch.ones(centers.shape[0], device=centers.device))

    def backward():
        return ch.phasor_backward(scaled, centers, COV_RADIUS, coef, **kw)

    gb, gb2 = backward(), backward()
    gp = ch.phasor_backward_plain(scaled, centers, COV_RADIUS, coef, **kw)
    gl, live_rays = ch._phasor_backward_launch(scaled, centers, COV_RADIUS, coef, **kw)
    _sync()
    _require(torch.equal(gb, gb2) and torch.equal(gb, gl), f"{what}: two backward runs differ")
    live_rays = int(live_rays)
    _require(live_rays == int(segs.alive.any(dim=0).sum()),
             f"{what}: the backward's scan listed {live_rays} live rays")
    g_scale = float(gp.abs().max())
    _require(bool(torch.isfinite(gb).all()) and torch.allclose(gb, gp, rtol=1e-4,
                                                                atol=1e-6 * g_scale),
             f"{what}: backward kernel != plain")
    captures, lost = ch.phasor_lists_spent(walks)
    per_region = torch.cat([w.regions(1).reshape(-1) for w in walks]).float()
    chunks = sum(int(w.ints[0]) for w in walks)
    m = centers.shape[0]
    seg_bytes = sum(int(t.numel() * t.element_size()) for t in segs)
    out = {"dbm_err_vs_plain": dbm_err,
           "ratio_max_rel_err": float(((k1[1] - p[1]).abs() / p[1].abs().clamp_min(1e-30)).max()),
           "spread_max_rel_err": float(((k1[2] - p[2]).abs()
                                        / p[2].abs().clamp_min(1e-30))[p[2] > 0].max()),
           "flagged": int(flags_k.sum()), "flags_at_threshold": int(edge.sum()),
           "ms": _cuda_ms(kernel, 5), "plain_ms": _cuda_ms(
               lambda: _dbm_cancel_plain(segs, centers, COV_RADIUS, **fkw), 1),
           "walk_ms": _cuda_ms(lambda: ch._phasor_sums(scaled, centers, COV_RADIUS, **kw), 5),
           "bound": _bound(seg_bytes + 12 * m + 12 * m, 17 * m * int(segs.alive.sum())),
           "captures": captures, "regions": int(per_region.numel()), "regions_lost": lost,
           "chunks_taken": chunks, "pool_chunks": sum(w.n_chunks for w in walks),
           "captures_per_region": {q: float(torch.quantile(per_region, float(q)))
                                   for q in ("0.5", "0.99", "1.0")},
           "table": {"max_abs_err": float((tab - tab_p).abs().max()),
                     "ms": _cuda_ms(lambda: ch.phasor_table(COV_BINS, step, omega,
                                                            segs.t_env.device), 20),
                     "plain_ms": _cuda_ms(lambda: ch.phasor_table_plain(COV_BINS, step, omega,
                                                                        segs.t_env.device), 20),
                     # 16 bytes a bin written; sqrt, cos, sin and four more operations a bin.
                     "bound": _bound(16 * COV_BINS, 7 * COV_BINS)},
           "spread": {"max_rel_err": float(((spread - spread_p).abs()
                                            / spread_p.abs().clamp_min(1e-30))[hit].max()),
                      "ms": _cuda_ms(lambda: ch._phasor_spread(walks, t_mean), 10),
                      "plain_ms": _cuda_ms(lambda: ch.phasor_spread_plain(
                          scaled, centers, COV_RADIUS, t_mean, **kw), 1),
                      # A capture's pair read once (8 bytes), four operations.
                      "bound": _bound(8 * captures + 8 * m, 4 * captures)},
           # The backward does the walk's sphere tests; it reads the
           # segments, the centers and 32 bytes of coefficients a receiver
           # and writes one gradient a segment.
           "backward": {"max_abs_err": float((gb - gp).abs().max()), "max_abs_grad": g_scale,
                        "live_rays": live_rays,
                        "live_segment_share": float(segs.alive.float().mean()),
                        "ms": _cuda_ms(backward, 5),
                        "plain_ms": _cuda_ms(lambda: ch.phasor_backward_plain(
                            scaled, centers, COV_RADIUS, coef, **kw), 1),
                        "bound": _bound(seg_bytes + 12 * m + 32 * m + 4 * segs.t_env.numel(),
                                        17 * m * int(segs.alive.sum()))}}
    print(f"# {what}, {m} receivers: kernel == plain (dBm max |d| {dbm_err:.3e}, ratio rel "
          f"{out['ratio_max_rel_err']:.3e}, spread rel {out['spread_max_rel_err']:.3e}, "
          f"{out['flagged']} flagged), bit-identical across runs and alone; kernel {out['ms']:.3f} "
          f"ms a sweep (walk {out['walk_ms']:.3f} ms, spread {out['spread']['ms']:.4f} ms, table "
          f"{out['table']['ms']:.4f} ms), plain {out['plain_ms']:.1f} ms, bound "
          f"{out['bound']['bound_ms']:.3f} ms by {out['bound']['bound_by']}; {captures} captures "
          f"in {out['regions']} (slab, receiver) regions (median {out['captures_per_region']['0.5']:.0f}, "
          f"p99 {out['captures_per_region']['0.99']:.0f}, max {out['captures_per_region']['1.0']:.0f}), "
          f"{chunks} of {out['pool_chunks']} chunks, {lost} regions lost (walked again)", flush=True)
    bw = out["backward"]
    print(f"# {what} backward, {m} receivers, g_dbm = 1: kernel == plain (max |d| "
          f"{bw['max_abs_err']:.3e} of {g_scale:.3e}), bit-identical across runs; "
          f"{live_rays} of {segs.t_env.shape[1]} rays live by its scan, "
          f"{bw['live_segment_share']:.4f} of the segments live; kernel "
          f"{bw['ms']:.3f} ms a call (one launch), plain "
          f"{bw['plain_ms']:.1f} ms, bound {bw['bound']['bound_ms']:.3f} ms by "
          f"{bw['bound']['bound_by']}", flush=True)
    return out


def _load_script(root: str, name: str):
    """Import scripts/<name>.py of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counted(kernels, path: str, needs, fn):
    """Run `fn` once as one main-path run: every launch count set to 0 just
    before, read just after. Fails unless each kernel (by its C entry point)
    in `needs` launched. Returns (fn's result, {entry point: launches})."""
    _sync()
    for k in kernels:
        k.launches = 0
    out = fn()
    _sync()
    counts = {k.symbol: k.launches for k in kernels}
    _require(all(counts[s] > 0 for s in needs), f"{path}: a kernel did not run: {counts}")
    print(f"# {path} launches {counts}", flush=True)
    return out, counts


def _plain_calls(fn):
    """(fn(), the calls that fn made of the plain first-capture composition,
    rfx_torch.coverage._first_capture, of the plain brute closest hit,
    `_brute_forward`, wherever the port binds it, and of the map engine's
    plain record and record entry)."""
    from rfx_torch import coverage
    from rfx_torch.ops import fused, intersect, map_capture

    calls = [0]
    sites = ((coverage, "_first_capture"), (intersect, "_brute_forward"),
             (fused, "_brute_forward"), (map_capture, "_brute_forward"),
             (map_capture, "map_record_plain"),
             (map_capture, "histogram_record_plain"))
    originals = [getattr(mod, attr) for mod, attr in sites]

    def counted(f):
        def call(*args, **kwargs):
            calls[0] += 1
            return f(*args, **kwargs)

        return call

    for (mod, attr), f in zip(sites, originals):
        setattr(mod, attr, counted(f))
    try:
        return fn(), calls[0]
    finally:
        for (mod, attr), f in zip(sites, originals):
            setattr(mod, attr, f)


def _closest_hit_phase(mesh, bvh, sub):
    """Phase 7: the closest-hit kernel against its plain version on three
    query sets, with the packed triangle table, and on two of them with a
    live repack (`live_tri`) of triangles shrunk by 0.1% about their
    centroids (a table unlike the packed one whose triangles stay inside the
    host-built boxes); then the counted entry point against the plain walk
    on the tx and the second-bounce set. Returns a dict: the largest |error|,
    the brute plain version's ms on the tx set, and per set the kernel's and
    the counted kernel's ms, the plain walk's, the walk's totals and the
    bound they give."""
    import torch

    from rfx_torch.ops import bvh_trace, bvh_traverse
    from rfx_torch.ops.intersect import dot3, mesh_soa

    dev = sub.device
    o1 = torch.tensor(TX, device=dev).expand(sub.shape[0], 3).contiguous()
    t1, _, _, n1 = bvh_trace.closest_hit_plain(bvh, o1, sub)
    hit = t1 < 1e29
    o2 = (o1 + sub * t1[:, None])[hit].contiguous()
    d2 = (sub - 2.0 * dot3(sub, n1)[:, None] * n1)[hit].contiguous()
    parked = torch.full((1024, 3), 1e9, device=dev)
    v0, e1, e2 = mesh_soa(torch.as_tensor(mesh.vertices, device=dev),
                          torch.as_tensor(mesh.faces, device=dev))
    shrink = 0.999
    live = bvh_trace.live_tri(bvh, v0 + (1.0 - shrink) / 3.0 * (e1 + e2), shrink * e1,
                              shrink * e2)
    sets = {"tx": (o1, sub, None), "bounce2": (o2, d2, None),
            "parked": (parked, sub[:1024].contiguous(), None),
            "tx, live table": (o1, sub, live), "bounce2, live table": (o2, d2, live)}
    err = 0.0
    for name, (o, d, tri) in sets.items():
        k = bvh_trace.closest_hit(bvh, o, d, tri)
        p = bvh_trace.closest_hit_plain(bvh, o, d, tri)
        _sync()
        for what, a, b in zip(("t", "idx", "face", "nrm"), k, p):
            _require(torch.equal(a, b), f"closest hit, {name} rays: {what} differs from plain")
        err = max(err, float((k[0] - p[0]).abs().max()), float((k[3] - p[3]).abs().max()))
        n_hit = int((k[1] >= 0).sum())
        _require(n_hit == 0 if name == "parked" else n_hit > 0, f"closest hit, {name}: {n_hit} hits")
        note = ""
        if tri is not None:  # the live table must answer differently from the packed one
            n_diff = int((k[0] != bvh_trace.closest_hit(bvh, o, d)[0]).sum())
            _require(n_diff > 0, f"closest hit, {name}: the live table answers as the packed one")
            note = f", {n_diff} t differ from the packed table's"
        print(f"# closest hit, {o.shape[0]} {name} rays: kernel == plain ({n_hit} hits{note})")
    # The counted entry point against the plain walk, integer for integer,
    # on the tx and the second-bounce set; its totals give each set's bound.
    out = {"max_abs_err": err}
    for name in ("tx", "bounce2"):
        o, d, _ = sets[name]
        plain = bvh_trace.closest_hit(bvh, o, d)
        *counted, counts = bvh_trace.closest_hit(bvh, o, d, count=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        walk_t, walk_idx, walk_counts = bvh_traverse.walk_closest_hit(bvh, o, d, count=True)
        end.record()
        _sync()
        for what, a, b in zip(("t", "idx", "face", "nrm"), counted, plain):
            _require(torch.equal(a, b), f"counted closest hit, {name}: {what} differs from the uncounted")
        _require(counts.dtype == torch.int64 and torch.equal(counts, walk_counts),
                 f"counted closest hit, {name}: counters differ from the plain walk's: "
                 f"{counts.sum(0).tolist()} vs {walk_counts.sum(0).tolist()}")
        _require(torch.equal(walk_t, plain[0]) and torch.equal(walk_idx.int(), plain[1]),
                 f"closest hit, {name}: the plain walk's hits differ from the kernel's")
        res = out[name] = closest_hit_stats(bvh, o, d)
        res.update(queries=int(o.shape[0]),
                   ms=_cuda_ms(lambda: bvh_trace.closest_hit(bvh, o, d), 20),
                   counted_ms=_cuda_ms(lambda: bvh_trace.closest_hit(bvh, o, d, count=True), 20),
                   walk_plain_ms=start.elapsed_time(end),
                   counters_max_abs_err=float((counts - walk_counts).abs().max()))
        print(f"# closest hit, {res['queries']} {name} queries: counted == plain walk integer for "
              f"integer ({res['nodes']} nodes, {res['leaves']} leaves, {res['tris']} triangles; "
              f"{res['nodes_per_query_mean']:.2f} nodes a query, max {res['nodes_per_query_max']}, "
              f"per-warp max {res['warp_max_nodes_mean']:.2f}); kernel {res['ms']:.4f} ms, counted "
              f"{res['counted_ms']:.4f} ms, plain walk {res['walk_plain_ms']:.1f} ms; bound "
              f"{res['bound_ms']:.5f} ms by {res['bound_by']}", flush=True)
    out["plain_ms"] = _cuda_ms(lambda: bvh_trace.closest_hit_plain(bvh, o1, sub), 1)
    print(f"# closest hit, {sub.shape[0]} rays from tx: brute plain version {out['plain_ms']:.2f} ms",
          flush=True)
    return out


def _gradient_phase(mesh, flat, bvh, dev, kernels):
    """Phase 9: d loss / d tx through both differentiation paths at full
    width; returns a dict of what it measured, the launch counts of each
    path's counted value+grad among it."""
    import numpy as np
    import torch

    from rfx_torch.cir import cir_from_trace
    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.ops.fused import make_diff_fused_tracer
    from rfx_torch.sampler import morton_sphere_directions
    from rfx_torch.tracer import Scene, trace_to_rx

    scene = Scene.from_mesh(mesh, dev)
    dirs = morton_sphere_directions(GRAD_RAYS, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    env = make_kernel_env_hit(bvh)
    dt = make_diff_fused_tracer(flat, scene.faces, max_bounces=BOUNCES, device=dev)

    def ir_loss(r):
        ir = cir_from_trace(r, tx_power=1.0, num_rays=GRAD_RAYS, nbins=NBINS, light_speed_mps=C,
                            sample_rate_hz=RATE, soft=True)
        return torch.sum(ir * ir) * 1e12

    traces = {
        "scan": lambda txp: trace_to_rx(scene, txp, dirs, RX, RX_RADIUS, max_bounces=BOUNCES,
                                        rx_mode="analytic", env_hit=env),
        "fused": lambda txp: dt(scene.vertices, txp, dirs, RX, RX_RADIUS),
    }
    needs = {"scan": (K_HIT, K_HIST), "fused": (K_FUSED, K_ORDER, K_HIST)}
    out = {}
    for name, trace in traces.items():
        tx_c = torch.tensor(TX, device=dev)
        with torch.no_grad():
            ir_loss(trace(tx_c))  # warm-up
            fwd_ms = _cuda_ms(lambda: ir_loss(trace(tx_c)), 3)

        def valgrad():
            tx = torch.tensor(TX, device=dev, requires_grad=True)
            loss = ir_loss(trace(tx))
            loss.backward()
            return loss.detach(), tx.grad

        valgrad()
        _sync()
        torch.cuda.reset_peak_memory_stats(dev)
        vg_ms = _cuda_ms(valgrad, 3)
        peak = torch.cuda.max_memory_allocated(dev)
        (loss, grad), launches = _counted(kernels, f"{name} value+grad", needs[name], valgrad)
        with torch.no_grad():
            captured = trace(tx_c).captured
        _sync()
        g = grad.cpu().numpy()
        _require(np.all(np.isfinite(g)) and np.abs(g).sum() > 0, f"{name} gradient {g}")
        out[name] = dict(forward_ms=fwd_ms, valgrad_ms=vg_ms, peak_bytes=peak,
                         loss=float(loss), grad=g, captured=captured, launches=launches)
        print(f"# gradient path {name}, {GRAD_RAYS} rays: loss {float(loss):.6e}, d/d tx {g}; "
              f"forward {fwd_ms:.3f} ms, value+grad {vg_ms:.3f} ms "
              f"({GRAD_RAYS / vg_ms / 1e3:.2f} Mrays/s), peak {peak / 2**30:.3f} GiB", flush=True)
    g_s, g_f = out["scan"]["grad"], out["fused"]["grad"]
    rel = float((np.abs(g_f - g_s) / np.maximum(np.abs(g_s), 1e-3)).max())
    flips = int((out["scan"]["captured"] != out["fused"]["captured"]).sum())
    n_cap = int(out["scan"]["captured"].sum())
    print(f"# gradient path: scan vs fused max rel diff {rel:.5f} (< 0.06), capture flips "
          f"{flips} of {n_cap} captures (<= {_flip_budget(GRAD_RAYS)})", flush=True)
    _require(flips <= _flip_budget(GRAD_RAYS), f"{flips} capture flips")
    _require(rel < 0.06, f"fused vs scan gradients {g_f} vs {g_s}")
    for v in out.values():
        del v["captured"]
    out["rel_diff"], out["flips"], out["captured"] = rel, flips, n_cap
    return out


def _fd_phase(terrain, terrain_bvh, dev):
    """Phase 10: the FD and cross-implementation gradient checks of
    tests/test_tpu_compiled.py:170-376, on the same direction sets (the
    oracle's numpy sampler)."""
    import numpy as np
    import torch

    from oracle import sample_sphere_directions
    from rfx_torch.geometry import make_room
    from rfx_torch.cir import cir_from_trace
    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.ops.intersect import make_env_intersector
    from rfx_torch.tracer import Scene, trace_to_rx

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def grad_of(f, x):
        x = x.detach().clone().requires_grad_()
        f(x).backward()
        return x.grad

    def value(f, x):
        with torch.no_grad():
            return float(f(x))

    def check(cond, what):
        _require(cond, what)
        print(f"# FD check: {what}", flush=True)

    room = make_room()
    scene = Scene.from_mesh(room, dev)
    dirs = t(sample_sphere_directions(2048, seed=21))
    tx0, rxp = t([4.0, 3.0, 6.0]), t([-6.0, -4.0, 5.0])
    env_dt = make_env_intersector("kernel", mesh=room, differentiable_tris=True, device=dev)
    env_nd = make_kernel_env_hit(env_dt.bvh)

    def trace(env, scn=scene, txp=tx0):
        return trace_to_rx(scn, txp, dirs, rxp, 2.0, max_bounces=2, rx_mode="analytic",
                           env_hit=env)

    def loss_v(v):
        r = trace(env_dt, Scene(v, scene.faces))
        return torch.where(r.captured, r.amplitude * r.distance, 0.0).sum()

    v0 = scene.vertices
    g = grad_of(loss_v, v0)
    _require(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0, "room vertex grad")
    u = t(np.random.default_rng(5).normal(size=v0.shape))
    u = u / torch.linalg.norm(u)
    fd = (value(loss_v, v0 + 2e-3 * u) - value(loss_v, v0 - 2e-3 * u)) / 4e-3
    ad = float((g * u).sum())
    check(abs(ad - fd) < 0.08 * max(abs(fd), abs(ad), 1e-3),
          f"room vertex grad, differentiable-tris closest hit: ad {ad:.6g} fd {fd:.6g} (8%)")

    rngw = np.random.default_rng(7)
    w, uw = t(rngw.normal(size=2048)), t(rngw.normal(size=2048))

    def loss_smooth(txp):
        r = trace(env_nd, txp=txp)
        return (r.captured.float() * (w * r.distance + 10.0 * uw * r.amplitude)).sum()

    gtx = grad_of(loss_smooth, tx0)
    for a in range(3):
        e = torch.zeros(3, device=dev)
        e[a] = 1e-3
        fd = (value(loss_smooth, tx0 + e) - value(loss_smooth, tx0 - e)) / 2e-3
        ga = float(gtx[a])
        check(abs(ga - fd) < 0.08 * max(abs(fd), abs(ga), 1e-3),
              f"room tx grad axis {a}, linear loss: ad {ga:.6g} fd {fd:.6g} (8%)")

    def loss_ir(env):
        def f(txp):
            ir = cir_from_trace(trace(env, txp=txp), tx_power=5.0, num_rays=2048, nbins=512,
                                light_speed_mps=C, sample_rate_hz=10e9, soft=True)
            return torch.sum(ir * ir) * 1e12
        return f

    g_k = grad_of(loss_ir(env_nd), tx0).cpu().numpy()
    g_b = grad_of(loss_ir(make_env_intersector("brute")), tx0).cpu().numpy()
    rel = float((np.abs(g_k - g_b) / np.maximum(np.abs(g_b), 1e-3)).max())
    check(np.all(np.isfinite(g_k)) and rel < 0.03,
          f"room soft-IR tx grad, closest hit vs brute: {g_k} vs {g_b}, rel {rel:.5f} (3%)")

    tscene = Scene.from_mesh(terrain, dev)
    tdirs = t(sample_sphere_directions(16384, seed=33))
    ttx, trx = t([10.0, 0.0, 25.0]), t([-10.0, 0.0, 8.0])
    env_t_nd = make_kernel_env_hit(terrain_bvh)
    env_t_dt = make_kernel_env_hit(terrain_bvh, differentiable_tris=True)

    def ttrace(env, scn=tscene, n1=5.0):
        return trace_to_rx(scn, ttx, tdirs, trx, 1.5, max_bounces=3, rx_mode="analytic",
                           env_hit=env, n1=n1)

    def loss_n1(env):
        def f(n1):
            r = ttrace(env, n1=n1)
            return torch.where(r.captured, r.amplitude, 0.0).sum() * 1e3
        return f

    five = t(5.0)
    g_n1 = float(grad_of(loss_n1(env_t_nd), five))
    fd = (value(loss_n1(env_t_nd), five + 1e-2) - value(loss_n1(env_t_nd), five - 1e-2)) / 2e-2
    check(np.isfinite(g_n1) and g_n1 != 0.0 and abs(g_n1 - fd) < 0.05 * max(abs(fd), 1e-6),
          f"terrain n1 grad: ad {g_n1:.6g} fd {fd:.6g} (5%)")
    g_n1_dt = float(grad_of(loss_n1(env_t_dt), five))
    check(np.isfinite(g_n1_dt) and abs(g_n1_dt - g_n1) < 0.02 * max(abs(g_n1), 1e-6),
          f"terrain n1 grad, differentiable-tris {g_n1_dt:.6g} vs baked {g_n1:.6g} (2%)")

    wt = t(np.random.default_rng(11).normal(size=16384))

    def loss_vt(env):
        def f(v):
            r = ttrace(env, Scene(v, tscene.faces))
            return (r.captured.float() * (wt * r.distance + 10.0 * r.amplitude)).sum()
        return f

    g_v = grad_of(loss_vt(env_t_dt), tscene.vertices)
    g_ref = grad_of(loss_vt(make_env_intersector("brute")), tscene.vertices)
    num, den = float(torch.linalg.norm(g_v - g_ref)), float(torch.linalg.norm(g_ref))
    check(bool(torch.isfinite(g_v).all()) and float(g_v.abs().sum()) > 0 and num < 0.02 * den,
          f"terrain vertex grad, differentiable-tris closest hit vs brute backward: "
          f"|diff| {num:.6g}, |ref| {den:.6g} (2%)")


def _solver_step_vs_plain(dev):
    """Phase 11, first part: three solver steps where the parameters move
    (the room of tests/test_torch_solver.py: 2,048 rays, 2 bounces, two
    receivers, 512 bins at 10 GHz, lr 0.1), on the card through the
    closest-hit kernel. Each step is held against the same step on the CPU
    through the kernel's plain version, started from the card's parameters
    and Adam state: the loss, the gradients and the updated parameters must
    agree. (Two trajectories would drift apart: the soft-binned loss's
    gradient jumps where a path's delay crosses a bin centre, so ulp-level
    differences in the parameters can change it by ~1%.)"""
    import numpy as np
    import torch

    from oracle import sample_sphere_directions
    from rfx_torch.geometry import make_room
    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.solver import coverage_irs_soft, make_inverse_solver
    from rfx_torch.tracer import Scene

    room = make_room()
    dirs = torch.from_numpy(sample_sphere_directions(2048, seed=13))
    rxc = torch.tensor([[-6.0, 0.0, 5.0], [6.0, 0.0, 5.0]])
    kw = dict(max_bounces=2, nbins=512, light_speed_mps=C, sample_rate_hz=10e9)
    cpu = torch.device("cpu")
    scene_c = Scene.from_mesh(room, cpu)
    with torch.no_grad():
        irs = coverage_irs_soft(scene_c.vertices, scene_c.faces, torch.tensor([3.0, 0.0, 5.0]),
                                5.0, dirs, rxc, 2.5, num_rays=2048,
                                env_hit=make_kernel_env_hit(room, device=cpu), **kw)
        target = torch.sum(irs * irs, dim=1)
    tx0 = [-2.0, 1.5, 4.0]
    (pk, ok, step_k), (pc, oc, step_c) = (
        (*init_fn(tx0), step_fn) for init_fn, step_fn in (
            make_inverse_solver(Scene.from_mesh(room, dv), dirs, rxc, 2.5, target,
                                learning_rate=0.1, env_hit=make_kernel_env_hit(room, device=dv),
                                **kw) for dv in (dev, cpu)))

    def state(params, loss):
        return [np.asarray(float(loss))] + [
            a.detach().cpu().numpy().copy()
            for a in (params.tx_pos.grad, params.log_n1.grad, params.tx_pos, params.log_n1)]

    worst = [0.0] * 5
    losses = []
    for i in range(3):
        with torch.no_grad():  # the CPU starts from the card's parameters and Adam state
            for c, k in zip(pc[:2], pk[:2]):
                c.copy_(k.cpu())
        oc.load_state_dict(copy.deepcopy(ok.state_dict()))
        pk, ok, loss_k = step_k(pk, ok)
        pc, oc, loss_c = step_c(pc, oc)
        k, p = state(pk, loss_k), state(pc, loss_c)
        _sync()
        losses.append(float(k[0]))
        for j, (what, a, b, rtol, atol) in enumerate(zip(
                ("loss", "tx grad", "log_n1 grad", "tx", "log_n1"), k, p,
                (1e-4, 1e-4, 1e-4, 0.0, 0.0),
                (0.0, 1e-6 * np.abs(p[1]).max(), 1e-6 * np.abs(p[2]).max(), 1e-5, 1e-5))):
            _require(np.all(np.isfinite(a)) and np.allclose(a, b, rtol=rtol, atol=atol),
                     f"solver step {i + 1} on the card vs the CPU: {what} {a} vs {b}")
            worst[j] = max(worst[j], float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))))
        _require(float(np.abs(k[1]).min()) > 0, f"room solver step {i + 1}: tx grad {k[1]}")
    moved = float(np.abs(pk.tx_pos.detach().cpu().numpy() - np.asarray(tx0, np.float32)).max())
    _require(moved > 0.1, f"room solver: tx moved {moved} in 3 steps")
    print(f"# inverse solve, room, 3 steps on the card == the same steps on the CPU (plain): "
          f"losses {losses}, tx {pk.tx_pos.detach().cpu().numpy()} (moved {moved:.6g}); max rel "
          f"diff loss {worst[0]:.3e}, tx grad {worst[1]:.3e}, log_n1 grad {worst[2]:.3e}, tx "
          f"{worst[3]:.3e}, log_n1 {worst[4]:.3e}", flush=True)
    return dict(room_losses=losses, room_tx_moved=moved, room_max_rel_diff=worst)


def _batched_histogram_check(scene, dirs, centers, env, dev):
    """The histogram kernel's dense entry at the inverse solve's shapes, on
    the plain map engine's dense rows (1,048,576 rays x 4 bounces
    flattened: 4,194,304 entries a row, one row a receiver; the map engine
    itself bins its first-capture record): all 64 rows in one launch and the
    best-lit row alone, hard and soft, against the plain version (the same
    nonzero bins, rtol 1e-5 / atol 1e-12), bit-identical from run to run, a
    row alone == the row in the batch, and a row of at most 2,048 captures
    == the CPU's plain version bit for bit (both sum in ray order). Returns
    the times beside `index_add_` and both bounds."""
    import torch

    from rfx_torch import cir
    from rfx_torch.coverage import _amp_scale, _first_capture
    from rfx_torch.tracer import trace_env

    zero = torch.zeros((), device=dev)
    with torch.no_grad():
        segs = trace_env(scene, torch.tensor(TX, device=dev), dirs, max_bounces=BOUNCES, env_hit=env)
        t_rx, first = _first_capture(segs, centers, 1.0, "analytic")
        rows = centers.shape[0]
        amp = (torch.where(first, segs.amplitude, zero)
               * _amp_scale(1.0, SOLVER_RAYS, dev)).reshape(rows, -1)
        dist = torch.where(first, segs.distance + t_rx, zero).reshape(rows, -1)
        first = first.reshape(rows, -1)
        del segs, t_rx
    kw = dict(nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE)
    per_row = first.sum(dim=1)
    lit = int(per_row.argmax())
    out = {"rows": rows, "entries_per_row": int(amp.shape[1]), "captured": int(per_row.sum()),
           "captured_max_row": int(per_row[lit]), "max_abs_err": 0.0}
    one = tuple(t[lit:lit + 1] for t in (amp, dist, first))
    for soft in (False, True):
        tag = "soft" if soft else "hard"
        modes = (cir.SOFT_LO, cir.SOFT_HI) if soft else (cir.HARD,)
        before = cir.HISTOGRAM_KERNEL.launches
        k1 = cir.bin_impulse_response(amp, dist, first, soft=soft, **kw)
        _require(cir.HISTOGRAM_KERNEL.launches == before + 1, "the batch took more than one launch")
        k2 = cir.bin_impulse_response(amp, dist, first, soft=soft, **kw)
        p = sum(cir.histogram_plain(amp, dist, first, mode=m, **kw) for m in modes)
        alone = cir.bin_impulse_response(*one, soft=soft, **kw)
        p_cpu = sum(cir.histogram_plain(*(t.cpu() for t in one), mode=m, **kw) for m in modes)
        _sync()
        what = f"batched histogram, {tag}"
        _require(k1.shape == (rows, NBINS) and torch.equal(k1, k2), f"{what}: two runs differ")
        _require(torch.equal(k1 != 0, p != 0), f"{what}: nonzero bins differ from plain")
        _require(torch.allclose(k1, p, rtol=1e-5, atol=1e-12), f"{what}: kernel != plain")
        _require(torch.equal(alone[0], k1[lit]) and bool((alone != 0).any()),
                 f"{what}: row {lit} alone differs from it in the batch")
        _require(out["captured_max_row"] > 2048 or torch.equal(alone.cpu(), p_cpu),
                 f"{what}: row {lit} differs from the CPU's plain version")
        out["max_abs_err"] = max(out["max_abs_err"], float((k1 - p).abs().max()))
        out[f"{tag}_ms"] = _cuda_ms(lambda: cir.bin_impulse_response(amp, dist, first, soft=soft, **kw), 10)
        out[f"{tag}_plain_ms"] = _cuda_ms(
            lambda: sum(cir.histogram_plain(amp, dist, first, mode=m, **kw) for m in modes), 3)
        out[f"{tag}_one_row_ms"] = _cuda_ms(lambda: cir.bin_impulse_response(*one, soft=soft, **kw), 20)
        out[f"{tag}_device_ms"] = device_ms(
            lambda: cir.bin_impulse_response(amp, dist, first, soft=soft, **kw), 10)
        out[f"{tag}_one_row_device_ms"] = device_ms(
            lambda: cir.bin_impulse_response(*one, soft=soft, **kw), 20)
        out[f"{tag}_one_row_plain_ms"] = _cuda_ms(
            lambda: sum(cir.histogram_plain(*one, mode=m, **kw) for m in modes), 5)
        out[f"bounds_{tag}"] = histogram_bounds(first, NBINS, planes=len(modes))
        out[f"bounds_{tag}_one_row"] = histogram_bounds(one[2], NBINS, planes=len(modes))
    # The library's call for the hard sums: `index_add_` on ready-made flat
    # bins and masked weights (not deterministic; used nowhere in the port).
    for tag, (a, d, c) in (("", (amp, dist, first)), ("_one_row", one)):
        raw = (d / torch.tensor(C, device=dev) * torch.tensor(RATE, device=dev)).long()
        weight = torch.where(c & (raw >= 0) & (raw < NBINS), a, zero).reshape(-1)
        key = (raw.clamp_(0, NBINS - 1) + NBINS * torch.arange(a.shape[0], device=dev)[:, None]).reshape(-1)
        out[f"index_add{tag}_ms"] = _cuda_ms(
            lambda: torch.zeros(a.shape[0] * NBINS, device=dev).index_add_(0, key, weight), 5)
        del raw, weight, key
    print(f"# batched histogram, {rows} rows x {out['entries_per_row']} entries "
          f"({out['captured']} captured, {out['captured_max_row']} in row {lit}), {NBINS} bins: one "
          f"launch == plain (max |d| {out['max_abs_err']:.3e}), bit-identical across runs, row {lit} "
          f"alone == in the batch == the CPU's plain version; hard {out['hard_ms']:.4f} ms, soft "
          f"{out['soft_ms']:.4f} ms a call, {out['hard_device_ms']:.4f} / {out['soft_device_ms']:.4f} "
          f"ms of it on the device (plain {out['hard_plain_ms']:.3f} / {out['soft_plain_ms']:.3f} ms, "
          f"index_add_ {out['index_add_ms']:.3f} ms; bound {out['bounds_soft']['bound_ms']:.4f} ms "
          f"at 9 bytes an entry, {out['bounds_soft']['needed_bound_ms']:.4f} ms by the bytes it "
          f"needs); one row: hard {out['hard_one_row_ms']:.4f} ms, soft {out['soft_one_row_ms']:.4f} "
          f"ms a call, {out['hard_one_row_device_ms']:.4f} / {out['soft_one_row_device_ms']:.4f} ms "
          f"on the device (plain {out['hard_one_row_plain_ms']:.3f} / {out['soft_one_row_plain_ms']:.3f} ms, "
          f"index_add_ {out['index_add_one_row_ms']:.3f} ms; bound "
          f"{out['bounds_hard_one_row']['bound_ms']:.4f} / "
          f"{out['bounds_hard_one_row']['needed_bound_ms']:.5f} ms)", flush=True)
    return out


def _map_capture_check(scene, dirs, centers, env, dev, card):
    """The map engine's capture pass at the inverse solve's shape, on the
    segments of tx (1,048,576 rays x 4 bounces, 64 receivers of radius 1.0,
    20,000 bins): K-S's first-capture record == map_record_plain's byte for
    byte and the same in two runs; the histogram's record entry, hard and
    soft, == the plain map engine's IRs (map_capture_plain's rows through
    the dense entry) bit for bit, the same in two runs, and within rtol 1e-5
    of its plain version (histogram_record_plain, on the same nonzero bins);
    map_irs's IRs == those bits; the backward given the record, for a seeded
    (64, 20,000) cotangent (numpy seed 3), soft: the segments' gradients ==
    map_capture_backward_plain's bit for bit, the centers', the scale's and
    the radius's within rtol 1e-5 (an absolute floor of 1e-6 of the largest
    entry), every output the same bits in two runs. Returns the times
    beside the bounds."""
    import numpy as np
    import torch

    from rfx_torch import cir
    from rfx_torch.coverage import _amp_scale
    from rfx_torch.ops import map_capture as mc
    from rfx_torch.tracer import trace_env

    with torch.no_grad():
        segs = trace_env(scene, torch.tensor(TX, device=dev), dirs, max_bounces=BOUNCES, env_hit=env)
    scale = float(_amp_scale(1.0, SOLVER_RAYS, torch.device("cpu")))
    hkw = dict(nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE)
    m = centers.shape[0]
    record = mc.map_record(segs, centers, 1.0)
    again = mc.map_record(segs, centers, 1.0)
    plain = mc.map_record_plain(segs, centers, 1.0)
    _sync()
    _require(torch.equal(record, again), "map capture: two runs differ (record)")
    _require(torch.equal(record, plain), "map capture: the record differs from the plain version's")
    captured = int((record != mc.NO_CAPTURE).sum())
    record_err = int((record.int() - plain.int()).abs().max())
    del again, plain
    rows = mc.map_capture_plain(segs, centers, 1.0, scale)
    per_row = rows[2].sum(dim=1)
    kh = {"captured_max_row": int(per_row.max()), "max_abs_err": 0.0}
    for soft in (False, True):
        tag = "soft" if soft else "hard"
        k1 = cir.histogram_record(record, segs, centers, 1.0, scale, soft=soft, **hkw)
        k2 = cir.histogram_record(record, segs, centers, 1.0, scale, soft=soft, **hkw)
        irs = mc.map_irs(segs, centers, 1.0, scale=scale, soft=soft, **hkw)
        want = cir.histogram_rows(*rows, soft=soft, **hkw)
        p = mc.histogram_record_plain(record, segs, centers, 1.0, scale, soft=soft, **hkw)
        _sync()
        what = f"histogram record entry, {tag}"
        _require(torch.equal(k1, k2), f"{what}: two runs differ")
        _require(torch.equal(k1, want) and float(k1.sum()) > 0,
                 f"{what}: the IRs differ from the plain map engine's")
        _require(torch.equal(irs, want), f"map_irs, {tag}: the IRs differ from the plain map engine's")
        _require(torch.equal(k1 != 0, p != 0) and torch.allclose(k1, p, rtol=1e-5, atol=1e-12),
                 f"{what}: kernel != plain")
        kh["max_abs_err"] = max(kh["max_abs_err"], float((k1 - p).abs().max()))
    del rows, k1, k2, irs, want, p
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(m, NBINS)).astype(np.float32)).to(dev)
    bkw = dict(scale=scale, soft=True, **hkw)
    k1 = mc.map_capture_backward(segs, centers, 1.0, g, record, **bkw)
    k2 = mc.map_capture_backward(segs, centers, 1.0, g, record, **bkw)
    p = mc.map_capture_backward_plain(segs, centers, 1.0, g, **bkw)
    _sync()
    errs = {}
    names = ("origin", "direction", "amplitude", "distance", "centers", "scale", "radius")
    _require(len(k1) == len(p) == len(names), "map capture backward: outputs missing")
    for name, a, b, c in zip(names, k1, k2, p):
        _require(torch.equal(a, b), f"map capture backward: two runs differ ({name})")
        _require(name not in names[:4] or torch.equal(a, c),
                 f"map capture backward: the segments' gradient differs from the plain version's "
                 f"bits ({name})")
        _require(torch.allclose(a, c, rtol=1e-5, atol=1e-6 * float(c.abs().max())),
                 f"map capture backward != its plain version ({name})")
        errs[name] = float((a - c).abs().max())
    del k1, k2, p
    live = int(segs.alive.sum())
    n_seg = segs.t_env.numel()
    n = segs.t_env.shape[1]
    # K-S tests each live segment against each receiver (17 f32 operations,
    # as K3's), reads the segments' geometry, t_env and life (29 bytes each)
    # and the centers once, and writes the (64, N) record. The record entry
    # reads the record, and at each capture 32 bytes of its segment (amp,
    # dist, origin, direction), recomputes t_rx (17 operations) and bins it
    # (4 a plane), and writes the IRs. The function the pair serves,
    # segments to IRs, reads the segments once (37 bytes each) and writes the
    # IRs once. The backward reads the record, the cotangent and 32 bytes of
    # each captured segment, and writes 32 bytes a segment.
    tests = 17 * m * live
    rec_bytes = m * n
    ir_bytes = 4 * m * NBINS
    hist_bound = {tag: _bound(rec_bytes + 32 * captured + 12 * m + planes * ir_bytes,
                              (17 + 4 * planes) * captured)
                  for tag, planes in (("hard", 1), ("soft", 2))}

    def hist(soft):
        return lambda: cir.histogram_record(record, segs, centers, 1.0, scale, soft=soft, **hkw)

    for soft, tag in ((False, "hard"), (True, "soft")):
        kh[f"{tag}_ms"] = _cuda_ms(hist(soft), 10)
        kh[f"{tag}_device_ms"] = device_ms(hist(soft), 10)
        kh[f"{tag}_plain_ms"] = _cuda_ms(lambda: mc.histogram_record_plain(
            record, segs, centers, 1.0, scale, soft=soft, **hkw), 2)
        kh[f"bound_{tag}"] = hist_bound[tag]

    def backward(full):
        return lambda: mc.map_capture_backward(segs, centers, 1.0, g, record, centers_grad=full,
                                               scalars_grad=full, **bkw)

    out = {"receivers": m, "segments": n_seg, "live_segments": live, "captured": captured,
           "max_abs_err": record_err, "backward_max_abs_err": errs, "histogram": kh,
           "ms": _cuda_ms(lambda: mc.map_record(segs, centers, 1.0), 10),
           "device_ms": device_ms(lambda: mc.map_record(segs, centers, 1.0), 10),
           "irs_ms": _cuda_ms(lambda: mc.map_irs(segs, centers, 1.0, scale=scale, soft=True, **hkw), 10),
           "irs_ms_hard": _cuda_ms(lambda: mc.map_irs(segs, centers, 1.0, scale=scale, soft=False,
                                                      **hkw), 10),
           "irs_device_ms": device_ms(lambda: mc.map_irs(segs, centers, 1.0, scale=scale, soft=True,
                                                         **hkw), 10),
           "plain_ms": _cuda_ms(lambda: mc.map_record_plain(segs, centers, 1.0), 2),
           "backward_ms": _cuda_ms(backward(False), 10),
           "backward_centers_ms": _cuda_ms(backward(True), 10),
           "backward_device_ms": device_ms(backward(False), 10),
           "backward_centers_device_ms": device_ms(backward(True), 10),
           "backward_plain_ms": _cuda_ms(lambda: mc.map_capture_backward_plain(
               segs, centers, 1.0, g, centers_grad=False, scalars_grad=False, **bkw), 1),
           "bound": _bound(29 * n_seg + 12 * m + rec_bytes, tests),
           "function_bound": _bound(37 * n_seg + 12 * m + ir_bytes, tests),
           "backward_bound": _bound(rec_bytes + ir_bytes + 32 * captured + 12 * m + 32 * n_seg,
                                    60 * captured)}
    print(f"# map capture (K-S), {m} receivers x {BOUNCES} x {SOLVER_RAYS} segments ({live} live, "
          f"{captured} captured, at most {kh['captured_max_row']} in a row): the record == plain "
          f"byte for byte, two runs the same; the histogram's record entry == the plain map "
          f"engine's IRs bit for bit, hard and soft, two runs the same (max |d| against its plain "
          f"version {kh['max_abs_err']:.3e}); K-S {out['ms']:.4f} ms a call, "
          f"{out['device_ms']:.4f} ms on the device (bound "
          f"{out['bound']['bound_ms']:.4f} ms by {out['bound']['bound_by']}; plain "
          f"{out['plain_ms']:.3f} ms); record entry hard / soft {kh['hard_ms']:.4f} / "
          f"{kh['soft_ms']:.4f} ms a call, {kh['hard_device_ms']:.4f} / {kh['soft_device_ms']:.4f} ms "
          f"on the device (bound {hist_bound['hard']['bound_ms']:.4f} / "
          f"{hist_bound['soft']['bound_ms']:.4f} ms; plain {kh['hard_plain_ms']:.3f} / "
          f"{kh['soft_plain_ms']:.3f} ms); map_irs (K-S with the record entry) soft "
          f"{out['irs_ms']:.4f} ms ({out['irs_device_ms']:.4f} on the device), hard "
          f"{out['irs_ms_hard']:.4f} ms (segments to IRs: bound "
          f"{out['function_bound']['bound_ms']:.4f} ms by {out['function_bound']['bound_by']}); "
          f"backward == plain (segments bit for bit; max |d| {errs}), two runs the same; "
          f"{out['backward_ms']:.4f} ms a call, {out['backward_device_ms']:.4f} ms on the device "
          f"({out['backward_centers_ms']:.4f} / {out['backward_centers_device_ms']:.4f} ms with the "
          f"centers', scale's and radius's gradients), plain {out['backward_plain_ms']:.3f} ms, bound "
          f"{out['backward_bound']['bound_ms']:.4f} ms by {out['backward_bound']['bound_by']}; "
          f"{card}", flush=True)
    return out


def _solver_phase(mesh, bvh, dev, kernels, card):
    """Phase 11: the room steps against their CPU version, then five steps
    of the inverse solve at full width; returns what it measured."""
    import numpy as np
    import torch

    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.solver import make_inverse_solver

    room = _solver_step_vs_plain(dev)
    env = make_kernel_env_hit(bvh)
    scene, dirs, centers = solver_inputs(mesh, dev)
    target = _solver_target(scene, dirs, centers, env)
    n_lit = int((target > 0).sum())
    kw = dict(max_bounces=BOUNCES, nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE)
    kh_batch = _batched_histogram_check(scene, dirs, centers, env, dev)
    torch.cuda.empty_cache()
    ks = _map_capture_check(scene, dirs, centers, env, dev, card)
    torch.cuda.empty_cache()
    init_fn, step_fn = make_inverse_solver(scene, dirs, centers, 1.0, target, learning_rate=0.05,
                                           env_hit=env, **kw)
    params, opt = init_fn([12.0, -2.0, 26.0])
    leaves = list(params[:2])
    start = [p.detach().clone() for p in leaves]
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []

    def steps():
        nonlocal params, opt
        for _ in range(5):
            h0 = time.perf_counter()
            params, opt, loss = step_fn(params, opt)
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - h0) * 1e3)

    (_, plain_calls), launches = _counted(kernels, "inverse solve",
                                          (K_HIT, K_HIST_RECORD, K_MAP, K_MAP_BACKWARD),
                                          lambda: _plain_calls(steps))
    peak = torch.cuda.max_memory_allocated(dev)
    # One launch each of K-S, the histogram's record entry and K-S's
    # backward for each receiver batch and step (64 receivers, rx_batch 64);
    # the dense rows and the histogram's dense entry are not on this path.
    _require(all(launches[k] == 5 for k in (K_MAP, K_HIST_RECORD, K_MAP_BACKWARD))
             and launches[K_HIST] == 0 and plain_calls == 0,
             f"inverse solve: {launches[K_MAP]} / {launches[K_HIST_RECORD]} / "
             f"{launches[K_MAP_BACKWARD]} launches of K-S / the record entry / K-S's backward, "
             f"{launches[K_HIST]} of the dense histogram and {plain_calls} plain first-capture "
             f"calls in 5 steps")
    grads = [p.grad.cpu().numpy() for p in leaves]
    _require(all(np.isfinite(losses)), f"solver losses {losses}")
    for name, g in zip(("tx", "log_n1"), grads):
        _require(np.all(np.isfinite(g)) and np.abs(g).sum() > 0, f"solver {name} grad {g}")
    # At this width the reference's loss (scaled as (1/N)^4) gives gradients
    # near 1e-18, so Adam's eps (1e-8) keeps each step below an f32 ulp of
    # the parameters; the room steps above are where they move.
    moved_max = [float((p.detach() - s).abs().max()) for p, s in zip(leaves, start)]
    print(f"# inverse solve, {SOLVER_RAYS} rays x {centers.shape[0]} receivers ({n_lit} lit): "
          f"losses {losses}; ms per step {[round(x, 3) for x in step_ms]}; tx "
          f"{params.tx_pos.detach().cpu().numpy()}, n1 {float(params.log_n1.detach().exp()):.6f}; "
          f"last grads tx {grads[0]}, log_n1 {grads[1]}; max |moved| tx {moved_max[0]:.6g}, "
          f"log_n1 {moved_max[1]:.6g}; peak {peak / 2**30:.3f} GiB; {card}", flush=True)
    return dict(losses=losses, step_ms=step_ms, peak_bytes=peak, moved_max=moved_max,
                launches=launches, histogram_batch=kh_batch, map_capture=ks, **room)


def _facade_phase(mesh, dirs, dev):
    """Phase 12: recorded paths and coverage through the facade."""
    import numpy as np

    from rfx_torch.api import Tracer
    from rfx_torch.coverage import make_grid

    tracer = Tracer(mesh, C, RATE, WINDOW, max_bounces=BOUNCES, tx_num_rays=FACADE_RAYS,
                    device=dev)
    d = dirs[:: dirs.shape[0] // FACADE_RAYS].contiguous()
    paths, ir = tracer.compute_cir(TX, 1.0, RX, RX_RADIUS, directions=d, record_paths=True)
    n_fused = int(tracer._fused(d, TX, RX, RX_RADIUS).captured.sum())
    _sync()
    _require(len(paths) > 0 and all(np.allclose(p[0], TX) for p in paths),
             "recorded paths do not start at tx")
    _require(abs(len(paths) - n_fused) <= _flip_budget(FACADE_RAYS),
             f"{len(paths)} recorded paths vs {n_fused} fused captures")
    _require(ir.shape == (NBINS,) and np.all(np.isfinite(ir)) and ir.sum() > 0, "paths IR")
    centers = make_grid([-12.0, -4.0, 4.0, 12.0], [-12.0, -4.0, 4.0, 12.0], [8.0])
    irs = tracer.compute_coverage(TX, 1.0, centers, 2.0, directions=d)
    _sync()
    _require(irs.shape == (16, NBINS) and np.all(np.isfinite(irs)) and irs.sum() > 0,
             "coverage IRs")
    print(f"# facade, {FACADE_RAYS} rays: {len(paths)} recorded paths from tx (fused kernel: "
          f"{n_fused} captures); coverage of 16 receivers, {int((irs.sum(axis=1) > 0).sum())} "
          f"lit, IR sums {float(irs.sum()):.6e}", flush=True)


def _timed(fn):
    """(fn(), host seconds, CUDA-event ms) of one call that ends synchronized."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _sync()
    h0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    _sync()
    return out, time.perf_counter() - h0, start.elapsed_time(end)


def coverage_workload(mesh, tx, zs, dirs, dev):
    """(tracer, grid, segs, scaled) of one coverage sweep: the facade over
    `mesh`, the receiver grid, the environment trace of `dirs` from tx and
    the same segments with the amplitude scaled by tx_power / num_rays, as
    the coverage kernel takes them."""
    import torch

    from rfx_torch.api import Tracer
    from rfx_torch.coverage import make_grid
    from rfx_torch.tracer import trace_env

    tracer = Tracer(mesh, C, RATE, COV_WINDOW, max_bounces=2, tx_num_rays=COV_RAYS, device=dev)
    grid = make_grid(range(-15, 16, 2), range(-15, 16, 2), zs)
    segs = trace_env(tracer.scene, tx, dirs, max_bounces=2, env_hit=tracer.env_hit)
    scaled = segs._replace(amplitude=segs.amplitude * (torch.tensor(1.0) / COV_RAYS).to(dev))
    return tracer, grid, segs, scaled


def _coverage_phase(terrain, dev, kernels):
    """Phase 13: exact, fast and hybrid coverage on the room and the terrain
    at full width; returns what it measured, with the launch counts of each
    counted path."""
    import tempfile

    import numpy as np
    import torch

    from rfx_torch.geometry import make_room
    from rfx_torch import cir, cli
    from rfx_torch.api import Tracer
    from rfx_torch.coverage import _dbm_cancel_from_segments
    from rfx_torch.ops.coverage_hist import (
        coverage_hist,
        coverage_hist_plain,
        coverage_slabs,
        reduce_planes,
        reduce_planes_plain,
    )
    from rfx_torch.sampler import morton_sphere_directions
    from rfx_torch.tracer import EnvSegments

    dirs = morton_sphere_directions(COV_RAYS, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    hkw = dict(nbins=COV_BINS, light_speed_mps=C, sample_rate_hz=RATE)
    fkw = dict(num_rays=COV_RAYS, sample_window_s=COV_WINDOW, sample_rate_hz=RATE,
               carrier_hz=2.4e9, light_speed_mps=C, tx_power=1.0, rx_batch=64)
    out = {"launches": {}}

    # 0. The slab reduction against its plain version at the sweeps' shape;
    #    the library's call for the same sum is `sum(dim=0)`.
    n_slabs = coverage_slabs(COV_RAYS)
    planes = torch.rand((n_slabs, 2048, COV_BINS), generator=torch.Generator(dev).manual_seed(5),
                        device=dev)
    got, want = reduce_planes(planes), reduce_planes_plain(planes)
    _require(torch.equal(got, want), "slab reduction: kernel != plain")
    red = out["reduce"] = {
        "planes": n_slabs, "max_abs_err": float((got - want).abs().max()),
        "ms": _cuda_ms(lambda: reduce_planes(planes), 5),
        "plain_ms": _cuda_ms(lambda: reduce_planes_plain(planes), 2),
        "library_ms": _cuda_ms(lambda: planes.sum(dim=0), 5),
        "bound": _bound(4 * planes.numel() + 4 * 2048 * COV_BINS, (n_slabs - 1) * 2048 * COV_BINS)}
    print(f"# slab reduction, {n_slabs} planes of 2048 x {COV_BINS}: kernel == plain bit for bit; "
          f"kernel {red['ms']:.4f} ms, plain {red['plain_ms']:.4f} ms, sum(dim=0) "
          f"{red['library_ms']:.4f} ms, bound {red['bound']['bound_ms']:.4f} ms by "
          f"{red['bound']['bound_by']}", flush=True)
    del planes, got, want
    torch.cuda.empty_cache()
    meshes = {"room": make_room(), "terrain": terrain}
    for name, tx, zs in COV_SCENES:
        res = out[name] = {}
        mesh = meshes[name]
        tracer, grid, segs, scaled = coverage_workload(mesh, tx, zs, dirs, dev)
        m = grid.shape[0]
        centers = torch.as_tensor(grid, device=dev)
        _sync()
        _require(m == 2048 and tracer.backend == ("brute" if name == "room" else "fused"),
                 f"coverage {name}: {m} receivers, backend {tracer.backend}")

        # 1. K3 against its plain version on the card's own segments.
        k1 = coverage_hist(scaled, centers, COV_RADIUS, **hkw)
        k2 = coverage_hist(scaled, centers, COV_RADIUS, **hkw)
        p = coverage_hist_plain(scaled, centers, COV_RADIUS, **hkw)
        _sync()
        _require(torch.equal(k1, k2), f"coverage kernel, {name}: two runs differ")
        _require(torch.equal(k1 != 0, p != 0), f"coverage kernel, {name}: nonzero bins differ")
        _require(torch.allclose(k1, p, rtol=1e-5, atol=1e-12),
                 f"coverage kernel, {name}: kernel != plain")
        alone = coverage_hist(scaled, centers[777:778], COV_RADIUS, **hkw)
        _require(torch.equal(alone[0], k1[777]) and bool((alone != 0).any()),
                 f"coverage kernel, {name}: receiver 777 alone differs from it in the group")
        res["max_abs_err"] = float((k1 - p).abs().max())
        res["k3_ms"] = _cuda_ms(lambda: coverage_hist(scaled, centers, COV_RADIUS, **hkw), 5)
        res["plain_ms"] = _cuda_ms(lambda: coverage_hist_plain(scaled, centers, COV_RADIUS, **hkw), 1)
        # Each live segment is tested against each receiver's sphere (3 sub,
        # two dot products, the discriminant and its compare: 17 f32
        # operations); segments and centers are read once, the IRs written once.
        seg_bytes = sum(int(t.numel() * t.element_size()) for t in scaled)
        res["bound"] = _bound(seg_bytes + 12 * m + 4 * m * COV_BINS,
                              17 * m * int(scaled.alive.sum()))
        n_lit = int((k1 != 0).any(dim=1).sum())
        print(f"# coverage kernel, {name}, {m} receivers x 2 x {COV_RAYS} segments, {COV_BINS} "
              f"bins: kernel == plain ({int((k1 != 0).sum())} nonzero bins, {n_lit} receivers "
              f"lit, max |d| {res['max_abs_err']:.3e}), bit-identical across runs and alone; kernel "
              f"{res['k3_ms']:.3f} ms, plain {res['plain_ms']:.1f} ms, bound "
              f"{res['bound']['bound_ms']:.3f} ms by {res['bound']['bound_by']}", flush=True)
        del k2, p

        # 1b. K-P on K3's IRs (the exact sweep's) and K-F on the segments,
        #     each against its plain version on the card.
        res["rx_power"] = _rx_power_leg(k1, COV_WINDOW, f"rx_power kernel, {name}")
        res["rx_power_backward"] = _rx_power_backward_leg(k1, COV_WINDOW,
                                                          f"rx_power kernel, {name}")
        res["phasor"] = _phasor_leg(segs, centers, fkw, f"phasor kernel, {name}")
        torch.cuda.empty_cache()

        # 2. The exact metric through the command line (room), with
        #    rx_power_dbm on the card twice and on the CPU.
        if name == "room":
            with tempfile.TemporaryDirectory() as tmp:
                save = os.path.join(tmp, "dbm.npy")
                argv = ["coverage", "--scene", "room", "--rays", str(COV_RAYS), "--tx", "3", "2",
                        "2", "--rx-radius", str(COV_RADIUS), "--metric", "exact", "--no-viz",
                        "--save-dbm", save, "--device", "cuda"]
                (rc, launches), host_s, ev_ms = _timed(lambda: _counted(
                    kernels, "coverage_exact", (K_COV, K_REDUCE, K_POWER, K_BRUTE),
                    lambda: cli.main(argv)))
                rows = np.load(save)
            out["launches"]["coverage_exact"] = launches
            _require(rc == 0 and rows.shape == (2048, 4), f"coverage CLI: rc {rc}, {rows.shape}")
            # The same request through the facade (its generator redraws the
            # CLI's directions): the IRs, and the same dBm bit for bit.
            cli_tracer = Tracer(mesh, C, RATE, COV_WINDOW, max_bounces=2, tx_num_rays=COV_RAYS,
                                device=dev)
            irs = torch.as_tensor(cli_tracer.compute_coverage(tx, 1.0, grid, COV_RADIUS), device=dev)
            d1, _ = cir.rx_power_dbm(irs, COV_WINDOW)
            d2, _ = cir.rx_power_dbm(irs, COV_WINDOW)
            _sync()
            lit = (irs != 0).any(dim=1).cpu().numpy()
            d1 = d1.cpu().numpy()
            _require(np.array_equal(rows[:, :3], grid) and np.array_equal(rows[:, 3], d1),
                     "coverage CLI: saved rows differ from the facade's")
            _require(np.array_equal(np.isfinite(rows[:, 3]), lit) and lit.sum() > 1000,
                     f"coverage CLI: dBm finite at {int(np.isfinite(rows[:, 3]).sum())} "
                     f"receivers, IR nonzero at {int(lit.sum())}")
            _require(np.array_equal(d1, d2.cpu().numpy()), "rx_power_dbm: two card runs differ")
            d_cpu, _ = cir.rx_power_dbm(irs.cpu(), COV_WINDOW)
            d_cpu = d_cpu.numpy()
            fin = np.isfinite(d_cpu)
            _require(np.array_equal(np.isfinite(d1), fin), "rx_power_dbm: card vs CPU -inf")
            dbm_err = float(np.abs(d1[fin] - d_cpu[fin]).max())
            _require(dbm_err < 1e-3, f"rx_power_dbm: card vs CPU differ by {dbm_err} dB")
            res.update(cli_host_s=host_s, cli_ms=ev_ms, rx_dbm_card_vs_cpu_db=dbm_err,
                       rx_dbm_bits_differ=int((d1 != d_cpu).sum()))
            print(f"# coverage CLI --metric exact, room: {host_s:.3f} s ({ev_ms:.1f} ms CUDA "
                  f"events), {int(lit.sum())} of 2048 receivers reached, dBm "
                  f"[{np.nanmin(np.where(lit, d1, np.nan)):.2f}, {np.nanmax(d1):.2f}]; "
                  f"rx_power_dbm (the kernel) bit-identical across two card runs, card vs CPU "
                  f"on {int(fin.size)} receivers max |d| {dbm_err:.3e} dB "
                  f"({res['rx_dbm_bits_differ']} differ in any bit)", flush=True)
            del irs

        # 3. Fast and hybrid through the facade, each counted; the fast
        #    metric's diagnostics against the CPU on every CPU_FAST_STRIDE-th
        #    receiver of the same segments.
        env_needs = (K_BRUTE,) if name == "room" else (K_HIT,)
        req = (tx, 1.0, grid, COV_RADIUS)
        (fast, launches), res["fast_host_s"], res["fast_ms"] = _timed(lambda: _counted(
            kernels, f"coverage_fast_{name}", PHASOR_NEEDS + env_needs,
            lambda: tracer.compute_coverage_dbm_fast(*req, directions=dirs)))
        _require(launches[K_COV] == 0, f"fast metric, {name}: the coverage kernel ran")
        # One walk a sweep: the table, the walk and the spread once each.
        _require(all(launches[k] == 1 for k in PHASOR_NEEDS),
                 f"fast metric, {name}: the phasor metric's launches {launches}")
        out["launches"][f"coverage_fast_{name}"] = launches
        (hybrid, n_flagged), launches = _counted(
            kernels, f"coverage_hybrid_{name}", PHASOR_NEEDS + (K_COV, K_REDUCE, K_POWER) + env_needs,
            lambda: tracer.compute_coverage_dbm_hybrid(*req, directions=dirs))
        out["launches"][f"coverage_hybrid_{name}"] = launches
        dbm_k, ratio_k, spread_k = (x.cpu().numpy() for x in _dbm_cancel_from_segments(
            segs, centers, COV_RADIUS, **fkw))
        _require(np.array_equal(fast, dbm_k), f"fast metric, {name}: facade != its segments'")
        sub = slice(0, 2048, CPU_FAST_STRIDE)
        segs_cpu = EnvSegments(*(t.cpu() for t in segs))
        dbm_c, ratio_c, spread_c = (x.numpy() for x in _dbm_cancel_from_segments(
            segs_cpu, grid[sub], COV_RADIUS, **fkw))
        fin = np.isfinite(dbm_c)
        _require(np.array_equal(np.isfinite(dbm_k[sub]), fin), f"fast metric, {name}: -inf")
        fast_err = float(np.abs(dbm_k[sub][fin] - dbm_c[fin]).max())
        _require(fast_err < 1e-3, f"fast metric, {name}: card vs CPU {fast_err} dB")
        for what, a, b in (("ratio", ratio_k[sub], ratio_c), ("spread", spread_k[sub], spread_c)):
            _require(np.allclose(a, b, rtol=1e-4, atol=0), f"fast metric, {name}: {what} differs")
        flags_k = (ratio_k < 0.5) | (spread_k > 10e-9)
        flags_c = (ratio_c < 0.5) | (spread_c > 10e-9)
        edge = ((np.abs(ratio_c - 0.5) <= 1e-4 * 0.5)
                | (np.abs(spread_c - 10e-9) <= 1e-4 * 10e-9))
        _require(np.array_equal(flags_k[sub][~edge], flags_c[~edge]),
                 f"hybrid, {name}: flagged set differs from the CPU's")
        _require(n_flagged == int(flags_k.sum()), f"hybrid, {name}: n_flagged {n_flagged}")
        wholesale = n_flagged > 0.15 * m

        # 4. Exact through the facade, split into K3 and rx_power_dbm; the
        #    hybrid against it and the fast metric.
        irs_np, res["exact_host_s"], res["exact_ms"] = _timed(
            lambda: tracer.compute_coverage(*req, directions=dirs))
        irs = torch.as_tensor(irs_np, device=dev)
        (exact, _), _, res["rx_dbm_ms"] = _timed(lambda: cir.rx_power_dbm(irs, COV_WINDOW))
        exact = exact.cpu().numpy()
        _require(np.array_equal(irs_np, k1.cpu().numpy()), f"exact, {name}: IRs differ from K3's")
        redo = np.ones(m, bool) if wholesale else flags_k
        ok = np.isfinite(exact)
        _require(np.array_equal(np.isfinite(hybrid), ok), f"hybrid, {name}: -inf pattern")
        # K3 and K-P give a receiver the same bits alone as in any group, so
        # the re-evaluated receivers equal the exact sweep's bit for bit.
        _require(np.array_equal(hybrid[redo], exact[redo])
                 and np.array_equal(hybrid[~redo], fast[~redo]),
                 f"hybrid, {name}: not the exact bits where re-evaluated and fast elsewhere")
        _, res["hybrid_host_s"], res["hybrid_ms"] = _timed(
            lambda: tracer.compute_coverage_dbm_hybrid(*req, directions=dirs))
        gap = np.abs(fast[ok] - exact[ok])
        res.update(fast_card_vs_cpu_db=fast_err, n_flagged=n_flagged, flag_rate=n_flagged / m,
                   wholesale=bool(wholesale), reached=int(ok.sum()),
                   fast_vs_exact_db={"median": float(np.median(gap)),
                                     "p95": float(np.percentile(gap, 95)),
                                     "max": float(gap.max())},
                   hybrid_vs_exact_db_max=float(np.abs(hybrid[ok] - exact[ok]).max()))
        print(f"# coverage, {name}: {n_flagged} of {m} receivers flagged "
              f"({100.0 * n_flagged / m:.1f}%), {'wholesale' if wholesale else 'subset'} exact "
              f"fallback; fast card vs CPU on {int(fin.size)} receivers max |d| "
              f"{fast_err:.3e} dB; fast vs exact median {res['fast_vs_exact_db']['median']:.3f} "
              f"/ max {res['fast_vs_exact_db']['max']:.3f} dB, hybrid vs exact max "
              f"{res['hybrid_vs_exact_db_max']:.3f} dB", flush=True)
        print(f"# coverage times, {name}: exact {res['exact_host_s'] * 1e3:.1f} ms host / "
              f"{res['exact_ms']:.1f} ms events for the IRs (K3 {res['k3_ms']:.3f} ms) + "
              f"rx_power_dbm {res['rx_dbm_ms']:.1f} ms; fast {res['fast_host_s'] * 1e3:.1f} / "
              f"{res['fast_ms']:.1f} ms; hybrid {res['hybrid_host_s'] * 1e3:.1f} / "
              f"{res['hybrid_ms']:.1f} ms", flush=True)
        del segs, scaled, segs_cpu, k1, irs
        torch.cuda.empty_cache()
    return out


def _mean_finite(dbm):
    import torch

    fin = torch.isfinite(dbm)
    return torch.where(fin, dbm, torch.zeros((), device=dbm.device)).sum() / fin.sum()


def _fd_check(loss_at, log_n1: float, grad: float, h: float, what: str) -> dict:
    """A central difference of `loss_at` (a forward without autograd) in
    log n1 with step h against the autograd derivative: within 1%."""
    import torch

    with torch.no_grad():
        fd = (float(loss_at(log_n1 + h)) - float(loss_at(log_n1 - h))) / (2 * h)
    rel = abs(grad - fd) / max(abs(fd), 1e-30)
    _require(rel < 0.01, f"{what}: d/d log n1 {grad} vs central difference {fd} (step {h})")
    return {"fd": fd, "autograd": grad, "step": h, "rel_err": rel}


def _coverage_grad_phase(terrain, dev, kernels):
    """Phase 16: the coverage metrics' value+grad at full width, counted on
    their own; returns what it measured, with the launch counts of each path."""
    import math

    import torch

    from rfx_torch import cir
    from rfx_torch.coverage import coverage_dbm, coverage_dbm_fast, coverage_irs
    from rfx_torch.geometry import make_room
    from rfx_torch.ops import coverage_hist as ch
    from rfx_torch.sampler import morton_sphere_directions

    dirs = morton_sphere_directions(COV_RAYS, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    log_n1_0 = math.log(5.0)
    base = dict(max_bounces=2, num_rays=COV_RAYS, sample_window_s=COV_WINDOW,
                sample_rate_hz=RATE)
    kw = dict(nbins=COV_BINS, light_speed_mps=C, sample_rate_hz=RATE, sample_window_s=COV_WINDOW,
              carrier_hz=2.4e9)
    out = {"launches": {}}
    meshes = {"room": make_room(), "terrain": terrain}
    for name, tx, zs in COV_SCENES:
        tracer, grid, segs, scaled = coverage_workload(meshes[name], tx, zs, dirs, dev)
        centers = torch.as_tensor(grid, device=dev)
        fast_kw = dict(base, env_hit=tracer.env_hit)

        def fast_loss(log_n1, tx_p, c=centers):
            return _mean_finite(coverage_dbm_fast(tracer.scene, tx_p, dirs, c, COV_RADIUS,
                                                  n1=torch.exp(log_n1), **fast_kw))

        def fast_valgrad():
            log_n1 = torch.tensor(log_n1_0, device=dev, requires_grad=True)
            tx_p = torch.tensor(tx, device=dev, requires_grad=True)
            loss = fast_loss(log_n1, tx_p)
            g = torch.autograd.grad(loss, [log_n1, tx_p], allow_unused=True,
                                    materialize_grads=True)
            return loss.detach(), g[0], g[1]

        fast_valgrad()  # warm-up
        needs = (*PHASOR_NEEDS, K_PHASOR_BACKWARD) + ((K_BRUTE,) if name == "room" else (K_HIT,))
        (loss, g_n1, g_tx), launches = _counted(kernels, f"coverage_fast_grad_{name}", needs,
                                                fast_valgrad)
        out["launches"][f"coverage_fast_grad_{name}"] = launches
        _require(all(launches[k] == 1 for k in (*PHASOR_NEEDS, K_PHASOR_BACKWARD))
                 and launches[K_COV] == 0,
                 f"fast metric value+grad, {name}: launches {launches}")
        again = fast_valgrad()
        _sync()
        _require(all(torch.equal(a, b) for a, b in zip((loss, g_n1, g_tx), again)),
                 f"fast metric value+grad, {name}: two runs differ")
        _require(torch.equal(g_tx, torch.zeros_like(g_tx)),
                 f"fast metric, {name}: d/d tx is {g_tx.tolist()}, not exactly 0")
        fd = _fd_check(lambda v: fast_loss(torch.tensor(v, device=dev),
                                           torch.tensor(tx, device=dev)),
                       log_n1_0, float(g_n1), 2e-3, f"fast metric, {name}")
        # The kernel's g_amplitude against its plain version on the same
        # forward, for this loss's cotangent (1 / n on the reached receivers).
        amp = scaled.amplitude.detach().clone().requires_grad_()
        fwd = ch.coverage_phasor(scaled._replace(amplitude=amp), centers, COV_RADIUS, **kw)
        fin = torch.isfinite(fwd[0])
        g_dbm = torch.where(fin, 1.0 / fin.sum(), torch.zeros((), device=dev)).float()
        (g_amp,) = torch.autograd.grad(fwd[0], amp, grad_outputs=g_dbm)
        sums, _ = ch._phasor_sums(scaled, centers, COV_RADIUS, **kw)
        g_plain = ch.phasor_backward_plain(
            scaled, centers, COV_RADIUS, ch.phasor_coefficients(sums, fwd[2].detach(), g_dbm), **kw)
        _sync()
        g_scale = float(g_plain.abs().max())
        _require(torch.allclose(g_amp, g_plain, rtol=1e-4, atol=1e-6 * g_scale),
                 f"fast metric, {name}: g_amplitude != phasor_backward_plain")
        res = out[f"fast_{name}"] = {
            "loss": float(loss), "d_log_n1": float(g_n1), "d_tx": g_tx.tolist(), "fd": fd,
            "g_amp_max_abs_err": float((g_amp - g_plain).abs().max()), "g_amp_max": g_scale,
            "valgrad_ms": _cuda_ms(fast_valgrad, 3),
            "forward_ms": _cuda_ms(lambda: fast_loss(torch.tensor(log_n1_0, device=dev),
                                                     torch.tensor(tx, device=dev)), 3)}
        print(f"# coverage fast value+grad, {name}, {centers.shape[0]} receivers x 2 x {COV_RAYS}: "
              f"loss {res['loss']:.6f} dBm, d/d log n1 {res['d_log_n1']:.6e} (central difference, "
              f"step {fd['step']}: {fd['fd']:.6e}, rel {fd['rel_err']:.2e}), d/d tx exactly 0; "
              f"g_amplitude == plain (max |d| {res['g_amp_max_abs_err']:.3e} of {g_scale:.3e}), "
              f"bit-identical across runs; value+grad {res['valgrad_ms']:.2f} ms, forward "
              f"{res['forward_ms']:.2f} ms", flush=True)
        del amp, fwd, g_amp, g_plain, segs, scaled

        if name != "room":
            continue
        # The exact metric with soft binning on 64 of the room's receivers
        # (every 32nd): the map engine, K-H, K-P and their backwards.
        few = centers[::32].contiguous()
        exact_kw = dict(base, env_hit=tracer.env_hit, soft=True, rx_batch=64, engine="map")

        def exact_loss(log_n1, tx_p):
            return _mean_finite(coverage_dbm(tracer.scene, tx_p, dirs, few, COV_RADIUS,
                                             n1=torch.exp(log_n1), **exact_kw))

        def exact_valgrad():
            log_n1 = torch.tensor(log_n1_0, device=dev, requires_grad=True)
            tx_p = torch.tensor(tx, device=dev, requires_grad=True)
            loss = exact_loss(log_n1, tx_p)
            g = torch.autograd.grad(loss, [log_n1, tx_p])
            return loss.detach(), g[0], g[1]

        exact_valgrad()  # warm-up
        ((loss, g_n1, g_tx), plain_calls), launches = _counted(
            kernels, "coverage_exact_grad_room",
            (K_MAP, K_HIST_RECORD, K_POWER, K_POWER_BACKWARD, K_MAP_BACKWARD, K_BRUTE),
            lambda: _plain_calls(exact_valgrad))
        out["launches"]["coverage_exact_grad_room"] = launches
        # The histogram's backward is in the map capture's backward: the
        # histogram's record entry launches once, in the forward.
        _require(all(launches[k] == 1 for k in (K_MAP, K_HIST_RECORD, K_POWER, K_POWER_BACKWARD,
                                                K_MAP_BACKWARD))
                 and launches[K_COV] == launches[K_HIST] == 0 and plain_calls == 0,
                 f"exact metric value+grad: launches {launches}, {plain_calls} plain "
                 f"first-capture calls")
        again = exact_valgrad()
        _sync()
        _require(all(torch.equal(a, b) for a, b in zip((loss, g_n1, g_tx), again)),
                 "exact metric value+grad: two runs differ")
        _require(bool(torch.isfinite(g_tx).all()) and bool((g_tx != 0).any()),
                 f"exact metric: d/d tx {g_tx.tolist()}")
        fd = _fd_check(lambda v: exact_loss(torch.tensor(v, device=dev),
                                            torch.tensor(tx, device=dev)),
                       log_n1_0, float(g_n1), 2e-3, "exact metric")
        # K-P's backward against its plain version on all 64 rows, for this
        # loss's cotangent, on the same forward.
        with torch.no_grad():
            irs = coverage_irs(tracer.scene, torch.tensor(tx, device=dev), dirs, few, COV_RADIUS,
                               nbins=COV_BINS, n1=5.0, **{k: v for k, v in exact_kw.items()
                                                          if k != "sample_window_s"})
        x = irs.clone().requires_grad_()
        dbm, _ = cir.rx_power_dbm(x, COV_WINDOW)
        fin = torch.isfinite(dbm)
        g_dbm = torch.where(fin, 1.0 / fin.sum(), torch.zeros((), device=dev)).float()
        (g_ir,) = torch.autograd.grad(dbm, x, grad_outputs=g_dbm)
        kern = cir.carrier_cached(COV_BINS, COV_WINDOW, 2.4e9, dev)
        sig, _, sums = cir._rx_power_launch(irs, kern)
        g_plain = cir.rx_power_backward_plain(g_dbm, None, sig, sums, kern)
        _sync()
        g_scale = float(g_plain.abs().max())
        _require(torch.allclose(g_ir, g_plain, rtol=1e-4, atol=1e-5 * g_scale),
                 "exact metric: K-P's g_ir != rx_power_backward_plain")
        res = out["exact_room"] = {
            "receivers": int(few.shape[0]), "loss": float(loss), "d_log_n1": float(g_n1),
            "d_tx": g_tx.tolist(), "fd": fd,
            "g_ir_max_abs_err": float((g_ir - g_plain).abs().max()), "g_ir_max": g_scale,
            "valgrad_ms": _cuda_ms(exact_valgrad, 3),
            "forward_ms": _cuda_ms(lambda: exact_loss(torch.tensor(log_n1_0, device=dev),
                                                      torch.tensor(tx, device=dev)), 3)}
        torch.cuda.reset_peak_memory_stats(dev)
        exact_valgrad()
        res["valgrad_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(f"# coverage exact (soft) value+grad, room, {few.shape[0]} receivers x 2 x "
              f"{COV_RAYS}: loss {res['loss']:.6f} dBm, d/d log n1 {res['d_log_n1']:.6e} (central "
              f"difference, step {fd['step']}: {fd['fd']:.6e}, rel {fd['rel_err']:.2e}), d/d tx "
              f"{[round(v, 6) for v in res['d_tx']]}; K-P g_ir == plain on all rows (max |d| "
              f"{res['g_ir_max_abs_err']:.3e} of {g_scale:.3e}), bit-identical across runs; "
              f"value+grad {res['valgrad_ms']:.2f} ms, forward {res['forward_ms']:.2f} ms, peak "
              f"{res['valgrad_peak_bytes'] / 2**30:.2f} GiB", flush=True)
        del irs, x, g_ir, g_plain
        torch.cuda.empty_cache()
    return out


def _brute_bound(n: int, passes: int, n_tris: int, cull: bool) -> dict:
    """K-B's bound on n rays against n_tris faces: 24 bytes of ray in and 8
    of t and face out a ray, the faces and the cull's sphere read once; the
    cull's operations on every ray where there is one, and 54 a test on the
    rays that pass it (all rays without a cull)."""
    return _bound(32 * n + 36 * n_tris + (16 if cull else 0),
                  ((CULL_FLOPS + RAY_NORM_FLOPS) * n if cull else 0)
                  + MT_TEST_FLOPS * n_tris * passes)


def _cull_passes(o, d, centers, radius) -> int:
    """(ray, receiver) pairs of the rays (L, 3) and the (m, 3) centers that
    pass the icosphere's cull (intersect.cull_pass, the kernel's predicate)."""
    import torch

    from rfx_torch.ops import intersect

    total = 0
    for c in centers:
        sphere = torch.cat([c.reshape(3), torch.tensor([radius], device=c.device)])
        total += int(intersect.cull_pass(o, d, sphere).sum())
    return total


def brute_request_inputs(dirs):
    """K-B's inputs at the icosphere request's first bounce: (o, d, v0, e1,
    e2, cull), the rays `dirs` from TX against the receiver icosphere at RX
    (radius RX_RADIUS) with its bounding sphere as the cull."""
    import torch

    from rfx_torch.ops.intersect import icosphere_soa

    dev = dirs.device
    o = torch.tensor(TX, device=dev).expand(dirs.shape[0], 3).contiguous()
    rx = torch.tensor(RX, device=dev)
    cull = torch.cat([rx, torch.tensor([RX_RADIUS], device=dev)])
    return (o, dirs, *icosphere_soa(rx, RX_RADIUS), cull)


def brute_env_inputs(scene, segs):
    """K-B's inputs on an environment: (o, d, v0, e1, e2, None), every
    segment of `segs` (both bounces' queries) against the faces of `scene`,
    no cull."""
    from rfx_torch.ops.intersect import mesh_soa

    return (segs.origin.reshape(-1, 3), segs.direction.reshape(-1, 3),
            *mesh_soa(scene.vertices, scene.faces), None)


def fused_ico_bound(bvh, dirs, tx, rx, radius) -> dict:
    """Bound of one fused trace with the icosphere receiver of `radius` on
    `dirs`: the analytic trace's (`_fused_bound`, from the counted walk on
    the same rays), the unit faces read once, the cull's operations on every
    ray-bounce, and the 80 tests of each ray that passes the cull at the
    first bounce."""
    import torch

    from rfx_torch.ops.fused import fused_trace
    from rfx_torch.ops.intersect import cull_pass

    trace, stats = fused_trace(bvh, dirs, tx, rx, radius, 5.0, 1.0, max_bounces=BOUNCES,
                               count_stats=True)
    s = stats.cpu()
    n, ray_bounces = int(dirs.shape[0]), int(trace.num_bounces.sum())
    walk = _fused_bound(bvh, {"rays": n, "ray_bounces": ray_bounces,
                              "nodes_per_bounce": s[:, 0].tolist(),
                              "tris_per_bounce": s[:, 2].tolist()})
    o = torch.tensor(tx, dtype=torch.float32, device=dirs.device).expand_as(dirs)
    cull = torch.tensor([*rx, radius], dtype=torch.float32, device=dirs.device)
    passes = int(cull_pass(o, dirs, cull).sum())
    return {**_bound(walk["bound_bytes"] + ICO_TRI_BYTES,
                     walk["bound_flops"] + (CULL_FLOPS + RAY_NORM_FLOPS) * (n + ray_bounces)
                     + MT_TEST_FLOPS * ICO_FACES * passes),
            "cull_passes_bounce0": passes}


def _icosphere_cir_leg(terrain, dev, kernels, card):
    """Phase 17, the request: Tracer(bench terrain, rx_mode="icosphere")
    .compute_cir at the bench workload, at radius 1.0 and 0.1, counted (K1's
    icosphere entry point once, the order once, K-H; no K-B, no K2, no
    analytic K1) and timed (CUDA events, seven runs); the IR the same bits in
    eight runs, and within rtol 1e-4 (the same nonzero bins) of the scan
    tracer's with the icosphere receiver, counted too (K2 for the terrain,
    K-B once a bounce for the receiver: what recorded paths run); the fused
    trace of every 80th ray (the caller's order) and of the first
    ORDER_MIN_RAYS i.i.d. rays (cell order) == fused_trace_plain(rx_mode=
    "icosphere")'s bit for bit, the face record too (the plain receiver
    tests every ray at every bounce: no cull); the CIR cells' 5,242,880
    i.i.d. rays in cell order == the caller's order bit for bit, and at
    radius 0.1 the time of that call and its bound. Then K-B alone on the
    request's first bounce (5,242,880 rays from tx against the receiver
    icosphere, with its cull) against `_brute_forward`, timed beside it."""
    import numpy as np
    import torch

    from rfx_torch.api import Tracer
    from rfx_torch.ops import fused as fused_mod
    from rfx_torch.ops import intersect
    from rfx_torch.sampler import morton_sphere_directions
    from rfx_torch.tracer import trace_to_rx

    dirs = morton_sphere_directions(N_RAYS, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    iid = iid_directions(dev)
    tracer = Tracer(terrain, C, RATE, WINDOW, max_bounces=BOUNCES, tx_num_rays=N_RAYS,
                    rx_mode="icosphere", device=dev)
    _require(tracer.backend == "fused" and tracer._fused is not None,
             f"icosphere Tracer: backend {tracer.backend}, fused kernel {tracer._fused}")
    bvh = tracer._fused.bvh
    sub = dirs[::N_RAYS // SUBSET].contiguous()
    first = iid[:fused_mod.ORDER_MIN_RAYS].contiguous()
    out = {"launches": {}}
    for radius in ICO_RADII:
        tag = f"r{radius:g}"
        res = out[tag] = {}
        args = (TX, RX, radius, 5.0, 1.0)
        kw = dict(max_bounces=BOUNCES, rx_mode="icosphere")

        def request():
            return tracer.compute_cir(TX, 1.0, RX, radius, directions=dirs, record_paths=False)[1]

        def scan():
            result = trace_to_rx(tracer.scene, TX, dirs, RX, radius, max_bounces=BOUNCES,
                                 rx_mode="icosphere", env_hit=tracer.env_hit)
            return tracer._cir(result, 1.0).cpu().numpy()

        request()  # warm-up
        (ir, plain_calls), launches = _counted(kernels, f"icosphere_cir_{tag}",
                                               (K_FUSED_ICO, K_ORDER, K_HIST),
                                               lambda: _plain_calls(request))
        out["launches"][f"icosphere_cir_{tag}"] = launches
        _require(launches[K_FUSED_ICO] == 1 and launches[K_ORDER] == 1
                 and launches[K_BRUTE] == launches[K_HIT] == launches[K_FUSED] == 0
                 and plain_calls == 0,
                 f"icosphere request, radius {radius}: launches {launches}, {plain_calls} plain "
                 f"calls")
        _require(ir.shape == (NBINS,) and np.all(np.isfinite(ir)) and float(ir.sum()) > 0,
                 f"icosphere request, radius {radius}: IR shape {ir.shape}, sum {ir.sum()}")
        times = []
        for _ in range(7):
            again, _, ev_ms = _timed(request)
            _require(np.array_equal(again, ir), f"icosphere request, radius {radius}: runs differ")
            times.append(ev_ms)
        scan()  # warm-up
        (scan_ir, scan_plain), scan_launches = _counted(kernels, f"icosphere_scan_{tag}",
                                                        (K_BRUTE, K_HIT, K_HIST),
                                                        lambda: _plain_calls(scan))
        out["launches"][f"icosphere_scan_{tag}"] = scan_launches
        _require(scan_launches[K_BRUTE] == BOUNCES
                 and scan_launches[K_FUSED] == scan_launches[K_FUSED_ICO] == 0
                 and scan_plain == 0,
                 f"icosphere scan request, radius {radius}: launches {scan_launches}, "
                 f"{scan_plain} plain calls")
        _require(np.array_equal(ir != 0, scan_ir != 0)
                 and np.allclose(ir, scan_ir, rtol=1e-4, atol=1e-9),
                 f"icosphere request, radius {radius}: the IR differs from the scan tracer's")
        for name, d in (("subset", sub), ("cell_order", first)):
            k = fused_mod.fused_trace(bvh, d, *args, record_faces=True, **kw)
            p = fused_mod.fused_trace_plain(bvh, d, *args, record_faces=True, **kw)
            _sync()
            _require(all(map(torch.equal, [*k[0][:4], k[1]], [*p[0][:4], p[1]])),
                     f"icosphere fused trace, radius {radius}, {name}: kernel != plain")
            res[f"captured_{name}"] = int(p[0].captured.sum())
            del k, p
        ordered = fused_mod.fused_trace(bvh, iid, *args, **kw)
        with _caller_order():
            caller = fused_mod.fused_trace(bvh, iid, *args, **kw)
        _sync()
        _require(all(map(torch.equal, ordered[:4], caller[:4])),
                 f"icosphere fused trace, radius {radius}: cell order != the caller's order")
        if radius == ICO_RADII[-1]:  # the CIR cells' receivers
            res["iid_ms"] = _cuda_ms(lambda: fused_mod.fused_trace(bvh, iid, *args, **kw), 10)
            res["bound"] = fused_ico_bound(bvh, iid, TX, RX, radius)
        res.update(iid_captured=int(ordered.captured.sum()),
                   nonzero_bins=int((ir != 0).sum()), ir_sum=float(ir.sum()), ms=times,
                   dbm=float(tracer.rx_power_dbm(ir)))
        timing = (f"; {N_RAYS} i.i.d. rays {res['iid_ms']:.4f} ms a call, bound "
                  f"{res['bound']['bound_ms']:.4f} ms by {res['bound']['bound_by']}"
                  if "iid_ms" in res else "")
        print(f"# icosphere compute_cir, radius {radius}, {N_RAYS} rays: IR sum "
              f"{res['ir_sum']:.6e} ({res['nonzero_bins']} nonzero bins, {res['dbm']:.4f} dBm), "
              f"the same bits in 8 runs, == the scan tracer's within rtol 1e-4 (K-B "
              f"{scan_launches[K_BRUTE]} launches, one a bounce); launches "
              f"{launches[K_FUSED_ICO]} of K1/ico, none of K-B or K2; K1/ico == plain bit for bit "
              f"on {SUBSET} rays (caller's order, {res['captured_subset']} captures) and "
              f"{first.shape[0]} i.i.d. rays (cell order, {res['captured_cell_order']}); "
              f"{N_RAYS} i.i.d. rays: cell order == the caller's{timing}; request min / median / "
              f"max {min(times):.3f} / {float(np.median(times)):.3f} / {max(times):.3f} ms (CUDA "
              f"events); {card}", flush=True)
        del ordered, caller

    # K-B alone at the request's first bounce, radius 1.0.
    o, _, v0, e1, e2, cull = brute_request_inputs(dirs)
    k1 = intersect.brute_hit(o, dirs, v0, e1, e2, cull=cull)
    k2 = intersect.brute_hit(o, dirs, v0, e1, e2, cull=cull)
    p = intersect._brute_forward(o, dirs, v0, e1, e2, intersect.T_MIN_EPS, intersect.T_MAX, None)
    _sync()
    for a, b, c in zip(k1, k2, p):
        _require(torch.equal(a, b) and torch.equal(a, c), "K-B: kernel != plain, request's rays")
    passes = int(intersect.cull_pass(o, dirs, cull).sum())
    kb = out["kernel"] = {
        "rays": N_RAYS, "cull_passes": passes, "hits": int((k1[1] >= 0).sum()),
        "ms": _cuda_ms(lambda: intersect.brute_hit(o, dirs, v0, e1, e2, cull=cull), 20),
        "device_ms": device_ms(lambda: intersect.brute_hit(o, dirs, v0, e1, e2, cull=cull), 20),
        "queued_ms": queued_ms(lambda: intersect.brute_hit(o, dirs, v0, e1, e2, cull=cull), 20),
        "plain_ms": _cuda_ms(lambda: intersect._brute_forward(
            o, dirs, v0, e1, e2, intersect.T_MIN_EPS, intersect.T_MAX, None), 1),
        "no_cull_ms": _cuda_ms(lambda: intersect.brute_hit(o, dirs, v0, e1, e2), 10),
        "bound": _brute_bound(N_RAYS, passes, ICO_FACES, True)}
    print(f"# K-B, the request's receiver (radius {RX_RADIUS}), {N_RAYS} rays from tx: kernel == "
          f"plain ({kb['hits']} hits; {passes} rays pass the cull); {kb['ms']:.4f} ms a call, "
          f"{kb['device_ms']:.4f} ms on the device ({kb['queued_ms']:.4f} queued), without the cull {kb['no_cull_ms']:.4f} ms, "
          f"plain {kb['plain_ms']:.1f} ms, bound {kb['bound']['bound_ms']:.4f} ms by "
          f"{kb['bound']['bound_by']}; {card}", flush=True)
    del o, k1, k2, p
    torch.cuda.empty_cache()
    return out


def icosphere_dirs(dev):
    """The icosphere sweeps' COV_RAYS Morton directions (seed 0)."""
    import torch

    from rfx_torch.sampler import morton_sphere_directions

    return morton_sphere_directions(COV_RAYS, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)


def icosphere_workload(mesh, tx, zs, dirs, dev):
    """(tracer, grid, segs, few) of one icosphere coverage sweep of phase
    17: the facade with rx_mode="icosphere" over `mesh`, the receiver grid,
    the environment trace of `dirs` from tx (2 bounces, the facade's
    environment query) and the grid's first 64 receivers on the card, the
    batch that K-S/ico and the record entry/ico are held and timed on."""
    import torch

    from rfx_torch.api import Tracer
    from rfx_torch.coverage import make_grid
    from rfx_torch.tracer import trace_env

    tracer = Tracer(mesh, C, RATE, COV_WINDOW, max_bounces=2, tx_num_rays=COV_RAYS,
                    rx_mode="icosphere", device=dev)
    grid = make_grid(range(-15, 16, 2), range(-15, 16, 2), zs)
    segs = trace_env(tracer.scene, tx, dirs, max_bounces=2, env_hit=tracer.env_hit)
    return tracer, grid, segs, torch.as_tensor(grid[:64], device=dev)


def ico_capture_bound(n_seg: int, live: int, passes: int, captured: int) -> dict:
    """K-S/ico on 64 receivers: the segments (29 bytes each), the centers,
    the unit faces, the record and each capture's t read or written once;
    the cull on every live segment and receiver, |d|^2 a live segment, the
    80 tests of each (segment, receiver) that passes it."""
    return _bound(29 * n_seg + 12 * 64 + ICO_TRI_BYTES + 64 * COV_RAYS + 4 * captured,
                  (CULL_FLOPS * 64 + RAY_NORM_FLOPS) * live + MT_TEST_FLOPS * ICO_FACES * passes)


def ico_entry_bound(captured: int, planes: int) -> dict:
    """The record entry/ico on K-S/ico's (64, COV_RAYS) record: the record,
    12 bytes a capture (amplitude, distance, K-S/ico's t) and the IRs once;
    four operations a capture and plane."""
    return _bound(64 * COV_RAYS + 12 * captured + planes * 4 * 64 * COV_BINS,
                  4 * planes * captured)


def _icosphere_coverage_leg(terrain, dev, kernels, card):
    """Phase 17, coverage: compute_coverage with rx_mode="icosphere" (2,048
    receivers x 1,048,576 rays x 2 bounces x 10,000 bins, the facade's map
    engine) on the room (its environment through K-B) and the terrain,
    counted, three runs the same bits; on the first 64 receivers against the
    plain composition (`_first_capture`, the dense histogram) on the same
    segments: K-S/ico's record byte for byte, the record entry/ico's IRs
    bit for bit hard and soft, the sweep's rows bit for bit; the composition
    timed once as the "before". K-B on the room's environment against its
    plain version. Then the icosphere's exact metric, soft, value+grad on 64
    of the room's receivers (phase 16's exact leg), and B11/ico against its
    plain version there."""
    import math

    import numpy as np
    import torch

    from rfx_torch import cir, coverage
    from rfx_torch.coverage import _amp_scale
    from rfx_torch.geometry import make_room
    from rfx_torch.ops import intersect
    from rfx_torch.ops import map_capture as mc

    dirs = icosphere_dirs(dev)
    hkw = dict(nbins=COV_BINS, light_speed_mps=C, sample_rate_hz=RATE)
    scale = float(_amp_scale(1.0, COV_RAYS, torch.device("cpu")))
    out = {"launches": {}}
    meshes = {"room": make_room(), "terrain": terrain}
    for name, tx, zs in COV_SCENES:
        res = out[name] = {}
        tracer, grid, segs, few = icosphere_workload(meshes[name], tx, zs, dirs, dev)
        m = grid.shape[0]

        def sweep():
            return tracer.compute_coverage(tx, 1.0, grid, COV_RADIUS, directions=dirs)

        sweep()  # warm-up
        env = (K_BRUTE,) if name == "room" else (K_HIT,)
        (irs, plain_calls), launches = _counted(
            kernels, f"coverage_ico_{name}", (K_MAP_ICO, K_HIST_RECORD_ICO) + env,
            lambda: _plain_calls(sweep))
        out["launches"][f"coverage_ico_{name}"] = launches
        batches = -(-m // 64)
        _require(launches[K_MAP_ICO] == launches[K_HIST_RECORD_ICO] == batches
                 and launches[K_MAP] == launches[K_HIST] == launches[K_COV] == 0
                 and plain_calls == 0,
                 f"icosphere coverage, {name}: launches {launches}, {plain_calls} plain calls")
        host, events = [], []
        for _ in range(3):
            again, host_s, ev_ms = _timed(sweep)
            _require(np.array_equal(again, irs), f"icosphere coverage, {name}: runs differ")
            host.append(host_s * 1e3)
            events.append(ev_ms)
        lit = int((irs != 0).any(axis=1).sum())
        _require(irs.shape == (m, COV_BINS) and lit > 100,
                 f"icosphere coverage, {name}: {lit} receivers lit")

        # The first 64 receivers against the plain composition.
        def ks_ico():
            return mc.map_record(segs, few, COV_RADIUS, "icosphere", t_first=True)

        record, t_first = ks_ico()
        again, t_again = ks_ico()
        (plain_record, plain_t), _, ks_plain_ms = _timed(
            lambda: mc.map_record_plain(segs, few, COV_RADIUS, "icosphere", t_first=True))
        cap = plain_record != mc.NO_CAPTURE
        _require(torch.equal(record, again) and torch.equal(record, plain_record)
                 and torch.equal(t_first[cap], t_again[cap])
                 and torch.equal(t_first[cap], plain_t[cap]),
                 f"K-S/ico, {name}: the record or t_first differs from the plain version's or "
                 f"between runs")
        captured = int(cap.sum())
        del plain_t, t_again

        def composition(soft_modes):
            t_rx, first = coverage._first_capture(segs, few, COV_RADIUS, "icosphere")
            zero = torch.zeros((), device=dev)
            amp = (torch.where(first, segs.amplitude, zero)
                   * _amp_scale(1.0, COV_RAYS, dev)).reshape(64, -1)
            dist = torch.where(first, segs.distance + t_rx, zero).reshape(64, -1)
            return [cir.histogram_rows(amp, dist, first.reshape(64, -1), soft=s, **hkw)
                    for s in soft_modes]

        (want_hard,), _, composition_ms = _timed(lambda: composition((False,)))
        (want_soft,) = composition((True,))
        _require(np.array_equal(irs[:64], want_hard.cpu().numpy()),
                 f"icosphere coverage, {name}: the sweep's rows differ from the plain composition")
        kh = {}
        for soft, want in ((False, want_hard), (True, want_soft)):
            tag = "soft" if soft else "hard"
            k1 = cir.histogram_record(record, segs, few, COV_RADIUS, scale, soft=soft,
                                      rx_mode="icosphere", t_first=t_first, **hkw)
            k2 = cir.histogram_record(record, segs, few, COV_RADIUS, scale, soft=soft,
                                      rx_mode="icosphere", t_first=t_first, **hkw)
            irs_f = mc.map_irs(segs, few, COV_RADIUS, scale=scale, soft=soft, rx_mode="icosphere",
                               **hkw)
            _sync()
            _require(torch.equal(k1, k2) and torch.equal(k1, want) and torch.equal(irs_f, want),
                     f"record entry/ico, {name}, {tag}: IRs differ from the plain composition's")

            def entry(soft=soft):
                return cir.histogram_record(record, segs, few, COV_RADIUS, scale, soft=soft,
                                            rx_mode="icosphere", t_first=t_first, **hkw)

            kh[f"{tag}_ms"] = _cuda_ms(entry, 10)
            kh[f"{tag}_device_ms"] = device_ms(entry, 10)
            kh[f"{tag}_queued_ms"] = queued_ms(entry, 20)
            kh[f"{tag}_plain_ms"] = _timed(lambda soft=soft: mc.histogram_record_plain(
                record, segs, few, COV_RADIUS, scale, soft=soft, rx_mode="icosphere", **hkw))[2]
            kh[f"bound_{tag}"] = ico_entry_bound(captured, 2 if soft else 1)
        live = segs.alive
        o_live, d_live = segs.origin[live], segs.direction[live]
        passes = _cull_passes(o_live, d_live, few, COV_RADIUS)
        n_seg = segs.t_env.numel()
        res.update(
            receivers=m, lit=lit, sweep_host_ms=host, sweep_ms=events,
            composition_64_ms=composition_ms, live_segments=int(live.sum()),
            captured_64=captured, cull_passes_64=passes, histogram=kh,
            ks_ms=_cuda_ms(ks_ico, 10), ks_device_ms=device_ms(ks_ico, 10),
            ks_queued_ms=queued_ms(ks_ico, 20), ks_plain_ms=ks_plain_ms,
            ks_bound=ico_capture_bound(n_seg, int(live.sum()), passes, captured))
        del t_first  # 4 bytes a receiver and ray: not held into the value+grad's peak
        if name == "room":
            # K-B on the room's environment (12 faces, no cull), both bounces' queries.
            o, d, v0, e1, e2, _ = brute_env_inputs(tracer.scene, segs)
            k = intersect.brute_hit(o, d, v0, e1, e2)
            p = intersect._brute_forward(o, d, v0, e1, e2, intersect.T_MIN_EPS, intersect.T_MAX,
                                         None)
            _sync()
            _require(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
                     "K-B: kernel != plain on the room's environment")
            n = o.shape[0]
            res["env"] = {
                "queries": n, "faces": int(v0.shape[0]),
                "ms": _cuda_ms(lambda: intersect.brute_hit(o, d, v0, e1, e2), 20),
                "queued_ms": queued_ms(lambda: intersect.brute_hit(o, d, v0, e1, e2), 20),
                "plain_ms": _cuda_ms(lambda: intersect._brute_forward(
                    o, d, v0, e1, e2, intersect.T_MIN_EPS, intersect.T_MAX, None), 2),
                "bound": _brute_bound(n, n, int(v0.shape[0]), False)}
        print(f"# icosphere coverage, {name}, {m} receivers x 2 x {COV_RAYS}, {COV_BINS} bins, "
              f"radius {COV_RADIUS}: {lit} receivers lit, three sweeps the same bits; K-S/ico "
              f"{launches[K_MAP_ICO]} and record entry/ico {launches[K_HIST_RECORD_ICO]} launches, "
              f"no plain call; first 64 receivers: record == plain byte for byte ({captured} "
              f"captures, {passes} (segment, receiver) pairs pass the cull), IRs == the plain "
              f"composition bit for bit, hard and soft; sweep {min(host):.1f}-{max(host):.1f} ms "
              f"host, {min(events):.1f}-{max(events):.1f} ms events; the plain composition on 64 "
              f"receivers {composition_ms:.1f} ms; K-S/ico {res['ks_ms']:.4f} ms a call, "
              f"{res['ks_device_ms']:.4f} on the device, {res['ks_queued_ms']:.4f} queued (plain "
              f"{ks_plain_ms:.1f} ms, bound "
              f"{res['ks_bound']['bound_ms']:.4f} ms by {res['ks_bound']['bound_by']}); record "
              f"entry/ico hard / soft {kh['hard_ms']:.4f} / {kh['soft_ms']:.4f} ms a call, "
              f"{kh['hard_device_ms']:.4f} / {kh['soft_device_ms']:.4f} on the device, "
              f"{kh['hard_queued_ms']:.4f} / {kh['soft_queued_ms']:.4f} queued (plain "
              f"{kh['hard_plain_ms']:.1f} / {kh['soft_plain_ms']:.1f} ms); {card}", flush=True)
        if name == "room":
            env = res["env"]
            print(f"# K-B, the room's environment, {env['queries']} queries x {env['faces']} "
                  f"faces: kernel == plain; {env['ms']:.4f} ms ({env['queued_ms']:.4f} queued), plain {env['plain_ms']:.2f} ms, "
                  f"bound {env['bound']['bound_ms']:.4f} ms by {env['bound']['bound_by']}",
                  flush=True)
            out["grad"] = _icosphere_grad(tracer, dirs, segs, torch.as_tensor(grid, device=dev),
                                          kernels, card, out["launches"])
        del segs, record, plain_record, want_hard, want_soft, irs
        torch.cuda.empty_cache()
    return out


def ico_grad_receivers(centers):
    """The value+grad's 64 receivers of phase 17: every 32nd of the room's
    (2,048, 3) grid."""
    return centers[::32].contiguous()


def ico_backward_inputs(segs, few):
    """B11/ico's call of phase 17 on the segments `segs` and the receivers
    `few`: (record, g, keywords): K-S/ico's record, the seeded (64,
    COV_BINS) cotangent (numpy seed 3) and map_capture_backward's keywords,
    soft."""
    import numpy as np
    import torch

    from rfx_torch.coverage import _amp_scale
    from rfx_torch.ops import map_capture as mc

    record = mc.map_record(segs, few, COV_RADIUS, "icosphere")
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(few.shape[0], COV_BINS)).astype(np.float32)).to(few.device)
    bkw = dict(scale=float(_amp_scale(1.0, COV_RAYS, torch.device("cpu"))), soft=True,
               rx_mode="icosphere", nbins=COV_BINS, light_speed_mps=C, sample_rate_hz=RATE)
    return record, g, bkw


def ico_backward_bound(n_seg: int, captured: int) -> dict:
    """B11/ico's bound: the record, the cotangent, 32 bytes of each captured
    segment, the centers and the unit faces read once, 32 bytes a segment
    written; at a capture the 80 tests that find the face again, its t's VJP
    and the bins."""
    return _bound(64 * COV_RAYS + 4 * 64 * COV_BINS + 32 * captured + 12 * 64 + ICO_TRI_BYTES
                  + 32 * n_seg, (MT_TEST_FLOPS * ICO_FACES + 120) * captured)


def _icosphere_grad(tracer, dirs, segs, centers, kernels, card, launches_out):
    """Phase 17, value+grad: coverage_dbm(soft=True, rx_mode="icosphere",
    engine="map") on 64 of the room's receivers (every 32nd), d / d (log n1,
    tx) of the mean finite dBm, counted (K-S/ico, the record entry/ico,
    B11/ico, K-P and its backward once each, K-B for the room), two runs the
    same bits, d / d log n1 against a central difference; then B11/ico
    against its plain version on the same segments for a seeded cotangent
    (rtol 1e-5 with a floor of 1e-6 of the largest entry), two runs the
    same bits; times and peak memory."""
    import math

    import torch

    from rfx_torch.coverage import coverage_dbm
    from rfx_torch.ops import map_capture as mc

    dev = centers.device
    tx = COV_SCENES[0][1]
    few = ico_grad_receivers(centers)
    log_n1_0 = math.log(5.0)
    kw = dict(max_bounces=2, num_rays=COV_RAYS, sample_window_s=COV_WINDOW, sample_rate_hz=RATE,
              env_hit=tracer.env_hit, soft=True, rx_batch=64, engine="map", rx_mode="icosphere")

    def loss_at(log_n1, tx_p):
        return _mean_finite(coverage_dbm(tracer.scene, tx_p, dirs, few, COV_RADIUS,
                                         n1=torch.exp(log_n1), **kw))

    def valgrad():
        log_n1 = torch.tensor(log_n1_0, device=dev, requires_grad=True)
        tx_p = torch.tensor(tx, device=dev, requires_grad=True)
        loss = loss_at(log_n1, tx_p)
        g = torch.autograd.grad(loss, [log_n1, tx_p])
        return loss.detach(), g[0], g[1]

    valgrad()  # warm-up
    needs = (K_MAP_ICO, K_HIST_RECORD_ICO, K_MAP_BACKWARD_ICO, K_POWER, K_POWER_BACKWARD)
    ((loss, g_n1, g_tx), plain_calls), launches = _counted(
        kernels, "coverage_ico_grad_room", needs + (K_BRUTE,), lambda: _plain_calls(valgrad))
    launches_out["coverage_ico_grad_room"] = launches
    _require(all(launches[k] == 1 for k in needs)
             and launches[K_MAP] == launches[K_HIST] == launches[K_COV] == 0 and plain_calls == 0,
             f"icosphere exact value+grad: launches {launches}, {plain_calls} plain calls")
    again = valgrad()
    _sync()
    _require(all(torch.equal(a, b) for a, b in zip((loss, g_n1, g_tx), again)),
             "icosphere exact value+grad: two runs differ")
    _require(bool(torch.isfinite(g_tx).all()) and bool((g_tx != 0).any()),
             f"icosphere exact value+grad: d/d tx {g_tx.tolist()}")
    # The loss is an f32 near 60 dB (ulp 3.8e-6): a step of 2e-3 leaves the
    # difference ~70 of its ulps, good to ~1.5%; 2e-2 leaves ~700.
    fd = _fd_check(lambda v: loss_at(torch.tensor(v, device=dev), torch.tensor(tx, device=dev)),
                   log_n1_0, float(g_n1), 2e-2, "icosphere exact metric")
    out = {"receivers": int(few.shape[0]), "loss": float(loss), "d_log_n1": float(g_n1),
           "d_tx": g_tx.tolist(), "fd": fd, "valgrad_ms": _cuda_ms(valgrad, 3),
           "forward_ms": _cuda_ms(lambda: loss_at(torch.tensor(log_n1_0, device=dev),
                                                  torch.tensor(tx, device=dev)), 3)}
    torch.cuda.reset_peak_memory_stats(dev)
    valgrad()
    out["valgrad_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    # B11/ico against its plain version on the sweep's segments.
    record, g, bkw = ico_backward_inputs(segs, few)
    k1 = mc.map_capture_backward(segs, few, COV_RADIUS, g, record, **bkw)
    k2 = mc.map_capture_backward(segs, few, COV_RADIUS, g, record, **bkw)
    p, _, plain_ms = _timed(lambda: mc.map_capture_backward_plain(segs, few, COV_RADIUS, g, **bkw))
    errs, same_bits = {}, {}
    names = ("origin", "direction", "amplitude", "distance", "centers", "scale", "radius")
    for name, a, b, c in zip(names, k1, k2, p):
        _require(torch.equal(a, b), f"B11/ico: two runs differ ({name})")
        _require(torch.allclose(a, c, rtol=1e-5, atol=1e-6 * float(c.abs().max())),
                 f"B11/ico != its plain version ({name})")
        errs[name] = float((a - c).abs().max())
        same_bits[name] = bool(torch.equal(a, c))
    _require(float(k1[0].abs().max()) > 0 and float(k1[6]) != 0.0, "B11/ico: no gradient")
    captured = int((record != mc.NO_CAPTURE).sum())
    n_seg = segs.t_env.numel()

    def backward(full):
        return lambda: mc.map_capture_backward(segs, few, COV_RADIUS, g, record,
                                               centers_grad=full, scalars_grad=full, **bkw)

    out["backward"] = {
        "captured": captured, "max_abs_err": errs, "bit_equal_plain": same_bits,
        "ms": _cuda_ms(backward(False), 10), "device_ms": device_ms(backward(False), 10),
        "queued_ms": queued_ms(backward(False), 20),
        "centers_ms": _cuda_ms(backward(True), 10),
        "centers_device_ms": device_ms(backward(True), 10),
        "centers_queued_ms": queued_ms(backward(True), 20), "plain_ms": plain_ms,
        "bound": ico_backward_bound(n_seg, captured)}
    b = out["backward"]
    print(f"# icosphere exact (soft) value+grad, room, {few.shape[0]} receivers x 2 x {COV_RAYS}: "
          f"loss {out['loss']:.6f} dBm, d/d log n1 {out['d_log_n1']:.6e} (central difference, step "
          f"{fd['step']}: {fd['fd']:.6e}, rel {fd['rel_err']:.2e}), d/d tx "
          f"{[round(v, 6) for v in out['d_tx']]}, two runs the same bits; value+grad "
          f"{out['valgrad_ms']:.2f} ms, forward {out['forward_ms']:.2f} ms, peak "
          f"{out['valgrad_peak_bytes'] / 2**30:.2f} GiB; B11/ico == plain within rtol 1e-5 (max |d| "
          f"{errs}; bit-equal {same_bits}), two runs the same; {b['ms']:.4f} ms a call, "
          f"{b['device_ms']:.4f} on the device, {b['queued_ms']:.4f} queued "
          f"({b['centers_ms']:.4f} / {b['centers_queued_ms']:.4f} queued with the centers' and "
          f"scalars'), plain {plain_ms:.1f} ms, bound {b['bound']['bound_ms']:.4f} ms by "
          f"{b['bound']['bound_by']}; {card}", flush=True)
    return out


def _trace_close(k, p, what: str):
    """Phase 4's bars: identical capture masks and bounce counts, amplitude
    within rtol 2e-5 / atol 1e-7, distance within rtol 1e-5 / atol 1e-4 on
    the captured rays; returns (max |d amp|, max |d dist|)."""
    import torch

    m = p.captured
    _require(torch.equal(k.captured, p.captured), f"{what}: capture masks differ")
    _require(torch.equal(k.num_bounces, p.num_bounces), f"{what}: bounce counts differ")
    if not bool(m.any()):
        return 0.0, 0.0
    amp_err = float((k.amplitude[m] - p.amplitude[m]).abs().max())
    dist_err = float((k.distance[m] - p.distance[m]).abs().max())
    _require(torch.allclose(k.amplitude[m], p.amplitude[m], rtol=2e-5, atol=1e-7),
             f"{what}: amplitude differs by {amp_err}")
    _require(torch.allclose(k.distance[m], p.distance[m], rtol=1e-5, atol=1e-4),
             f"{what}: distance differs by {dist_err}")
    return amp_err, dist_err


def iid_directions(dev):
    """5,242,880 i.i.d. uniform directions, as the facade's default sampler
    draws them (seed 22)."""
    import torch

    from rfx_torch.sampler import sphere_directions

    return sphere_directions(N_RAYS, generator=torch.Generator(dev).manual_seed(22), device=dev)


@contextlib.contextmanager
def _caller_order():
    """Within it, every uncounted fused launch walks the caller's order."""
    from rfx_torch.ops import fused

    before, fused.ORDER_MIN_RAYS = fused.ORDER_MIN_RAYS, 2**31
    try:
        yield
    finally:
        fused.ORDER_MIN_RAYS = before


def _ordered_vs_caller(bvh, d, args, what: str, record_faces: bool = False) -> dict:
    """The fused trace of `d` walked in direction-cell order (one launch of
    the order) against the same launch in the caller's order (none): every
    output, and the face record, the same bits. Returns each side's
    CUDA-event ms a call."""
    import torch

    from rfx_torch.ops.fused import fused_trace
    from rfx_torch.ops.ray_order import RAY_ORDER_KERNEL

    def call():
        out = fused_trace(bvh, d, *args, max_bounces=BOUNCES, record_faces=record_faces)
        return [*out[0][:4], out[1]] if record_faces else list(out[:4])

    before = RAY_ORDER_KERNEL.launches
    ordered = call()
    _sync()
    _require(RAY_ORDER_KERNEL.launches == before + 1, f"{what}: the launch was not ordered once")
    with _caller_order():
        caller = call()
        _sync()
        _require(RAY_ORDER_KERNEL.launches == before + 1, f"{what}: the caller's order ordered")
        caller_ms = _cuda_ms(call, 10)
    _require(all(map(torch.equal, ordered, caller)),
             f"{what}: the trace in cell order differs from the caller's order")
    out = {"ms": _cuda_ms(call, 10), "caller_order_ms": caller_ms}
    print(f"# fused trace in cell order, {what}, {d.shape[0]} rays"
          f"{' with the face record' if record_faces else ''}: == the caller's order bit for bit; "
          f"{out['ms']:.4f} ms (order, walk, put-back), {caller_ms:.4f} ms in the caller's order",
          flush=True)
    return out


def _ray_order_phase(bvh, morton, args, dev) -> dict:
    """Phase 4's direction-cell order at the main paths' shapes: the order of
    5,242,880 i.i.d. and Morton rays against its plain version (the same keys
    and cell counts, an order that is a permutation with `rank` its inverse,
    the keys along it the plain stable sort's), timed beside the plain version,
    argsort with a gather and the bound; the ordered fused trace against its
    plain version on the first ORDER_MIN_RAYS i.i.d. rays (the smallest launch
    it orders), with and without the face record; and at 5,242,880 rays (the
    face record at 2,621,440) the same bits as the caller's order."""
    import torch

    from rfx_torch.ops import fused
    from rfx_torch.ops.fused import fused_trace, fused_trace_plain
    from rfx_torch.ops.ray_order import RAY_ORDER_KERNEL, cell_bits, ray_order, ray_order_plain

    iid = iid_directions(dev)
    bits = cell_bits(N_RAYS)
    every = torch.arange(N_RAYS, dtype=torch.int32, device=dev)
    out = {"rays": N_RAYS, "bits": bits}
    for name, d in (("iid", iid), ("morton", morton)):
        k = ray_order(d)
        p = ray_order_plain(d.cpu(), bits)
        _sync()
        _require(torch.equal(k.keys.cpu(), p.keys), f"ray order, {name}: keys differ from plain")
        _require(torch.equal(k.counts.cpu(), p.counts), f"ray order, {name}: counts differ")
        _require(int(k.order.min()) >= 0 and int(k.order.max()) < N_RAYS,
                 f"ray order, {name}: an index out of range")
        _require(torch.equal(k.rank[k.order.long()], every) and torch.equal(k.order[k.rank.long()], every),
                 f"ray order, {name}: not a permutation with rank its inverse")
        _require(torch.equal(k.keys[k.order.long()].cpu(), p.keys[p.order.long()]),
                 f"ray order, {name}: the keys along the order differ from the plain sort's")
        out[name] = {"ms": _cuda_ms(lambda d=d: ray_order(d), 20),
                     "queued_ms": queued_ms(lambda d=d: ray_order(d), 20),
                     "largest_cell": int(k.counts.max()), "empty_cells": int((k.counts == 0).sum())}
        del k, p
    out["plain_ms"] = _cuda_ms(lambda: ray_order_plain(iid, bits), 3)
    keys = ray_order(iid).keys.clone()
    out["library_ms"] = _cuda_ms(lambda: iid[torch.argsort(keys)], 20)
    out["bound"] = _bound(ORDER_BYTES * N_RAYS, ORDER_FLOPS * N_RAYS)
    del keys
    print(f"# ray order, {N_RAYS} rays on 2^{bits} x 2^{bits} cells: keys and counts == plain, "
          f"a permutation with its inverse, sorted as plain; i.i.d. {out['iid']['ms']:.4f} ms "
          f"({out['iid']['queued_ms']:.4f} queued), Morton {out['morton']['ms']:.4f} ms "
          f"({out['morton']['queued_ms']:.4f} queued), plain {out['plain_ms']:.3f} ms, argsort and "
          f"gather {out['library_ms']:.4f} ms, bound {out['bound']['bound_ms']:.4f} ms", flush=True)

    m = fused.ORDER_MIN_RAYS
    sub = iid[:m].contiguous()
    before = RAY_ORDER_KERNEL.launches
    k_out = fused_trace(bvh, sub, *args, max_bounces=BOUNCES)
    k_res, k_faces = fused_trace(bvh, sub, *args, max_bounces=BOUNCES, record_faces=True)
    _sync()
    _require(RAY_ORDER_KERNEL.launches == before + 2, f"{m} rays: the launches were not ordered")
    p_res, p_faces = fused_trace_plain(bvh, sub, *args, max_bounces=BOUNCES, record_faces=True)
    _sync()
    amp_err, dist_err = _trace_close(k_out, p_res, f"fused trace in cell order, {m} rays")
    _require(torch.equal(k_faces, p_faces), f"{m} rays in cell order: face records differ from plain")
    _require(all(map(torch.equal, k_res[:4], k_out[:4])), "the face record changed the ordered trace")
    out["max_abs_err"], out["min_rays"] = max(amp_err, dist_err), m
    print(f"# fused trace in cell order, {m} i.i.d. rays: kernel == plain (captures "
          f"{int(p_res.captured.sum())}, bounces {int(p_res.num_bounces.sum())}), max |d amp| "
          f"{amp_err:.3e}, max |d dist| {dist_err:.3e}; face record == plain", flush=True)
    del k_out, k_res, k_faces, p_res, p_faces
    out["k1_iid"] = _ordered_vs_caller(bvh, iid, args, "bench terrain, i.i.d.")
    out["k1_morton"] = _ordered_vs_caller(bvh, morton, args, "bench terrain, Morton")
    out["k1_faces_iid"] = _ordered_vs_caller(bvh, iid[:GRAD_RAYS].contiguous(), args,
                                             "bench terrain, i.i.d.", record_faces=True)
    out["k1_faces_morton"] = _ordered_vs_caller(bvh, morton[:GRAD_RAYS].contiguous(), args,
                                                "bench terrain, Morton", record_faces=True)
    return out


def _counters_vs_plain(bvh, sub, args, what: str, brute=None):
    """The counted fused kernel on `sub` against `fused_trace_walk_plain`:
    counters integer for integer, the counted trace == the uncounted
    kernel's bit for bit, the plain walk's trace == the brute plain
    version's (`brute`, computed here if None) and the kernel's within phase
    4's bars. Returns a dict of what it measured."""
    import torch

    from rfx_torch.ops.fused import fused_trace, fused_trace_plain, fused_trace_walk_plain

    kw = dict(max_bounces=BOUNCES)
    uncounted = fused_trace(bvh, sub, *args, **kw)
    counted, k_stats = fused_trace(bvh, sub, *args, count_stats=True, **kw)
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    start.record()
    walked, p_stats = fused_trace_walk_plain(bvh, sub, *args, count_stats=True, **kw)
    mid.record()
    if brute is None:
        brute = fused_trace_plain(bvh, sub, *args, **kw)
    end.record()
    _sync()
    for name, a, b in zip(("captured", "amplitude", "distance", "num_bounces"), counted[:4],
                          uncounted[:4]):
        _require(torch.equal(a, b), f"{what}: counted trace's {name} != the uncounted kernel's")
    for name, a, b in zip(("captured", "amplitude", "distance", "num_bounces"), walked[:4],
                          brute[:4]):
        _require(torch.equal(a, b), f"{what}: the plain walk's {name} != the brute plain version's")
    amp_err, dist_err = _trace_close(uncounted, brute, what)
    _require(k_stats.dtype == torch.int64 and k_stats.shape == (BOUNCES, 4),
             f"{what}: counters {k_stats.dtype} {tuple(k_stats.shape)}")
    _require(torch.equal(k_stats, p_stats),
             f"{what}: counters differ: kernel {k_stats.tolist()} plain {p_stats.tolist()}")
    _require(int(k_stats[0, 0]) >= sub.shape[0], f"{what}: {int(k_stats[0, 0])} root visits")
    ms = _cuda_ms(lambda: fused_trace(bvh, sub, *args, count_stats=True, **kw), 10)
    out = dict(rays=int(sub.shape[0]), counters=k_stats.tolist(), max_abs_err=max(amp_err, dist_err),
               counters_max_abs_err=float((k_stats - p_stats).abs().max()),
               captured=int(brute.captured.sum()), bounces=int(brute.num_bounces.sum()),
               counted_ms=ms, walk_plain_ms=start.elapsed_time(mid),
               brute_plain_ms=mid.elapsed_time(end))
    print(f"# walk counters, {what}, {out['rays']} rays: kernel == plain walk integer for "
          f"integer {out['counters']}; counted trace == uncounted bit for bit; plain walk's "
          f"trace == brute plain's; kernel vs brute plain ({out['captured']} captures, "
          f"{out['bounces']} bounces) max |d| {out['max_abs_err']:.3e}; counted kernel "
          f"{ms:.4f} ms, plain walk {out['walk_plain_ms']:.1f} ms", flush=True)
    return out


def _large_mesh_phase(root, dev, kernels, bench_bvh, bench_dirs):
    """Phase 14: the large-mesh path at full width, counted on its own, the
    same counters on the bench terrain, and the vote micro-kernel. Returns
    (what it measured, {path: launches})."""
    import torch

    from rfx_torch.ops.fused import fused_trace, fused_trace_plain

    large = _load_script(root, "torch_bench_large_mesh")
    micro = _load_script(root, "torch_micro_vote")
    out, launches = {}, {}

    mesh, flat, tracer, scene = large.build_scene(dev, method="native")
    bvh = tracer._fused.bvh
    _require(scene["triangles"] == 1_045_458, f"the terrain has {scene['triangles']} triangles")
    out["scene"] = scene
    print(f"# large mesh: {scene['triangles']} triangles; native build {scene['bvh_build_seconds']:.2f} s "
          f"(mesh {scene['mesh_seconds']:.2f} s, Tracer {scene['tracer_seconds']:.2f} s): "
          f"{scene['bvh_nodes']} nodes, {scene['padded_tris']} padded triangles, "
          f"{scene['table_bytes']['total'] / 1e6:.1f} MB on the card {scene['table_bytes']}", flush=True)

    # Against the plain versions, on a strided subset (brute force over 1.36M
    # padded triangles bounds its size).
    dirs = large.morton_dirs(large.N_RAYS, 0, dev)
    sub = dirs[:: large.N_RAYS // LARGE_SUBSET].contiguous()
    args = (large.TX, large.RX, large.RX_RADIUS, 5.0, 1.0)
    brute, _, brute_ms = _timed(lambda: fused_trace_plain(bvh, sub, *args, max_bounces=BOUNCES))
    k_ms = _cuda_ms(lambda: fused_trace(bvh, sub, *args, max_bounces=BOUNCES), 10)
    out["subset"] = _counters_vs_plain(bvh, sub, args, "1M-triangle terrain", brute)
    out["subset"].update(fused_ms=k_ms, brute_plain_ms=brute_ms)
    del brute
    # Cell order at the path's width: the same bits as the caller's order.
    out["cell_order"] = {
        "iid": _ordered_vs_caller(bvh, iid_directions(dev), args, "1M-triangle terrain, i.i.d."),
        "morton": _ordered_vs_caller(bvh, dirs, args, "1M-triangle terrain, Morton")}

    # The path itself.
    def path():
        res = {"parity": large.parity_leg(mesh, bvh, dev)}
        res["cir"] = large.cir_leg(tracer, dirs)
        res["walk_counters"] = large.counters_leg(bvh, dirs)
        res["perquery_vs_fused"] = large.perquery_leg(bvh, dirs[:large.N_PERQUERY].contiguous())
        res["perquery_counters"] = large.perquery_counters_leg(
            bvh, dirs[:large.N_PERQUERY].contiguous())
        return res

    res, launches["large_mesh"] = _counted(
        kernels, "large mesh", (K_FUSED, K_ORDER, K_COUNTED, K_HIT, K_HIT_COUNTED, K_HIST), path)
    out.update(res)
    par, cir_, wc, pq = res["parity"], res["cir"], res["walk_counters"], res["perquery_vs_fused"]
    out["fused_bound"] = _fused_bound(bvh, wc)
    print(f"# large mesh parity, {par['rays']} rays: {par['hits']} hits, hit-mask mismatch "
          f"{par['hit_mask_mismatch']}, max |d t| {par['t_max_abs_diff']:.3e}, face mismatch "
          f"{par['face_mismatch']} (independent leaf-16 tree, {par['independent_tree']['nodes']} "
          f"nodes); closest hit {par['closest_hit_ms']:.3f} ms, plain walk {par['plain_walk_ms']:.1f} ms")
    for r in cir_["requests"]:
        print(f"# large mesh compute_cir tx={tuple(r['tx'])}: {r['nonzero_bins']} nonzero bins, IR "
              f"sum {r['ir_sum']:.6e}, {r['dbm']:.4f} dBm; {r['ms']:.3f} ms (CUDA events), "
              f"{r['mrays_per_s']:.2f} Mrays/s")
    print(f"# large mesh compute_cir: the first request again is bit-identical; best "
          f"{cir_['best_ms']:.3f} ms, {cir_['best_mrays_per_s']:.2f} Mrays/s")
    _print_counters("1M-triangle terrain", wc, out["fused_bound"])
    print(f"# large mesh per-query vs fused, {pq['rays']} rays: captures {pq['perquery_captured']} "
          f"vs {pq['fused_captured']} ({pq['capture_flips']} flips), distance sums "
          f"{pq['perquery_dist_sum']:.2f} vs {pq['fused_dist_sum']:.2f}; per-query loop "
          f"{pq['perquery_ms']:.2f} ms, fused {pq['fused_ms']:.2f} ms", flush=True)
    for name, c in res["perquery_counters"].items():
        print(f"# large mesh counted closest hit, {c['queries']} {name} queries: == the uncounted "
              f"kernel; {c['nodes']} nodes, {c['leaves']} leaves, {c['tris']} triangles, max "
              f"{c['nodes_per_query_max']} nodes a query; counted kernel {c['counted_ms']:.4f} ms",
              flush=True)
    del dirs, sub, tracer, bvh
    torch.cuda.empty_cache()

    # The same counters and times on the bench terrain.
    bench = large.counters_leg(bench_bvh, bench_dirs, tx=TX, rx=RX, rx_radius=RX_RADIUS)
    out["bench_walk_counters"] = bench
    out["bench_fused_bound"] = _fused_bound(bench_bvh, bench)
    _print_counters("bench terrain", bench, out["bench_fused_bound"])

    # The vote micro-kernel: every style against the plain version, then timed.
    check = micro.check_styles(dev)
    timed, launches["micro_vote"] = _counted(kernels, "micro vote", (K_VOTE,),
                                             lambda: micro.time_styles(dev))
    for style in check:
        check[style].update(timed[style])
        print(f"# micro vote {style}: carry {check[style]['carry']:.9e} == plain after "
              f"{micro.CHECK_STEPS} bodies (kernel {check[style]['check_ms']:.4f} ms, plain "
              f"{check[style]['plain_ms']:.1f} ms); {check[style]['ns_per_body']:.2f} ns per body "
              f"at {micro.STEPS} bodies ({check[style]['ms']:.4f} ms)", flush=True)
    carries = {check[s_]["carry"] for s_ in ("votes", "ballotfold", "sumpack")}
    _require(len(carries) == 1 and check["novec"]["carry"] == 0.0 and min(carries) > 0.0,
             f"micro vote: carries {check}")
    out["micro_vote"] = {"steps": micro.STEPS, "check_steps": micro.CHECK_STEPS, "styles": check}
    return out, launches


def solver_inputs(mesh, dev):
    """Phase 11's inverse solve on `mesh`: 1,048,576 Morton rays (seed 1) and
    64 receivers of radius 1.0 on an 8 x 8 grid at z = 8 over x, y in
    [-20, 20]; (scene, dirs, centers)."""
    import numpy as np
    import torch

    from rfx_torch.coverage import make_grid
    from rfx_torch.sampler import morton_sphere_directions
    from rfx_torch.tracer import Scene

    dirs = morton_sphere_directions(SOLVER_RAYS, generator=torch.Generator(dev).manual_seed(1),
                                    device=dev)
    axis = np.linspace(-20.0, 20.0, 8)
    return Scene.from_mesh(mesh, dev), dirs, torch.as_tensor(make_grid(axis, axis, [8.0]), device=dev)


def _solver_target(scene, dirs, centers, env):
    """The receivers' IR energies of tx, the inverse solve's target."""
    import torch

    from rfx_torch.solver import coverage_irs_soft

    with torch.no_grad():
        irs = coverage_irs_soft(scene.vertices, scene.faces, torch.tensor(TX, device=dirs.device),
                                5.0, dirs, centers, 1.0, num_rays=SOLVER_RAYS, env_hit=env,
                                max_bounces=BOUNCES, nbins=NBINS, light_speed_mps=C,
                                sample_rate_hz=RATE)
        target = torch.sum(irs * irs, dim=1)
    _sync()
    _require(bool(torch.isfinite(target).all()) and int((target > 0).sum()) > 0,
             "solver target is empty")
    return target


def _close_irs(got, want, what: str, rtol: float = 1e-5):
    """The same nonzero bins, and the values within rtol / atol 1e-12
    (tests/test_multiprocess.py:93: a shard's partial sums group
    differently); returns the largest |difference|."""
    import numpy as np

    _require(got.shape == want.shape and np.array_equal(got != 0, want != 0),
             f"{what}: nonzero bins differ ({int((got != 0).sum())} vs {int((want != 0).sum())})")
    _require(np.allclose(got, want, rtol=rtol, atol=1e-12), f"{what}: values differ")
    return float(np.abs(got - want).max())


def _dist_phase(root, dev, mesh, bvh):
    """Phase 15: the sharded paths of rfx_torch.parallel. One rank in this
    process, then four ranks on this card, each against this process's
    unsharded run; returns (what it measured, {path: launches summed over
    the ranks})."""
    import tempfile

    import numpy as np
    import torch

    from rfx_torch.cir import cir_from_trace
    from rfx_torch.coverage import coverage_irs, make_grid
    from rfx_torch.geometry import make_room
    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.parallel import dist as pdist
    from rfx_torch.parallel import make_mesh, sharded_cir
    from rfx_torch.parallel.launch import one_rank_group, result_of, run_ranks
    from rfx_torch.sampler import morton_sphere_directions
    from rfx_torch.solver import make_inverse_solver
    from rfx_torch.tracer import Scene, trace_to_rx

    out = {}
    scene, env = Scene.from_mesh(mesh, dev), make_kernel_env_hit(bvh)
    dirs = morton_sphere_directions(N_RAYS, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    kw = dict(max_bounces=BOUNCES, nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE,
              env_hit=env)

    def unsharded(soft):
        with torch.no_grad():
            r = trace_to_rx(scene, TX, dirs, RX, RX_RADIUS, max_bounces=BOUNCES,
                            rx_mode="analytic", env_hit=env)
            return cir_from_trace(r, tx_power=1.0, num_rays=N_RAYS, nbins=NBINS,
                                  light_speed_mps=C, sample_rate_hz=RATE, soft=soft)

    def host_ms(fn, reps):
        return [_timed(fn)[1] * 1e3 for _ in range(reps)]

    # 1. One rank in this process: the sharded path == the unsharded path
    #    bit for bit, and what the sharding costs on one card.
    backend = pdist.default_backend(1)
    one = out["one_rank"] = {"backend": backend}
    with one_rank_group(backend):
        one_mesh = make_mesh(device=dev)
        for soft in (False, True):
            tag = "soft" if soft else "hard"

            def sharded():
                with torch.no_grad():
                    return sharded_cir(scene, TX, dirs, RX, RX_RADIUS, one_mesh, soft=soft, **kw)

            got, want = sharded(), unsharded(soft)
            _sync()
            _require(torch.equal(got, want) and float(got.sum()) > 0,
                     f"one-rank sharded_cir, {tag}: differs from the unsharded path")
            one[f"{tag}_ms"], one[f"{tag}_unsharded_ms"] = host_ms(sharded, 5), host_ms(
                lambda: unsharded(soft), 5)
        for shape in ((20_000,), (32, 20_000)):
            x = torch.ones(shape, device=dev)
            one[f"all_reduce_ms_{shape}"] = host_ms(lambda: pdist._all_reduce(x, one_mesh, "rays"), 10)
    ir_ref = unsharded(False).cpu().numpy()
    print(f"# sharded, one rank ({backend}), {N_RAYS} rays: sharded_cir == trace_to_rx + "
          f"cir_from_trace bit for bit, hard and soft; hard {min(one['hard_ms']):.3f} ms against "
          f"{min(one['hard_unsharded_ms']):.3f} unsharded, soft {min(one['soft_ms']):.3f} against "
          f"{min(one['soft_unsharded_ms']):.3f} (host clock, synchronized, best of 5); all-reduce "
          f"(20000,) {min(one['all_reduce_ms_(20000,)']):.4f} ms, (32, 20000) "
          f"{min(one['all_reduce_ms_(32, 20000)']):.4f} ms", flush=True)
    del dirs

    # 2. This process's unsharded runs of the four ranks' workloads.
    room = make_room()
    (_, tx_room, zs), = [s for s in COV_SCENES if s[0] == "room"]
    grid = make_grid(range(-15, 16, 2), range(-15, 16, 2), zs)
    with torch.no_grad():
        cov_ref = coverage_irs(Scene.from_mesh(room, dev), tx_room,
                               morton_sphere_directions(COV_RAYS, generator=torch.Generator(dev)
                                                        .manual_seed(0), device=dev),
                               grid, COV_RADIUS, max_bounces=2, nbins=COV_BINS, num_rays=COV_RAYS,
                               light_speed_mps=C, sample_rate_hz=RATE,
                               env_hit=make_kernel_env_hit(room, device=dev),
                               engine="batched").cpu().numpy()
    s_scene, s_dirs, centers = solver_inputs(mesh, dev)
    target = _solver_target(s_scene, s_dirs, centers, env)
    init_fn, step_fn = make_inverse_solver(s_scene, s_dirs, centers, 1.0, target, max_bounces=BOUNCES,
                                           nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE,
                                           learning_rate=0.05, env_hit=env)
    # One step from phase 11's start, twice (the ranks do the same).
    steps = [_timed(lambda: step_fn(*init_fn([12.0, -2.0, 26.0]))) for _ in range(2)]
    params, opt, loss = steps[-1][0]
    step_ref = {"loss": float(loss), "grad_tx": params.tx_pos.grad.cpu().numpy(),
                "grad_log_n1": params.log_n1.grad.cpu().numpy(),
                "ms": [t[1] * 1e3 for t in steps]}
    target = target.cpu().numpy()
    del s_scene, s_dirs, centers, params, opt, loss, scene, env
    torch.cuda.empty_cache()

    # 3. Four ranks on this card, over gloo (NCCL refuses two ranks on one
    #    card), built kernels loaded from build/rfx_torch/.
    world = 4
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, target=target)
        worker = os.path.join(root, "scripts", "torch_multiproc_worker.py")
        env_vars = dict(os.environ, PYTHONPATH=root)
        (outs, host_s, _) = _timed(lambda: run_ranks(
            lambda r, c: [sys.executable, worker, c, str(world), str(r),
                          os.path.join(tmp, f"rank{r}.npz"), "--device", "cuda", "--workload",
                          "chip", "--cases", "cir,coverage,solver", "--inputs", inputs],
            world, timeout=600, env=env_vars, cwd=root))
        infos = [result_of(o) for o in outs]
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]
    _require(all(i["backend"] == "gloo" and i["device"] == torch.cuda.get_device_name(dev)
                 for i in infos), f"four ranks: backends {[i['backend'] for i in infos]}")
    four = out["four_ranks"] = {"world": world, "backend": "gloo", "host_s": host_s}

    # sharded_cir on {'rays': 4}: every rank the same bits, two runs the same.
    irs = [r["cir_ir"] for r in ranks]
    _require(all(np.array_equal(ir, irs[0]) for ir in irs), "four-rank CIR: the ranks differ")
    _require(all(i[case]["repeat_equal"] for i in infos for case in ("cir", "solver")),
             "four ranks: two runs of the CIR or of the solver step differ")
    four["cir_max_abs_err"] = _close_irs(irs[0], ir_ref, "four-rank CIR vs unsharded")

    # sharded_coverage_irs on {'rays': 2, 'rx': 2}, tiles in rank order.
    _require([i["coverage"]["coords"] for i in infos]
             == [{"rays": r, "rx": x} for r in range(2) for x in range(2)], "coverage coords")
    tiles = [r["coverage_tile"] for r in ranks]
    _require(all(np.array_equal(tiles[r], tiles[r - 2]) for r in (2, 3))
             and all(i["coverage"]["repeat_equal"] for i in infos),
             "four-rank coverage: a tile's replicas or two runs differ")
    four["coverage_max_abs_err"] = _close_irs(np.concatenate(tiles[:2]), cov_ref,
                                              "four-rank coverage vs unsharded")
    map_tiles = np.concatenate([r["coverage_tile_map"] for r in ranks[:2]])
    _require(np.allclose(map_tiles, cov_ref, rtol=1e-5, atol=1e-12),
             "four-rank coverage, engine 'map' vs the coverage kernel")
    four["coverage_map_nonzero_mismatch"] = int(((map_tiles != 0) != (cov_ref != 0)).sum())

    # One solver step on {'rays': 2, 'rx': 2} from phase 11's start.
    rows = [np.concatenate([r["solver_tx"].ravel(), r["solver_log_n1"].ravel(),
                            r["solver_loss"].ravel()]) for r in ranks]
    _require(all(np.array_equal(row, rows[0]) for row in rows),
             "four-rank solver: the ranks' parameters or losses differ")
    loss4 = float(ranks[0]["solver_loss"])
    _require(np.isfinite(loss4) and abs(loss4 - step_ref["loss"]) <= 1e-4 * abs(step_ref["loss"]),
             f"four-rank solver: loss {loss4} vs unsharded {step_ref['loss']}")
    for name in ("grad_tx", "grad_log_n1"):
        g, ref = ranks[0][f"solver_{name}"], step_ref[name]
        _require(np.all(np.isfinite(g)) and np.abs(ref).max() > 0
                 and np.abs(g - ref).max() <= 1e-4 * np.abs(ref).max(),
                 f"four-rank solver: {name} {g} vs unsharded {ref}")
    ir_shape = tuple(infos[0]["solver"]["ir_shape"])
    reduces = [(a, tuple(s)) for a, s in infos[0]["solver"]["all_reduces"]]
    n_ir = sum(1 for _, s in reduces if s == ir_shape)
    _require(all(i["solver"]["all_reduces"] == infos[0]["solver"]["all_reduces"] for i in infos)
             and n_ir <= 2 and len(reduces) - n_ir <= 2,
             f"four-rank solver: all-reduces a step {reduces}")
    four.update(solver_loss=loss4, solver_loss_unsharded=step_ref["loss"],
                solver_step_ms_unsharded=step_ref["ms"], solver_all_reduces=reduces,
                per_rank={case: {k: [i[case][k] for i in infos] for k in ("ms", "peak_bytes")}
                          for case in ("cir", "coverage", "solver")},
                all_reduce_ms=infos[0]["cir"]["all_reduce_ms"],
                solver_grad_max_rel={n: float(np.abs(ranks[0][f"solver_{n}"] - step_ref[n]).max()
                                              / np.abs(step_ref[n]).max())
                                     for n in ("grad_tx", "grad_log_n1")})
    launches = {f"sharded_{case}": {k: sum(i[case]["launches"][k] for i in infos)
                                    for k in infos[0][case]["launches"]}
                for case in ("cir", "coverage", "solver")}
    for path, needs in (("sharded_cir", (K_HIT, K_HIST)),
                        ("sharded_coverage", (K_HIT, K_HIST_RECORD, K_COV, K_MAP)),
                        ("sharded_solver", (K_HIT, K_HIST_RECORD, K_MAP, K_MAP_BACKWARD))):
        _require(all(launches[path][k] > 0 for k in needs), f"{path}: a kernel did not run: {launches[path]}")
        print(f"# {path} launches, summed over the ranks: {launches[path]}", flush=True)
    pr = four["per_rank"]

    def warm(case, call=1):  # the ranks' times of one call (the first warms up), ms
        return [round(ms[call], 1) for ms in pr[case]["ms"]]

    print(f"# sharded, four ranks on one card (gloo, which stages the CUDA tensors through the "
          f"host itself; the port copies nothing), {host_s:.1f} s with start-up: sharded_cir "
          f"{{'rays': 4}}, {N_RAYS} rays: ranks bit-identical, two runs bit-identical, == unsharded "
          f"on the same nonzero bins (max |d| {four['cir_max_abs_err']:.3e}); {warm('cir')} ms a "
          f"call per rank", flush=True)
    print(f"# sharded coverage {{'rays': 2, 'rx': 2}}, 2048 receivers x {COV_RAYS} rays, "
          f"coverage kernel: tiles == unsharded on the same nonzero bins (max |d| "
          f"{four['coverage_max_abs_err']:.3e}), replicas and two runs bit-identical; engine "
          f"'map' within rtol 1e-5 ({four['coverage_map_nonzero_mismatch']} nonzero bins differ); "
          f"a sweep per rank {warm('coverage')} ms (coverage kernel), {warm('coverage', 2)} ms "
          f"(map engine)", flush=True)
    print(f"# sharded solver step {{'rays': 2, 'rx': 2}}, {SOLVER_RAYS} rays x 64 receivers: loss "
          f"{loss4:.9e} vs unsharded {step_ref['loss']:.9e}, grads max rel "
          f"{four['solver_grad_max_rel']}, parameters bit-identical on every rank and in two runs; "
          f"all-reduces a step {reduces}; {warm('solver')} ms per rank (unsharded "
          f"{step_ref['ms'][1]:.1f} ms); peak {[round(b / 2**30, 3) for b in pr['solver']['peak_bytes']]} "
          f"GiB per rank; gloo all-reduce ms {four['all_reduce_ms']}", flush=True)
    return out, launches


def _print_counters(name, c, bound):
    eff = ", ".join("-" if e is None else f"{e:.3f}" for e in c["simt_efficiency_per_bounce"])
    print(f"# walk counters, {name}, {c['rays']} rays: nodes {c['nodes_per_bounce']}, leaves "
          f"{c['leaves_per_bounce']}, triangles {c['tris_per_bounce']}, warp steps "
          f"{c['warp_steps_per_bounce']}; SIMT efficiency {c['simt_efficiency']:.3f} (per bounce "
          f"{eff}); {c['nodes_per_ray_bounce0']:.1f} nodes and {c['tris_per_ray_bounce0']:.1f} "
          f"triangles per ray at bounce 0; fused trace {c['fused_trace_ms']:.3f} ms "
          f"({c['mrays_per_s']:.2f} Mrays/s), counted {c['fused_trace_counted_ms']:.3f} ms; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['bound_flops']:.3e} f32 "
          f"operations, {bound['bound_bytes']:.3e} bytes)", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from rfx_torch import cir
    from rfx_torch.api import Tracer
    from rfx_torch.bvh import build_bvh
    from rfx_torch.geometry import make_terrain
    from rfx_torch.ops import native_lib
    from rfx_torch.ops.fused import FUSED_TRACE_KERNEL, FusedTracer, fused_trace, fused_trace_plain
    from rfx_torch.ops.ray_order import RAY_ORDER_KERNEL
    from rfx_torch.sampler import morton_sphere_directions

    # Full f32 everywhere (no TF32 matmul or convolution), as the JAX
    # reference computes on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cards_used = {dev.index}  # every phase runs on this one card

    # 1. The card.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    print(card, flush=True)

    # 2. Build the nine CUDA sources and the native BVH builder from the
    #    sources in this checkout, one compiler each, all started together;
    #    the counted fused trace, the counted closest hit, the slab reduction,
    #    the phasor metric's walk, spread, table and backward, the RX-power
    #    backward, the map capture's backward, its icosphere instantiations
    #    and the histogram's record entries bind their entries in the
    #    libraries of the fused trace, the closest hit, the coverage
    #    histogram, the RX power, the map capture and the IR histogram.
    t0 = time.perf_counter()
    kernels_built = port_kernels()
    per_source = kernels_built[:N_SOURCES]
    _require(len({k.source for k in per_source}) == N_SOURCES == len({k.source for k in kernels_built}),
             "port_kernels: one kernel of each source first")
    with ThreadPoolExecutor(len(per_source) + 1) as pool:
        native = pool.submit(native_lib.load)
        list(pool.map(lambda k: k.load(), per_source))
        native.result()
    for k in kernels_built[len(per_source):]:
        k.load()
    for k in per_source:
        print(f"# built {k.source}: {k.build_log.strip()}")
    print("# built native/bvh_builder.cpp with g++")
    print(f"# kernel build: {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. The bench workload.
    t0 = time.perf_counter()
    mesh = make_terrain(**BENCH_TERRAIN)
    flat = build_bvh(mesh, leaf_size=8)
    fused = FusedTracer(flat, max_bounces=BOUNCES, device=dev)
    bvh = fused.bvh
    dirs = morton_sphere_directions(N_RAYS, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    _sync()
    print(f"# scene: {mesh.num_faces} triangles, {bvh.n_nodes} BVH nodes, "
          f"{bvh.n_padded_tris} padded triangles; {N_RAYS} rays; "
          f"host BVH build + packing + sampling {time.perf_counter() - t0:.2f} s", flush=True)
    _require(mesh.num_faces == 32_258, f"terrain has {mesh.num_faces} triangles")

    # 4. Fused-trace kernel against its plain version on a strided subset.
    stride = N_RAYS // SUBSET
    sub = dirs[::stride].contiguous()
    args = (TX, RX, RX_RADIUS, 5.0, 1.0)
    k_out = fused_trace(bvh, sub, *args, max_bounces=BOUNCES)
    p_out = fused_trace_plain(bvh, sub, *args, max_bounces=BOUNCES)
    _sync()
    n_cap_sub = int(p_out.captured.sum())
    _require(n_cap_sub > 0, "the subset captured nothing")
    amp_err, dist_err = _trace_close(k_out, p_out, "fused trace")
    k1_ms_sub = _cuda_ms(lambda: fused_trace(bvh, sub, *args, max_bounces=BOUNCES), 20)
    k1_plain_ms_sub = _cuda_ms(lambda: fused_trace_plain(bvh, sub, *args, max_bounces=BOUNCES), 1)
    print(f"# fused trace, {SUBSET} rays: kernel == plain (captures {n_cap_sub}, bounces "
          f"{int(p_out.num_bounces.sum())}), max |d amp| {amp_err:.3e}, max |d dist| "
          f"{dist_err:.3e}; kernel {k1_ms_sub:.4f} ms, plain {k1_plain_ms_sub:.2f} ms", flush=True)
    order = _ray_order_phase(bvh, dirs, args, dev)

    # 5. IR histogram kernel against its plain version on the full trace.
    full = fused_trace(bvh, dirs, *args, max_bounces=BOUNCES)
    _sync()
    k1_ms_full = _cuda_ms(lambda: fused_trace(bvh, dirs, *args, max_bounces=BOUNCES), 10)
    amp = full.amplitude * (torch.tensor(1.0) / N_RAYS).to(dev)
    hkw = dict(nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE)
    h_args = (amp, full.distance, full.captured)
    ir_k = cir.bin_impulse_response(*h_args, **hkw)
    ir_k2 = cir.bin_impulse_response(*h_args, **hkw)
    ir_p = cir.histogram_plain(*h_args, **hkw)
    _sync()
    _require(torch.equal(ir_k, ir_k2), "IR histogram: two kernel runs differ")
    _require(torch.equal(ir_k != 0, ir_p != 0), "IR histogram: nonzero bins differ from plain")
    _require(torch.allclose(ir_k, ir_p, rtol=1e-4, atol=1e-9), "IR histogram: kernel != plain")
    ir_err = float((ir_k - ir_p).abs().max())
    s_k = cir.bin_impulse_response(*h_args, soft=True, **hkw)
    s_p = sum(cir.histogram_plain(*h_args, mode=m, **hkw) for m in (cir.SOFT_LO, cir.SOFT_HI))
    _require(torch.allclose(s_k, s_p, rtol=1e-4, atol=1e-9), "soft histogram differs")
    ir_err = max(ir_err, float((s_k - s_p).abs().max()))
    _sync()
    kh_ms = _cuda_ms(lambda: cir.bin_impulse_response(*h_args, **hkw), 20)
    kh_device_ms = device_ms(lambda: cir.bin_impulse_response(*h_args, **hkw), 20)
    kh_plain_ms = _cuda_ms(lambda: cir.histogram_plain(*h_args, **hkw), 20)
    n_cap = int(full.captured.sum())
    # The library's calls for the same sums (timed here, used nowhere in the
    # port): they take the bin of each ray and its masked weight ready-made,
    # which the kernel computes itself, and add with atomics in no fixed order.
    raw = (full.distance / torch.tensor(C, device=dev) * torch.tensor(RATE, device=dev)).long()
    weight = torch.where(full.captured & (raw >= 0) & (raw < NBINS), amp,
                         torch.zeros((), device=dev))
    bins = raw.clamp_(0, NBINS - 1)
    lib_add = torch.zeros(NBINS, device=dev).index_add_(0, bins, weight)
    _require(torch.allclose(lib_add, ir_k, rtol=1e-4, atol=1e-9), "index_add_ != the IR kernel")
    kh_lib_ms = _cuda_ms(lambda: torch.zeros(NBINS, device=dev).index_add_(0, bins, weight), 20)
    kh_bincount_ms = _cuda_ms(lambda: torch.bincount(bins, weights=weight, minlength=NBINS), 20)
    kh_bound = histogram_bounds(full.captured, NBINS, planes=1)
    del raw, bins, weight, lib_add
    print(f"# IR histogram, {N_RAYS} rays ({n_cap} captured), {NBINS} bins: kernel == plain "
          f"(max |d| {ir_err:.3e}, {int((ir_k != 0).sum())} nonzero bins), bit-identical "
          f"across runs; kernel {kh_ms:.4f} ms a call ({kh_device_ms:.4f} ms of it on the device), "
          f"plain {kh_plain_ms:.4f} ms, index_add_ "
          f"{kh_lib_ms:.4f} ms, bincount {kh_bincount_ms:.4f} ms, bound "
          f"{kh_bound['bound_ms']:.4f} ms by {kh_bound['bound_by']} (9 bytes a ray and the bins), "
          f"{kh_bound['needed_bound_ms']:.5f} ms by the bytes it needs (the mask, the captures' "
          f"sectors, the bins)", flush=True)

    # 6. The main path, through the entry points a user calls.
    tracer = Tracer(mesh, C, RATE, WINDOW, max_bounces=BOUNCES, tx_num_rays=N_RAYS, device=dev)
    _require(tracer.backend == "fused", f"Tracer chose backend {tracer.backend}")
    _sync()
    for k in kernels_built:
        k.launches = 0
    requests = []
    for i in range(3):
        tx_i = (TX[0], TX[1], TX[2] + float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        paths, ir = tracer.compute_cir(tx_i, 1.0, RX, RX_RADIUS, directions=dirs,
                                       record_paths=False)
        end.record()
        _sync()
        host_s = time.perf_counter() - h0
        dbm = float(tracer.rx_power_dbm(ir))
        _sync()
        requests.append((tx_i, start.elapsed_time(end), host_s, ir, dbm))
        _require(paths == [], "the fused path returned paths")
        _require(ir.shape == (NBINS,) and np.all(np.isfinite(ir)), "IR is not finite (nbins,)")
        _require(float(ir.sum()) > 0.0, f"request {i}: IR sum is 0")
        _require(np.isfinite(dbm), f"request {i}: dBm is not finite")
    launches = {K_FUSED: FUSED_TRACE_KERNEL.launches, K_HIST: cir.HISTOGRAM_KERNEL.launches,
                K_POWER: cir.RX_POWER_KERNEL.launches, K_ORDER: RAY_ORDER_KERNEL.launches}
    _require(all(v > 0 for v in launches.values()), f"a kernel did not run: {launches}")
    _require(launches[K_ORDER] == launches[K_FUSED], f"a request was not ordered: {launches}")
    _require(np.array_equal(requests[0][3], ir_k.cpu().numpy()),
             "the main path's first IR differs from the checked kernels' IR")
    # K-P on that IR, the `cir` command's single-IR call.
    kp_cir = _rx_power_leg(ir_k, WINDOW, "rx_power kernel, the request's IR")
    kpb_cir = _rx_power_backward_leg(ir_k, WINDOW, "rx_power kernel, the request's IR")
    _require(float(cir.rx_power_dbm(ir_k, WINDOW)[0]) == requests[0][4],
             "rx_power_dbm of the checked IR differs from the first request's")
    for tx_i, ev_ms, host_s, ir, dbm in requests:
        print(f"# compute_cir tx={tx_i}: {int((ir != 0).sum())} nonzero bins, IR sum "
              f"{float(ir.sum()):.6e}, {dbm:.4f} dBm; {ev_ms:.3f} ms (CUDA events), "
              f"{host_s * 1e3:.3f} ms host, {N_RAYS / host_s / 1e6:.2f} Mrays/s")
    print(f"# main path: captures {n_cap} at tx={TX}; launches {launches}", flush=True)

    # 7. The closest-hit kernel against its plain version.
    k2 = _closest_hit_phase(mesh, bvh, sub)

    # 8. The fused kernel's face record against its plain version.
    k_res, k_faces = fused_trace(bvh, sub, *args, max_bounces=BOUNCES, record_faces=True)
    p_res, p_faces = fused_trace_plain(bvh, sub, *args, max_bounces=BOUNCES, record_faces=True)
    _sync()
    _require(torch.equal(k_faces, p_faces), "fused trace: face records differ from plain")
    for a, b in zip(k_res[:4], k_out[:4]):
        _require(torch.equal(a, b), "the face record changed the fused trace")
    _require(torch.equal((k_faces >= 0).sum(0).int(), k_res.num_bounces),
             "face record and bounce counts disagree")
    k1_faces_ms = _cuda_ms(lambda: fused_trace(bvh, sub, *args, max_bounces=BOUNCES,
                                               record_faces=True), 20)
    fused_trace(bvh, dirs, *args, max_bounces=BOUNCES, record_faces=True)  # warm-up: allocates
    k1_faces_ms_full = _cuda_ms(lambda: fused_trace(bvh, dirs, *args, max_bounces=BOUNCES,
                                                    record_faces=True), 10)
    print(f"# fused trace face record, {SUBSET} rays: kernel == plain "
          f"({int((k_faces >= 0).sum())} bounces recorded); kernel {k1_faces_ms:.4f} ms, "
          f"{N_RAYS} rays {k1_faces_ms_full:.4f} ms", flush=True)
    del full, k_res, p_res, k_faces, p_faces
    torch.cuda.empty_cache()
    # The counted instantiation against the plain walk on the same subset
    # (phase 14 does the same on the 1M-triangle terrain).
    bench_sub = _counters_vs_plain(bvh, sub, args, "bench terrain", p_out)

    # 9-13. The gradient path, its checks, the inverse solve, the facade and
    #       coverage. Each main-path run (the forward requests above, each
    #       gradient path's value+grad, the solver's five steps, the coverage
    #       CLI's exact sweep, each fast and hybrid sweep) is counted on its
    #       own; the checks' and the facade's launches are not counted.
    grad = _gradient_phase(mesh, flat, bvh, dev, kernels_built)
    _fd_phase(mesh, bvh, dev)
    solve = _solver_phase(mesh, bvh, dev, kernels_built, card)
    _facade_phase(mesh, dirs, dev)
    del dirs, fused, tracer
    torch.cuda.empty_cache()
    cov = _coverage_phase(mesh, dev, kernels_built)
    # 16. The coverage metrics' value+grad (before phase 14, whose tables
    #     would otherwise share the card with its tensors).
    torch.cuda.empty_cache()
    cov_grad = _coverage_grad_phase(mesh, dev, kernels_built)
    # 17. The icosphere receiver at full width: the request, coverage and
    #     its value+grad.
    torch.cuda.empty_cache()
    ico_cir = _icosphere_cir_leg(mesh, dev, kernels_built, card)
    torch.cuda.empty_cache()
    ico_cov = _icosphere_coverage_leg(mesh, dev, kernels_built, card)
    torch.cuda.empty_cache()
    large, large_launches = _large_mesh_phase(
        root, dev, kernels_built, bvh,
        morton_sphere_directions(N_RAYS, generator=torch.Generator(dev).manual_seed(0), device=dev))
    # 15. The sharded paths: one rank in this process, then four ranks on
    #     this card (each rank counts its own launches; they are summed here).
    torch.cuda.empty_cache()
    dist_out, dist_launches = _dist_phase(root, dev, mesh, bvh)
    by_path = {
        "forward": launches,
        "scan_grad": grad["scan"].pop("launches"),
        "fused_grad": grad["fused"].pop("launches"),
        "solver": solve.pop("launches"),
        **cov.pop("launches"),
        **cov_grad.pop("launches"),
        **ico_cir.pop("launches"),
        **ico_cov.pop("launches"),
        **large_launches,
        **dist_launches,
    }

    def counts(symbol):
        per_path = {p: c.get(symbol, 0) for p, c in by_path.items()}
        return {"launches": sum(per_path.values()), "launches_by_path": per_path}

    # `ms`, `bound_ms` and `library_ms` are at the main path's shape; where the
    # plain version cannot run at that shape, `plain_ms` is its time on the
    # subset it was compared on and `ms_at_plain_shape` the kernel's there.
    kh_batch = solve["histogram_batch"]
    ks = solve.pop("map_capture")
    kp_room, kp_terrain = cov["room"].pop("rx_power"), cov["terrain"].pop("rx_power")
    kf_room, kf_terrain = cov["room"].pop("phasor"), cov["terrain"].pop("phasor")
    kpb_room = cov["room"].pop("rx_power_backward")
    kpb_terrain = cov["terrain"].pop("rx_power_backward")
    kfb_room, kfb_terrain = kf_room.pop("backward"), kf_terrain.pop("backward")
    bench_wc, large_wc, sub14 = large["bench_walk_counters"], large["walk_counters"], large["subset"]
    votes = large["micro_vote"]["styles"]["votes"]
    kb, kb_env = ico_cir["kernel"], ico_cov["room"]["env"]
    ico_room, ico_terrain = ico_cov["room"], ico_cov["terrain"]
    kbi = ico_cov["grad"]["backward"]
    m_steps, m_check = large["micro_vote"]["steps"], large["micro_vote"]["check_steps"]
    kernels = [
        {"name": "fused_trace", "route": "cuda", "source": "rfx_torch/csrc/fused_trace.cu",
         "replaces": "rfx/ops/pallas_fused.py:62", **counts(K_FUSED),
         "max_abs_err": max(amp_err, dist_err, sub14["max_abs_err"]),
         "ms": k1_ms_full, "plain_ms": k1_plain_ms_sub, "ms_at_plain_shape": k1_ms_sub,
         **large["bench_fused_bound"], "library_ms": None,
         "ms_record_faces": k1_faces_ms, "ms_record_faces_full": k1_faces_ms_full,
         "ms_large_mesh": large_wc["fused_trace_ms"],
         **_suffixed(large["fused_bound"], "_large_mesh"),
         "plain_ms_large_mesh": sub14["brute_plain_ms"],
         "ms_at_plain_shape_large_mesh": sub14["fused_ms"],
         "max_abs_err_cell_order": order["max_abs_err"],
         **{f"{k}_{leg}": order[leg][k] for leg in ("k1_iid", "k1_morton", "k1_faces_iid",
                                                     "k1_faces_morton")
            for k in ("ms", "caller_order_ms")},
         **{f"{k}_k1_{leg}_large_mesh": large["cell_order"][leg][k] for leg in ("iid", "morton")
            for k in ("ms", "caller_order_ms")},
         "shape": f"ms, bound_ms: {N_RAYS} Morton rays x {BOUNCES} bounces on the bench terrain, "
                  f"walked in direction-cell order (order, walk and put-back), the operations "
                  f"from this run's walk counters; plain_ms, ms_at_plain_shape, ms_record_faces: "
                  f"{SUBSET} rays, in the caller's order; *_large_mesh: the 1,045,458-triangle "
                  f"terrain, {N_RAYS} rays (plain: {LARGE_SUBSET} rays); max_abs_err_cell_order: "
                  f"{order['min_rays']} i.i.d. rays in cell order against the plain "
                  f"version; *_k1_iid / *_k1_morton: {N_RAYS} i.i.d. / Morton rays, ms in cell "
                  f"order and caller_order_ms in the caller's, the same bits; *_k1_faces_*: "
                  f"{GRAD_RAYS} rays with the face record"},
        {"name": "ray_order", "route": "cuda", "source": "rfx_torch/csrc/ray_order.cu",
         "replaces": "rfx/sampler.py:86", **counts(K_ORDER), "max_abs_err": 0,
         "ms": order["iid"]["ms"], "queued_ms": order["iid"]["queued_ms"],
         "plain_ms": order["plain_ms"], **order["bound"], "library_ms": order["library_ms"],
         "ms_morton": order["morton"]["ms"], "queued_ms_morton": order["morton"]["queued_ms"],
         "largest_cell": order["iid"]["largest_cell"], "empty_cells": order["iid"]["empty_cells"],
         "shape": f"the direction-cell order of {N_RAYS} i.i.d. rays (*_morton: Morton rays) on "
                  f"2^{order['bits']} x 2^{order['bits']} octahedral cells: the memset and the "
                  f"two kernels; keys and counts equal the plain version's (max_abs_err 0), the "
                  f"order a permutation with rank its inverse, the keys along it the plain "
                  f"stable sort's; queued_ms the device's own time a call; plain_ms: "
                  f"ray_order_plain on the card; library_ms: argsort of the keys and a gather "
                  f"of the directions; bound_ms: {ORDER_BYTES} bytes and {ORDER_FLOPS} f32 "
                  f"operations a ray; the TPU path had its rays Morton-ordered by the sampler's "
                  f"argsort"},
        {"name": "fused_trace_counted", "route": "cuda",
         "source": "rfx_torch/csrc/fused_trace.cu", "replaces": "rfx/ops/pallas_fused.py:62",
         **counts(K_COUNTED),
         "max_abs_err": max(bench_sub["counters_max_abs_err"], sub14["counters_max_abs_err"]),
         "ms": bench_wc["fused_trace_counted_ms"], "plain_ms": bench_sub["walk_plain_ms"],
         "ms_at_plain_shape": bench_sub["counted_ms"],
         **_counted_bound(large["bench_fused_bound"]), "library_ms": None,
         "ms_large_mesh": large_wc["fused_trace_counted_ms"],
         **_suffixed(_counted_bound(large["fused_bound"]), "_large_mesh"),
         "plain_ms_large_mesh": sub14["walk_plain_ms"],
         "ms_at_plain_shape_large_mesh": sub14["counted_ms"],
         "shape": f"the count_stats option of the TPU kernel: as fused_trace, plus the "
                  f"({BOUNCES}, 4) int64 counters; counters equal the plain walk's integer for "
                  f"integer (max_abs_err 0) and the trace equals the uncounted kernel's bit for bit"},
        {"name": "closest_hit", "route": "cuda", "source": "rfx_torch/csrc/closest_hit.cu",
         "replaces": "rfx/ops/pallas_trace.py:100", **counts(K_HIT),
         "max_abs_err": k2["max_abs_err"], "ms": k2["tx"]["ms"], "plain_ms": k2["plain_ms"],
         **_walk_keys(k2["tx"]), "library_ms": None,
         "ms_bounce2": k2["bounce2"]["ms"], "plain_ms_bounce2": k2["bounce2"]["walk_plain_ms"],
         **_suffixed(_walk_keys(k2["bounce2"]), "_bounce2"),
         "shape": f"{SUBSET} rays from tx on the bench terrain (plain_ms: brute force over the "
                  f"padded triangles); *_bounce2: their {k2['bounce2']['queries']} second-bounce "
                  f"queries (plain: the plain walk); bounds from the counted entry point's "
                  f"totals; also checked on 1,024 parked rays and a live triangle table"},
        {"name": "closest_hit_counted", "route": "cuda",
         "source": "rfx_torch/csrc/closest_hit.cu", "replaces": "rfx/ops/pallas_trace.py:100",
         **counts(K_HIT_COUNTED),
         "max_abs_err": max(k2["tx"]["counters_max_abs_err"], k2["bounce2"]["counters_max_abs_err"]),
         "ms": k2["tx"]["counted_ms"], "plain_ms": k2["tx"]["walk_plain_ms"],
         **_counted_hit_bound(k2["tx"]), "library_ms": None,
         "ms_bounce2": k2["bounce2"]["counted_ms"],
         "plain_ms_bounce2": k2["bounce2"]["walk_plain_ms"],
         **_suffixed(_counted_hit_bound(k2["bounce2"]), "_bounce2"),
         "shape": f"the WalkCount instantiation of closest_hit: as closest_hit, plus (n, 3) "
                  f"counters (nodes, leaves, triangles a query) that equal the plain walk's "
                  f"integer for integer (max_abs_err 0); {SUBSET} rays from tx and their "
                  f"second-bounce queries"},
        {"name": "ir_histogram", "route": "cuda", "source": "rfx_torch/csrc/histogram.cu",
         "replaces": "rfx/cir.py:32", **counts(K_HIST),
         "max_abs_err": max(ir_err, kh_batch["max_abs_err"]), "ms": kh_ms,
         "device_ms": kh_device_ms, "plain_ms": kh_plain_ms,
         **kh_bound, "library_ms": kh_lib_ms, "library_ms_bincount": kh_bincount_ms,
         "ms_solver_batch": kh_batch["soft_ms"], "ms_solver_batch_hard": kh_batch["hard_ms"],
         "device_ms_solver_batch": kh_batch["soft_device_ms"],
         "device_ms_solver_row": kh_batch["soft_one_row_device_ms"],
         "plain_ms_solver_batch": kh_batch["soft_plain_ms"],
         "plain_ms_solver_batch_hard": kh_batch["hard_plain_ms"],
         "library_ms_solver_batch_hard": kh_batch["index_add_ms"],
         **_suffixed(kh_batch["bounds_soft"], "_solver_batch"),
         "ms_solver_row": kh_batch["soft_one_row_ms"], "ms_solver_row_hard": kh_batch["hard_one_row_ms"],
         "plain_ms_solver_row": kh_batch["soft_one_row_plain_ms"],
         "plain_ms_solver_row_hard": kh_batch["hard_one_row_plain_ms"],
         "library_ms_solver_row_hard": kh_batch["index_add_one_row_ms"],
         **_suffixed(kh_batch["bounds_soft_one_row"], "_solver_row"),
         "shape": f"ms, plain_ms, bound_ms, library_ms: {N_RAYS} rays, one row, {NBINS} bins, hard; "
                  f"*_solver_batch: the inverse solve's call, {kh_batch['rows']} rows x "
                  f"{kh_batch['entries_per_row']} entries, soft (two planes), one launch; "
                  f"*_solver_row: one of those rows; bound_ms reads every input once (9 bytes an "
                  f"entry) and writes the bins, needed_bound_ms counts the mask, the captures' "
                  f"32-byte sectors and the bins; ms is the CUDA-event time of back-to-back "
                  f"calls of the wrapper, device_ms the device's own time a call; library_ms: index_add_ on ready-made bins and "
                  f"masked weights (hard sums, not deterministic)"},
        {"name": "coverage_hist", "route": "cuda", "source": "rfx_torch/csrc/coverage_hist.cu",
         "replaces": "rfx/ops/pallas_coverage.py:64", **counts(K_COV),
         "max_abs_err": max(cov["room"]["max_abs_err"], cov["terrain"]["max_abs_err"]),
         "ms": cov["room"]["k3_ms"], "plain_ms": cov["room"]["plain_ms"],
         **cov["room"].pop("bound"), "library_ms": None,
         "ms_terrain": cov["terrain"]["k3_ms"], "plain_ms_terrain": cov["terrain"]["plain_ms"],
         **_suffixed(cov["terrain"].pop("bound"), "_terrain"),
         "shape": f"2048 receivers x 2 bounces x {COV_RAYS} rays, {COV_BINS} bins, radius "
                  f"{COV_RADIUS}; ms, plain_ms, bound_ms: the room; *_terrain: the terrain; ms "
                  f"is the wrapper's call: zeroing the slabs' planes, the kernel and the slab "
                  f"reduction"},
        {"name": "coverage_hist_reduce", "route": "cuda",
         "source": "rfx_torch/csrc/coverage_hist.cu", "replaces": "rfx/ops/pallas_coverage.py:64",
         **counts(K_REDUCE), "max_abs_err": cov["reduce"]["max_abs_err"],
         "ms": cov["reduce"]["ms"], "plain_ms": cov["reduce"]["plain_ms"],
         **cov["reduce"].pop("bound"), "library_ms": cov["reduce"]["library_ms"],
         "shape": f"{cov['reduce']['planes']} slab planes of 2048 x {COV_BINS} f32 added per bin "
                  f"in slab order (the second launch of a coverage_hist call); library_ms: "
                  f"sum(dim=0)"},
        {"name": "rx_power", "route": "cuda", "source": "rfx_torch/csrc/rx_power.cu",
         "replaces": "rfx/cir.py:160", **counts(K_POWER),
         "max_abs_err": max(kp["max_abs_err"] for kp in (kp_room, kp_terrain, kp_cir)),
         "ms": kp_room["ms"], "plain_ms": kp_room["plain_ms"], **kp_room["bound"],
         "library_ms": kp_room["library_ms"],
         "ms_terrain": kp_terrain["ms"], "plain_ms_terrain": kp_terrain["plain_ms"],
         **_suffixed(kp_terrain["bound"], "_terrain"), "library_ms_terrain": kp_terrain["library_ms"],
         "device_ms": kp_room["device_ms"], "device_ms_terrain": kp_terrain["device_ms"],
         "ms_cir": kp_cir["ms"], "device_ms_cir": kp_cir["device_ms"],
         "plain_ms_cir": kp_cir["plain_ms"],
         **_suffixed(kp_cir["bound"], "_cir"), "library_ms_cir": kp_cir["library_ms"],
         "dbm_err_vs_plain": max(kp["dbm_err_vs_plain"] for kp in (kp_room, kp_terrain, kp_cir)),
         "shape": f"ms, plain_ms, bound_ms, library_ms: the room's 2048 exact IRs x {COV_BINS} "
                  f"bins; *_terrain: the terrain's; *_cir: the forward request's IR, {NBINS} bins; "
                  f"ms is the wrapper's call (three kernels in one launch sequence, the dBm "
                  f"included), device_ms the device's own time a call; bound_ms counts 2 f32 operations per in-range tap of the nonzero "
                  f"bins; max_abs_err on the signal; library_ms: conv1d with the flipped carrier, "
                  f"no TF32"},
        {"name": "coverage_phasor", "route": "cuda", "source": "rfx_torch/csrc/coverage_hist.cu",
         "replaces": "rfx/coverage.py:229", **counts(K_PHASOR),
         "max_abs_err": max(kf["dbm_err_vs_plain"] for kf in (kf_room, kf_terrain)),
         "ms": kf_room["ms"], "plain_ms": kf_room["plain_ms"], **kf_room["bound"],
         "library_ms": None, "walk_ms": kf_room["walk_ms"],
         "ms_terrain": kf_terrain["ms"], "plain_ms_terrain": kf_terrain["plain_ms"],
         "walk_ms_terrain": kf_terrain["walk_ms"],
         **_suffixed(kf_terrain["bound"], "_terrain"),
         "regions_lost": kf_room["regions_lost"], "regions_lost_terrain": kf_terrain["regions_lost"],
         "shape": f"2048 receivers x 2 bounces x {COV_RAYS} rays, radius {COV_RADIUS}, "
                  f"{COV_BINS} bins; ms, plain_ms, bound_ms: the room; *_terrain: the terrain; ms "
                  f"is the fast metric's call from the segments (the table, the walk with its "
                  f"slab reduction, the spread over the walk's capture lists, the formulas in "
                  f"torch), walk_ms the walk's call alone; max_abs_err in dB against the plain "
                  f"version; launches count one a sweep; regions_lost: (slab, receiver) "
                  f"regions whose list was lost and walked again"},
        {"name": "coverage_phasor_spread", "route": "cuda",
         "source": "rfx_torch/csrc/coverage_hist.cu", "replaces": "rfx/coverage.py:229",
         **counts(K_SPREAD),
         "max_abs_err": max(kf["spread"]["max_rel_err"] for kf in (kf_room, kf_terrain)),
         "ms": kf_room["spread"]["ms"], "plain_ms": kf_room["spread"]["plain_ms"],
         **kf_room["spread"]["bound"], "library_ms": None,
         "ms_terrain": kf_terrain["spread"]["ms"],
         "plain_ms_terrain": kf_terrain["spread"]["plain_ms"],
         **_suffixed(kf_terrain["spread"]["bound"], "_terrain"),
         "shape": f"the phasor metric's spread about each receiver's mean delay over the "
                  f"walk's capture lists, 2048 receivers ({kf_room['captures']} / "
                  f"{kf_terrain['captures']} captures, room / terrain); max_abs_err is relative "
                  f"to the plain version (phasor_spread_plain) at the kernel's mean delays"},
        {"name": "phasor_table", "route": "cuda", "source": "rfx_torch/csrc/coverage_hist.cu",
         "replaces": "rfx/cir.py:204", **counts(K_TABLE),
         "max_abs_err": max(kf["table"]["max_abs_err"] for kf in (kf_room, kf_terrain)),
         "ms": kf_room["table"]["ms"], "plain_ms": kf_room["table"]["plain_ms"],
         **kf_room["table"]["bound"], "library_ms": None,
         "shape": f"the phasor metric's per-bin (sqrt s_k, cos, sin, t_k), {COV_BINS} bins; "
                  f"max_abs_err against its torch form on the card (cos and sin)"},
        {"name": "rx_power_backward", "route": "cuda", "source": "rfx_torch/csrc/rx_power.cu",
         "replaces": "rfx/cir.py:184", **counts(K_POWER_BACKWARD),
         "max_abs_err": max(kp["max_abs_err"] for kp in (kpb_room, kpb_terrain, kpb_cir)),
         "ms": kpb_room["ms"], "plain_ms": kpb_room["plain_ms"], **kpb_room["bound"],
         "library_ms": kpb_room["library_ms"],
         "ms_terrain": kpb_terrain["ms"], "plain_ms_terrain": kpb_terrain["plain_ms"],
         **_suffixed(kpb_terrain["bound"], "_terrain"),
         "library_ms_terrain": kpb_terrain["library_ms"],
         "ms_cir": kpb_cir["ms"], "device_ms_cir": kpb_cir["device_ms"],
         "plain_ms_cir": kpb_cir["plain_ms"], **_suffixed(kpb_cir["bound"], "_cir"),
         "library_ms_cir": kpb_cir["library_ms"],
         "shape": f"the transpose of rfx/cir.py:184's lax.conv under jax.grad, g_dbm = 1 on "
                  f"every row: ms, bound_ms, library_ms: the room's 2048 exact IRs x {COV_BINS} "
                  f"bins; *_terrain: the terrain's; *_cir: the forward request's IR, {NBINS} bins; "
                  f"plain_ms: rx_power_backward_plain on {kpb_room['plain_rows']} of the rows; ms "
                  f"is the wrapper's call (the cotangent's staging and the transposed "
                  f"convolution), device_ms_cir the device's own time a call; bound_ms counts 2 f32 "
                  f"operations per in-range tap of the nonzero g_eff; max_abs_err on g_ir; "
                  f"library_ms: conv1d of g_eff with the carrier, no TF32"},
        {"name": "coverage_phasor_backward", "route": "cuda",
         "source": "rfx_torch/csrc/coverage_hist.cu", "replaces": "rfx/coverage.py:229",
         **counts(K_PHASOR_BACKWARD),
         "max_abs_err": max(kf["max_abs_err"] for kf in (kfb_room, kfb_terrain)),
         "ms": kfb_room["ms"], "plain_ms": kfb_room["plain_ms"], **kfb_room["bound"],
         "library_ms": None, "ms_terrain": kfb_terrain["ms"],
         "plain_ms_terrain": kfb_terrain["plain_ms"],
         **_suffixed(kfb_terrain["bound"], "_terrain"),
         "shape": f"the phasor metric's d / d amplitude under jax.grad, g_dbm = 1 on every "
                  f"receiver, 2048 receivers x 2 bounces x {COV_RAYS} rays, radius {COV_RADIUS}, "
                  f"{COV_BINS} bins: ms, plain_ms, bound_ms: the room; *_terrain: the terrain; "
                  f"max_abs_err on g_amplitude against phasor_backward_plain; bound_ms: the "
                  f"forward walk's sphere tests"},
        {"name": "map_capture", "route": "cuda", "source": "rfx_torch/csrc/map_capture.cu",
         "replaces": "rfx/coverage.py:56", **counts(K_MAP), "max_abs_err": ks["max_abs_err"],
         "ms": ks["ms"], "device_ms": ks["device_ms"], "plain_ms": ks["plain_ms"], **ks["bound"],
         "library_ms": None,
         "ms_with_histogram": ks["irs_ms"], "ms_with_histogram_hard": ks["irs_ms_hard"],
         "device_ms_with_histogram": ks["irs_device_ms"],
         "function_bound_ms": ks["function_bound"]["bound_ms"],
         "function_bound_by": ks["function_bound"]["bound_by"],
         "shape": f"the inverse solve's {ks['receivers']} receivers x {BOUNCES} bounces x "
                  f"{SOLVER_RAYS} rays (radius 1.0) on the segments of tx: the first-capture "
                  f"record, ({ks['receivers']}, {SOLVER_RAYS}) uint8, the bounce of each "
                  f"receiver's first capture along each ray or 0xFF, equal to the plain version's "
                  f"byte for byte (max_abs_err: the largest byte difference); "
                  f"ms_with_histogram(_hard): map_irs's forward, K-S and the histogram's record "
                  f"entry, soft (hard); bound_ms: 17 f32 operations per live segment and "
                  f"receiver, the segments' geometry, t_env and life read once (29 bytes each) "
                  f"and the record written once; function_bound_ms: the same operations, the "
                  f"segments read once (37 bytes each) and the ({ks['receivers']}, {NBINS}) IRs "
                  f"written once (segments to IRs, what K-S with the record entry computes); "
                  f"rfx/coverage.py:56-81 under the vmap / lax.map of :185-203 (XLA)"},
        {"name": "ir_histogram_record", "route": "cuda", "source": "rfx_torch/csrc/histogram.cu",
         "replaces": "rfx/cir.py:32", **counts(K_HIST_RECORD),
         "max_abs_err": ks["histogram"]["max_abs_err"], "ms": ks["histogram"]["soft_ms"],
         "device_ms": ks["histogram"]["soft_device_ms"], "plain_ms": ks["histogram"]["soft_plain_ms"],
         **ks["histogram"]["bound_soft"], "library_ms": None,
         "ms_hard": ks["histogram"]["hard_ms"], "device_ms_hard": ks["histogram"]["hard_device_ms"],
         "plain_ms_hard": ks["histogram"]["hard_plain_ms"],
         **_suffixed(ks["histogram"]["bound_hard"], "_hard"),
         "shape": f"the IR histogram's record entry at the inverse solve's shape: the "
                  f"({ks['receivers']}, {SOLVER_RAYS}) first-capture record of K-S on the "
                  f"segments of tx ({ks['captured']} captures, at most "
                  f"{ks['histogram']['captured_max_row']} in a row), {NBINS} bins, soft (two "
                  f"planes; *_hard: hard), one launch; the IRs equal the plain map engine's (its "
                  f"dense rows through the dense entry) bit for bit; max_abs_err against "
                  f"histogram_record_plain (index_add_ on the record expanded to rows); bound_ms: "
                  f"the record read once, 32 bytes of each capture's segment, the centers, the "
                  f"IRs written once; 21 (25) f32 operations a capture; ms is the CUDA-event time "
                  f"of back-to-back calls of the wrapper, device_ms the device's own time a call; "
                  f"no PyTorch call bins the record: library_ms null"},
        {"name": "map_capture_backward", "route": "cuda",
         "source": "rfx_torch/csrc/map_capture.cu", "replaces": "rfx/ops/intersect.py:234",
         **counts(K_MAP_BACKWARD), "max_abs_err": max(ks["backward_max_abs_err"].values()),
         "ms": ks["backward_ms"], "device_ms": ks["backward_device_ms"],
         "plain_ms": ks["backward_plain_ms"], **ks["backward_bound"],
         "library_ms": None, "ms_with_centers": ks["backward_centers_ms"],
         "device_ms_with_centers": ks["backward_centers_device_ms"],
         "max_abs_err_by_output": ks["backward_max_abs_err"],
         "shape": f"jax.grad through rfx/coverage.py:56-81 (the sphere's VJP, "
                  f"rfx/ops/intersect.py:234-248, and the transposes of the capture's where and "
                  f"the histogram's scatter), soft: d / d origin, direction, amplitude, distance "
                  f"of the solver's {ks['receivers']} x {BOUNCES} x {SOLVER_RAYS} segments for a "
                  f"seeded ({ks['receivers']}, {NBINS}) cotangent, given K-S's record; "
                  f"ms_with_centers: also d / d the centers, the scale and the radius; bound_ms: "
                  f"the record, the cotangent and 32 bytes of each captured segment read once, "
                  f"32 bytes a segment written, 60 f32 operations a capture"},
        {"name": "brute_hit", "route": "cuda", "source": "rfx_torch/csrc/brute_hit.cu",
         "replaces": "rfx/ops/intersect.py:75", **counts(K_BRUTE), "max_abs_err": 0.0,
         "ms": kb["ms"], "device_ms": kb["device_ms"], "queued_ms": kb["queued_ms"],
         "plain_ms": kb["plain_ms"], **kb["bound"],
         "library_ms": None, "ms_no_cull": kb["no_cull_ms"], "cull_passes": kb["cull_passes"],
         "ms_room_env": kb_env["ms"], "queued_ms_room_env": kb_env["queued_ms"],
         "plain_ms_room_env": kb_env["plain_ms"],
         **_suffixed(kb_env["bound"], "_room_env"),
         "shape": f"ms, plain_ms, bound_ms: the icosphere request's receiver test on its first "
                  f"bounce, {N_RAYS} rays from tx against the 80-face receiver (radius "
                  f"{RX_RADIUS}) with its cull ({kb['cull_passes']} rays pass it and test the "
                  f"faces); *_room_env: the room's environment, {kb_env['queries']} queries of "
                  f"the coverage trace's 2 bounces x 12 faces, no cull; t and face equal the "
                  f"plain version's (_brute_forward) bit for bit; bound_ms: 32 bytes a ray and "
                  f"the faces, {CULL_FLOPS + RAY_NORM_FLOPS} operations a ray for the cull and {MT_TEST_FLOPS} a "
                  f"test; XLA's (chunk, T) broadcast in rfx"},
        {"name": "fused_trace_ico", "route": "cuda", "source": "rfx_torch/csrc/fused_trace.cu",
         "replaces": "rfx/tracer.py:87 (the icosphere receiver under the scan tracer)",
         **counts(K_FUSED_ICO), "max_abs_err": 0.0, "ms": ico_cir["r0.1"]["iid_ms"],
         **ico_cir["r0.1"]["bound"], "library_ms": None,
         "shape": f"ms, bound_ms: {N_RAYS} i.i.d. rays x {BOUNCES} bounces on the bench "
                  f"terrain in direction-cell order (order, walk and put-back), the receiver an "
                  f"icosphere of radius 0.1; bound_ms: the analytic walk's counters on these "
                  f"rays, the cull on every ray-bounce and the 80 tests of the rays that pass it "
                  f"at the first bounce; the kernel equals fused_trace_plain(rx_mode="
                  f"'icosphere') bit for bit (max_abs_err) on {SUBSET} Morton rays and on "
                  f"ORDER_MIN_RAYS i.i.d. rays in cell order at radius 0.1 and 1.0; the TPU path "
                  f"ran this receiver only in the scan tracer; the comparison times are "
                  f"scripts/torch_bench_kernels.py's k1i row"},
        {"name": "map_capture_ico", "route": "cuda", "source": "rfx_torch/csrc/map_capture.cu",
         "replaces": "rfx/coverage.py:38", **counts(K_MAP_ICO), "max_abs_err": 0,
         "ms": ico_room["ks_ms"], "device_ms": ico_room["ks_device_ms"],
         "queued_ms": ico_room["ks_queued_ms"], "queued_ms_terrain": ico_terrain["ks_queued_ms"],
         "plain_ms": ico_room["ks_plain_ms"], **ico_room["ks_bound"], "library_ms": None,
         "ms_terrain": ico_terrain["ks_ms"], "device_ms_terrain": ico_terrain["ks_device_ms"],
         "plain_ms_terrain": ico_terrain["ks_plain_ms"],
         **_suffixed(ico_terrain["ks_bound"], "_terrain"),
         "shape": f"the icosphere coverage sweep's call: 64 receivers (radius {COV_RADIUS}) x 2 "
                  f"bounces x {COV_RAYS} rays on the room ({ico_room['cull_passes_64']} "
                  f"(segment, receiver) pairs pass the cull, {ico_room['captured_64']} "
                  f"captures); *_terrain: the terrain's; the (64, {COV_RAYS}) first-capture "
                  f"record equals map_record_plain's byte for byte (max_abs_err: the largest byte "
                  f"difference), and its t_first at every capture bit for bit; a warp a 32-ray "
                  f"group, two receivers a lane, each passing pair's 80 tests across the warp; "
                  f"bound_ms: the cull on every live segment and receiver, 80 tests where it "
                  f"passes, the segments (29 bytes), the unit faces, the record and t_first once; "
                  f"rfx/coverage.py:38-81 (_rx_query_t, icosphere) under the map engine's vmap "
                  f"(XLA)"},
        {"name": "ir_histogram_record_ico", "route": "cuda",
         "source": "rfx_torch/csrc/histogram.cu", "replaces": "rfx/cir.py:32",
         **counts(K_HIST_RECORD_ICO), "max_abs_err": 0.0,
         "ms": ico_room["histogram"]["soft_ms"], "device_ms": ico_room["histogram"]["soft_device_ms"],
         "queued_ms": ico_room["histogram"]["soft_queued_ms"],
         "plain_ms": ico_room["histogram"]["soft_plain_ms"], **ico_room["histogram"]["bound_soft"],
         "library_ms": None, "ms_hard": ico_room["histogram"]["hard_ms"],
         "device_ms_hard": ico_room["histogram"]["hard_device_ms"],
         "plain_ms_hard": ico_room["histogram"]["hard_plain_ms"],
         **_suffixed(ico_room["histogram"]["bound_hard"], "_hard"),
         "shape": f"the record entry's icosphere instantiation on K-S/ico's (64, {COV_RAYS}) record "
                  f"of the room ({ico_room['captured_64']} captures), {COV_BINS} bins, soft (two "
                  f"planes; *_hard: hard): t_rx read from K-S/ico's t_first; the IRs equal the "
                  f"plain composition's (_first_capture and the dense histogram) bit for bit "
                  f"(max_abs_err 0); bound_ms: the record, 12 bytes a capture and the IRs once, "
                  f"the binning a capture"},
        {"name": "map_capture_backward_ico", "route": "cuda",
         "source": "rfx_torch/csrc/map_capture.cu", "replaces": "rfx/ops/intersect.py:159",
         **counts(K_MAP_BACKWARD_ICO), "max_abs_err": max(kbi["max_abs_err"].values()),
         "ms": kbi["ms"], "device_ms": kbi["device_ms"], "queued_ms": kbi["queued_ms"],
         "plain_ms": kbi["plain_ms"],
         **kbi["bound"], "library_ms": None, "ms_with_centers": kbi["centers_ms"],
         "device_ms_with_centers": kbi["centers_device_ms"],
         "queued_ms_with_centers": kbi["centers_queued_ms"],
         "max_abs_err_by_output": kbi["max_abs_err"],
         "shape": f"jax.grad through rfx/coverage.py:38-81 with the icosphere (the brute hit's "
                  f"custom VJP, rfx/ops/intersect.py:159-185, through v0 = unit r + C), soft: d / d "
                  f"origin, direction, amplitude, distance of the room's 2 x {COV_RAYS} segments "
                  f"for a seeded (64, {COV_BINS}) cotangent, given K-S/ico's record "
                  f"({kbi['captured']} captures); ms_with_centers: also d / d the centers, the "
                  f"scale and the radius; within rtol 1e-5 of map_capture_backward_plain; "
                  f"bound_ms: the record, the cotangent, 32 bytes a captured segment, the centers "
                  f"and the unit faces read once, 32 bytes a segment written, 80 tests and the "
                  f"VJP a capture"},
        {"name": "micro_vote", "route": "cuda", "source": "rfx_torch/csrc/micro_vote.cu",
         "replaces": "scripts/micro_reduce.py:64", **counts(K_VOTE),
         "max_abs_err": max(abs(v["carry"] - v["plain_carry"])
                            for v in large["micro_vote"]["styles"].values()),
         "ms": votes["ms"], "plain_ms": votes["plain_ms"], "ms_at_plain_shape": votes["check_ms"],
         # One warp, per step and lane 8 x (add, add, compare) and the carry's
         # multiply-add; 4 KB in, 4 bytes out.
         **_bound(4 * 8 * 128 + 4, m_steps * 32 * (3 * 8 + 2)), "library_ms": None,
         "ns_per_body": {k: v["ns_per_body"] for k, v in large["micro_vote"]["styles"].items()},
         "shape": f"style votes, one (8, 128) f32 tile over one warp; ms: {m_steps} bodies; "
                  f"plain_ms, ms_at_plain_shape: {m_check} bodies; a latency measurement: the "
                  f"roofline bound says nothing about it"},
    ]
    print(json.dumps({"gradient_path": {
        "rays": GRAD_RAYS, "rel_diff": grad["rel_diff"], "flips": grad["flips"],
        "captured": grad["captured"],
        **{f"{p}_{k}": grad[p][k] for p in ("scan", "fused")
           for k in ("forward_ms", "valgrad_ms", "peak_bytes")}},
        "solver": {"rays": SOLVER_RAYS, "receivers": 64, **solve, "map_capture": ks},
        "coverage": {"rays": COV_RAYS, "receivers": 2048, "bins": COV_BINS, **cov},
        "rx_power": {"room": kp_room, "terrain": kp_terrain, "cir": kp_cir},
        "phasor": {"room": kf_room, "terrain": kf_terrain},
        "rx_power_backward": {"room": kpb_room, "terrain": kpb_terrain, "cir": kpb_cir},
        "phasor_backward": {"room": kfb_room, "terrain": kfb_terrain},
        "coverage_grad": cov_grad, "icosphere": {"cir": ico_cir, "coverage": ico_cov}}))
    print(json.dumps({"large_mesh": large, "bench_subset_counters": bench_sub}))
    print(json.dumps({"distribution": dist_out}))
    print(f"# inverse solve at full width: {[round(x, 3) for x in solve['step_ms']]} ms a step, "
          f"peak {solve['peak_bytes'] / 2**30:.3f} GiB; map capture {ks['ms']:.4f} ms (bound "
          f"{ks['bound']['bound_ms']:.4f}), with the record entry {ks['irs_ms']:.4f} ms (segments "
          f"to IRs {ks['function_bound']['bound_ms']:.4f}), its backward {ks['backward_ms']:.4f} / "
          f"{ks['backward_centers_ms']:.4f} ms (bound {ks['backward_bound']['bound_ms']:.4f}); on "
          f"{card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": len(cards_used)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
