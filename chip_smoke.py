#!/usr/bin/env python3
"""Drive the PyTorch port's forward CIR path, its gradient path, its coverage
path and its large-mesh path once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize() so a fault shows where it
happened, and none catching its own failure:

1. the card's name and power limit (nvidia-smi);
2. build the five CUDA sources of rfx_torch/csrc/ (six kernels: the fused
   trace and its counted instantiation share one) and the native C++ BVH
   builder into build/rfx_torch/, one compiler each, all started together;
3. the bench workload (bench.py): make_terrain(grid=128, extent=60, seed=0),
   32,258 triangles, 5,242,880 Morton-ordered rays, 4 bounces, a 20,000-bin
   IR, tx (10, 0, 25), rx (-10, 0, 8), rx radius 1.0;
4. the fused-trace kernel against its plain PyTorch version on 65,536 of
   those rays (every 80th): identical capture masks and bounce counts,
   amplitude within rtol 2e-5 / atol 1e-7, distance within rtol 1e-5 /
   atol 1e-4 (tests/test_fused.py:15-26);
5. the IR histogram kernel against its plain version on the full trace's
   outputs (rtol 1e-4, atol 1e-9, the same nonzero bins), hard and soft, and
   bit-identical across two runs;
6. the forward path: rfx_torch.api.Tracer(...).compute_cir answers three
   requests, the tx raised by 1 m each time, and rx_power_dbm reads each IR.
   The launch counts are reset just before and must be > 0 after; the first
   IR must equal phase 5's bit for bit;
7. the per-query closest-hit kernel against its plain version on the bench
   scene: the 65,536 rays of phase 4 from tx, their reflected second-bounce
   queries from the terrain, and 1,024 parked rays; identical t, indices,
   faces and normals; the first two sets again with a live triangle table
   (`live_tri`, the differentiable-tris route's repack);
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
    1e-5; then five steps at full width: the
    terrain, 1,048,576 Morton rays, 4 bounces, 64 receivers on an 8x8 grid
    at z = 8 over x, y in [-20, 20], radius 1.0, 20,000 bins at 100 GHz,
    target energies from tx (10, 0, 25), start (12, -2, 26), lr 0.05: finite
    losses, finite nonzero gradients, time per step and peak memory;
12. the facade: compute_cir(record_paths=True) at 262,144 rays through the
    closest-hit kernel (paths start at tx, captures within the flip budget
    of the fused kernel's), and compute_coverage of 16 receivers;
13. coverage (scripts/coverage_exact_tpu.py, scripts/hybrid_coverage_r5.py):
    2,048 receivers of radius 0.5, 1,048,576 Morton rays, 2 bounces, 10,000
    bins at 100 GHz, on the room (tx (3, 2, 2), z 0..14) and the terrain
    (tx (10, 0, 25), z 10..24): the coverage kernel against its plain version
    on the card's segments (the same nonzero bins, rtol 1e-5 / atol 1e-12,
    bit-identical across runs); the exact metric through
    `rfx_torch.cli.main(["coverage", ...])` (room), whose saved dBm must equal
    the facade's and be finite exactly where an IR is nonzero, with
    rx_power_dbm bit-identical across two card runs and within 1e-3 dB of the
    CPU; the fast and hybrid metrics through the facade, the fast one's dBm
    (1e-3 dB), ratio and spread (rtol 1e-4) held against the CPU on the same
    segments, the hybrid's flagged set against the CPU's (bar receivers
    within 1e-4 of a threshold), the hybrid exact where it fell back and fast
    elsewhere; wall and CUDA-event times of each metric;
14. the large-mesh path (scripts/torch_bench_large_mesh.py, whose legs this
    phase calls): make_terrain(grid=724, extent=120, seed=0), 1,045,458
    triangles, the native builder at leaf 8 (asserted, with its seconds,
    nodes, padded triangles and bytes on the card), tx (10, 0, 30), rx
    (-15, 5, 12), radius 2.0. Against the plain versions, on 8,192 of the
    5,242,880 Morton rays: the fused kernel == the brute plain version
    (phase 4's bars), the counted kernel's trace == the uncounted kernel's
    bit for bit, its (4, 4) int64 counters == `fused_trace_walk_plain`'s
    integer for integer, and that plain walk's trace == the brute plain
    version's; the same counter check on phase 4's 65,536 rays of the bench
    terrain. Then the path itself, counted on its own: the 16,384-ray parity
    leg of the closest-hit kernel against the plain walk of an independent
    leaf-16 tree; three compute_cir requests at 5,242,880 rays x 4 bounces x
    20,000 bins (CUDA events, Mrays/s; the first again, bit-identical); the
    walk counters at full width with the counted trace == the uncounted one
    bit for bit, and the SIMT efficiency nodes / (32 * warp_steps); the
    per-query cross-check at 1,048,576 rays. The same counters and times on
    the bench terrain beside them. Last, the vote micro-kernel
    (scripts/torch_micro_vote.py): each style's carry == the plain version's
    after 2,000 bodies, then ns per body at 50,000 bodies, counted on its own.
Each main-path run is counted on its own: every launch count is set to 0
just before it and read just after, and each kernel the path runs must have
launched (the forward requests: fused trace and histogram; the large-mesh
path: fused trace, counted fused trace, closest hit and histogram; the
micro-kernel's timed launches: micro vote; the scan
value+grad and the five full-width solver steps: closest hit and histogram;
the fused value+grad: fused trace and histogram; the coverage CLI's exact
sweep: the coverage kernel; each hybrid sweep: the coverage kernel, and on
the terrain the closest hit; each fast sweep: on the terrain the closest hit,
and never the coverage kernel). The comparisons with the plain versions, the
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
# Phase 13 holds rx_power_dbm against the CPU on all 2,048 IRs (about 20 s
# of CPU time) and the fast metric on every CPU_FAST_STRIDE-th receiver: all
# 2,048 would add about 60 s of CPU time per configuration.
CPU_FAST_STRIDE = 32
LARGE_SUBSET = 8_192
# Launch counts are kept per C entry point (CudaKernel.symbol).
K_FUSED = "rfx_fused_trace"
K_COUNTED = "rfx_fused_trace_counted"
K_HIT = "rfx_closest_hit"
K_HIST = "rfx_ir_histogram"
K_COV = "rfx_coverage_hist"
K_VOTE = "rfx_micro_vote"
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
BOUNCE_FLOPS = 60
NODE_BYTES = 48  # two float4 of box, one int4 of meta
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
    tables = sum(int(t.numel() * t.element_size()) for t in (bvh.node_box, bvh.node_meta, bvh.tri))
    touched = min(tables, nodes * NODE_BYTES + tris * TRI_BYTES)
    return _bound(io_bytes + touched, nodes * SLAB_FLOPS + tris * MT_FLOPS + extra_flops)


def _fused_bound(bvh, counters: dict) -> dict:
    """Bound of one fused trace from `counters_leg`'s numbers: 12 bytes of
    direction in and 13 bytes of result out per ray."""
    n = counters["rays"]
    return _walk_bound(bvh, sum(counters["nodes_per_bounce"]), sum(counters["tris_per_bounce"]),
                       25 * n, BOUNCE_FLOPS * (n + counters["ray_bounces"]))


def _suffixed(d: dict, suffix: str) -> dict:
    return {k + suffix: v for k, v in d.items()}


def _counted_bound(fused_bound: dict) -> dict:
    """The counted instantiation does the fused trace's work and writes 128
    bytes of counters more."""
    return _bound(fused_bound["bound_bytes"] + 32 * BOUNCES, fused_bound["bound_flops"])


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


def _closest_hit_phase(mesh, bvh, sub):
    """Phase 7: the closest-hit kernel against its plain version on three
    query sets, with the packed triangle table, and on two of them with a
    live repack (`live_tri`) of triangles shrunk by 0.1% about their
    centroids (a table unlike the packed one whose triangles stay inside the
    host-built boxes); returns (max |error|, kernel ms, plain ms, bound) on
    the tx set, the bound from the counted fused kernel's one-bounce walk of
    the same queries."""
    import torch

    from rfx_torch.ops import bvh_trace
    from rfx_torch.ops.fused import fused_trace
    from rfx_torch.ops.intersect import dot3, mesh_soa

    dev = sub.device
    o1 = torch.tensor(TX, device=dev).expand(sub.shape[0], 3).contiguous()
    t1, _, _, n1 = bvh_trace.closest_hit_plain(bvh, o1, sub)
    hit = t1 < 1e29
    o2 = (o1 + sub * t1[:, None])[hit].contiguous()
    d2 = (sub - 2.0 * dot3(sub, n1)[:, None] * n1)[hit].contiguous()
    parked = torch.full((1024, 3), 1e9, device=dev)
    v0, e1, e2, _ = mesh_soa(torch.as_tensor(mesh.vertices, device=dev),
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
    ms = _cuda_ms(lambda: bvh_trace.closest_hit(bvh, o1, sub), 20)
    plain_ms = _cuda_ms(lambda: bvh_trace.closest_hit_plain(bvh, o1, sub), 1)
    # The same walk, counted: 24 bytes of origin and direction in, 24 bytes
    # of t, index, face and normal out per ray, and the face ids.
    _, walk = fused_trace(bvh, sub, TX, RX, RX_RADIUS, max_bounces=1, count_stats=True)
    nodes, _, tris, _ = (int(v) for v in walk[0])
    n = sub.shape[0]
    bound = _walk_bound(bvh, nodes, tris, 48 * n + min(4 * bvh.n_padded_tris, 4 * n))
    print(f"# closest hit, {n} rays from tx: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms; "
          f"{nodes} nodes, {tris} triangles tested: bound {bound['bound_ms']:.5f} ms by "
          f"{bound['bound_by']}", flush=True)
    return err, ms, plain_ms, bound


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
    needs = {"scan": (K_HIT, K_HIST), "fused": (K_FUSED, K_HIST)}
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


def _solver_phase(mesh, bvh, dev, kernels):
    """Phase 11: the room steps against their CPU version, then five steps
    of the inverse solve at full width; returns what it measured."""
    import numpy as np
    import torch

    from rfx_torch.coverage import make_grid
    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.sampler import morton_sphere_directions
    from rfx_torch.solver import coverage_irs_soft, make_inverse_solver
    from rfx_torch.tracer import Scene

    room = _solver_step_vs_plain(dev)
    scene = Scene.from_mesh(mesh, dev)
    dirs = morton_sphere_directions(SOLVER_RAYS, generator=torch.Generator(dev).manual_seed(1),
                                    device=dev)
    axis = np.linspace(-20.0, 20.0, 8)
    centers = torch.as_tensor(make_grid(axis, axis, [8.0]), device=dev)
    env = make_kernel_env_hit(bvh)
    kw = dict(max_bounces=BOUNCES, nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE)
    with torch.no_grad():
        irs = coverage_irs_soft(scene.vertices, scene.faces, torch.tensor(TX, device=dev), 5.0,
                                dirs, centers, 1.0, num_rays=SOLVER_RAYS, env_hit=env, **kw)
        target = torch.sum(irs * irs, dim=1)
    _sync()
    n_lit = int((target > 0).sum())
    _require(bool(torch.isfinite(target).all()) and n_lit > 0, "solver target is empty")
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

    _, launches = _counted(kernels, "inverse solve", (K_HIT, K_HIST), steps)
    peak = torch.cuda.max_memory_allocated(dev)
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
          f"log_n1 {moved_max[1]:.6g}; peak {peak / 2**30:.3f} GiB", flush=True)
    return dict(losses=losses, step_ms=step_ms, peak_bytes=peak, moved_max=moved_max,
                launches=launches, **room)


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
    from rfx_torch.coverage import _dbm_cancel_from_segments, make_grid
    from rfx_torch.ops.coverage_hist import coverage_hist, coverage_hist_plain
    from rfx_torch.sampler import morton_sphere_directions
    from rfx_torch.tracer import EnvSegments, trace_env

    dirs = morton_sphere_directions(COV_RAYS, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    hkw = dict(nbins=COV_BINS, light_speed_mps=C, sample_rate_hz=RATE)
    fkw = dict(num_rays=COV_RAYS, sample_window_s=COV_WINDOW, sample_rate_hz=RATE,
               carrier_hz=2.4e9, light_speed_mps=C, tx_power=1.0, rx_batch=64)
    out = {"launches": {}}
    for name, mesh, tx, zs in (("room", make_room(), (3.0, 2.0, 2.0), range(0, 16, 2)),
                               ("terrain", terrain, (10.0, 0.0, 25.0), range(10, 26, 2))):
        res = out[name] = {}
        tracer = Tracer(mesh, C, RATE, COV_WINDOW, max_bounces=2, tx_num_rays=COV_RAYS,
                        device=dev)
        grid = make_grid(range(-15, 16, 2), range(-15, 16, 2), zs)
        m = grid.shape[0]
        centers = torch.as_tensor(grid, device=dev)
        segs = trace_env(tracer.scene, tx, dirs, max_bounces=2, env_hit=tracer.env_hit)
        scaled = segs._replace(amplitude=segs.amplitude * (torch.tensor(1.0) / COV_RAYS).to(dev))
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
              f"lit, max |d| {res['max_abs_err']:.3e}), bit-identical across runs; kernel "
              f"{res['k3_ms']:.3f} ms, plain {res['plain_ms']:.1f} ms, bound "
              f"{res['bound']['bound_ms']:.3f} ms by {res['bound']['bound_by']}", flush=True)
        del k2, p

        # 2. The exact metric through the command line (room), with
        #    rx_power_dbm on the card twice and on the CPU.
        if name == "room":
            with tempfile.TemporaryDirectory() as tmp:
                save = os.path.join(tmp, "dbm.npy")
                argv = ["coverage", "--scene", "room", "--rays", str(COV_RAYS), "--tx", "3", "2",
                        "2", "--rx-radius", str(COV_RADIUS), "--metric", "exact", "--no-viz",
                        "--save-dbm", save, "--device", "cuda"]
                (rc, launches), host_s, ev_ms = _timed(lambda: _counted(
                    kernels, "coverage_exact", (K_COV,), lambda: cli.main(argv)))
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
                  f"rx_power_dbm bit-identical across two card runs, card vs CPU on "
                  f"{int(fin.size)} receivers max |d| {dbm_err:.3e} dB "
                  f"({res['rx_dbm_bits_differ']} differ in any bit)", flush=True)
            del irs

        # 3. Fast and hybrid through the facade, each counted; the fast
        #    metric's diagnostics against the CPU on every CPU_FAST_STRIDE-th
        #    receiver of the same segments.
        env_needs = () if name == "room" else (K_HIT,)
        req = (tx, 1.0, grid, COV_RADIUS)
        (fast, launches), res["fast_host_s"], res["fast_ms"] = _timed(lambda: _counted(
            kernels, f"coverage_fast_{name}", env_needs,
            lambda: tracer.compute_coverage_dbm_fast(*req, directions=dirs)))
        _require(launches[K_COV] == 0, f"fast metric, {name}: the coverage kernel ran")
        out["launches"][f"coverage_fast_{name}"] = launches
        (hybrid, n_flagged), launches = _counted(
            kernels, f"coverage_hybrid_{name}", (K_COV,) + env_needs,
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
        _require(np.allclose(hybrid[redo & ok], exact[redo & ok], rtol=0, atol=1e-3)
                 and np.array_equal(hybrid[~redo], fast[~redo]),
                 f"hybrid, {name}: not exact where flagged and fast elsewhere")
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

    # The path itself.
    def path():
        res = {"parity": large.parity_leg(mesh, bvh, dev)}
        res["cir"] = large.cir_leg(tracer, dirs)
        res["walk_counters"] = large.counters_leg(bvh, dirs)
        res["perquery_vs_fused"] = large.perquery_leg(bvh, dirs[:large.N_PERQUERY].contiguous())
        return res

    res, launches["large_mesh"] = _counted(kernels, "large mesh", (K_FUSED, K_COUNTED, K_HIT, K_HIST),
                                           path)
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
    from rfx_torch.ops.bvh_trace import CLOSEST_HIT_KERNEL
    from rfx_torch.ops.coverage_hist import COVERAGE_HIST_KERNEL
    from rfx_torch.ops.fused import (
        FUSED_TRACE_COUNTED_KERNEL,
        FUSED_TRACE_KERNEL,
        FusedTracer,
        fused_trace,
        fused_trace_plain,
    )
    from rfx_torch.ops.micro_vote import MICRO_VOTE_KERNEL
    from rfx_torch.sampler import morton_sphere_directions

    # Full f32 everywhere (no TF32 matmul or convolution), as the JAX
    # reference computes on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. The card.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    print(card, flush=True)

    # 2. Build the five CUDA sources and the native BVH builder from the
    #    sources in this checkout, one compiler each, all started together;
    #    the counted fused trace binds its entry in the fused trace's library.
    t0 = time.perf_counter()
    per_source = (FUSED_TRACE_KERNEL, CLOSEST_HIT_KERNEL, cir.HISTOGRAM_KERNEL,
                  COVERAGE_HIST_KERNEL, MICRO_VOTE_KERNEL)
    kernels_built = per_source + (FUSED_TRACE_COUNTED_KERNEL,)
    with ThreadPoolExecutor(len(per_source) + 1) as pool:
        native = pool.submit(native_lib.load)
        list(pool.map(lambda k: k.load(), per_source))
        native.result()
    FUSED_TRACE_COUNTED_KERNEL.load()
    for k in per_source:
        print(f"# built {k.source}: {k.build_log.strip()}")
    print("# built native/bvh_builder.cpp with g++")
    print(f"# kernel build: {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. The bench workload.
    t0 = time.perf_counter()
    mesh = make_terrain(grid=128, extent=60.0, seed=0)
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
    kh_bound = _bound(9 * N_RAYS + 4 * NBINS, 4 * N_RAYS)
    del raw, bins, weight, lib_add
    print(f"# IR histogram, {N_RAYS} rays ({n_cap} captured), {NBINS} bins: kernel == plain "
          f"(max |d| {ir_err:.3e}, {int((ir_k != 0).sum())} nonzero bins), bit-identical "
          f"across runs; kernel {kh_ms:.4f} ms, plain {kh_plain_ms:.4f} ms, index_add_ "
          f"{kh_lib_ms:.4f} ms, bincount {kh_bincount_ms:.4f} ms, bound "
          f"{kh_bound['bound_ms']:.4f} ms by {kh_bound['bound_by']}", flush=True)

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
    launches = {K_FUSED: FUSED_TRACE_KERNEL.launches, K_HIST: cir.HISTOGRAM_KERNEL.launches}
    _require(all(v > 0 for v in launches.values()), f"a kernel did not run: {launches}")
    _require(np.array_equal(requests[0][3], ir_k.cpu().numpy()),
             "the main path's first IR differs from the checked kernels' IR")
    for tx_i, ev_ms, host_s, ir, dbm in requests:
        print(f"# compute_cir tx={tx_i}: {int((ir != 0).sum())} nonzero bins, IR sum "
              f"{float(ir.sum()):.6e}, {dbm:.4f} dBm; {ev_ms:.3f} ms (CUDA events), "
              f"{host_s * 1e3:.3f} ms host, {N_RAYS / host_s / 1e6:.2f} Mrays/s")
    print(f"# main path: captures {n_cap} at tx={TX}; launches {launches}", flush=True)

    # 7. The closest-hit kernel against its plain version.
    k2_err, k2_ms, k2_plain_ms, k2_bound = _closest_hit_phase(mesh, bvh, sub)

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
    solve = _solver_phase(mesh, bvh, dev, kernels_built)
    _facade_phase(mesh, dirs, dev)
    del dirs, fused, tracer
    torch.cuda.empty_cache()
    cov = _coverage_phase(mesh, dev, kernels_built)
    large, large_launches = _large_mesh_phase(
        root, dev, kernels_built, bvh,
        morton_sphere_directions(N_RAYS, generator=torch.Generator(dev).manual_seed(0), device=dev))
    by_path = {
        "forward": launches,
        "scan_grad": grad["scan"].pop("launches"),
        "fused_grad": grad["fused"].pop("launches"),
        "solver": solve.pop("launches"),
        **cov.pop("launches"),
        **large_launches,
    }

    def counts(symbol):
        per_path = {p: c.get(symbol, 0) for p, c in by_path.items()}
        return {"launches": sum(per_path.values()), "launches_by_path": per_path}

    # `ms`, `bound_ms` and `library_ms` are at the main path's shape; where the
    # plain version cannot run at that shape, `plain_ms` is its time on the
    # subset it was compared on and `ms_at_plain_shape` the kernel's there.
    bench_wc, large_wc, sub14 = large["bench_walk_counters"], large["walk_counters"], large["subset"]
    votes = large["micro_vote"]["styles"]["votes"]
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
         "shape": f"ms, bound_ms: {N_RAYS} rays x {BOUNCES} bounces on the bench terrain, the "
                  f"operations from this run's walk counters; plain_ms, ms_at_plain_shape, "
                  f"ms_record_faces: {SUBSET} rays; *_large_mesh: the 1,045,458-triangle "
                  f"terrain, {N_RAYS} rays (plain: {LARGE_SUBSET} rays)"},
        {"name": "fused_trace_counted", "route": "cuda",
         "source": "rfx_torch/csrc/fused_trace.cu", "replaces": "rfx/ops/pallas_fused.py:62",
         **counts(K_COUNTED), "max_abs_err": 0.0,
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
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, **k2_bound,
         "library_ms": None,
         "shape": f"{SUBSET} rays from tx on the bench terrain; also checked on their "
                  f"second-bounce queries, 1,024 parked rays and a live triangle table"},
        {"name": "ir_histogram", "route": "cuda", "source": "rfx_torch/csrc/histogram.cu",
         "replaces": "rfx/cir.py:32", **counts(K_HIST),
         "max_abs_err": ir_err, "ms": kh_ms, "plain_ms": kh_plain_ms, **kh_bound,
         "library_ms": kh_lib_ms, "library_ms_bincount": kh_bincount_ms,
         "shape": f"{N_RAYS} rays, {NBINS} bins, hard; library_ms: index_add_ on ready-made "
                  f"bins and masked weights (not deterministic)"},
        {"name": "coverage_hist", "route": "cuda", "source": "rfx_torch/csrc/coverage_hist.cu",
         "replaces": "rfx/ops/pallas_coverage.py:64", **counts(K_COV),
         "max_abs_err": max(cov["room"]["max_abs_err"], cov["terrain"]["max_abs_err"]),
         "ms": cov["room"]["k3_ms"], "plain_ms": cov["room"]["plain_ms"],
         **cov["room"].pop("bound"), "library_ms": None,
         "ms_terrain": cov["terrain"]["k3_ms"], "plain_ms_terrain": cov["terrain"]["plain_ms"],
         **_suffixed(cov["terrain"].pop("bound"), "_terrain"),
         "shape": f"2048 receivers x 2 bounces x {COV_RAYS} rays, {COV_BINS} bins, radius "
                  f"{COV_RADIUS}; ms, plain_ms, bound_ms: the room; *_terrain: the terrain"},
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
        "solver": {"rays": SOLVER_RAYS, "receivers": 64, **solve},
        "coverage": {"rays": COV_RAYS, "receivers": 2048, "bins": COV_BINS, **cov}}))
    print(json.dumps({"large_mesh": large, "bench_subset_counters": bench_sub}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
