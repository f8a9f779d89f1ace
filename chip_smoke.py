#!/usr/bin/env python3
"""Drive the PyTorch port's forward CIR main path once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize() so a fault shows where it
happened, and none catching its own failure:

1. the card's name and power limit (nvidia-smi);
2. build both kernels from rfx_torch/csrc/ into build/rfx_torch/;
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
6. the main path: rfx_torch.api.Tracer(...).compute_cir answers three
   requests, the tx raised by 1 m each time, and rx_power_dbm reads each IR.
   Both kernels' launch counts are reset just before and must be > 0 after;
   the first IR must equal phase 5's bit for bit.

Prints CUDA-event times of both kernels beside their plain versions, one JSON
line of the kernels, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, where CUDA is unavailable or the port's
sources are missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from rfx.bvh import build_bvh
    from rfx.geometry import make_terrain
    from rfx_torch import cir
    from rfx_torch.api import Tracer
    from rfx_torch.ops.fused import FUSED_TRACE_KERNEL, FusedTracer, fused_trace, fused_trace_plain
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

    # 2. Build both kernels from the sources in this checkout.
    t0 = time.perf_counter()
    for k in (FUSED_TRACE_KERNEL, cir.HISTOGRAM_KERNEL):
        k.load()
        print(f"# built {k.source}: {k.build_log.strip()}")
    print(f"# kernel build: {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. The bench workload.
    t0 = time.perf_counter()
    mesh = make_terrain(grid=128, extent=60.0, seed=0)
    flat = build_bvh(mesh, leaf_size=8, method="numpy")
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
    m = p_out.captured
    n_cap_sub = int(m.sum())
    _require(n_cap_sub > 0, "the subset captured nothing")
    _require(torch.equal(k_out.captured, p_out.captured), "fused trace: capture masks differ")
    _require(torch.equal(k_out.num_bounces, p_out.num_bounces), "fused trace: bounce counts differ")
    amp_err = float((k_out.amplitude[m] - p_out.amplitude[m]).abs().max())
    dist_err = float((k_out.distance[m] - p_out.distance[m]).abs().max())
    _require(torch.allclose(k_out.amplitude[m], p_out.amplitude[m], rtol=2e-5, atol=1e-7),
             f"fused trace: amplitude differs by {amp_err}")
    _require(torch.allclose(k_out.distance[m], p_out.distance[m], rtol=1e-5, atol=1e-4),
             f"fused trace: distance differs by {dist_err}")
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
    ir_k = cir.histogram(*h_args, **hkw)
    ir_k2 = cir.histogram(*h_args, **hkw)
    ir_p = cir.histogram_plain(*h_args, **hkw)
    _sync()
    _require(torch.equal(ir_k, ir_k2), "IR histogram: two kernel runs differ")
    _require(torch.equal(ir_k != 0, ir_p != 0), "IR histogram: nonzero bins differ from plain")
    _require(torch.allclose(ir_k, ir_p, rtol=1e-4, atol=1e-9), "IR histogram: kernel != plain")
    ir_err = float((ir_k - ir_p).abs().max())
    for mode in (cir.SOFT_LO, cir.SOFT_HI):
        s_k = cir.histogram(*h_args, mode=mode, **hkw)
        s_p = cir.histogram_plain(*h_args, mode=mode, **hkw)
        _require(torch.allclose(s_k, s_p, rtol=1e-4, atol=1e-9), f"soft histogram {mode} differs")
        ir_err = max(ir_err, float((s_k - s_p).abs().max()))
    _sync()
    kh_ms = _cuda_ms(lambda: cir.histogram(*h_args, **hkw), 20)
    kh_plain_ms = _cuda_ms(lambda: cir.histogram_plain(*h_args, **hkw), 20)
    n_cap = int(full.captured.sum())
    print(f"# IR histogram, {N_RAYS} rays ({n_cap} captured), {NBINS} bins: kernel == plain "
          f"(max |d| {ir_err:.3e}, {int((ir_k != 0).sum())} nonzero bins), bit-identical "
          f"across runs; kernel {kh_ms:.4f} ms, plain {kh_plain_ms:.4f} ms", flush=True)

    # 6. The main path, through the entry points a user calls.
    tracer = Tracer(mesh, C, RATE, WINDOW, max_bounces=BOUNCES, tx_num_rays=N_RAYS, device=dev)
    _require(tracer.backend == "fused", f"Tracer chose backend {tracer.backend}")
    _sync()
    FUSED_TRACE_KERNEL.launches = 0
    cir.HISTOGRAM_KERNEL.launches = 0
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
    launches = {"fused_trace": FUSED_TRACE_KERNEL.launches,
                "ir_histogram": cir.HISTOGRAM_KERNEL.launches}
    _require(all(v > 0 for v in launches.values()), f"a kernel did not run: {launches}")
    _require(np.array_equal(requests[0][3], ir_k.cpu().numpy()),
             "the main path's first IR differs from the checked kernels' IR")
    for tx_i, ev_ms, host_s, ir, dbm in requests:
        print(f"# compute_cir tx={tx_i}: {int((ir != 0).sum())} nonzero bins, IR sum "
              f"{float(ir.sum()):.6e}, {dbm:.4f} dBm; {ev_ms:.3f} ms (CUDA events), "
              f"{host_s * 1e3:.3f} ms host, {N_RAYS / host_s / 1e6:.2f} Mrays/s")
    print(f"# main path: captures {n_cap} at tx={TX}; launches {launches}", flush=True)

    kernels = [
        {"name": "fused_trace", "route": "cuda", "source": "rfx_torch/csrc/fused_trace.cu",
         "replaces": "rfx/ops/pallas_fused.py:62", "launches": launches["fused_trace"],
         "max_abs_err": max(amp_err, dist_err), "ms": k1_ms_sub, "plain_ms": k1_plain_ms_sub,
         "ms_full": k1_ms_full,
         "shape": f"ms, plain_ms: {SUBSET} rays; ms_full: {N_RAYS} rays; {BOUNCES} bounces"},
        {"name": "ir_histogram", "route": "cuda", "source": "rfx_torch/csrc/histogram.cu",
         "replaces": "rfx/cir.py:32", "launches": launches["ir_histogram"],
         "max_abs_err": ir_err, "ms": kh_ms, "plain_ms": kh_plain_ms,
         "shape": f"{N_RAYS} rays, {NBINS} bins, hard"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
