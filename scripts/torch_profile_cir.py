"""Where the time of one rfx_torch request goes, on a CUDA card.

`--path cir` (the default) runs the bench workload (bench.py: 32,258-triangle
terrain, 5,242,880 Morton-ordered rays, 4 bounces, 20,000-bin IR) through
rfx_torch.api.Tracer.compute_cir; with `--scene large` it runs the large-mesh
workload instead (scripts/torch_bench_large_mesh.py: the 1,045,458-triangle
terrain, tx (10, 0, 30), rx (-15, 5, 12), radius 2.0). `--path scan-grad` and `--path fused-grad`
run one value + gradient of scripts/bench_gradients.py's loss (sum(ir^2) *
1e12 over a 20,000-bin soft IR of 2,621,440 rays, 4 bounces) with respect to
tx, through the scan tracer on the closest-hit kernel or through the
differentiable fused tracer. `--path coverage-exact|coverage-fast|coverage-hybrid`
runs one coverage sweep through the facade (2,048 receivers of radius 0.5,
1,048,576 Morton rays, 2 bounces, 10,000 bins) on `--scene room` (tx
(3, 2, 2), z 0..14) or `--scene terrain` (tx (10, 0, 25), z 10..24); the
exact sweep includes rx_power_dbm. Each runs under torch.profiler and prints
the device time by kernel, the device busy share of the profiled window, and
the CUDA-event time of each request. Run from the root of a checkout:

    python3 scripts/torch_profile_cir.py [--path cir] [--scene terrain] [--requests 5]
                                         [--trace out.json]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="cir", choices=(
        "cir", "scan-grad", "fused-grad", "coverage-exact", "coverage-fast", "coverage-hybrid"))
    ap.add_argument("--scene", choices=("room", "terrain", "large"), default="terrain",
                    help="the coverage paths' scene; `large` is the cir path's 1M-triangle terrain")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--trace", help="write a Chrome trace of the profiled window here")
    a = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from rfx_torch.bvh import build_bvh
    from rfx_torch.geometry import make_room, make_terrain
    from rfx_torch.api import Tracer
    from rfx_torch.cir import cir_from_trace
    from rfx_torch.coverage import make_grid
    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.ops.fused import make_diff_fused_tracer
    from rfx_torch.sampler import morton_sphere_directions
    from rfx_torch.tracer import Scene, trace_to_rx

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    coverage = a.path.startswith("coverage")
    room = coverage and a.scene == "room"
    large = a.path == "cir" and a.scene == "large"
    if a.scene == "large" and not large:
        ap.error("--scene large goes with --path cir")
    mesh = (make_room() if room else make_terrain(grid=724, extent=120.0, seed=0) if large
            else make_terrain(grid=128, extent=60.0, seed=0))
    n = {"cir": 5_242_880, "scan-grad": 2_621_440, "fused-grad": 2_621_440}.get(a.path, 1_048_576)
    dirs = morton_sphere_directions(n, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    rx = (-10.0, 0.0, 8.0)

    if coverage:
        tracer = Tracer(mesh, 2.998e8, 100e9, 100e-9, max_bounces=2, tx_num_rays=n, device=dev)
        tx = (3.0, 2.0, 2.0) if room else (10.0, 0.0, 25.0)
        grid = make_grid(range(-15, 16, 2), range(-15, 16, 2),
                         range(0, 16, 2) if room else range(10, 26, 2))

        def request(i):
            req = (tx, 1.0, grid, 0.5)
            if a.path == "coverage-exact":
                return tracer.rx_power_dbm(tracer.compute_coverage(*req, directions=dirs))
            if a.path == "coverage-fast":
                return tracer.compute_coverage_dbm_fast(*req, directions=dirs)
            return tracer.compute_coverage_dbm_hybrid(*req, directions=dirs)
    elif a.path == "cir":
        tracer = Tracer(mesh, max_bounces=4, tx_num_rays=n, device=dev)

        def request(i):
            if large:
                return tracer.compute_cir((10.0, 0.0, 30.0 + i), 1.0, (-15.0, 5.0, 12.0), 2.0,
                                          directions=dirs, record_paths=False)
            return tracer.compute_cir((10.0, 0.0, 25.0 + i), 1.0, rx, 1.0, directions=dirs,
                                      record_paths=False)
    else:
        scene = Scene.from_mesh(mesh, dev)
        flat = build_bvh(mesh, leaf_size=8)
        if a.path == "scan-grad":
            env = make_kernel_env_hit(flat, device=dev)

            def trace(txp):
                return trace_to_rx(scene, txp, dirs, rx, 1.0, max_bounces=4,
                                   rx_mode="analytic", env_hit=env)
        else:
            dt = make_diff_fused_tracer(flat, scene.faces, max_bounces=4, device=dev)

            def trace(txp):
                return dt(scene.vertices, txp, dirs, rx, 1.0)

        def request(i):
            tx = torch.tensor([10.0, 0.0, 25.0 + i], device=dev, requires_grad=True)
            ir = cir_from_trace(trace(tx), tx_power=1.0, num_rays=n, nbins=20_000,
                                light_speed_mps=2.998e8, sample_rate_hz=100e9, soft=True)
            (torch.sum(ir * ir) * 1e12).backward()
            return tx.grad

    for i in range(2):  # build the kernels, warm up
        request(i)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(a.requests):
            request(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    print(events.table(sort_by="cuda_time_total", row_limit=15))
    # Device time of the kernels alone: an operator row also carries the
    # time of the kernels it launched, so summing every row counts it twice
    # (the table's own "Self CUDA time total" sums the same way as here).
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    print(f"profiled window: {a.requests} requests, {wall_ms:.3f} ms host wall, "
          f"{device_us / 1e3:.3f} ms device busy ({100 * device_us / 1e3 / wall_ms:.1f}%)")
    if a.trace:
        prof.export_chrome_trace(a.trace)

    for i in range(a.requests):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        request(i)
        end.record()
        torch.cuda.synchronize()
        print(f"request {i}: {start.elapsed_time(end):.4f} ms (CUDA events), "
              f"{n / start.elapsed_time(end) / 1e3:.1f} Mrays/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
