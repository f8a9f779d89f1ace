#!/usr/bin/env python3
"""Weak-scaling harness of the port's sharded CIR (the port's bench_scaling.py):
throughput of `rfx_torch.parallel.sharded_cir` against the number of ranks,
with the same rays a rank at every count, so ideal scaling keeps the time
constant and the efficiency is t(1) / t(d).

    python3 scripts/torch_bench_scaling.py [--ranks 1,2,4] [--rays-per-rank 1048576]
    python3 scripts/torch_bench_scaling.py --device cpu --rays-per-rank 4096   # a rehearsal

On the card: the bench terrain (32,258 triangles) through the closest-hit
kernel, 4 bounces, 20,000 bins, 1,048,576 Morton rays a rank, tx (10, 0, 25),
rx (-10, 0, 8), radius 1.0. On the CPU: the room through the brute-force
intersector, 2 bounces, 2,000 bins at 10 GHz. Each count starts its ranks as processes
of this host (rfx_torch.parallel.launch) over gloo, or NCCL where every rank
has a card of its own; a rank times `--reps` calls after one warm-up (host
clock, synchronized), and the slowest rank's best call is the count's time.

This measures the protocol, not scaling: the machine with the card has one
H100, so the ranks share it and time-slice its SMs (and on the CPU, the
host's cores). Multi-GPU scaling is unmeasured. Prints one JSON line per
rank count and one of efficiencies.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402  (the bench terrain)

PROTOCOL = ("measures the protocol over ranks that share one device (time-sliced), "
            "not scaling: multi-GPU scaling is unmeasured")


def _rank(coordinator: str, world: int, rank: int, args) -> None:
    import torch

    from rfx_torch.device import resolve_device
    from rfx_torch.geometry import make_room, make_terrain
    from rfx_torch.ops.bvh_trace import make_kernel_env_hit
    from rfx_torch.parallel import initialize_multihost, make_mesh, sharded_cir
    from rfx_torch.parallel.launch import RESULT
    from rfx_torch.sampler import morton_sphere_directions
    from rfx_torch.tracer import Scene

    torch.set_num_threads(1)
    backend = initialize_multihost(coordinator, world, rank)
    dev = resolve_device(args.device)
    mesh = make_mesh(device=dev)
    if dev.type == "cuda":
        terrain = make_terrain(**smoke.BENCH_TERRAIN)
        scene, env = Scene.from_mesh(terrain, dev), make_kernel_env_hit(terrain, device=dev)
        tx, rx, radius, bounces = smoke.TX, smoke.RX, smoke.RX_RADIUS, smoke.BOUNCES
        nbins, rate = smoke.NBINS, smoke.RATE
    else:  # tests/test_multiprocess.py's room: a 200 ns window reaches the receiver
        scene, env = Scene.from_mesh(make_room(), dev), None
        tx, rx, radius, bounces, nbins, rate = (3.0, 2.0, 2.0), (-8.0, -5.0, 3.0), 1.0, 2, 2000, 10e9
    n = args.rays_per_rank * world
    dirs = morton_sphere_directions(n, generator=torch.Generator(dev).manual_seed(0), device=dev)

    def run():
        with torch.no_grad():
            ir = sharded_cir(scene, tx, dirs, rx, radius, mesh, max_bounces=bounces, nbins=nbins,
                             sample_rate_hz=rate, env_hit=env)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return ir

    ir = run()
    times = []
    for _ in range(args.reps):
        h0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - h0)
    print(RESULT + json.dumps({"rank": rank, "backend": backend, "seconds": times,
                               "ir_sum": float(ir.sum())}), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", default="1,2,4", help="comma-separated rank counts")
    ap.add_argument("--rays-per-rank", type=int, default=1_048_576)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rank", nargs=3, metavar=("COORDINATOR", "N", "RANK"),
                    help="run one rank (the harness starts them itself)")
    args = ap.parse_args(argv)
    if args.rank:
        _rank(args.rank[0], int(args.rank[1]), int(args.rank[2]), args)
        return 0
    import torch

    from rfx_torch.device import resolve_device
    from rfx_torch.parallel.launch import result_of, run_ranks

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
        from rfx_torch.cir import HISTOGRAM_KERNEL
        from rfx_torch.ops.bvh_trace import CLOSEST_HIT_KERNEL

        for k in (CLOSEST_HIT_KERNEL, HISTOGRAM_KERNEL):  # built once, before the ranks start
            k.load()
    print(f"# torch_bench_scaling: {PROTOCOL}", flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    best = {}
    for world in (int(x) for x in args.ranks.split(",")):
        outs = run_ranks(lambda r, c: [sys.executable, os.path.abspath(__file__), "--rank", c,
                                       str(world), str(r), "--device", args.device,
                                       "--rays-per-rank", str(args.rays_per_rank),
                                       "--reps", str(args.reps)],
                         world, timeout=600, env=env, cwd=HERE)
        results = [result_of(o) for o in outs]
        sums = {r["ir_sum"] for r in results}
        if len(sums) != 1 or not sums.pop() > 0:
            raise RuntimeError(f"{world} ranks: the ranks' IRs differ or are empty: {results}")
        best[world] = max(min(r["seconds"]) for r in results)
        n = args.rays_per_rank * world
        print(json.dumps({"ranks": world, "rays": n, "device": str(dev),
                          "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None,
                          "backend": results[0]["backend"], "seconds": best[world],
                          "mrays_per_s": n / best[world] / 1e6,
                          "per_rank_seconds": [r["seconds"] for r in results]}), flush=True)
    base = min(best)
    print(json.dumps({"weak_scaling_efficiency": {w: best[base] / t for w, t in best.items()},
                      "note": PROTOCOL}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
