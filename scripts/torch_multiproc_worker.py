#!/usr/bin/env python3
"""One rank of a torch.distributed run of the port's sharded paths (the
port's scripts/multiproc_worker.py).

    python3 scripts/torch_multiproc_worker.py <coordinator> <num_procs> <proc_id> <out.npz>
        [--device cuda|cpu] [--workload test|chip] [--cases cir,coverage,solver]
        [--inputs in.npz]

Start one process per rank (rfx_torch.parallel.launch.run_ranks does), all
with the same coordinator ("host:port"). Each rank joins the group through
rfx_torch.parallel.initialize_multihost, runs the cases, saves its arrays to
<out.npz> and prints one line `RESULT {json}`: per case its launch counts by
C entry point, host times, peak device memory and the all-reduces it made.

Cases (the mesh over the world's ranks):

- `cir`, {'rays': num_procs}: `sharded_cir`, hard, run twice (the same bits
  both times); with `--workload test` also the tx gradient of a soft,
  delay-weighted IR (tests/test_dist.py:79-97);
- `coverage`, {'rays': num_procs / 2, 'rx': 2}: this rank's tile of
  `sharded_coverage_irs`, through engine 'map' twice, or with `--workload
  chip` through engine 'batched' (the coverage kernel) twice and 'map' (the
  capture pass and the IR histogram's record entry) once;
- `solver`, {'rays': num_procs / 2, 'rx': 2}: one step of
  `make_inverse_solver(mesh=)` from the start, twice (the same bits;
  scripts/torch_multiproc_solver_worker.py runs this case alone): the loss,
  the gradients, the parameters after the step and the step's all-reduces.

Each case times every call on the host clock (the first warms up) and sums
the launches over its calls.

Workloads: `test`, the CPU tests' inputs (tests/test_dist.py:30-60 and
tests/test_multiprocess.py:139-167, the box room); `chip`, chip_smoke.py
phase 15's at full width (the bench terrain through the closest-hit kernel,
5,242,880 rays; the room's 2,048-receiver coverage at 1,048,576 rays; the
inverse solve at 1,048,576 rays x 64 receivers, whose target energies come
from `--inputs`). Ranks that share one card time-slice it: their times
measure the protocol, not scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402  (the scenes and sizes of phase 15)
from rfx_torch.coverage import make_grid  # noqa: E402
from rfx_torch.device import resolve_device  # noqa: E402
from rfx_torch.geometry import make_room, make_terrain  # noqa: E402
from rfx_torch.graft_entry import uniform_sphere_directions  # noqa: E402
from rfx_torch.ops.bvh_trace import make_kernel_env_hit  # noqa: E402
from rfx_torch.parallel import dist as pdist  # noqa: E402
from rfx_torch.parallel import initialize_multihost, make_mesh, sharded_cir  # noqa: E402
from rfx_torch.parallel import sharded_coverage_irs  # noqa: E402
from rfx_torch.parallel.launch import RESULT  # noqa: E402
from rfx_torch.sampler import morton_sphere_directions  # noqa: E402
from rfx_torch.solver import make_inverse_solver  # noqa: E402
from rfx_torch.tracer import Scene  # noqa: E402

# tests/test_dist.py's constants.
TEST_TX = (5.0, 0.0, 5.0)
TEST_RX = (-8.0, 2.0, 4.0)
TEST_BINS = int(100e-9 * smoke.RATE)
# tests/test_multiprocess.py:139-167's solver step.
SOLVER_TEST = dict(rays=512, receivers=8, nbins=256, rate=10e9, tx0=(5.0, 0.0, 5.0))
SOLVER_TX0 = (12.0, -2.0, 26.0)  # chip_smoke.py phase 11's start
ALL_REDUCE_SHAPES = ((20_000,), (32, 20_000), (1024, 10_000))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _oracle_dirs(n: int, seed: int) -> torch.Tensor:
    """The oracle's sampler (the CPU tests' directions), the port's copy."""
    return torch.from_numpy(uniform_sphere_directions(n, seed=seed))


def _morton(n: int, seed: int, dev) -> torch.Tensor:
    return morton_sphere_directions(n, generator=torch.Generator(dev).manual_seed(seed), device=dev)


def _run(dev, fn):
    """(fn(), {'launches': by C entry point, 'ms': host time, 'all_reduces':
    the collectives it made}): launch counts and the log are reset just
    before and read just after."""
    kernels = smoke.port_kernels()
    _sync(dev)
    for k in kernels:
        k.launches = 0
    pdist.ALL_REDUCE_LOG.clear()
    h0 = time.perf_counter()
    out = fn()
    _sync(dev)
    ms = (time.perf_counter() - h0) * 1e3
    return out, {"launches": {k.symbol: k.launches for k in kernels}, "ms": ms,
                 "all_reduces": [[a, list(s)] for a, s in pdist.ALL_REDUCE_LOG]}


def _runs(dev, fns):
    """Each of `fns` through `_run`: (their outputs, {'launches': summed over
    the calls, 'ms': one time a call (the first one warms up), 'all_reduces':
    the last call's})."""
    outs, infos = zip(*(_run(dev, fn) for fn in fns))
    return list(outs), {"launches": {k: sum(i["launches"][k] for i in infos)
                                     for k in infos[0]["launches"]},
                        "ms": [i["ms"] for i in infos], "all_reduces": infos[-1]["all_reduces"]}


def cir_case(dev, workload: str):
    mesh = make_mesh(device=dev)
    if workload == "chip":
        terrain = make_terrain(**smoke.BENCH_TERRAIN)
        scene, env = Scene.from_mesh(terrain, dev), make_kernel_env_hit(terrain, device=dev)
        dirs, tx, rx, radius = _morton(smoke.N_RAYS, 0, dev), smoke.TX, smoke.RX, smoke.RX_RADIUS
        kw = dict(max_bounces=smoke.BOUNCES, nbins=smoke.NBINS, env_hit=env)
    else:
        scene, dirs = Scene.from_mesh(make_room(), dev), _oracle_dirs(4096, 31)
        tx, rx, radius = TEST_TX, TEST_RX, 0.8
        kw = dict(max_bounces=3, nbins=TEST_BINS)
    kw.update(light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE)

    def run():
        with torch.no_grad():
            return sharded_cir(scene, tx, dirs, rx, radius, mesh, **kw)

    (ir, again), info = _runs(dev, (run, run))
    info["repeat_equal"] = bool(torch.equal(ir, again))
    arrays = {"ir": ir.cpu().numpy()}
    if workload == "test":  # tests/test_dist.py:79-97: soft binning, a delay-weighted loss
        gdirs = _oracle_dirs(1024, 55)
        bins = torch.arange(TEST_BINS, dtype=torch.float32, device=dev)
        txg = torch.tensor(TEST_TX, device=dev, requires_grad=True)
        ir_soft = sharded_cir(scene, txg, gdirs, rx, 1.5, mesh, max_bounces=2, nbins=TEST_BINS,
                              light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE, soft=True)
        torch.sum(ir_soft * bins).backward()
        arrays["grad"] = txg.grad.cpu().numpy()
    else:  # the collective alone, on this mesh's group
        info["all_reduce_ms"] = {}
        for shape in ALL_REDUCE_SHAPES:
            x = torch.ones(shape, device=dev)
            times = [_run(dev, lambda: pdist._all_reduce(x, mesh, "rays"))[1]["ms"]
                     for _ in range(6)]
            info["all_reduce_ms"][str(shape)] = times[1:]  # the first one warms up
    return arrays, info


def coverage_case(dev, workload: str):
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    mesh = make_mesh({"rays": world // 2, "rx": 2}, device=dev)
    if workload == "chip":
        room = make_room()
        (_, tx, zs), = [s for s in smoke.COV_SCENES if s[0] == "room"]
        env = make_kernel_env_hit(room, device=dev)
        args = (Scene.from_mesh(room, dev), tx, _morton(smoke.COV_RAYS, 0, dev),
                make_grid(range(-15, 16, 2), range(-15, 16, 2), zs), smoke.COV_RADIUS, mesh)
        kw = dict(max_bounces=2, nbins=smoke.COV_BINS, env_hit=env, rx_batch=64)
        engines = ("batched", "batched", "map")
    else:
        centers = make_grid(range(-12, 13, 6), [-6, 6], [2, 8])[:16]
        args = (Scene.from_mesh(make_room(), dev), TEST_TX, _oracle_dirs(2048, 13), centers, 0.8,
                mesh)
        kw = dict(max_bounces=2, nbins=TEST_BINS, rx_batch=4)
        engines = ("map", "map")
    kw.update(light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE)

    def sweep(engine):
        def run():
            with torch.no_grad():
                return sharded_coverage_irs(*args, engine=engine, **kw)
        return run

    tiles, info = _runs(dev, [sweep(e) for e in engines])
    info.update(engines=list(engines), repeat_equal=bool(torch.equal(tiles[0], tiles[1])),
                coords=mesh.coords)
    arrays = {"tile": tiles[0].cpu().numpy()}
    if len(tiles) > 2:
        arrays["tile_map"] = tiles[2].cpu().numpy()
    return arrays, info


def solver_case(dev, workload: str, inputs=None):
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    mesh = make_mesh({"rays": world // 2, "rx": 2}, device=dev)
    if workload == "chip":
        terrain = make_terrain(**smoke.BENCH_TERRAIN)
        scene, dirs, centers = smoke.solver_inputs(terrain, dev)
        env = make_kernel_env_hit(terrain, device=dev)
        target = np.load(inputs)["target"]
        kw = dict(max_bounces=smoke.BOUNCES, nbins=smoke.NBINS, sample_rate_hz=smoke.RATE,
                  learning_rate=0.05, env_hit=env)
        tx0 = SOLVER_TX0
    else:
        s = SOLVER_TEST
        scene, dirs = Scene.from_mesh(make_room(), dev), _oracle_dirs(s["rays"], 0)
        m = s["receivers"]
        centers = np.stack([np.linspace(-10, 10, m), np.zeros(m), np.full(m, 5.0)],
                           axis=1).astype(np.float32)
        target = np.zeros(m, np.float32)
        kw = dict(max_bounces=2, nbins=s["nbins"], sample_rate_hz=s["rate"])
        tx0 = s["tx0"]
    init_fn, step_fn = make_inverse_solver(scene, dirs, centers, 1.0, target,
                                           light_speed_mps=smoke.C, mesh=mesh, **kw)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # One step from the start, twice (the first warms up): the same bits both times.
    steps, info = _runs(dev, [lambda: step_fn(*init_fn(tx0))] * 2)
    if dev.type == "cuda":
        info["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    (first, _, _), (params, opt, loss) = steps
    info["repeat_equal"] = all(torch.equal(a.detach(), b.detach()) and torch.equal(a.grad, b.grad)
                               for a, b in zip(first, params) if a is not None)
    info["ir_shape"] = [centers.shape[0] // mesh.shape["rx"], kw["nbins"]]
    arrays = {"loss": loss.cpu().numpy(), "tx": params.tx_pos.detach().cpu().numpy(),
              "log_n1": params.log_n1.detach().cpu().numpy(),
              "grad_tx": params.tx_pos.grad.cpu().numpy(),
              "grad_log_n1": params.log_n1.grad.cpu().numpy()}
    return arrays, info


CASES = {"cir": cir_case, "coverage": coverage_case, "solver": solver_case}


def main(argv=None, default_cases=("cir", "coverage")) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("num_procs", type=int)
    ap.add_argument("proc_id", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workload", choices=("test", "chip"), default="test")
    ap.add_argument("--cases", default=",".join(default_cases))
    ap.add_argument("--inputs", default=None, help="npz with 'target' (the chip workload's solver)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    backend = initialize_multihost(args.coordinator, args.num_procs, args.proc_id)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    arrays, info = {}, {"rank": args.proc_id, "world": args.num_procs, "backend": backend,
                        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for case in args.cases.split(","):
        extra = (args.inputs,) if case == "solver" else ()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        case_arrays, info[case] = CASES[case](dev, args.workload, *extra)
        if dev.type == "cuda":
            info[case].setdefault("peak_bytes", torch.cuda.max_memory_allocated(dev))
        arrays.update({f"{case}_{k}": v for k, v in case_arrays.items()})
    np.savez(args.out, **arrays)
    print(RESULT + json.dumps(info), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
