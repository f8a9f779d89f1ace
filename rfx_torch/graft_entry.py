"""Entry points of the port (counterparts of __graft_entry__.py): the
forward CIR step on the flagship workload at small shapes, and a dry run of
one full sharded inverse-solve step over n ranks.

    python -m rfx_torch.graft_entry [--device cuda|cpu] [--ranks N]

runs `entry()`'s forward once and `dryrun_multichip(N)` (N default 2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from rfx_torch.cir import cir_from_trace
from rfx_torch.device import resolve_device
from rfx_torch.geometry import make_room, make_terrain
from rfx_torch.parallel import initialize_multihost, make_mesh
from rfx_torch.parallel.launch import RESULT, result_of, run_ranks
from rfx_torch.solver import make_inverse_solver
from rfx_torch.tracer import Scene, trace_to_rx

__all__ = ["entry", "dryrun_multichip", "uniform_sphere_directions"]

ROOT = Path(__file__).resolve().parents[1]


def uniform_sphere_directions(n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) float32 directions uniform on the unit sphere from numpy's
    default_rng(seed): the oracle's sampler (oracle/oracle.py:44), which
    __graft_entry__.py draws its directions from."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1.0, 1.0, size=n)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=n)
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1).astype(np.float32)


def entry(device="cuda"):
    """(fn, example_args): the forward CIR step on the flagship workload
    (terrain trace -> impulse response) at small shapes
    (__graft_entry__.py:8-43): a 24-grid terrain, 2,048 rays, 3 bounces,
    2,000 bins at 10 GHz (a 200 ns window, so the ~20 m flight lands inside)."""
    dev = resolve_device(device)
    scene = Scene.from_mesh(make_terrain(grid=24, extent=40.0, seed=0), dev)
    n_rays = 2048
    dirs = torch.from_numpy(uniform_sphere_directions(n_rays, seed=0)).to(dev)

    def forward(vertices, faces, tx_pos, rx_pos, directions):
        result = trace_to_rx(Scene(vertices, faces), tx_pos, directions, rx_pos, 2.0,
                             max_bounces=3, rx_mode="analytic")
        return cir_from_trace(result, tx_power=1.0, num_rays=n_rays, nbins=2000,
                              light_speed_mps=2.998e8, sample_rate_hz=10e9)

    example_args = (scene.vertices, scene.faces, torch.tensor([10.0, 0.0, 6.0], device=dev),
                    torch.tensor([-10.0, 0.0, 6.0], device=dev), dirs)
    return forward, example_args


def _dryrun_rank(coordinator: str, n_devices: int, rank: int, device: str) -> None:
    """One rank of `dryrun_multichip`: one step on the room, prints its result."""
    torch.set_num_threads(1)
    initialize_multihost(coordinator, n_devices, rank)
    rx_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh({"rays": n_devices // rx_axis, "rx": rx_axis}, device=device)
    scene = Scene.from_mesh(make_room(), mesh.device)
    m = 4 * rx_axis
    centers = np.stack([np.linspace(-10, 10, m), np.zeros(m), np.full(m, 5.0)], axis=1)
    init_fn, step_fn = make_inverse_solver(
        scene, uniform_sphere_directions(64 * n_devices, seed=0), centers.astype(np.float32), 1.0,
        np.zeros(m, np.float32), max_bounces=2, nbins=256, sample_rate_hz=10e9, mesh=mesh)
    params, opt = init_fn(tx0=[5.0, 0.0, 5.0])
    params, opt, loss = step_fn(params, opt)
    out = {"loss": float(loss), "tx": params.tx_pos.detach().cpu().tolist(),
           "log_n1": float(params.log_n1.detach())}
    if not (np.isfinite(out["loss"]) and np.all(np.isfinite(out["tx"] + [out["log_n1"]]))):
        raise RuntimeError(f"rank {rank}: non-finite step {out}")
    print(RESULT + json.dumps(out), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0) -> float:
    """Run ONE full training step of the inverse solve (trace -> soft-binned
    coverage IRs -> loss -> gradients -> Adam update) over n_devices ranks
    (__graft_entry__.py:46-124): rays split over 'rays', receivers over 'rx'
    (2 where n_devices is even), the partial IRs summed over 'rays' and the
    loss over 'rx'. The room, 64 rays a rank, 256 bins at 10 GHz. The ranks
    are processes of this host (rfx_torch.parallel.launch); on one card they
    share it over gloo. Fails unless every rank ends with the same finite
    loss and parameters; returns the loss."""
    resolve_device(device)  # no card for device='cuda' raises here, before any rank starts
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    outs = run_ranks(lambda r, c: [sys.executable, "-m", "rfx_torch.graft_entry", "--rank", c,
                                   str(n_devices), str(r), "--device", str(device)],
                     n_devices, timeout=timeout, env=env, cwd=str(ROOT))
    results = [result_of(o) for o in outs]
    if any(r != results[0] for r in results):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks differ: {results}")
    loss = results[0]["loss"]
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.3e}")
    return loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="entry() and dryrun_multichip(n) of the port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--rank", nargs=3, metavar=("COORDINATOR", "N", "RANK"),
                    help="run one rank of dryrun_multichip (it starts them itself)")
    args = ap.parse_args(argv)
    if args.rank:
        _dryrun_rank(args.rank[0], int(args.rank[1]), int(args.rank[2]), args.device)
        return 0
    fn, example_args = entry(args.device)
    with torch.no_grad():
        out = fn(*example_args)
    print("entry forward:", tuple(out.shape), float(out.sum()))
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
