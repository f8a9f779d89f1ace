"""Command-line drivers of the port (port of rfx/cli.py):

    python -m rfx_torch.cli cir ...       # one receiver's CIR and dBm (ref main.py)
    python -m rfx_torch.cli coverage ...  # a receiver-grid sweep (ref coverage.py)

The flags, their defaults and `--config x.json` are rfx.cli's (rfx.config's
TraceConfig / CoverageConfig; flags override the file), with the port's
backend names (`auto`, `brute`, `fused`; `bvh` is not ported yet) and
`--device` (default `cuda`; `cpu` runs every kernel's plain version).

matplotlib is imported only to color the coverage viewer's points and to
write `--plot`: `--no-viz` without `--plot` runs without it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

from rfx.config import CoverageConfig, TraceConfig, resolve_scene

__all__ = ["main"]


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", type=str, default=None, help="JSON config file")
    p.add_argument("--scene", type=str, default=None, help="named scene or STL path")
    p.add_argument("--tx", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--tx-power", type=float, default=None)
    p.add_argument("--rays", type=int, default=None)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--rx-radius", type=float, default=None)
    p.add_argument("--sample-rate", type=float, default=None, help="Hz")
    p.add_argument("--window", type=float, default=None, help="seconds")
    p.add_argument("--backend", type=str, default=None, choices=["auto", "brute", "fused", "bvh"])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (the kernels) or 'cpu' (their plain versions)")
    p.add_argument("--out", type=str, default="viz/scene.html")
    p.add_argument("--no-viz", action="store_true",
                   help="skip the scene viewer output (and, for cir, the small "
                        "secondary path-recording trace that feeds it)")
    p.add_argument("--serve", action="store_true", help="serve the scene on :8000 (blocking)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace (DIR/trace.json) and print "
                        "per-phase wall-clock timings")


_COMMON_MAP = {
    "scene": "scene",
    "tx": "tx_pos",
    "tx_power": "tx_power",
    "rays": "num_rays",
    "bounces": "max_bounces",
    "rx_radius": "rx_radius",
    "sample_rate": "sample_rate_hz",
    "window": "sample_window_s",
    "backend": "backend",
    "seed": "seed",
}


def _merge(cfg, args, mapping):
    for flag, fieldname in mapping.items():
        v = getattr(args, flag)
        if v is not None:
            cfg = dataclasses.replace(cfg, **{fieldname: tuple(v) if isinstance(v, list) else v})
    return cfg


def _config(cls, args):
    cfg = cls.from_json(open(args.config).read()) if args.config else cls()
    return _merge(cfg, args, _COMMON_MAP)


def _make_tracer(cfg, device):
    from rfx_torch.api import Tracer

    mesh = resolve_scene(cfg.scene)
    return mesh, Tracer(mesh, cfg.light_speed_mps, cfg.sample_rate_hz, cfg.sample_window_s,
                        cfg.max_bounces, cfg.num_rays, n1=cfg.n1, n2=cfg.n2,
                        rx_mode=cfg.rx_mode, backend=cfg.backend, seed=cfg.seed, device=device)


def _generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator seeded from (seed, stream), so that chunk `stream` of a
    run draws the same directions whenever it is (re)computed."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


# The stream of the viewer's secondary trace (rfx/cli.py:160-162).
_VIZ_STREAM = 7919


def cmd_cir(args) -> int:
    from rfx_torch import sampler
    from rfx_torch.utils.profiling import PhaseTimer, device_trace

    cfg = _config(TraceConfig, args)
    if args.rx is not None:
        cfg = dataclasses.replace(cfg, rx_pos=tuple(args.rx))
    mesh, tracer = _make_tracer(cfg, args.device)
    dev = tracer.device
    request = (cfg.tx_pos, cfg.tx_power, cfg.rx_pos, cfg.rx_radius)

    timer = PhaseTimer()
    prof = device_trace(args.profile) if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof:
        if args.chunks and args.chunks > 1:
            # Each chunk traces num_rays / chunks directions of its own
            # stream; amplitudes are normalised by the whole run's ray count,
            # so the partial IRs sum to the IR (rfx.utils.checkpoint).
            from rfx.utils.checkpoint import run_chunked

            n_chunk = cfg.num_rays // args.chunks

            def compute_chunk(cid):
                dirs = sampler.sphere_directions(n_chunk, generator=_generator(cfg.seed, cid, dev),
                                                 device=dev)
                with timer.phase("chunk"):
                    _, partial_ir = tracer.compute_cir(*request, directions=dirs)
                return {"ir": partial_ir}

            acc = run_chunked(compute_chunk, args.chunks, args.resume_dir or (args.out + ".chunks"))
            ir = acc["ir"]
        else:
            with timer.phase("trace"):
                _, ir = tracer.compute_cir(*request)
    dt = time.perf_counter() - t0
    with timer.phase("metric"):
        dbm = tracer.rx_power_dbm(ir, cfg.carrier_hz)
    print(f"traced {cfg.num_rays} rays x {cfg.max_bounces} bounces in {dt:.3f}s "
          f"({cfg.num_rays / dt / 1e6:.1f} Mrays/s)")

    # The viewer's polylines come from a small secondary trace that records
    # paths, so the main trace above keeps the fused kernel (rfx/cli.py:143-167).
    paths = []
    if not args.no_viz:
        n_viz = min(max(cfg.num_rays // 4, 4096), 262_144, cfg.num_rays)
        viz_dirs = sampler.sphere_directions(
            n_viz, generator=_generator(cfg.seed, _VIZ_STREAM, dev), device=dev)
        with timer.phase("viz-trace"):
            paths, _ = tracer.compute_cir(*request, directions=viz_dirs, record_paths=True,
                                          max_paths=2000)
    print(f"received paths (viz subsample): {len(paths)}  |  RX power: {float(dbm):.2f} dBm")
    if args.profile:
        print(f"profiler trace written to {args.profile}")
        print(timer.report())

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(ir)
        plt.xlabel("sample")
        plt.ylabel("amplitude")
        plt.title("Impulse response")  # ref main.py:39-44
        plt.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")

    if not args.no_viz:
        from rfx.viz import visualize

        visualize(mesh=mesh, tx_pos=cfg.tx_pos, rx_pos=cfg.rx_pos, rx_radius=cfg.rx_radius,
                  paths=paths, out_path=args.out, port=args.port, serve=args.serve)
        if not args.serve:
            print(f"wrote {args.out}")
    return 0


def cmd_coverage(args) -> int:
    from rfx_torch.utils.profiling import device_trace

    cfg = _config(CoverageConfig, args)
    mesh, tracer = _make_tracer(cfg, args.device)
    grid = cfg.grid_points()
    request = (cfg.tx_pos, cfg.tx_power, grid, cfg.rx_radius)

    prof = device_trace(args.profile) if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof:
        if args.metric == "fast":
            dbm = tracer.compute_coverage_dbm_fast(*request, carrier_hz=cfg.carrier_hz,
                                                   rx_batch=cfg.rx_batch)
        elif args.metric == "hybrid":
            dbm, n_flagged = tracer.compute_coverage_dbm_hybrid(
                *request, carrier_hz=cfg.carrier_hz, rx_batch=cfg.rx_batch)
            print(f"hybrid: {n_flagged} cancellation-flagged receivers re-evaluated exactly")
        else:
            irs = tracer.compute_coverage(*request, rx_batch=cfg.rx_batch)
            dbm = tracer.rx_power_dbm(irs, cfg.carrier_hz)
    dt = time.perf_counter() - t0
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    print(f"coverage: {grid.shape[0]} receivers from one {cfg.num_rays}-ray trace in {dt:.2f}s")
    finite = np.isfinite(dbm)
    if finite.any():
        print(f"dBm range: [{dbm[finite].min():.1f}, {dbm[finite].max():.1f}], "
              f"{int(finite.sum())}/{len(dbm)} receivers reached")

    if not args.no_viz:
        from matplotlib import cm

        from rfx.viz import visualize

        # viridis dBm coloring, range per ref coverage.py:32-36
        lo, hi = cfg.dbm_range
        frac = np.clip((np.nan_to_num(dbm, neginf=lo) - lo) / (hi - lo), 0.0, 1.0)
        colors = (np.asarray(cm.viridis(frac))[:, :3] * 255).astype(int)
        pairs = [(grid[i], colors[i]) for i in range(grid.shape[0])]
        visualize(mesh=mesh, tx_pos=cfg.tx_pos, point_color_pairs=pairs, out_path=args.out,
                  port=args.port, serve=args.serve)
        if not args.serve:
            print(f"wrote {args.out}")
    if args.save_dbm:
        np.save(args.save_dbm, np.concatenate([grid, dbm[:, None]], axis=1).astype(np.float32))
        print(f"wrote {args.save_dbm}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rfx_torch",
                                     description="RF ray tracer, PyTorch / CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)

    p_cir = sub.add_parser("cir", help="single-receiver channel impulse response (ref main.py)")
    _add_common(p_cir)
    p_cir.add_argument("--rx", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p_cir.add_argument("--plot", type=str, default=None, help="write IR plot PNG")
    p_cir.add_argument("--chunks", type=int, default=1,
                       help="split the trace into N idempotent chunks with "
                            "checkpointed accumulation (resume after a kill)")
    p_cir.add_argument("--resume-dir", type=str, default=None,
                       help="chunk-state directory (default: <out>.chunks)")
    p_cir.set_defaults(fn=cmd_cir)

    p_cov = sub.add_parser("coverage", help="receiver-grid coverage sweep (ref coverage.py)")
    _add_common(p_cov)
    p_cov.add_argument("--save-dbm", type=str, default=None, help="write (x,y,z,dbm) .npy")
    p_cov.add_argument("--metric", type=str, default="exact", choices=["exact", "fast", "hybrid"],
                       help="'exact' = per-receiver IR and convolution; 'fast' = phasor dBm "
                            "(no per-receiver IR; off by up to 20 dB under strong "
                            "cancellation); 'hybrid' = fast + exact re-evaluation of "
                            "the flagged receivers (bounded error)")
    p_cov.set_defaults(fn=cmd_coverage)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
