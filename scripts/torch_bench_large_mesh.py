#!/usr/bin/env python3
"""The large-mesh CIR path on one NVIDIA GPU (the port's
scripts/bench_large_mesh.py): a 724 x 724 procedural crater field of
1,045,458 triangles, the stand-in for the reference's terrain scan.

    python3 scripts/torch_bench_large_mesh.py

Legs, each a function that chip_smoke.py calls too:

- `build_scene`: `make_terrain(grid=724, extent=120.0, seed=0)`, the native
  C++ SAH build at leaf 8 (timed), and `rfx_torch.api.Tracer` over the mesh,
  whose own `build_bvh(method="auto")` must give the native tree;
- `parity_leg`: 16,384 Morton rays from tx through the per-query closest-hit
  kernel against an independent tree (a second native build at leaf 16)
  walked by the plain stackless walk of rfx_torch.ops.bvh_traverse; bars:
  hit-mask mismatches <= N / 2000, t within rtol 1e-4 / atol 1e-3 where both
  hit, face mismatches <= max(4, hits / 1000) (ties between abutting terrain
  triangles may take either face);
- `cir_leg`: three `Tracer.compute_cir` requests of 5,242,880 rays x 4
  bounces x 20,000 bins, the tx raised by 1 m each time, timed with CUDA
  events; the first request twice, bit-identical;
- `counters_leg`: the counted fused trace at full width: per bounce the
  nodes visited, leaves entered, triangles tested and warp steps, the SIMT
  efficiency nodes / (32 * warp_steps), its trace bit for bit the uncounted
  kernel's, and both kernels' times;
- `perquery_leg`: an eager per-bounce loop over the closest-hit kernel at
  1,048,576 rays against the fused kernel on the same rays; bar: captures
  differ by at most max(4, captures / 200).

tx (10, 0, 30), rx (-15, 5, 12), radius 2.0. One JSON line on stdout; no
file is written. `--grid`, `--rays` and `--device cpu` shrink it for a
rehearsal on the kernels' plain versions: the JSON names the device and the
clock, and a CPU run's times are host times of the plain versions, never the
card's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

GRID = 724
EXTENT = 120.0
TX = (10.0, 0.0, 30.0)
RX = (-15.0, 5.0, 12.0)
RX_RADIUS = 2.0
N_RAYS = 5_242_880
BOUNCES = 4
C = 2.998e8
RATE = 100e9
WINDOW = 200e-9
N_PARITY = 16_384
N_PERQUERY = 1_048_576
LEAF = 8
PARITY_LEAF = 16  # the independent tree's


def timed_ms(fn, dev, reps: int = 1, warm: bool = False):
    """(fn's last result, mean ms per call): CUDA events on a card, the host
    clock around the synchronous plain versions on the CPU. `warm` runs one
    untimed call first, so that the timed ones reuse its device memory."""
    import torch

    if warm:
        fn()
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def morton_dirs(n: int, seed: int, dev):
    import torch

    from rfx_torch.sampler import morton_sphere_directions

    return morton_sphere_directions(n, generator=torch.Generator(dev).manual_seed(seed), device=dev)


def build_scene(dev, *, grid: int = GRID, extent: float = EXTENT, n_rays: int = N_RAYS,
                method: str = "native"):
    """(mesh, flat, tracer, info): the terrain, its leaf-8 tree by `method`
    and a Tracer over it, whose own tree must be that tree."""
    import numpy as np

    from rfx_torch.api import Tracer
    from rfx_torch.bvh import build_bvh
    from rfx_torch.geometry import make_terrain

    t0 = time.perf_counter()
    mesh = make_terrain(grid=grid, extent=extent, seed=0)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = build_bvh(mesh, leaf_size=LEAF, method=method)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    # `auto` takes the fused kernel on a card; the CPU rehearsal asks for its
    # plain version by name (`auto` would take the plain walk there).
    tracer = Tracer(mesh, C, RATE, WINDOW, max_bounces=BOUNCES, tx_num_rays=n_rays,
                    backend="auto" if dev.type == "cuda" else "fused", device=dev)
    t_tracer = time.perf_counter() - t0
    bvh = tracer._fused.bvh
    if tracer.backend != "fused" or not np.array_equal(
            bvh.skip.cpu().numpy(), flat.skip):
        raise AssertionError(f"the facade's tree is not the {method} builder's "
                             f"(backend {tracer.backend}, {bvh.n_nodes} vs {flat.n_nodes} nodes)")
    tables = {"tri": bvh.tri, "tri_face": bvh.tri_face, "nodes": bvh.nodes}
    info = {"triangles": int(mesh.num_faces), "build_method": method,
            "mesh_seconds": t_mesh, "bvh_build_seconds": t_build,
            "tracer_seconds": t_tracer, "bvh_nodes": int(flat.n_nodes),
            "padded_tris": int(flat.n_padded_tris), "leaf_size": LEAF,
            "table_bytes": {k: int(v.numel() * v.element_size()) for k, v in tables.items()}}
    info["table_bytes"]["total"] = sum(info["table_bytes"].values())
    return mesh, flat, tracer, info


def parity_leg(mesh, bvh, dev, *, n: int = N_PARITY, tx=TX, method: str = "native") -> dict:
    """The per-query kernel on `bvh` against the plain walk of an independent
    tree (leaf 16) on `n` Morton rays from tx, with the reference's bars."""
    import torch

    from rfx_torch.bvh import build_bvh
    from rfx_torch.ops.bvh_pack import pack_bvh
    from rfx_torch.ops.bvh_trace import closest_hit
    from rfx_torch.ops.bvh_traverse import walk_closest_hit

    dirs = morton_dirs(n, 7, dev)
    o = torch.tensor(tx, dtype=torch.float32, device=dev).expand(n, 3).contiguous()
    (tp, _, fp, _), k_ms = timed_ms(lambda: closest_hit(bvh, o, dirs), dev, warm=True)
    t0 = time.perf_counter()
    other = pack_bvh(build_bvh(mesh, leaf_size=PARITY_LEAF, method=method), dev)
    build_s = time.perf_counter() - t0
    (tc, ic), walk_ms = timed_ms(lambda: walk_closest_hit(other, o, dirs), dev)
    fc = torch.where(ic >= 0, other.tri_face[ic.clamp_min(0)], torch.full_like(fp, -1))
    hit_c, hit_p = tc < 1e29, tp < 1e29
    both = hit_c & hit_p
    out = {"rays": n, "hits": int(hit_c.sum()), "hit_mask_mismatch": int((hit_c != hit_p).sum()),
           "t_allclose": bool(torch.allclose(tp[both], tc[both], rtol=1e-4, atol=1e-3)),
           "t_max_abs_diff": float((tp[both] - tc[both]).abs().max()) if bool(both.any()) else 0.0,
           "face_mismatch": int((fp[both] != fc[both]).sum()),
           "independent_tree": {"leaf_size": PARITY_LEAF, "nodes": other.n_nodes,
                                "build_seconds": build_s},
           "closest_hit_ms": k_ms, "plain_walk_ms": walk_ms}
    if out["hits"] == 0:
        raise AssertionError("parity leg: no ray hit the terrain")
    if out["hit_mask_mismatch"] > n // 2000:
        raise AssertionError(f"parity leg: hit-mask mismatch {out['hit_mask_mismatch']}")
    if not out["t_allclose"]:
        raise AssertionError(f"parity leg: t differs by {out['t_max_abs_diff']}")
    if out["face_mismatch"] > max(4, int(both.sum()) // 1000):
        raise AssertionError(f"parity leg: face mismatch {out['face_mismatch']}")
    return out


def cir_leg(tracer, dirs, *, tx=TX, rx=RX, rx_radius=RX_RADIUS, requests: int = 3) -> dict:
    """`requests` compute_cir calls after one untimed call, the tx raised by
    1 m each time, and the first one again: bit-identical IRs."""
    import numpy as np

    dev = tracer.device
    n = int(dirs.shape[0])
    out = {"rays": n, "bounces": tracer.max_bounces, "nbins": tracer.nbins, "requests": []}
    first = None
    tracer.compute_cir(tx, 1.0, rx, rx_radius, directions=dirs, record_paths=False)
    for i in range(requests + 1):
        tx_i = (tx[0], tx[1], tx[2] + float(i % requests))
        h0 = time.perf_counter()
        (paths, ir), ms = timed_ms(lambda: tracer.compute_cir(
            tx_i, 1.0, rx, rx_radius, directions=dirs, record_paths=False), dev)
        host_ms = (time.perf_counter() - h0) * 1e3
        if paths != [] or ir.shape != (tracer.nbins,) or not np.all(np.isfinite(ir)):
            raise AssertionError(f"compute_cir request {i}: IR {ir.shape}")
        if not float(ir.sum()) > 0.0:
            raise AssertionError(f"compute_cir request {i}: nothing captured")
        if i == 0:
            first = ir
        if i == requests:  # the first request again
            if not np.array_equal(ir, first):
                raise AssertionError("compute_cir: two runs of one request differ")
            out["bit_identical_across_runs"] = True
            continue
        out["requests"].append({"tx": tx_i, "ms": ms, "host_ms": host_ms,
                                "mrays_per_s": n / ms / 1e3, "nonzero_bins": int((ir != 0).sum()),
                                "ir_sum": float(ir.sum()),
                                "dbm": float(tracer.rx_power_dbm(ir))})
    best = min(r["ms"] for r in out["requests"])
    out["best_ms"], out["best_mrays_per_s"] = best, n / best / 1e3
    return out


def counters_leg(bvh, dirs, *, tx=TX, rx=RX, rx_radius=RX_RADIUS, bounces: int = BOUNCES,
                 reps: int = 5) -> dict:
    """The counted fused trace on `dirs`: counters per bounce, SIMT
    efficiency, times of the counted and the uncounted kernel; the two
    traces must be equal bit for bit."""
    import torch

    from rfx_torch.ops.fused import WARP, fused_trace

    dev = dirs.device
    args = (tx, rx, rx_radius, 5.0, 1.0)
    plain = fused_trace(bvh, dirs, *args, max_bounces=bounces)
    counted, stats = fused_trace(bvh, dirs, *args, max_bounces=bounces, count_stats=True)
    for name, a, b in zip(("captured", "amplitude", "distance", "num_bounces"), counted[:4],
                          plain[:4]):
        if not torch.equal(a, b):
            raise AssertionError(f"counted fused trace: {name} differs from the uncounted trace")
    if stats.shape != (bounces, 4) or stats.dtype != torch.int64:
        raise AssertionError(f"walk counters: {stats.dtype} {tuple(stats.shape)}")
    _, ms = timed_ms(lambda: fused_trace(bvh, dirs, *args, max_bounces=bounces), dev, reps,
                     warm=True)
    _, counted_ms = timed_ms(lambda: fused_trace(bvh, dirs, *args, max_bounces=bounces,
                                                 count_stats=True), dev, reps, warm=True)
    s = stats.cpu()
    nodes, leaves, tris, steps = (s[:, j].tolist() for j in range(4))
    total_nodes, total_steps = sum(nodes), sum(steps)
    n = int(dirs.shape[0])
    return {"rays": n, "captured": int(plain.captured.sum()),
            "ray_bounces": int(plain.num_bounces.sum()),
            "nodes_per_bounce": nodes, "leaves_per_bounce": leaves, "tris_per_bounce": tris,
            "warp_steps_per_bounce": steps,
            "simt_efficiency_per_bounce": [a / (WARP * b) if b else None
                                           for a, b in zip(nodes, steps)],
            "simt_efficiency": total_nodes / (WARP * total_steps) if total_steps else None,
            "nodes_per_ray_bounce0": nodes[0] / n, "tris_per_ray_bounce0": tris[0] / n,
            "counted_equals_uncounted": True, "fused_trace_ms": ms,
            "fused_trace_counted_ms": counted_ms, "mrays_per_s": n / ms / 1e3}


def perquery_leg(bvh, dirs, *, tx=TX, rx=RX, rx_radius=RX_RADIUS,
                 bounces: int = BOUNCES) -> dict:
    """An eager per-bounce loop over the closest-hit kernel (the capture rule
    of rfx_torch.tracer.trace_to_rx) against the fused kernel on `dirs`."""
    import torch

    from rfx_torch.ops.bvh_trace import closest_hit
    from rfx_torch.ops.fused import fused_trace
    from rfx_torch.ops.intersect import dot3, is_hit, ray_sphere_hit

    dev = dirs.device
    n = int(dirs.shape[0])
    f32 = torch.float32
    rx_t = torch.tensor(rx, dtype=f32, device=dev)
    radius = torch.tensor(rx_radius, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    parked = torch.full((), 1e9, dtype=f32, device=dev)

    def loop():
        pos = torch.tensor(tx, dtype=f32, device=dev).expand(n, 3).contiguous()
        d = dirs
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        captured = torch.zeros(n, dtype=torch.bool, device=dev)
        dist = torch.zeros(n, dtype=f32, device=dev)
        capd = torch.zeros(n, dtype=f32, device=dev)
        for _ in range(bounces):
            t_rx = ray_sphere_hit(pos, d, rx_t, radius)
            t_env, _, _, nrm = closest_hit(bvh, pos, d)
            rx_win = alive & is_hit(t_rx) & (t_env > t_rx)
            env_b = alive & ~rx_win & is_hit(t_env)
            captured = captured | rx_win
            capd = torch.where(rx_win, dist + t_rx, capd)
            t_adv = torch.where(env_b, t_env, zero)
            pos = torch.where(env_b[:, None], pos + d * t_adv[:, None], parked).contiguous()
            d = torch.where(env_b[:, None], d - 2.0 * dot3(d, nrm)[:, None] * nrm, d).contiguous()
            dist = dist + t_adv
            alive = env_b
        return captured, capd

    (captured, capd), loop_ms = timed_ms(loop, dev, warm=True)
    r, fused_ms = timed_ms(lambda: fused_trace(bvh, dirs, tx, rx, rx_radius,
                                               max_bounces=bounces), dev, warm=True)
    ncap_s, ncap_f = int(captured.sum()), int(r.captured.sum())
    out = {"rays": n, "perquery_captured": ncap_s, "fused_captured": ncap_f,
           "capture_flips": int((captured != r.captured).sum()),
           "perquery_dist_sum": float(torch.where(captured, capd, zero).sum()),
           "fused_dist_sum": float(torch.where(r.captured, r.distance, zero).sum()),
           "perquery_ms": loop_ms, "fused_ms": fused_ms}
    if ncap_s == 0 or abs(ncap_s - ncap_f) > max(4, ncap_s // 200):
        raise AssertionError(f"fused vs per-query capture divergence: {ncap_f} vs {ncap_s}")
    return out


def perquery_counters_leg(bvh, dirs, *, tx=TX) -> dict:
    """The counted closest hit on `dirs` from tx and on their second-bounce
    queries: t, index, face and normal equal the uncounted kernel's, and per
    set the walk's totals and the most nodes a query visits."""
    import torch

    from rfx_torch.ops.bvh_trace import closest_hit
    from rfx_torch.ops.intersect import dot3

    dev = dirs.device
    n = int(dirs.shape[0])
    o = torch.tensor(tx, dtype=torch.float32, device=dev).expand(n, 3).contiguous()
    t, _, _, nrm = closest_hit(bvh, o, dirs)
    hit = t < 1e29
    sets = {"tx": (o, dirs),
            "bounce2": ((o + dirs * t[:, None])[hit].contiguous(),
                        (dirs - 2.0 * dot3(dirs, nrm)[:, None] * nrm)[hit].contiguous())}
    out = {}
    for name, (oo, dd) in sets.items():
        plain = closest_hit(bvh, oo, dd)
        (*counted, counts), ms = timed_ms(lambda: closest_hit(bvh, oo, dd, count=True), dev,
                                          warm=True)
        for what, a, b in zip(("t", "idx", "face", "nrm"), counted, plain):
            if not torch.equal(a, b):
                raise AssertionError(f"counted closest hit, {name}: {what} differs from the uncounted")
        m = int(oo.shape[0])
        nodes, leaves, tris = (int(v) for v in counts.sum(dim=0))
        out[name] = {"queries": m, "nodes": nodes, "leaves": leaves, "tris": tris,
                     "nodes_per_query_max": int(counts[:, 0].max()), "counted_ms": ms}
        if out[name]["nodes"] < m:
            raise AssertionError(f"counted closest hit, {name}: {out[name]['nodes']} root visits")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, default=GRID)
    ap.add_argument("--extent", type=float, default=EXTENT)
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--parity-rays", type=int, default=N_PARITY)
    ap.add_argument("--perquery-rays", type=int, default=N_PERQUERY)
    ap.add_argument("--method", default="native", choices=["native", "numpy"])
    args = ap.parse_args(argv)

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("needs a CUDA card (or --device cpu at a small --grid and --rays)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from rfx_torch.device import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "clock": "cuda events" if dev.type == "cuda" else "host clock, plain versions",
           "tx": TX, "rx": RX, "rx_radius": RX_RADIUS}
    mesh, _, tracer, out["scene"] = build_scene(dev, grid=args.grid, extent=args.extent,
                                                n_rays=args.rays, method=args.method)
    bvh = tracer._fused.bvh
    out["parity"] = parity_leg(mesh, bvh, dev, n=args.parity_rays, method=args.method)
    dirs = morton_dirs(args.rays, 0, dev)
    out["cir"] = cir_leg(tracer, dirs)
    out["walk_counters"] = counters_leg(bvh, dirs)
    out["perquery_vs_fused"] = perquery_leg(bvh, dirs[:args.perquery_rays].contiguous())
    out["perquery_counters"] = perquery_counters_leg(bvh, dirs[:args.perquery_rays].contiguous())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
