#!/usr/bin/env python3
"""Time the port's hand-written kernels at the shapes of their main paths on
one NVIDIA GPU, and hold them against another checkout's kernels.

    python3 scripts/torch_bench_kernels.py [--other DIR] [--out build/bench_kernels.json]

The scenes, transmitters, receivers and sizes are those of chip_smoke.py (the
bench terrain, the coverage sweeps) and of scripts/torch_bench_large_mesh.py
(the 1,045,458-triangle terrain), imported from there. What it runs (CUDA
events, the mean of `--reps` calls after one warm-up):

- K1, the fused trace, 5,242,880 Morton rays x 4 bounces on both terrains,
  with the counted instantiation and the face record beside it;
- K2, the per-query closest hit, on the bench terrain at 65,536, 1,048,576
  and 2,621,440 rays from tx (the shapes of the checks, of the solver and
  the coverage trace, of the scan gradient path) and on their second-bounce
  queries, and on the large terrain at 16,384 and 1,048,576 rays;
- K3, the coverage histogram, 2,048 receivers x 2 bounces x 1,048,576 rays x
  10,000 bins on the room and on the bench terrain;
- K-H, the IR histogram, at the solver's shape: 1,048,576 rays, 20,000
  bins, one receiver's captures, hard and soft.

`--other DIR` runs K1, K2 and K3 in a child process on the checkout in DIR
(another commit of this repository, unpacked there), before and after this
checkout's runs, and compares: K1's four outputs bit for bit on both
terrains, K3's nonzero bins exactly and its values within rtol 1e-5 / atol
1e-12. Prints one JSON object and writes the whole record to `--out`; `card`
is nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
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
        meshes = {name: make_terrain(**s["terrain"]) for name, s in SCENES.items()}
        self.bvh = {name: pack_bvh(build_bvh(mesh, leaf_size=large.LEAF), dev)
                    for name, mesh in meshes.items()}
        cov_meshes = {"room": make_room(), "terrain": meshes["bench"]}
        cov_dirs = large.morton_dirs(smoke.COV_RAYS, 0, dev)
        self.cov = {}
        for name, tx, zs in smoke.COV_SCENES:
            _, grid, _, scaled = smoke.coverage_workload(cov_meshes[name], tx, zs, cov_dirs, dev)
            self.cov[name] = (scaled, torch.as_tensor(grid, device=dev))
        torch.cuda.synchronize()


def run_k1(w: Workloads, reps: int, keep: dict) -> dict:
    from rfx_torch.ops.fused import fused_trace

    out = {}
    kw = dict(max_bounces=smoke.BOUNCES)
    for name, bvh in w.bvh.items():
        s = SCENES[name]
        args = (bvh, w.dirs, s["tx"], s["rx"], s["radius"], 5.0, 1.0)
        res, ms = _ms(lambda: fused_trace(*args, **kw), reps)
        (cres, stats), cms = _ms(lambda: fused_trace(*args, count_stats=True, **kw), reps)
        (fres, faces), fms = _ms(lambda: fused_trace(*args, record_faces=True, **kw), reps)
        out[name] = {"ms": ms, "counted_ms": cms, "record_faces_ms": fms,
                     "digest": _digest(res[:4]), "counted_digest": _digest(cres[:4]),
                     "faces_digest": _digest([*fres[:4], faces]),
                     "counters": stats.tolist(), "captured": int(res.captured.sum())}
        keep[f"k1_{name}"] = [t.cpu() for t in res[:4]]
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
            (t, idx, _, nrm), ms = _ms(lambda: closest_hit(bvh, o, d), reps)
            hit = t < 1e29
            o2 = (o + d * t[:, None])[hit].contiguous()
            d2 = (d - 2.0 * dot3(d, nrm)[:, None] * nrm)[hit].contiguous()
            (t2, idx2, _, _), ms2 = _ms(lambda: closest_hit(bvh, o2, d2), reps)
            out[f"{name}, {n} rays from tx"] = {"ms": ms, "hits": int(hit.sum()),
                                                "digest": _digest([t, idx])}
            out[f"{name}, {int(hit.sum())} second-bounce queries"] = {
                "ms": ms2, "hits": int((t2 < 1e29).sum()), "digest": _digest([t2, idx2])}
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


def run_kh(w: Workloads, reps: int) -> dict:
    from rfx_torch import cir
    from rfx_torch.ops.fused import fused_trace

    n, nbins = smoke.SOLVER_RAYS, smoke.NBINS
    r = fused_trace(w.bvh["bench"], large.morton_dirs(n, 1, w.dev), smoke.TX, (-20.0, -20.0, 8.0),
                    smoke.RX_RADIUS, 5.0, 1.0, max_bounces=smoke.BOUNCES)
    kw = dict(nbins=nbins, light_speed_mps=smoke.C, sample_rate_hz=smoke.RATE)
    args = (r.amplitude * (1.0 / n), r.distance, r.captured)
    out = {"rays": n, "captured": int(r.captured.sum())}
    for soft in (False, True):
        _, ms = _ms(lambda: cir.bin_impulse_response(*args, soft=soft, **kw), reps)
        out["soft_ms" if soft else "hard_ms"] = ms
    # 9 bytes a ray in, the bins out, at the card's memory rate.
    out["bound_ms"] = (9 * n + 4 * nbins) / smoke.PEAK_BYTES_PER_S * 1e3
    return out


def child(args) -> int:
    """Run K1, K2 and K3 on the checkout at --root; save times and outputs."""
    import torch

    sys.path.insert(0, args.root)
    import rfx_torch

    if os.path.realpath(os.path.dirname(rfx_torch.__file__)) != os.path.realpath(
            os.path.join(args.root, "rfx_torch")):
        raise AssertionError(f"imported rfx_torch from {rfx_torch.__file__}, not from {args.root}")
    w = Workloads(torch.device("cuda", 0))
    keep = {}
    out = {"k1": run_k1(w, args.reps, keep), "k2": run_k2(w, args.reps),
           "k3": run_k3(w, args.reps, keep)}
    torch.save({"times": out, "outputs": keep}, args.dump)
    return 0


def _run_other(root_other: str, reps: int) -> dict:
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "other.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--root", root_other,
                        "--dump", dump, "--reps", str(reps)], check=True, cwd=HERE, timeout=1500)
        return torch.load(dump)


def _compare(mine: dict, other: dict) -> dict:
    import torch

    out = {}
    for key, theirs in other.items():
        ours = mine[key]
        if key.startswith("k1_"):
            out[key] = {name: bool(torch.equal(a, b)) for name, a, b in zip(
                ("captured", "amplitude", "distance", "num_bounces"), ours, theirs)}
        else:
            out[key] = {"same_nonzero_bins": bool(torch.equal(ours != 0, theirs != 0)),
                        "allclose_rtol_1e-5": bool(torch.allclose(ours, theirs, rtol=1e-5, atol=1e-12)),
                        "bit_identical": bool(torch.equal(ours, theirs)),
                        "max_abs_diff": float((ours - theirs).abs().max())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of this repository to compare with")
    ap.add_argument("--reps", type=int, default=10)
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
        other = _run_other(os.path.abspath(args.other), args.reps)
        out["other_first"] = other["times"]
    w = Workloads(torch.device("cuda", 0))
    keep = {}
    out["here"] = {"k1": run_k1(w, args.reps, keep), "k2": run_k2(w, args.reps),
                   "k3": run_k3(w, args.reps, keep), "kh": run_kh(w, args.reps)}
    if args.other:
        out["here_vs_other"] = _compare(keep, other["outputs"])
        out["other_last"] = _run_other(os.path.abspath(args.other), args.reps)["times"]
    out["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)

    def brief(r):
        return {k: {s: v["ms"] for s, v in r[k].items()} for k in r if k in ("k1", "k2", "k3")}

    print(json.dumps({"card": card, "here": brief(out["here"]), "kh": out["here"]["kh"],
                      "k1_counted_ms": {s: v["counted_ms"] for s, v in out["here"]["k1"].items()},
                      "other_first": brief(out.get("other_first", {})),
                      "other_last": brief(out.get("other_last", {})),
                      "vs_other": out.get("here_vs_other"), "seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
