#!/usr/bin/env python3
"""Time the facade's `fused` and `bvh` backends on a CPU device, where both
run plain PyTorch: the fused trace's brute-force plain version against the
plain stackless walk under the scan tracer.

    python3 scripts/torch_bench_cpu_backends.py [--rays 4096] [--grid 128] [--threads 1]

The scene is the bench terrain (make_terrain(grid=128, extent=60, seed=0),
32,258 triangles), tx (10, 0, 25), rx (-10, 0, 8), radius 1.0, 4 bounces.
Prints one JSON object: host seconds of one `compute_cir` request per
backend (after the BVH build), and whether the two IRs agree. This is what
`backend="auto"` of rfx_torch.api.Tracer rests on for a CPU device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--threads", type=int, default=1)
    a = ap.parse_args(argv)

    import numpy as np
    import torch

    from rfx_torch.api import Tracer
    from rfx_torch.geometry import make_terrain
    from rfx_torch.sampler import morton_sphere_directions

    torch.set_num_threads(a.threads)
    mesh = make_terrain(grid=a.grid, extent=60.0, seed=0)
    dirs = morton_sphere_directions(a.rays, generator=torch.Generator().manual_seed(0), device="cpu")
    out = {"device": "cpu", "threads": a.threads, "triangles": int(mesh.num_faces), "rays": a.rays}
    irs = {}
    for backend in ("bvh", "fused"):
        tracer = Tracer(mesh, max_bounces=4, tx_num_rays=a.rays, backend=backend, device="cpu")
        t0 = time.perf_counter()
        _, irs[backend] = tracer.compute_cir((10.0, 0.0, 25.0), 1.0, (-10.0, 0.0, 8.0), 1.0,
                                             directions=dirs, record_paths=False)
        out[f"{backend}_seconds"] = time.perf_counter() - t0
    out["same_nonzero_bins"] = bool(np.array_equal(irs["bvh"] != 0, irs["fused"] != 0))
    out["max_abs_diff"] = float(np.abs(irs["bvh"] - irs["fused"]).max())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
