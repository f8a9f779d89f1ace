#!/usr/bin/env python3
"""Where a copy between a CUDA card and the host gains from page-locked host
memory: the host's time of one blocking copy of n float32 each way, by
payload size, through pageable memory and through a block of PyTorch's
caching host allocator.

    python3 scripts/torch_host_copy_crossover.py [--reps 50] [--out FILE]

To the host, `pageable` is `x.cpu()` (fresh pageable memory, as
`rfx_torch.utils.profiling.to_host` does below its size rule) and `pinned`
is `torch.empty(..., pin_memory=True).copy_(x)`, each timed two ways:
`dropped`, each result dropped before the next call (a caller that keeps no
array: the page-locked block comes from the cache), and `kept`, every result
held (a caller that keeps every array: each call allocates a new
page-locked block; up to 1 GiB is held, then freed and the cache emptied).
To the card, both copy a numpy array with `torch.as_tensor(a).to(dev)`,
from pageable memory or from a page-locked block. Each time is the median of
the calls after three warm-up calls. A crossover is the smallest size from
which the page-locked copy to the host is the faster at every larger size
measured, one for each way of calling. Also the cost of `is_pinned()` on a
small array. Needs a CUDA card; prints one JSON object and writes it to
`--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZES = sorted([1 << k for k in range(12, 28)] + [80_000, 81_920_000])
HELD_BYTES = 1 << 30


def _median_us(fn, reps: int, keep: bool) -> float:
    held, times = [], []
    for i in range(reps + 3):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        if keep:
            held.append(out)
        if i >= 3:
            times.append(dt)
        del out
    return statistics.median(times) * 1e6


def _crossover(rows, fast: str, slow: str):
    found = None
    for row in reversed(rows):
        if row[fast] >= row[slow]:
            break
        found = row["bytes"]
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default="chiprun_out/host_copy_crossover.json")
    a = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: torch.cuda.is_available() is False")
    # Frees the cache's unused page-locked blocks (its name moved between
    # torch releases); without it the `kept` times are not measured.
    empty_cache = (getattr(torch._C, "_host_emptyCache", None)
                   or getattr(torch._C, "_accelerator_emptyHostCache", None))
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    rows = []
    for nbytes in SIZES:
        n = nbytes // 4
        x = torch.rand(n, device=dev)
        to_host = {"pageable": lambda: x.cpu(),
                   "pinned": lambda: torch.empty(x.shape, dtype=x.dtype,
                                                 pin_memory=True).copy_(x)}
        src = {"pageable": np.random.default_rng(0).random(n, dtype=np.float32),
               "pinned": torch.rand(n).pin_memory().numpy()}
        row = {"bytes": n * 4}
        for kind, fn in to_host.items():
            row[f"to_host_{kind}_dropped_us"] = _median_us(fn, a.reps, keep=False)
        if empty_cache is not None:
            reps = max(3, min(a.reps, HELD_BYTES // row["bytes"] - 3))
            for kind, fn in to_host.items():
                empty_cache()
                row[f"to_host_{kind}_kept_us"] = _median_us(fn, reps, keep=True)
                empty_cache()
        for kind, arr in src.items():
            row[f"to_card_{kind}_us"] = _median_us(lambda: torch.as_tensor(arr).to(dev),
                                                   a.reps, keep=False)
        row["to_host_pinned_gb_s"] = row["bytes"] / row["to_host_pinned_dropped_us"] / 1e3
        row["to_card_pinned_gb_s"] = row["bytes"] / row["to_card_pinned_us"] / 1e3
        rows.append(row)
        del x, src
    small = torch.as_tensor(np.zeros(3, np.float32))
    n_query = 10_000
    t0 = time.perf_counter()
    for _ in range(n_query):
        small.is_pinned()
    result = {"card": card.strip(), "torch": torch.__version__, "cuda": torch.version.cuda,
              "reps": a.reps, "rows": rows,
              "crossover_dropped_bytes": _crossover(rows, "to_host_pinned_dropped_us",
                                                    "to_host_pageable_dropped_us"),
              "crossover_kept_bytes": (_crossover(rows, "to_host_pinned_kept_us",
                                                  "to_host_pageable_kept_us")
                                       if empty_cache is not None else "not measured"),
              "is_pinned_us": (time.perf_counter() - t0) / n_query * 1e6}
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print("bytes, to host: pageable / pinned dropped, pageable / pinned kept; to card: "
          "pageable / pinned (us)", file=sys.stderr)
    for row in rows:
        print(f"{row['bytes']:>11,}  {row['to_host_pageable_dropped_us']:9.1f} / "
              f"{row['to_host_pinned_dropped_us']:9.1f}  "
              f"{row.get('to_host_pageable_kept_us', float('nan')):9.1f} / "
              f"{row.get('to_host_pinned_kept_us', float('nan')):9.1f}  "
              f"{row['to_card_pageable_us']:9.1f} / {row['to_card_pinned_us']:9.1f}",
              file=sys.stderr)
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
