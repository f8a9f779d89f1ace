#!/usr/bin/env python3
"""Micro-benchmark of a warp's node test on one NVIDIA GPU: ns per body when 8
per-lane predicates become 8 warp-uniform flags (the port's
scripts/micro_reduce.py).

    python3 scripts/torch_micro_vote.py [--steps 50000] [--check-steps 2000]

For each style of rfx_torch.ops.micro_vote (`votes`, `ballotfold`, `sumpack`,
`novec`): the kernel's final carry must equal the plain PyTorch version's at
`--check-steps` bodies, bit for bit; then one launch of `--steps` bodies is
timed with CUDA events (the best of `--reps` launches) and reported as ns per
body. The tile is numpy's `default_rng(seed).random((8, 128))`. Prints one
line per style and one JSON line; exits non-zero without a CUDA card or on a
mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

STEPS = 50_000
CHECK_STEPS = 2_000


def _tile(dev, seed: int):
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(seed).random((8, 128)).astype(np.float32)).to(dev)


def check_styles(dev, *, check_steps: int = CHECK_STEPS, seed: int = 0) -> dict:
    """{style: {"carry", "plain_carry", "check_ms", "plain_ms"}} on the CUDA
    device `dev`: the kernel's and the plain version's carry after
    `check_steps` bodies and their times. Raises AssertionError where they
    differ in any bit."""
    import torch

    from rfx_torch.ops.micro_vote import STYLES, micro_vote, micro_vote_plain

    x = _tile(dev, seed)
    out = {}
    for style in STYLES:
        micro_vote(x, 1, style)  # the first launch loads the kernel
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        got = micro_vote(x, check_steps, style)
        mid.record()
        want = micro_vote_plain(x, check_steps, style)
        end.record()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"micro_vote {style}: carry {float(got)!r} != plain "
                                 f"{float(want)!r} after {check_steps} bodies")
        out[style] = {"carry": float(got), "plain_carry": float(want),
                      "check_ms": start.elapsed_time(mid), "plain_ms": mid.elapsed_time(end)}
    return out


def time_styles(dev, *, steps: int = STEPS, reps: int = 5, seed: int = 0) -> dict:
    """{style: {"ms", "ns_per_body"}}: the best of `reps` launches of `steps`
    bodies each, by CUDA events."""
    import torch

    from rfx_torch.ops.micro_vote import STYLES, micro_vote

    x = _tile(dev, seed)
    out = {}
    for style in STYLES:
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            micro_vote(x, steps, style)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[style] = {"ms": min(times), "ns_per_body": min(times) * 1e6 / steps}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--check-steps", type=int, default=CHECK_STEPS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    dev = torch.device("cuda", 0)
    res = check_styles(dev, check_steps=args.check_steps, seed=args.seed)
    for style, t in time_styles(dev, steps=args.steps, reps=args.reps, seed=args.seed).items():
        res[style].update(t)
    for style, r in res.items():
        print(f"{style:10s}: {r['ns_per_body']:8.2f} ns/body ({r['ms']:.3f} ms for {args.steps} "
              f"bodies); carry {r['carry']:.9e} == plain after {args.check_steps} bodies")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "steps": args.steps,
                      "check_steps": args.check_steps, "styles": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
