"""The general generator: a cell's inputs from its traffic file and the seed.

Every seed gives the same sizes and the same amount of work; the seed draws
the direction sets (i.i.d. uniform on the sphere, made on the device in one
call of the frozen sampler each) and the order in which the receivers are
visited. Traffic keys read here:

- `direction_sets`: the pool of S direction sets made in set-up and cycled,
  unit k taking set k mod S;
- `receivers`: {"x": axis, "y": axis, "z": axis}, each axis
  {"linspace": [lo, hi, count]} or {"arange": [start, stop, step]} (stop
  included), x slowest and z fastest;
- `rx_order`: "seeded_permutation" (unit k takes receiver
  order[(k // S) mod M], so that every S x M units take every pair of a set
  and a receiver once) or "all" (every unit takes every receiver);
- `tx`, `tx_power`, `rx_radius`, `rx_mode`, `carrier_hz`: as the port's facade
  takes them.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.sampler import sphere_directions

__all__ = ["sub_seed", "axis", "receivers", "direction_pool", "Schedule"]


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose, from the run's seed and tags."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [sum(ord(c) * 131 ** i for i, c in enumerate(str(t))) & 0xFFFFFFFF for t in tags]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def axis(spec: dict) -> np.ndarray:
    if "linspace" in spec:
        lo, hi, count = spec["linspace"]
        return np.linspace(lo, hi, int(count))
    start, stop, step = spec["arange"]
    return np.arange(start, stop + 0.5 * step, step)


def receivers(spec: dict) -> np.ndarray:
    """(M, 3) float32 receiver centers, x slowest and z fastest."""
    xs, ys, zs = (axis(spec[k]) for k in ("x", "y", "z"))
    pts = [(x, y, z) for x in xs for y in ys for z in zs]
    return np.asarray(pts, dtype=np.float32)


def direction_pool(rays: int, sets: int, seed: int, device) -> list[torch.Tensor]:
    """`sets` direction sets of `rays` rays each, float32 on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "directions"))
    return [sphere_directions(rays, generator=gen, device=device).contiguous() for _ in range(sets)]


class Schedule:
    """Which direction set and receivers unit k takes."""

    def __init__(self, traffic: dict, seed: int, num_rx: int):
        self.sets = int(traffic["direction_sets"])
        self.mode = traffic["rx_order"]
        if self.mode not in ("seeded_permutation", "all"):
            raise ValueError(f"unknown rx_order {self.mode!r}")
        rng = np.random.default_rng(sub_seed(seed, "rx_order"))
        self.order = rng.permutation(num_rx) if self.mode == "seeded_permutation" else None

    def set_of(self, k: int) -> int:
        return k % self.sets

    def rx_of(self, k: int):
        """The receiver index of unit k, or None where it takes them all."""
        if self.order is None:
            return None
        return int(self.order[(k // self.sets) % self.order.size])

    def check_sets(self, seed: int, count: int) -> list[int]:
        """The direction sets whose units the output check compares."""
        rng = np.random.default_rng(sub_seed(seed, "check_sets"))
        return sorted(int(i) for i in rng.choice(self.sets, size=min(count, self.sets),
                                                   replace=False))
