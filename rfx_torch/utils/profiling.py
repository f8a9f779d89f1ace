"""Profiling hooks (port of rfx/utils/profiling.py, which imports JAX): a
`torch.profiler` trace of a region, named phase timers that wait for the
device before they stop, and a rays/s tracker.

PyTorch launches CUDA work asynchronously, so a host clock around a call
measures its enqueue. `PhaseTimer.phase(..., block_on=x)` and
`Throughput.measure` synchronize the devices of the CUDA tensors they are
given before the clock stops, so each phase owns its device time.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["device_trace", "PhaseTimer", "Throughput", "block_until_ready"]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """Wait for the work that produces the CUDA tensors in `tree` (a tensor
    or nested lists, tuples and dicts of them): synchronize each of their
    devices once. CPU tensors and other leaves need no wait."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace a region with `torch.profiler` (host operators, and CUDA
    kernels where a card is present) and write it as a Chrome trace,
    `<logdir>/trace.json` (chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class PhaseTimer:
    """Accumulating named phase timers.

    with timer.phase("trace", block_on=ir): ...
    `block_on` (optional tensor or nest of tensors) is waited for before the
    phase closes, so asynchronous launches do not move device time into a
    later phase.
    """

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.4f}s total, {total / n:.4f}s/call x{n}")
        return "\n".join(lines)


@dataclass
class Throughput:
    """Mrays/s over timed trace calls: put the call's result in the yielded
    dict under "result" and it is waited for before the clock stops."""

    rays: int = 0
    seconds: float = 0.0

    @contextlib.contextmanager
    def measure(self, n_rays: int):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "result" in holder:
                block_until_ready(holder["result"])
            self.seconds += time.perf_counter() - t0
            self.rays += n_rays

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(self.seconds, 1e-12) / 1e6
