"""Profiling hooks (port of rfx/utils/profiling.py, which imports JAX): a
`torch.profiler` trace of a region, named phase timers that wait for the
device before they stop, and the port's own spans and counters.

PyTorch launches CUDA work asynchronously, so a host clock around a call
measures its enqueue. `PhaseTimer.phase(..., block_on=x)` synchronizes the
devices of the CUDA tensors it is given before the clock stops, so each
phase owns its device time.

Spans and counters. The port marks its layers with spans that a
`torch.profiler` trace records as host operators, on the clock of the
device's records (`torch._C._profiler._RecordFunctionFast`: under a
microsecond each where no profiler records). Tracing is on exactly while a
`torch.profiler` records (the CLI's `--profile`, the benchmark's traced
runs); there is no switch of its own. No span or counter runs inside a
kernel or once a ray, and no counter reads the device. The spans:

- `rfx.api.compute_cir`, `rfx.api.compute_coverage`,
  `rfx.api.compute_coverage_dbm_fast`, `rfx.api.compute_coverage_dbm_hybrid`,
  `rfx.api.rx_power_dbm`: the facade's calls (`rfx_torch.api.Tracer`);
- `rfx.tracer.fused` (the fused trace's CUDA branch: its arguments and the
  launch), `rfx.tracer.scan` (`trace_to_rx`), `rfx.tracer.env`
  (`trace_env`): the tracers;
- `rfx.ops.env_hit` (the closest-hit query of `make_kernel_env_hit` and of
  the brute intersector), `rfx.ops.rx_hit` (the icosphere receiver's query):
  the kernels' host wrappers;
- `rfx.cir.histogram` (`bin_impulse_response`), `rfx.cir.rx_power`
  (`rx_power_dbm`), `rfx.coverage.hist` (`coverage_hist` and its slab
  reduction), `rfx.coverage.phasor` (`coverage_phasor`: the phasor kernel's
  table, walk and spread);
- `rfx.wait.<site>`: each place on those paths where the host blocks on a
  card (a copy between host data and the device, or an index the host must
  read), each site under a name of its own (`to_device`, `to_host`). They open on every device, the CPU too,
  where nothing waits, so that a trace shows the same sites on both;
- `rfx.bvh.build` (`rfx_torch.bvh.build_bvh`, whichever builder it takes)
  and `rfx.bvh.pack` (`rfx_torch.ops.bvh_pack.pack_bvh`): a scene's set-up,
  once a tracer, never inside a request.

`counters()` holds two kinds of entries. Tallies: the payload bytes of the
`rfx.wait.*` sites, `bytes_to_host` and `bytes_to_device`, and of those the
bytes that crossed through page-locked host memory, `bytes_pinned_to_host`
and `bytes_pinned_to_device`; the rays the fused kernel walked on the card,
`rays_fused`, of those the rays it walked in direction-cell order,
`rays_ordered`, the rays it walked with the icosphere receiver,
`rays_fused_ico`, and the rays it walked nearer child first over the
child-pair table, `rays_near_first` (rfx_torch/ops/fused.py); the receivers whose sums the
phasor kernel's walk computed, `rx_phasor` (rfx_torch/ops/coverage_hist.py);
all counted only while a profiler records: in a benchmark's traced run,
exactly its traced units. Gauges of the last BVH
set-up, set whether or not a profiler records (set-up runs before one
starts), and absent until the first build: `bvh_build_s`, the host seconds
of the last `build_bvh`; `bvh_native`, 1 if the native builder made that
tree, else 0; `bvh_table_bytes`, the bytes of the last `pack_bvh`'s device
tables (the preorder nodes, the child-pair table, triangles and face ids,
from the tensors' sizes, not read from the device).

Page-locked memory. `to_host` brings a CUDA tensor of at least
`PINNED_MIN_BYTES` into page-locked memory from PyTorch's caching host
allocator (`torch.empty(..., pin_memory=True)`), which the card fills by DMA;
a smaller one, or a CPU tensor, goes through `.cpu()`. The numpy array a
caller makes of the result keeps its block until the array is dropped: a
block (the payload rounded up to a power of two) is held for each such
array alive, and a dropped one goes back to the cache for the next call, so
a returned array never changes under a later call. `to_device` copies
straight from host data that already lives in page-locked memory (such an
array handed back); either way the host waits for the copy. The size rule,
`PINNED_MIN_BYTES` (1 MiB), holds both ways; it was set from crossovers
measured on the card (`scripts/torch_host_copy_crossover.py`): a cached
block beats `.cpu()` from 32 KiB, a block made anew for each call from 1-4
MiB.

Where the installed torch has no `_RecordFunctionFast`, a span is a
`record_function`, entered only while a profiler records; a trace then holds
it as a user annotation, which readers of host operators do not read.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["device_trace", "PhaseTimer", "block_until_ready", "span", "spanned", "wait",
           "to_device", "to_host", "counters", "tally", "set_gauge", "PINNED_MIN_BYTES"]

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # an older torch: record_function while a profiler records
    _RecordFunctionFast = None

_profiler_enabled = torch._C._autograd._profiler_enabled

_COUNTERS = {"bytes_to_host": 0, "bytes_to_device": 0,
             "bytes_pinned_to_host": 0, "bytes_pinned_to_device": 0,
             "rays_fused": 0, "rays_ordered": 0, "rays_fused_ico": 0, "rays_near_first": 0,
             "rx_phasor": 0}
_GAUGES = {}

#: Payloads of at least this many bytes cross through page-locked memory:
#: a CUDA tensor comes to the host in a cached page-locked block, and host
#: data is asked whether it lives in one. Measured on an NVIDIA H100 80GB
#: HBM3 (700 W, torch 2.11.0+cu128; scripts/torch_host_copy_crossover.py),
#: a cached block overtakes `.cpu()` from 32 KiB (37 / 118 us at 1 MiB);
#: a block made anew for every call, as for a caller that keeps every
#: array, breaks even between 1 and 4 MiB (510 / 1,538 us at 1 MiB, 1,004 /
#: 990 us at 2 MiB, 1,545 / 3,688 us at 4 MiB). Below 1 MiB a copy gains a
#: few microseconds, which is not worth the page-locked RAM a kept array
#: would hold.
PINNED_MIN_BYTES = 1 << 20


def span(name: str):
    """A context manager that marks a region `name` in a `torch.profiler`
    trace; next to nothing while no profiler records."""
    if _RecordFunctionFast is not None:
        return _RecordFunctionFast(name)
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def wait(site: str, bytes_to_host: int = 0, bytes_to_device: int = 0, pinned: bool = False):
    """The span `rfx.wait.<site>` of a place where the host blocks on the
    device; while a profiler records, the payload's bytes are added to the
    counters, and to the page-locked ones where `pinned`."""
    if _profiler_enabled():
        _COUNTERS["bytes_to_host"] += int(bytes_to_host)
        _COUNTERS["bytes_to_device"] += int(bytes_to_device)
        if pinned:
            _COUNTERS["bytes_pinned_to_host"] += int(bytes_to_host)
            _COUNTERS["bytes_pinned_to_device"] += int(bytes_to_device)
    return span("rfx.wait." + site)


def to_device(site: str, x, device, dtype=torch.float32) -> torch.Tensor:
    """`torch.as_tensor(x, dtype=dtype, device=device)`: host data (anything
    but a tensor on another device than the CPU) is copied under
    `wait(site)` with its bytes (by DMA where it lives in page-locked
    memory, counted as such from `PINNED_MIN_BYTES`); a device tensor goes
    as it is."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return torch.as_tensor(x, dtype=dtype, device=device)
    host = torch.as_tensor(x, dtype=dtype)
    # A CUDA query (cudaPointerGetAttributes), so only for a CUDA device: on
    # a CPU device it would start CUDA where a card is present.
    pinned = (host.nbytes >= PINNED_MIN_BYTES and torch.device(device).type == "cuda"
              and host.is_pinned())
    with wait(site, bytes_to_device=host.nbytes, pinned=pinned):
        return host.to(device)


def to_host(site: str, x: torch.Tensor) -> torch.Tensor:
    """`x` on the host under `wait(site)` with its bytes: a CUDA tensor of
    at least `PINNED_MIN_BYTES` in a page-locked block of PyTorch's caching
    host allocator, anything else through `x.cpu()`. It returns once the
    copy is complete."""
    pinned = x.device.type == "cuda" and x.nbytes >= PINNED_MIN_BYTES
    with wait(site, bytes_to_host=x.nbytes, pinned=pinned):
        if not pinned:
            return x.cpu()
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)


def tally(name: str, value: int) -> None:
    """Add `value` to the tally `name` of `counters()` while a profiler records."""
    if _profiler_enabled():
        _COUNTERS[name] += int(value)


def set_gauge(name: str, value) -> None:
    """Set the gauge `name` of `counters()`, whether or not a profiler records."""
    _GAUGES[name] = value


def counters() -> dict:
    """A copy of the counters: the tallies bytes_to_host, bytes_to_device,
    bytes_pinned_to_host, bytes_pinned_to_device, rays_fused, rays_ordered,
    rays_fused_ico, rays_near_first, rx_phasor, and the gauges set so far (bvh_build_s, bvh_native,
    bvh_table_bytes)."""
    return {**_COUNTERS, **_GAUGES}


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
