"""rfx_torch: the PyTorch / CUDA (NVIDIA H100) port of rfx.

The JAX package `rfx` stays the reference. This package imports `torch` and
numpy, never `jax` and nothing of `rfx`: it keeps its own copies of the numpy
host modules (`geometry.py`, `bvh.py`, `config.py`, `viz/`, `utils/`), and an
`rfx` mesh or BVH crosses by field through `convert.py`.

Every public entry point takes `device=` (default `"cuda"`). On a CUDA tensor
the hand-written kernels run, twenty-four C entry points in nine sources of
rfx_torch/csrc/, built with nvcc at first use (`ops/_build.py`):
twenty-three launch kernels, and `rfx_map_capture_backward_blocks` gives the
rows of the map capture backward's scratch. The sources:

- `fused_trace.cu`: the fused bounce loop, which walks its rays in the
  order it is given and writes each ray's outputs at the ray's own index,
  with the analytic receiver sphere or the reference's 80-face icosphere
  (an instantiation each), and its counted instantiation;
- `ray_order.cu`: the rays' direction-cell order, a counting sort of the
  ray indices by each direction's cell on an octahedral lattice, which the
  fused trace walks (`ops/ray_order.py`);
- `closest_hit.cu`: the per-query closest hit and its counted instantiation;
- `histogram.cu`: the IR histogram, one launch for a batch of rows, and
  its record entry, which bins the map engine's first-capture record (and
  its form for the icosphere receiver's record, which reads the t that the
  capture pass wrote at each capture);
- `coverage_hist.cu`: the coverage histogram, its slab reduction, and the
  phasor metric: its per-bin table, its sums over the same walk and capture
  rule, its delay spread over the capture lists that walk leaves, and its
  backward (d / d amplitude, a thread a live ray over the receivers in
  order);
- `rx_power.cu`: the RX-power metric's convolution with the carrier and its
  dBm, one call for a batch of IRs, and its backward (the transposed
  convolution of the metric's cotangent);
- `map_capture.cu`: the map engine's capture pass (each receiver's first
  capture along each ray, written as a one-byte record, the bounce or none)
  and its backward from that record (d / d the segments, the centers, the
  amplitude scale and the radius, a thread a ray over the receivers in
  order), each also for the reference's 80-face icosphere receiver (its
  capture pass a kernel of its own: each bounce's live rays compacted, a
  lane a ray against 64 receivers, each passing pair's 80 tests shared by
  the warp, each capture's t written beside the record); it shares the
  capture rule with `coverage_hist.cu` through `sphere.cuh`, and the
  icosphere's with `brute_hit.cu` through `brute_hit.cuh`;
- `brute_hit.cu`: the brute closest hit, every ray against every triangle
  of a short list (the `brute` backend's meshes, the icosphere receiver,
  with its bounding-sphere cull);
- `micro_vote.cu`: the vote micro-kernel, a latency probe.

On a CPU tensor their plain PyTorch versions run. The map engine's capture
pass (`ops/map_capture.py`), the RX-power and the phasor metrics
differentiate on either device through one autograd Function each,
whose backward is the backward kernel on the card and its plain version on
the CPU; the coverage histogram has no backward (nor has rfx's batched
engine): on the card an input that requires grad raises there. Asking for
CUDA where there is no card raises. Gradients flow through the scan tracer
(`tracer.py`, whose closest hits share one backward, `ops/intersect.py`'s
`differentiable_hit`), the differentiable fused tracer (`ops/fused.py`), the
coverage engine (`coverage.py`: the map engine, the RX-power and the phasor
metrics) and the inverse solver (`solver.py`).

`parallel/` distributes over ranks with torch.distributed: `dist.py` shards
the CIR, coverage and (through `solver.py`'s `mesh=`) the inverse solve over
'rays' and 'rx' axes of ranks, and `launch.py` starts the ranks of one host.
`graft_entry.py` holds the entry points `entry()` and
`dryrun_multichip(n)`.
"""
