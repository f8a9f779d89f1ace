"""rfx_torch: the PyTorch / CUDA (NVIDIA H100) port of rfx.

The JAX package `rfx` stays the reference. This package imports `torch` and
numpy, never `jax` and nothing of `rfx`: it keeps its own copies of the numpy
host modules (`geometry.py`, `bvh.py`, `config.py`, `viz/`, `utils/`), and an
`rfx` mesh or BVH crosses by field through `convert.py`.

Every public entry point takes `device=` (default `"cuda"`). On a CUDA tensor
the hand-written kernels run, eight C entry points in five sources of
rfx_torch/csrc/, built with nvcc at first use (`ops/_build.py`):

- `fused_trace.cu`: the fused bounce loop and its counted instantiation;
- `closest_hit.cu`: the per-query closest hit and its counted instantiation;
- `histogram.cu`: the IR histogram, one launch for a batch of rows;
- `coverage_hist.cu`: the coverage histogram and its slab reduction;
- `micro_vote.cu`: the vote micro-kernel, a latency probe.

On a CPU tensor their plain PyTorch versions run. Asking for CUDA where there
is no card raises. Gradients flow through the scan tracer (`tracer.py`), the
differentiable fused tracer (`ops/fused.py`), the coverage engine
(`coverage.py`) and the inverse solver (`solver.py`).

`parallel/` distributes over ranks with torch.distributed: `dist.py` shards
the CIR, coverage and (through `solver.py`'s `mesh=`) the inverse solve over
'rays' and 'rx' axes of ranks, and `launch.py` starts the ranks of one host.
`graft_entry.py` holds the entry points `entry()` and
`dryrun_multichip(n)`.
"""
