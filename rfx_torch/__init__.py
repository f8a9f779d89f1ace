"""rfx_torch: the PyTorch / CUDA (NVIDIA H100) port of rfx.

The JAX package `rfx` stays the reference. This package imports `torch` and
never `jax`; host code that is plain numpy (`rfx.geometry`,
`rfx.bvh.build_bvh(..., method="numpy")`, `rfx.utils.logging`) is imported
from `rfx`, not copied.

Every public entry point takes `device=` (default `"cuda"`). On a CUDA tensor
the three kernels run (rfx_torch/csrc/*.cu, built with nvcc on first use):
the fused bounce loop, the per-query closest hit and the IR histogram; on a
CPU tensor their plain PyTorch versions run. Asking for CUDA where there is
no card raises. Gradients flow through the scan tracer (`tracer.py`), the
differentiable fused tracer (`ops/fused.py`), the coverage engine
(`coverage.py`) and the inverse solver (`solver.py`).
"""
