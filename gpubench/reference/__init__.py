"""The benchmark's plain reference and its frozen copies: plain PyTorch and
numpy, importing nothing of `rfx_torch`, `rfx` or JAX."""
