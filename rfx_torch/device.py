"""Explicit device selection: nothing falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`torch.device` for `device`, which must be a CUDA or CPU device.

    Raises RuntimeError for a CUDA device when no card is present: CPU runs
    (the tests) pass `device="cpu"` themselves."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"rfx_torch runs on 'cuda' or 'cpu', not {dev.type!r}")
    return dev
