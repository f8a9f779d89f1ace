"""Micro-benchmark of a warp's node test (port of scripts/micro_reduce.py).

`micro_vote(x, steps, style)` repeats a node-test body `steps` times on an
(8, 128) f32 tile: 8 masks `(x + carry + k) > 0.5`, reduced to 8 any-flags,
`s` the count of flags that are set, `carry += s * 1e-9` in f32; it returns
the final carry as a 0-dim tensor. On a CUDA tensor it launches
rfx_torch/csrc/micro_vote.cu (one warp, the reduction by warp votes; that
file says how the tile is laid over the warp); on a CPU tensor it runs the
plain version `micro_vote_plain`, a Python loop over the steps on the whole
tile. Styles:

- `votes`: 8 any-reduces (the TPU kernel's `reduces`);
- `ballotfold`: the masks packed into 8 bits per element and one OR fold
  (its `rollfold`);
- `sumpack`: two masks per integer sum, in 16-bit count fields;
- `novec`: the baseline without a reduction, `s = sum_k m_k[0, 0] * 0.0`,
  so s is 0 and the carry stays 0, as in the reference.

`votes`, `ballotfold` and `sumpack` give the same s, hence the same carry.
Time one launch with CUDA events (scripts/torch_micro_vote.py): ns per body
is the time over `steps`.
"""

from __future__ import annotations

import torch

from rfx_torch.ops._build import CudaKernel, F, I, P

__all__ = ["MICRO_VOTE_KERNEL", "STYLES", "TILE", "FLAGS", "micro_vote", "micro_vote_plain"]

MICRO_VOTE_KERNEL = CudaKernel("micro_vote.cu", "rfx_micro_vote", [P, I, I, F, P, P])

STYLES = ("votes", "ballotfold", "sumpack", "novec")  # the kernel's style numbers, in order
TILE = (8, 128)
FLAGS = 8


def _check(x, steps, style):
    if tuple(x.shape) != TILE or x.dtype != torch.float32:
        raise ValueError(f"x must be a float32 tile of shape {TILE}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if style not in STYLES:
        raise ValueError(f"unknown style {style!r}: one of {STYLES}")
    if not 0 <= int(steps) < 2**31:
        raise ValueError(f"steps must be in [0, 2^31), got {steps}")


def micro_vote_plain(x: torch.Tensor, steps: int, style: str = "votes") -> torch.Tensor:
    """Plain PyTorch version: the reference's body, step by step, on the whole
    tile; the final carry as a 0-dim f32 tensor on x's device."""
    _check(x, steps, style)
    dev = x.device
    f32 = torch.float32
    ks = torch.arange(FLAGS, dtype=f32, device=dev).view(FLAGS, 1, 1)
    shifts = torch.arange(FLAGS, dtype=torch.int32, device=dev)
    scale = torch.tensor(1e-9, dtype=f32, device=dev)
    carry = torch.zeros((), dtype=f32, device=dev)
    for _ in range(int(steps)):
        masks = ((x[None] + carry) + ks) > 0.5  # (FLAGS, 8, 128)
        if style == "votes":
            s = masks.flatten(1).any(dim=1).to(f32).sum()
        elif style == "ballotfold":
            bits = (masks.to(torch.int32) << shifts.view(FLAGS, 1, 1)).sum(dim=0)
            folded = ((bits.flatten()[:, None] >> shifts[None, :]) & 1).amax(dim=0)  # OR fold
            s = folded.to(f32).sum()
        elif style == "sumpack":
            pairs = masks.to(torch.int32).view(FLAGS // 2, 2, -1)
            tot = (pairs[:, 0] + pairs[:, 1] * (1 << 16)).sum(dim=1)
            s = ((tot & 0xFFFF) > 0).to(f32).sum() + ((tot >> 16) > 0).to(f32).sum()
        else:
            s = (masks[:, 0, 0].to(f32) * 0.0).sum()
        carry = carry + s * scale
    return carry


def micro_vote(x: torch.Tensor, steps: int, style: str = "votes") -> torch.Tensor:
    """The final carry of `steps` bodies on the tile `x`, a 0-dim f32 tensor.
    A CPU tensor runs `micro_vote_plain`; a CUDA tensor launches the kernel,
    or raises."""
    _check(x, steps, style)
    dev = x.device
    if dev.type == "cpu":
        return micro_vote_plain(x, steps, style)
    if dev.type != "cuda":
        raise ValueError(f"no micro_vote for device {dev}")
    x = x.contiguous()
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        MICRO_VOTE_KERNEL.launch(x.data_ptr(), int(steps), STYLES.index(style), 0.0,
                                 out.data_ptr(), stream)
    return out
