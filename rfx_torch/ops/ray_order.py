"""Direction-cell order of a batch of rays, for the fused trace to walk.

`ray_order(directions)` sorts the ray indices by the cell of each direction
on an octahedral lattice of 2^bits x 2^bits cells, the cell numbers in
Morton order: the fused trace (rfx_torch/ops/fused.py) walks its rays in that
order, so the 32 rays of a warp leave the transmitter inside one small cone
whatever order the caller drew them in. On a CUDA tensor it is a counting
sort on the card (rfx_torch/csrc/ray_order.cu: a histogram of the cells, a
scan, a scatter of int32 indices; the order of the rays inside one cell may
change from run to run); on a CPU tensor its plain version, a stable sort by
the same keys (`ray_order_plain`). Both return a `RayOrder`: the (N,) int32
permutation `order` (the rays cell by cell), its inverse `rank` (each ray's
place in it, order[rank[i]] == i), each ray's (N,) int32 cell key, and the
(4^bits,) int32 rays in each cell.

The key of a direction (x, y, z): u = x / s, v = y / s with s = |x| + |y| +
|z|; where z < 0 the lower hemisphere is folded out, (u, v) = ((1 - |v|)
sign u, (1 - |u|) sign v) with sign 0 = +1; each of u, v goes to the column
trunc((u + 1) 2^(bits-1)), clamped to the lattice (0 for NaN); the key
interleaves the two columns, u in the even bits. No transcendental function,
so the kernel's keys, built without contraction, are the plain version's
bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rfx_torch.ops._build import CudaKernel, I, P
from rfx_torch.sampler import _spread16

__all__ = ["RAY_ORDER_KERNEL", "RayOrder", "MIN_BITS", "MAX_BITS", "RAYS_PER_CELL", "cell_bits",
           "cell_keys_plain", "ray_order_plain", "ray_order"]

RAY_ORDER_KERNEL = CudaKernel("ray_order.cu", "rfx_ray_order", [P, I, I, P, P, P, P])

#: The lattice's range: 2^6 to 2^10 columns a side. The kernel's scan runs in
#: one block and takes runs of 128 cells a warp, so it needs at least 4,096
#: cells; above 2^20 cells the one block's scan costs more than it orders.
MIN_BITS, MAX_BITS = 6, 10
#: `cell_bits` takes the finest lattice whose cells hold at least this many
#: rays on average. Measured on an NVIDIA H100 80GB HBM3 (700 W;
#: scripts/torch_bench_kernels.py --only order) at 5,242,880 i.i.d. rays,
#: sort, walk and put-back together on the bench / 1,045,458-triangle
#: terrain: 1.39 / 2.01 ms at 6 bits, 1.16 / 1.79 at 7, 1.13-1.14 / 1.71-1.72
#: at 8 (80 rays a cell, what this rule takes), 1.14-1.15 / 1.83 at 9, 1.32 /
#: 1.92 at 10: a finer lattice walks faster, and sorts and puts back slower.
RAYS_PER_CELL = 64


class RayOrder(NamedTuple):
    order: torch.Tensor  # (N,) int32: the rays cell by cell
    rank: torch.Tensor  # (N,) int32: each ray's place in `order`
    keys: torch.Tensor  # (N,) int32: each ray's cell
    counts: torch.Tensor  # (4^bits,) int32: the rays in each cell


def cell_bits(n: int) -> int:
    """The lattice for n rays: the largest bits in [MIN_BITS, MAX_BITS] with
    4^bits * RAYS_PER_CELL <= n."""
    bits = max(int(n) // RAYS_PER_CELL, 1).bit_length() - 1
    return max(MIN_BITS, min(MAX_BITS, bits // 2))


def _column(u: torch.Tensor, bits: int) -> torch.Tensor:
    res = 1 << bits
    t = (u + 1.0) * float(res >> 1)
    return torch.where(t >= 0.0, torch.clamp_max(t, res - 1), torch.zeros_like(t)).to(torch.int64)


def cell_keys_plain(directions: torch.Tensor, bits: int) -> torch.Tensor:
    """(N,) int32 cell key of each of the (N, 3) f32 directions: the kernel's
    arithmetic, operation for operation."""
    x, y, z = directions[:, 0], directions[:, 1], directions[:, 2]
    s = x.abs() + y.abs() + z.abs()
    u, v = x / s, y / s
    fu, fv = 1.0 - v.abs(), 1.0 - u.abs()
    fold = z < 0.0
    u, v = (torch.where(fold, torch.where(u >= 0.0, fu, -fu), u),
            torch.where(fold, torch.where(v >= 0.0, fv, -fv), v))
    return (_spread16(_column(u, bits)) | (_spread16(_column(v, bits)) << 1)).to(torch.int32)


def ray_order_plain(directions: torch.Tensor, bits: int) -> RayOrder:
    """The RayOrder of a stable sort of the plain keys."""
    keys = cell_keys_plain(directions, bits)
    order = torch.argsort(keys, stable=True).to(torch.int32)
    rank = torch.empty_like(order)
    rank[order.long()] = torch.arange(order.numel(), dtype=torch.int32, device=order.device)
    counts = torch.bincount(keys, minlength=1 << (2 * bits)).to(torch.int32)
    return RayOrder(order, rank, keys, counts)


def ray_order(directions: torch.Tensor, bits: int | None = None) -> RayOrder:
    """The RayOrder of (N, 3) f32 directions on the lattice of `bits`
    (default `cell_bits(N)`): the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if directions.ndim != 2 or directions.shape[1] != 3:
        raise ValueError(f"directions must be (N, 3), got {tuple(directions.shape)}")
    if directions.dtype != torch.float32:
        raise TypeError("directions must be float32")
    n = directions.shape[0]
    bits = cell_bits(n) if bits is None else int(bits)
    if not MIN_BITS <= bits <= MAX_BITS:
        raise ValueError(f"bits must lie in [{MIN_BITS}, {MAX_BITS}], got {bits}")
    dev = directions.device
    if dev.type == "cpu":
        return ray_order_plain(directions, bits)
    if dev.type != "cuda":
        raise ValueError(f"no ray order for device {dev}")
    if n >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rays, got {n}")
    cells = 1 << (2 * bits)
    d = directions.contiguous()
    # start, counts, the done counter and 3 unused, keys, places (rfx_ray_order).
    work = torch.empty(2 * cells + 4 + 2 * n, dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            RAY_ORDER_KERNEL.launch(d.data_ptr(), n, bits, work.data_ptr(), order.data_ptr(),
                                    rank.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    keys = work[2 * cells + 4:2 * cells + 4 + n]
    return RayOrder(order, rank, keys, work[cells:2 * cells])
