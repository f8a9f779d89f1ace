"""Distribution over ranks (port of rfx/parallel/dist.py): torch.distributed
in place of shard_map and psum.

- Ray data parallelism: the ray batch splits into contiguous blocks over a
  'rays' axis of ranks, and the scene is replicated. Each rank traces its
  block and bins a partial impulse response normalised by the global ray
  count; one all-reduce over 'rays' sums the partials, so every rank holds
  the whole IR. Monte-Carlo rays never communicate: that all-reduce is the
  only traffic.
- Coverage grid parallelism: a second 'rx' axis splits the receivers. A rank
  computes its receiver tile from its ray block, the all-reduce over 'rays'
  completes the tile, and each rank returns its own tile (the reference's
  output stays sharded over 'rx').

Gradients. jax.grad transposes psum inside shard_map (rfx/parallel/dist.py:
18-19); here two autograd Functions take its place, and every rank must run
the backward, as every rank runs the forward:

- at the exit, `_SumOver` all-reduces in the forward and passes the
  cotangent through unchanged: each rank's replica of the loss is the same
  function of every rank's partial, so it already holds the complete
  dL/dIR (torch.distributed.nn.functional.all_reduce all-reduces the
  cotangent too and would multiply the gradient by the group size);
- at the entry, `_Replicated` is the identity in the forward and, in the
  backward, sums the replicated leaves' cotangents (tx, n1, vertices) over
  the ranks whose work the loss combines, in one all-reduce of their
  concatenation.

`ALL_REDUCE_LOG` records the axis and the shape of the last 1,024
all-reduces this process made, so a test can count a step's collectives
(there is no HLO to read).

Backends (`initialize_multihost`): NCCL where it is present and every rank
has a card of its own, gloo otherwise. NCCL refuses two ranks on one card,
so ranks that share one card run gloo, whose all_reduce takes CUDA tensors
(torch 2.11 on the H100 machine) and stages them through host memory
itself: the port makes no copy of its own.

The mesh is a small class of the port's own, `Mesh`, that holds one process
group per axis. torch's `init_device_mesh` would build the same groups, but
with a CUDA device type it defaults to NCCL and binds rank r to
cuda:(r % device_count), and neither holds for ranks that share one card.

Not ported: the jit cache of rfx/parallel/dist.py:38-60 (JAX machinery;
PyTorch runs eagerly). Multi-GPU scaling is unmeasured: the machine with the
card has one H100, and ranks that share it time-slice its SMs.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from rfx_torch.cir import cir_from_trace
from rfx_torch.coverage import _irs_from_segments
from rfx_torch.device import resolve_device
from rfx_torch.tracer import Scene, trace_env, trace_to_rx
from rfx_torch.utils.logging import get_logger

__all__ = ["initialize_multihost", "make_mesh", "sharded_cir", "sharded_coverage_irs"]

log = get_logger("rfx_torch.parallel")

# (axis, shape) of the last all-reduces this process made, oldest first; clear
# it to count one run. Bounded, so a long run does not grow it.
ALL_REDUCE_LOG: deque[tuple[str, tuple[int, ...]]] = deque(maxlen=1024)


def default_backend(num_processes: int) -> str:
    """NCCL where it is present and this host has a card for each of the
    `num_processes` ranks; gloo otherwise."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dist.is_nccl_available() and cards >= num_processes:
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None, *,
                         backend=None):
    """Join a process group of `num_processes` ranks at
    `coordinator_address` ("host:port"); a no-op for one process. `backend`
    None takes `default_backend`'s rule (for ranks on several hosts, where
    this host cannot see the others' cards, pass it). Where there is a card,
    rank r works on cuda:(r % device_count). Returns the backend's name, or
    None for one process."""
    if num_processes is None or num_processes <= 1:
        return None
    backend = backend or default_backend(num_processes)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    log.info("rank %d of %d: backend %s (nccl available %s, %d cards on this host)",
             process_id, num_processes, backend, dist.is_nccl_available(), cards)
    if cards:
        torch.cuda.set_device(process_id % cards)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return backend


class Mesh:
    """The ranks laid out row-major over named axes.

    `shape`: axis -> size; `coords`: axis -> this rank's index; `group(axis)`:
    the process group of the ranks that differ from this one only along
    `axis`, or the whole world for None (None in a process that belongs to
    no process group); `device`: where this rank computes."""

    def __init__(self, shape: dict, coords: dict, groups: dict, world, device: torch.device):
        self.shape = shape
        self.coords = coords
        self._groups = groups
        self._world = world
        self.device = device

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def group(self, axis: str | None = None):
        return self._world if axis is None else self._groups[axis]

    def block(self, x, axis: str) -> torch.Tensor:
        """This rank's contiguous block of `x`'s first axis along `axis`, on
        the mesh's device."""
        x = torch.as_tensor(x, device=self.device)
        size = x.shape[0] // self.shape[axis]
        return x[self.coords[axis] * size:(self.coords[axis] + 1) * size]

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords}, device={self.device})"


def make_mesh(axes: dict[str, int] | None = None, *, device="cuda") -> Mesh:
    """Lay the world's ranks out over `axes` (default: all on a flat
    ('rays',) axis), row-major in rank order, with one process group per
    axis. Every rank must call it, with the same axes. In a process that
    belongs to no process group the world is this one rank."""
    dev = resolve_device(device)
    joined = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if joined else (1, 0)
    if axes is None:
        axes = {"rays": world}
    shape = {name: int(size) for name, size in axes.items()}
    sizes = list(shape.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh axes {axes} do not cover {world} devices")
    coords = dict(zip(shape, (int(c) for c in np.unravel_index(rank, sizes))))
    groups = dict.fromkeys(shape)
    if joined:
        grid = np.arange(world).reshape(sizes)
        for i, name in enumerate(shape):
            # new_group is collective: every rank creates every group, in one order.
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = group
    return Mesh(shape, coords, groups, dist.group.WORLD if joined else None, dev)


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """The sum of `x` over the group of `axis` (None: the world), a new tensor."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    ALL_REDUCE_LOG.append((axis or "world", tuple(out.shape)))
    return out


class _SumOver(torch.autograd.Function):
    """Sum over an axis, identity backward (the module docstring says why)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward sums the cotangents over an axis in one
    all-reduce of their concatenation."""

    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in gs]), ctx.mesh, ctx.axis)
        parts = flat.split([g.numel() for g in gs])
        return (None, None, *(p.view_as(g) for p, g in zip(parts, gs)))


def sum_over(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """`x` summed over the ranks of `axis` (None: the world); the cotangent
    passes through unchanged. The identity in a one-process world."""
    return x if mesh.group(axis) is None else _SumOver.apply(x, mesh, axis)


def replicated(mesh: Mesh, axis: str | None, *xs):
    """`xs` unchanged; the cotangents of those that require grad are summed
    over `axis` (None: the world) in the backward, in one all-reduce."""
    grads = [i for i, x in enumerate(xs) if torch.is_tensor(x) and x.requires_grad]
    if mesh.group(axis) is None or not grads or not torch.is_grad_enabled():
        return xs
    out = list(xs)
    for i, y in zip(grads, _Replicated.apply(mesh, axis, *(xs[i] for i in grads))):
        out[i] = y
    return tuple(out)


def sharded_cir(scene: Scene, tx_pos, directions, rx_pos, rx_radius, mesh: Mesh, *,
                max_bounces: int, nbins: int, tx_power=1.0, light_speed_mps: float = 2.998e8,
                sample_rate_hz: float = 100e9, n1=5.0, n2=1.0, rx_mode: str = "analytic",
                env_hit=None, active=None, soft: bool = False) -> torch.Tensor:
    """CIR with the ray batch split over mesh axis 'rays'
    (rfx/parallel/dist.py:87-156). `directions` and `active` are global:
    each rank takes its contiguous block, traces it and bins a partial IR
    normalised by the global ray count; the partials are summed over
    'rays', and every rank returns the whole (nbins,) IR. A shard's partial
    sums group differently from one unsharded run (the reference allows
    rtol 1e-5); one rank equals the unsharded path bit for bit."""
    n = directions.shape[0]
    nd = mesh.shape["rays"]
    if n % nd:
        raise ValueError(f"ray count {n} not divisible by {nd} devices")
    dirs = mesh.block(directions, "rays")
    active = None if active is None else mesh.block(active, "rays")
    tx_pos, rx_pos, rx_radius, n1, n2, verts = replicated(
        mesh, "rays", tx_pos, rx_pos, rx_radius, n1, n2, scene.vertices)
    result = trace_to_rx(Scene(verts, scene.faces), tx_pos, dirs, rx_pos, rx_radius,
                         max_bounces=max_bounces, n1=n1, n2=n2, rx_mode=rx_mode,
                         env_hit=env_hit, active=active)
    ir = cir_from_trace(result, tx_power=tx_power, num_rays=n, nbins=nbins,
                        light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                        soft=soft)
    return sum_over(ir, mesh, "rays")


def sharded_coverage_irs(scene: Scene, tx_pos, directions, rx_centers, rx_radius, mesh: Mesh, *,
                         max_bounces: int, nbins: int, tx_power=1.0,
                         light_speed_mps: float = 2.998e8, sample_rate_hz: float = 100e9,
                         n1=5.0, n2=1.0, env_hit=None, rx_batch: int = 8,
                         engine: str = "map") -> torch.Tensor:
    """Coverage IRs on a ('rays', 'rx') mesh (rfx/parallel/dist.py:159-237).
    Each rank traces its block of the global `directions` once, builds the
    IRs of its tile of the global `rx_centers` from the shared segments, and
    the partial tiles are summed over 'rays'. Returns this rank's
    (M / rx, nbins) tile, hard-binned.

    engine: 'map' (the map engine, receivers `rx_batch` at a time through
    the IR histogram) or 'batched' (the coverage kernel on amplitudes scaled
    by tx_power / the global ray count, rfx/parallel/dist.py:206-214).

    Gradients: the tile differentiates as this rank's function of the
    replicated leaves (their cotangents summed over 'rays'). A loss that
    combines the tiles over 'rx' needs its leaves' cotangents summed over
    every rank instead, as make_inverse_solver(mesh=) does."""
    n, m = directions.shape[0], rx_centers.shape[0]
    if n % mesh.shape["rays"]:
        raise ValueError("ray count not divisible over 'rays' axis")
    if m % mesh.shape["rx"]:
        raise ValueError("receiver count not divisible over 'rx' axis")
    tx_pos, rx_radius, n1, n2, verts = replicated(
        mesh, "rays", tx_pos, rx_radius, n1, n2, scene.vertices)
    segs = trace_env(Scene(verts, scene.faces), tx_pos, mesh.block(directions, "rays"),
                     max_bounces=max_bounces, n1=n1, n2=n2, env_hit=env_hit)
    irs = _irs_from_segments(segs, mesh.block(rx_centers, "rx"), rx_radius, nbins=nbins,
                             num_rays=n, light_speed_mps=light_speed_mps,
                             sample_rate_hz=sample_rate_hz, tx_power=tx_power,
                             rx_batch=rx_batch, soft=False, rx_mode="analytic", engine=engine)
    return sum_over(irs, mesh, "rays")
