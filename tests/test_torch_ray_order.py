"""The direction-cell order's plain version (rfx_torch.ops.ray_order, what a
CPU tensor runs): the keys of known directions, the order as a permutation
with its counts per cell, and the plain fused trace walked in that order
against the caller's, bit for bit. The kernels themselves are held against
this plain version in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rfx_torch.geometry import make_terrain
from rfx_torch.ops import fused, ray_order
from rfx_torch.sampler import sphere_directions
from rfx_torch.utils import profiling

torch.set_num_threads(1)


def _iid(n, seed=0):
    return sphere_directions(n, generator=torch.Generator().manual_seed(seed), device="cpu")


def _key(iu, iv):
    """The Morton key of columns (iu, iv), bit by bit."""
    return sum(((iu >> b) & 1) << (2 * b) | ((iv >> b) & 1) << (2 * b + 1) for b in range(10))


@pytest.mark.parametrize("bits", [6, 8, 10])
def test_keys_of_the_poles_and_the_axes(bits):
    """(u, v) is (0, 0) at the upper pole, the far corner (1, 1) at the lower
    one, and an edge's midpoint on each horizontal axis; a column is
    trunc((u + 1) 2^(bits-1)), the last one where u = 1."""
    res, mid = 1 << bits, 1 << (bits - 1)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
                      [0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 0.0]])
    want = [_key(mid, mid), _key(res - 1, res - 1), _key(res - 1, mid), _key(0, mid),
            _key(mid, res - 1), _key(mid, 0), 0]  # a zero direction: NaN, column 0
    assert ray_order.cell_keys_plain(d, bits).tolist() == want


def test_keys_are_continuous_across_the_fold_at_the_horizon():
    """Just above and just below z = 0 a direction keeps its cell: the folded
    lower hemisphere meets the upper one at its edge."""
    phi = torch.linspace(0.05, 2 * np.pi - 0.05, 41)
    for sign in (1.0, -1.0):
        up = torch.stack([torch.cos(phi), torch.sin(phi), torch.full_like(phi, 1e-7)], dim=1)
        down = up * torch.tensor([1.0, 1.0, -1.0])
        a, b = ray_order.cell_keys_plain(up * sign, 8), ray_order.cell_keys_plain(down * sign, 8)
        # An azimuth whose u sits within a rounding of a column's edge may
        # round into the neighbour; these 41 do not.
        assert torch.equal(a, b)


def test_keys_of_the_lower_hemisphere_mirror_the_upper_one_folded():
    """A direction below the horizon takes the cell of the folded point:
    (x, y, -z) maps to ((1 - |v|) sign u, (1 - |u|) sign v) of (x, y, z)."""
    d = torch.tensor([[0.2, 0.3, 0.5], [-0.4, 0.1, 0.5], [-0.25, -0.25, 0.5], [0.3, -0.1, 0.6]])
    s = d[:, 0].abs() + d[:, 1].abs() + d[:, 2].abs()
    u, v = d[:, 0] / s, d[:, 1] / s
    fu, fv = (1 - v.abs()) * torch.sign(u), (1 - u.abs()) * torch.sign(v)
    cols = lambda a: ((a + 1) * 128).to(torch.int64).tolist()  # noqa: E731
    want = [_key(iu, iv) for iu, iv in zip(cols(fu), cols(fv))]
    below = d * torch.tensor([1.0, 1.0, -1.0])
    assert ray_order.cell_keys_plain(below, 8).tolist() == want


@pytest.mark.parametrize("bits", [6, 7, 9])
def test_order_is_a_permutation_by_cell_with_its_counts(bits):
    d = _iid(3001, seed=bits)
    order, rank, keys, counts = ray_order.ray_order(d, bits)
    assert order.dtype == rank.dtype == keys.dtype == counts.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(3001, dtype=torch.int32))
    assert torch.equal(order[rank.long()], torch.arange(3001, dtype=torch.int32))
    walked = keys[order.long()]
    assert bool((walked[1:] >= walked[:-1]).all())
    cells, n = np.unique(keys.numpy(), return_counts=True)
    want = np.zeros(1 << (2 * bits), dtype=np.int32)
    want[cells] = n
    assert np.array_equal(counts.numpy(), want) and int(counts.sum()) == 3001
    assert int(keys.max()) < 1 << (2 * bits) and int(keys.min()) >= 0
    # Within a cell the plain order keeps the caller's (a stable sort).
    same = walked[1:] == walked[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())


def test_cells_are_small_cones():
    """Rays that share a cell point within a few cell widths of each other."""
    d = _iid(20000, seed=3)
    order, _, keys, _ = ray_order.ray_order(d, 8)
    ds, ks = d[order.long()], keys[order.long()]
    same = ks[1:] == ks[:-1]
    cos = (ds[1:] * ds[:-1]).sum(dim=1)[same]
    assert int(same.sum()) > 1000 and float(cos.min()) > np.cos(4 * np.pi / 256)


def test_lattice_follows_the_ray_count():
    assert ray_order.cell_bits(5_242_880) == 8
    assert ray_order.cell_bits(1_048_576) == 7
    assert ray_order.cell_bits(64 * 4**9) == 9
    assert ray_order.cell_bits(1 << 40) == ray_order.MAX_BITS
    assert ray_order.cell_bits(1000) == ray_order.cell_bits(0) == ray_order.MIN_BITS


def test_ray_order_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ray_order.ray_order(torch.zeros(4, 2), 6)
    with pytest.raises(TypeError):
        ray_order.ray_order(torch.zeros(4, 3, dtype=torch.float64), 6)
    for bits in (ray_order.MIN_BITS - 1, ray_order.MAX_BITS + 1):
        with pytest.raises(ValueError):
            ray_order.ray_order(torch.zeros(4, 3), bits)
    order, rank, keys, counts = ray_order.ray_order(torch.zeros((0, 3)), 6)
    assert order.shape == rank.shape == keys.shape == (0,) and int(counts.sum()) == 0


@pytest.mark.parametrize("record_faces", [False, True], ids=["trace", "faces"])
def test_plain_trace_in_cell_order_equals_caller_order(record_faces):
    """The plain fused trace of the rays in cell order, each output put back
    at its ray's index, is the trace in the caller's order bit for bit: a
    ray's trace depends on nothing but its own direction."""
    ft = fused.make_fused_tracer(make_terrain(grid=16, extent=30.0, seed=3), max_bounces=3,
                                 device="cpu")
    d = _iid(2048, seed=4)
    args = ([2.0, 1.0, 9.0], [-5.0, 2.0, 6.0], 1.0)
    order = ray_order.ray_order(d).order.long()
    assert not torch.equal(order, torch.arange(2048))
    caller = fused.fused_trace_plain(ft.bvh, d, *args, max_bounces=3, record_faces=record_faces)
    walked = fused.fused_trace_plain(ft.bvh, d[order].contiguous(), *args, max_bounces=3,
                                     record_faces=record_faces)
    if record_faces:
        (caller, caller_faces), (walked, walked_faces) = caller, walked
        back = torch.empty_like(walked_faces)
        back[:, order] = walked_faces
        assert torch.equal(back, caller_faces)
    assert int(caller.captured.sum()) > 0
    for a, b in zip(caller[:4], walked[:4]):
        back = torch.empty_like(b)
        back[order] = b
        assert torch.equal(back, a)


def test_a_cpu_trace_launches_no_order_and_counts_no_rays():
    """On a CPU tensor the fused trace runs its plain version: no ordering
    kernel, and the ray tallies stay where they were under a profiler."""
    ft = fused.make_fused_tracer(make_terrain(grid=12, extent=24.0, seed=9), max_bounces=2,
                                 device="cpu")
    before = (ray_order.RAY_ORDER_KERNEL.launches, profiling.counters())
    with profile(activities=[ProfilerActivity.CPU]):
        ft(_iid(300), [1.0, -2.0, 7.0], [-4.0, 3.0, 5.0], 1.5)
    after = (ray_order.RAY_ORDER_KERNEL.launches, profiling.counters())
    assert after[0] == before[0]
    assert [after[1][k] - before[1][k] for k in ("rays_fused", "rays_ordered")] == [0, 0]


def test_tally_counts_only_while_a_profiler_records():
    before = profiling.counters()["rays_ordered"]
    profiling.tally("rays_ordered", 5)
    assert profiling.counters()["rays_ordered"] == before
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.tally("rays_ordered", 5)
    assert profiling.counters()["rays_ordered"] == before + 5
