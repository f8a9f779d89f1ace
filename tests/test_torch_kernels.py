"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and nvcc and skips elsewhere. On a machine
with a card, and without JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(`--noconftest`: tests/conftest.py configures JAX for the other test files;
this file imports neither JAX nor the JAX package).
"""

import numpy as np
import pytest
import torch

from rfx_torch import cir, coverage
from rfx_torch.api import Tracer
from rfx_torch.geometry import make_room, make_terrain
from rfx_torch import tracer
from rfx_torch.ops import (bvh_trace, bvh_traverse, coverage_hist, fused, intersect, map_capture,
                           micro_vote, ray_order)
from rfx_torch.sampler import morton_sphere_directions, sphere_directions
from rfx_torch.tracer import EnvSegments, Scene, trace_env, trace_to_rx
from rfx_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_trace_equal(k, p):
    """tests/test_fused.py's bar: identical masks and bounce counts."""
    m = p.captured
    assert torch.equal(k.captured, p.captured)
    assert torch.equal(k.num_bounces, p.num_bounces)
    assert torch.allclose(k.amplitude[m], p.amplitude[m], rtol=2e-5, atol=1e-7)
    assert torch.allclose(k.distance[m], p.distance[m], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [1, 1000, 65_536, 65_536 + 7, 300_007])
def test_fused_kernel_matches_plain(cuda, n):
    """Ray counts below one warp, ragged against a warp and a block, and
    (300,007) above what the card holds at once: more blocks than are
    resident."""
    ft = fused.make_fused_tracer(make_terrain(grid=48, extent=40.0, seed=3), max_bounces=4,
                                 device=cuda)
    dirs = morton_sphere_directions(n, generator=torch.Generator(cuda).manual_seed(4),
                                    device=cuda)
    args = ([2.0, 1.0, 12.0], [-5.0, 2.0, 6.0], 2.0)
    before = fused.FUSED_TRACE_KERNEL.launches
    k = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4)
    assert fused.FUSED_TRACE_KERNEL.launches == before + 1
    p = fused.fused_trace_plain(ft.bvh, dirs, *args, max_bounces=4)
    torch.cuda.synchronize()
    if n >= 1000:
        assert int(p.captured.sum()) > 0
    _assert_trace_equal(k, p)
    again = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4)
    for a, b in zip(k[:4], again[:4]):  # the same bits from run to run
        assert torch.equal(a, b)


def test_fused_kernel_materials_and_grazing_scene(cuda):
    """n1/n2 reach the kernel's Fresnel; a low transmitter makes grazing rays."""
    ft = fused.make_fused_tracer(make_terrain(grid=16, extent=30.0, seed=3), max_bounces=3,
                                 device=cuda)
    dirs = morton_sphere_directions(20_000, generator=torch.Generator(cuda).manual_seed(1),
                                    device=cuda)
    args = ([2.0, 1.0, 4.0], [-5.0, 2.0, 3.0], 2.5, 3.0, 1.2)
    k = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=3)
    p = fused.fused_trace_plain(ft.bvh, dirs, *args, max_bounces=3)
    torch.cuda.synchronize()
    assert int(p.captured.sum()) > 0
    _assert_trace_equal(k, p)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_histogram_kernel_matches_plain_and_is_deterministic(cuda, soft):
    g = np.random.default_rng(17)
    n = 300_000
    amp = torch.from_numpy(g.random(n).astype(np.float32)).to(cuda)
    dist = torch.from_numpy((g.random(n) * 70.0).astype(np.float32)).to(cuda)
    cap = torch.from_numpy(g.random(n) < 0.3).to(cuda)
    kw = dict(nbins=20_000, light_speed_mps=2.998e8, sample_rate_hz=100e9)
    modes = (cir.SOFT_LO, cir.SOFT_HI) if soft else (cir.HARD,)
    before = cir.HISTOGRAM_KERNEL.launches
    a = cir.bin_impulse_response(amp, dist, cap, soft=soft, **kw)
    b = cir.bin_impulse_response(amp, dist, cap, soft=soft, **kw)
    assert cir.HISTOGRAM_KERNEL.launches == before + 2  # one launch a call, both soft halves
    p = sum(cir.histogram_plain(amp, dist, cap, mode=m, **kw) for m in modes)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a != 0, p != 0)
    assert torch.allclose(a, p, rtol=1e-5, atol=1e-5)
    # The same inputs from an address that is no multiple of 16.
    c = cir.bin_impulse_response(amp[3:], dist[3:], cap[3:], soft=soft, **kw)
    pc = sum(cir.histogram_plain(amp[3:], dist[3:], cap[3:], mode=m, **kw) for m in modes)
    assert torch.equal(c != 0, pc != 0) and torch.allclose(c, pc, rtol=1e-5, atol=1e-5)


def _rows_on_card(cuda, n=100_003, seed=19):
    """(7, n) rows, n no multiple of 16: dense, sparse (under 2,048
    captures), empty, a twentieth, every path, a fiftieth, and half; row 4's
    paths all fall into one bin."""
    g = np.random.default_rng(seed)
    share = np.array([0.3, 0.001, 0.0, 0.05, 1.0, 0.02, 0.5])[:, None]
    amp = torch.from_numpy(g.random((7, n)).astype(np.float32)).to(cuda)
    dist = torch.from_numpy((g.random((7, n)) * 70.0).astype(np.float32))
    dist[4] = 31.0
    cap = torch.from_numpy(g.random((7, n)) < share).to(cuda)
    return amp, dist.to(cuda), cap


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_batched_histogram_kernel_matches_plain(cuda, soft):
    """One launch for (7, n) rows of every density: equal to the plain
    version, bit-identical from run to run, each row the same bits alone; a
    row of at most 2,048 captures is the ray-order sum, as on the CPU."""
    amp, dist, cap = _rows_on_card(cuda)
    kw = dict(nbins=20_000, light_speed_mps=2.998e8, sample_rate_hz=100e9)
    modes = (cir.SOFT_LO, cir.SOFT_HI) if soft else (cir.HARD,)
    before = cir.HISTOGRAM_KERNEL.launches
    a = cir.bin_impulse_response(amp, dist, cap, soft=soft, **kw)
    b = cir.bin_impulse_response(amp, dist, cap, soft=soft, **kw)
    assert cir.HISTOGRAM_KERNEL.launches == before + 2
    p = sum(cir.histogram_plain(amp, dist, cap, mode=m, **kw) for m in modes)
    torch.cuda.synchronize()
    assert a.shape == (7, 20_000) and torch.equal(a, b)
    assert torch.equal(a != 0, p != 0)
    spread = [0, 1, 2, 3, 5, 6]
    assert torch.allclose(a[spread], p[spread], rtol=1e-5, atol=1e-5)
    # Row 4 piles 100,003 paths into one bin (two in soft mode). The plain
    # version adds them with float atomics in no fixed order, which alone
    # costs about 1e-5 of the sum: hold the kernel against the sum in float64
    # of the same float32 weights.
    assert not a[2].any() and int((a[4] != 0).sum()) == len(modes)
    delay = dist[4] / torch.tensor(2.998e8, device=cuda) * torch.tensor(100e9, device=cuda)
    frac = delay - torch.floor(delay)
    weights = [amp[4]] if not soft else [amp[4] * (1.0 - frac), amp[4] * frac]
    want = torch.stack([w.double().sum() for w in weights])
    torch.testing.assert_close(a[4][a[4] != 0].double(), want, rtol=1e-5, atol=0)
    torch.testing.assert_close(p[4][p[4] != 0].double(), want, rtol=1e-4, atol=0)
    for r in range(7):
        alone = cir.bin_impulse_response(amp[r], dist[r], cap[r], soft=soft, **kw)
        assert torch.equal(alone, a[r]), r
    assert 0 < int(cap[1].sum()) <= 2048
    on_cpu = sum(cir.histogram_plain(amp[1].cpu(), dist[1].cpu(), cap[1].cpu(), mode=m, **kw)
                 for m in modes)
    assert torch.equal(a[1].cpu(), on_cpu)


def test_histogram_kernel_reads_any_nonzero_byte(cuda):
    """A bool tensor may hold any nonzero byte (a reinterpreted uint8)."""
    g = np.random.default_rng(20)
    n = 50_001
    amp = torch.from_numpy(g.random(n).astype(np.float32)).to(cuda)
    dist = torch.from_numpy((g.random(n) * 60.0).astype(np.float32)).to(cuda)
    raw = torch.from_numpy(g.integers(1, 256, n).astype(np.uint8) * (g.random(n) < 0.1)).to(cuda)
    kw = dict(nbins=20_000, light_speed_mps=2.998e8, sample_rate_hz=100e9)
    a = cir.bin_impulse_response(amp, dist, raw.view(torch.bool), **kw)
    p = cir.histogram_plain(amp, dist, raw != 0, **kw)
    torch.cuda.synchronize()
    assert int((raw > 1).sum()) > 1000
    assert torch.equal(a != 0, p != 0) and torch.allclose(a, p, rtol=1e-5, atol=1e-5)


def test_histogram_kernel_edges(cuda):
    empty = torch.zeros(0, device=cuda)
    ir = cir.bin_impulse_response(empty, empty, empty.bool(), nbins=100, light_speed_mps=1.0,
                                  sample_rate_hz=1.0)
    torch.cuda.synchronize()
    assert torch.equal(ir, torch.zeros(100, device=cuda))
    none = cir.bin_impulse_response(empty.reshape(0, 5), empty.reshape(0, 5),
                                    empty.bool().reshape(0, 5), nbins=100, light_speed_mps=1.0,
                                    sample_rate_hz=1.0)
    assert none.shape == (0, 100)
    # The histograms live in global memory: a million bins run, and equal plain.
    g = np.random.default_rng(22)
    n = 300_000
    amp = torch.from_numpy(g.random(n).astype(np.float32)).to(cuda)
    dist = torch.from_numpy((g.random(n) * 70.0).astype(np.float32)).to(cuda)
    cap = torch.from_numpy(g.random(n) < 0.3).to(cuda)
    kw = dict(nbins=1_000_000, light_speed_mps=2.998e8, sample_rate_hz=4e12)
    big = cir.bin_impulse_response(amp, dist, cap, **kw)
    big_p = cir.histogram_plain(amp, dist, cap, **kw)
    torch.cuda.synchronize()
    assert torch.equal(big != 0, big_p != 0) and int((big != 0).sum()) > 50_000
    assert torch.allclose(big, big_p, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="bins"):
        cir.bin_impulse_response(amp, dist, cap, nbins=2**31, light_speed_mps=1.0,
                                 sample_rate_hz=1.0)


def test_facade_on_card_matches_cpu(cuda):
    mesh = make_terrain(grid=48, extent=40.0, seed=3)
    dirs = morton_sphere_directions(100_000, generator=torch.Generator().manual_seed(2),
                                    device="cpu")
    kw = dict(max_bounces=3, tx_num_rays=100_000)
    req = ([2.0, 1.0, 12.0], 1.0, [-5.0, 2.0, 6.0], 2.0)
    _, ir_cpu = Tracer(mesh, device="cpu", **kw).compute_cir(*req, directions=dirs,
                                                            record_paths=False)
    _, ir_gpu = Tracer(mesh, device=cuda, **kw).compute_cir(*req, directions=dirs,
                                                           record_paths=False)
    assert ir_cpu.sum() > 0
    np.testing.assert_array_equal(ir_gpu != 0, ir_cpu != 0)
    np.testing.assert_allclose(ir_gpu, ir_cpu, rtol=1e-4, atol=1e-9)


def _query_sets(cuda, bvh, n):
    """Rays from a transmitter, their reflected second-bounce queries from
    the terrain, and parked rays (|o| = 1e9)."""
    d = morton_sphere_directions(n, generator=torch.Generator(cuda).manual_seed(9), device=cuda)
    o = torch.tensor([2.0, 1.0, 12.0], device=cuda).expand(n, 3).contiguous()
    t, _, _, nrm = bvh_trace.closest_hit_plain(bvh, o, d)
    hit = t < 1e29
    o2 = (o + d * t[:, None])[hit]
    d2 = (d - 2.0 * intersect.dot3(d, nrm)[:, None] * nrm)[hit]
    parked = torch.full((1024, 3), 1e9, device=cuda)
    return {"tx": (o, d), "bounce2": (o2.contiguous(), d2.contiguous()),
            "parked": (parked, d[:1024].contiguous())}


@pytest.mark.parametrize("live", [False, True], ids=["packed", "live_tri"])
def test_closest_hit_kernel_matches_plain(cuda, live):
    mesh = make_terrain(grid=48, extent=40.0, seed=3)
    env = bvh_trace.make_kernel_env_hit(mesh, device=cuda)
    bvh = env.bvh
    tri = None
    if live:
        v0, e1, e2, _ = intersect.mesh_soa(torch.as_tensor(mesh.vertices, device=cuda),
                                           torch.as_tensor(mesh.faces, device=cuda))
        tri = bvh_trace.live_tri(bvh, v0, e1, e2)
    for name, (o, d) in _query_sets(cuda, bvh, 20_000).items():
        before = bvh_trace.CLOSEST_HIT_KERNEL.launches
        k = bvh_trace.closest_hit(bvh, o, d, tri)
        assert bvh_trace.CLOSEST_HIT_KERNEL.launches == before + 1
        p = bvh_trace.closest_hit_plain(bvh, o, d, tri)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            assert torch.equal(a, b), name
        if name == "parked":
            assert (k[1] == -1).all()
        else:
            assert int((k[1] >= 0).sum()) > 0, name


def test_counted_closest_hit_kernel_matches_plain_walk(cuda):
    """The counted entry point: the uncounted kernel's hits, and per query the
    plain walk's nodes, leaves and triangles, integer for integer."""
    mesh = make_terrain(grid=48, extent=40.0, seed=3)
    bvh = bvh_trace.make_kernel_env_hit(mesh, device=cuda).bvh
    for name, (o, d) in _query_sets(cuda, bvh, 20_000).items():
        before = (bvh_trace.CLOSEST_HIT_COUNTED_KERNEL.launches,
                  bvh_trace.CLOSEST_HIT_KERNEL.launches)
        *k, counts = bvh_trace.closest_hit(bvh, o, d, count=True)
        assert (bvh_trace.CLOSEST_HIT_COUNTED_KERNEL.launches,
                bvh_trace.CLOSEST_HIT_KERNEL.launches) == (before[0] + 1, before[1])
        u = bvh_trace.closest_hit(bvh, o, d)
        t, idx, walk = bvh_traverse.walk_closest_hit(bvh, o, d, count=True)
        torch.cuda.synchronize()
        for a, b in zip(k, u):
            assert torch.equal(a, b), name
        assert counts.dtype == torch.int64 and counts.shape == (o.shape[0], 3)
        assert torch.equal(counts, walk), (name, counts.sum(0).tolist(), walk.sum(0).tolist())
        assert torch.equal(t, k[0]) and torch.equal(idx.int(), k[1]), name
        assert bool((counts[:, 0] >= 1).all())  # every query visits the root
        if name == "parked":
            assert int(counts.sum()) == o.shape[0]  # and a parked one nothing else


def test_fused_record_faces_kernel_matches_plain(cuda):
    ft = fused.make_fused_tracer(make_terrain(grid=48, extent=40.0, seed=3), max_bounces=4,
                                 device=cuda)
    dirs = morton_sphere_directions(65_536, generator=torch.Generator(cuda).manual_seed(4),
                                    device=cuda)
    args = ([2.0, 1.0, 12.0], [-5.0, 2.0, 6.0], 2.0)
    k, kf = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4, record_faces=True)
    p, pf = fused.fused_trace_plain(ft.bvh, dirs, *args, max_bounces=4, record_faces=True)
    plain = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4)
    torch.cuda.synchronize()
    assert kf.shape == (4, 65_536) and torch.equal(kf, pf)
    assert torch.equal((kf >= 0).sum(0).int(), k.num_bounces)
    _assert_trace_equal(k, p)
    for a, b in zip(k[:4], plain[:4]):  # the record leaves the trace as it was
        assert torch.equal(a, b)


def _iid(n, cuda, seed=11):
    return sphere_directions(n, generator=torch.Generator(cuda).manual_seed(seed), device=cuda)


@pytest.fixture(scope="module")
def bench_terrain():
    """The bench terrain (chip_smoke.py's, the CIR cells' `ref_main_terrain`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return fused.make_fused_tracer(make_terrain(grid=128, extent=60.0, seed=0), max_bounces=4,
                                   device=torch.device("cuda", 0))


@pytest.mark.parametrize("n", [5_242_880, 1_000_003])
def test_ordered_fused_kernel_keeps_every_output_bit(cuda, bench_terrain, monkeypatch, n):
    """I.i.d. rays on the bench terrain at the cells' size and at a ragged
    one: K1 walking the direction-cell order gives the four outputs of K1 in
    the caller's order bit for bit, and the same bits on a second call; so
    does the face record."""
    ft = bench_terrain
    dirs = _iid(n, cuda)
    args = ([10.0, 0.0, 25.0], [-10.0, 0.0, 8.0], 1.0)
    assert n >= fused.ORDER_MIN_RAYS
    before = (ray_order.RAY_ORDER_KERNEL.launches, fused.FUSED_TRACE_KERNEL.launches)
    ordered = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4)
    again = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4)
    assert (ray_order.RAY_ORDER_KERNEL.launches, fused.FUSED_TRACE_KERNEL.launches) == (
        before[0] + 2, before[1] + 2)
    of = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4, record_faces=True)
    monkeypatch.setattr(fused, "ORDER_MIN_RAYS", 2**31)
    caller = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4)
    cf = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4, record_faces=True)
    torch.cuda.synchronize()
    assert int(caller.captured.sum()) > 0
    for a, b, c in zip(ordered[:4], caller[:4], again[:4]):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip((*of[0][:4], of[1]), (*cf[0][:4], cf[1])):
        assert torch.equal(a, b)


_SPECIAL = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
            [0.0, -1.0, 0.0], [0.6, 0.3, 1e-7], [0.6, 0.3, -1e-7], [-0.0, -0.0, -1.0],
            [0.0, 0.0, 0.0], [1e-30, -1e-30, 1e-30]]


@pytest.mark.parametrize("bits", list(range(ray_order.MIN_BITS, ray_order.MAX_BITS + 1)))
@pytest.mark.parametrize("n", [1_000_003, 37])
def test_ray_order_kernel_matches_plain(cuda, bits, n):
    """The ordering kernels against their plain version on every lattice:
    the same key for every ray (the poles, the axes, both sides of the fold,
    a zero direction among them), the same count in every cell, an order
    that is a permutation of the rays with non-decreasing keys, and a rank
    that is its inverse."""
    dirs = torch.cat([torch.tensor(_SPECIAL, device=cuda), _iid(n, cuda, seed=bits)])
    order, rank, keys, counts = ray_order.ray_order(dirs, bits)
    p_order, _, p_keys, p_counts = ray_order.ray_order_plain(dirs, bits)
    torch.cuda.synchronize()
    m = dirs.shape[0]
    every = torch.arange(m, dtype=torch.int32, device=cuda)
    assert order.dtype == rank.dtype == keys.dtype == counts.dtype == torch.int32
    assert order.shape == rank.shape == keys.shape == (m,)
    assert counts.shape == (1 << (2 * bits),)
    assert torch.equal(keys, p_keys) and torch.equal(counts, p_counts)
    assert torch.equal(torch.sort(order).values, every)
    assert torch.equal(order[rank.long()], every)
    walked = keys[order.long()]
    assert bool((walked[1:] >= walked[:-1]).all())
    assert torch.equal(walked, p_keys[p_order.long()])


def test_fused_kernel_counts_the_rays_it_walks_in_cell_order(cuda):
    """Under a profiler `rays_fused` and `rays_ordered` both count a launch's
    rays from `ORDER_MIN_RAYS` up; below it, and in the counted walk, only
    `rays_fused` does; with no profiler neither moves."""
    from torch.profiler import ProfilerActivity, profile

    ft = fused.make_fused_tracer(make_terrain(grid=48, extent=40.0, seed=3), max_bounces=4,
                                 device=cuda)
    args = ([2.0, 1.0, 12.0], [-5.0, 2.0, 6.0], 2.0)
    big, small = fused.ORDER_MIN_RAYS, fused.ORDER_MIN_RAYS - 1

    def moved(n, **kw):
        dirs = _iid(n, cuda)
        before = profiling.counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4, **kw)
            torch.cuda.synchronize()
        after = profiling.counters()
        return after["rays_fused"] - before["rays_fused"], after["rays_ordered"] - before[
            "rays_ordered"]

    assert moved(big) == (big, big)
    assert moved(small) == (small, 0)
    assert moved(big, count_stats=True) == (big, 0)
    before = profiling.counters()
    fused.fused_trace(ft.bvh, _iid(big, cuda), *args, max_bounces=4)
    after = profiling.counters()
    assert (after["rays_fused"], after["rays_ordered"]) == (before["rays_fused"],
                                                            before["rays_ordered"])


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_histogram_backward_on_card_matches_plain(cuda, soft):
    g = np.random.default_rng(18)
    n = 300_000
    host = [torch.from_numpy(g.random(n).astype(np.float32)),
            torch.from_numpy((g.random(n) * 70.0).astype(np.float32))]
    cap = torch.from_numpy(g.random(n) < 0.3)
    w = torch.from_numpy(g.normal(size=20_000).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        amp, dist = (a.to(dev).requires_grad_() for a in host)
        ir = cir.bin_impulse_response(amp, dist, cap.to(dev), nbins=20_000,
                                      light_speed_mps=2.998e8, sample_rate_hz=100e9, soft=soft)
        assert ir.requires_grad
        (ir * w.to(dev)).sum().backward()
        grads.append((amp.grad.cpu(), dist.grad.cpu()))
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


def test_scan_gradients_on_card_match_cpu(cuda):
    room = make_room()
    dirs = morton_sphere_directions(4096, generator=torch.Generator().manual_seed(5), device="cpu")
    out = []
    for dev in (cuda, torch.device("cpu")):
        env = intersect.make_env_intersector("kernel", mesh=room, differentiable_tris=True,
                                             device=dev)
        tx = torch.tensor([4.0, 3.0, 6.0], device=dev, requires_grad=True)
        verts = torch.as_tensor(room.vertices, device=dev).clone().requires_grad_()
        r = trace_to_rx(Scene(verts, torch.as_tensor(room.faces, device=dev)), tx,
                        dirs.to(dev), [-6.0, -4.0, 5.0], 2.0, max_bounces=2, rx_mode="analytic",
                        env_hit=env)
        torch.where(r.captured, r.amplitude * r.distance, 0.0).sum().backward()
        out.append((r.captured.cpu(), tx.grad.cpu(), verts.grad.cpu()))
    torch.cuda.synchronize()
    assert torch.equal(out[0][0], out[1][0]) and int(out[0][0].sum()) > 0
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(out[0][2], out[1][2], rtol=1e-3,
                               atol=1e-6 * float(out[1][2].abs().max()))


def _room_segments(cuda, n, max_bounces=3):
    """Env segments of n Morton rays in the box room, amplitude scaled by
    1 / n (the coverage kernel's input)."""
    dirs = morton_sphere_directions(n, generator=torch.Generator(cuda).manual_seed(6), device=cuda)
    segs = trace_env(Scene.from_mesh(make_room(), cuda), [3.0, 2.0, 2.0], dirs,
                     max_bounces=max_bounces)
    return segs._replace(amplitude=segs.amplitude * (torch.tensor(1.0) / n).to(cuda))


def _room_receivers(m):
    """m - 1 receivers spread over the room and one far outside it."""
    g = np.random.default_rng(21)
    inside = np.column_stack([g.uniform(-18, 18, m - 1), g.uniform(-18, 18, m - 1),
                              g.uniform(0.5, 14, m - 1)])
    return np.vstack([inside, [[100.0, 100.0, 100.0]]]).astype(np.float32)


def test_coverage_kernel_matches_plain(cuda):
    """531 receivers (an odd count: the last warp's tile is short, and the
    last block has fewer warps at work), 100,003 rays (an odd count, four
    slabs, the last one short), 3 bounces, a 50 ns window that drops the
    longer paths, and a receiver that nothing reaches."""
    segs = _room_segments(cuda, 100_003)
    assert coverage_hist.coverage_slabs(100_003) == 4
    centers = _room_receivers(531)
    kw = dict(light_speed_mps=2.998e8, sample_rate_hz=100e9)
    before = (coverage_hist.COVERAGE_HIST_KERNEL.launches,
              coverage_hist.COVERAGE_REDUCE_KERNEL.launches)
    k1 = coverage_hist.coverage_hist(segs, centers, 0.7, nbins=5000, **kw)
    k2 = coverage_hist.coverage_hist(segs, centers, 0.7, nbins=5000, **kw)
    assert (coverage_hist.COVERAGE_HIST_KERNEL.launches,
            coverage_hist.COVERAGE_REDUCE_KERNEL.launches) == (before[0] + 2, before[1] + 2)
    p = coverage_hist.coverage_hist_plain(segs, centers, 0.7, nbins=5000, **kw)
    wide = coverage_hist.coverage_hist_plain(segs, centers, 0.7, nbins=40_000, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    assert torch.equal(k1 != 0, p != 0)
    torch.testing.assert_close(k1, p, rtol=1e-5, atol=1e-12)
    assert float(wide[:, 5000:].sum()) > 0  # paths beyond the window were dropped
    torch.testing.assert_close(p, wide[:, :5000], rtol=1e-5, atol=1e-12)
    lit = (k1 != 0).any(dim=1)
    assert not bool(lit[-1]) and int(lit.sum()) > 200
    # A receiver's IR does not depend on the warp or block it shares: alone,
    # or in a group that is no multiple of a warp's tile, it is the same bit
    # for bit.
    for i in (0, 4, 5, 15, 16, 530):
        alone = coverage_hist.coverage_hist(segs, centers[i:i + 1], 0.7, nbins=5000, **kw)
        assert torch.equal(alone[0], k1[i]), i
    group = coverage_hist.coverage_hist(segs, centers[7:44], 0.7, nbins=5000, **kw)
    assert torch.equal(group, k1[7:44])
    # Fewer rays than one slab: one plane, no reduction, and the same rules.
    short = EnvSegments(*(t[:, :20_011].contiguous() for t in segs))
    assert coverage_hist.coverage_slabs(20_011) == 1
    before = coverage_hist.COVERAGE_REDUCE_KERNEL.launches
    ks = coverage_hist.coverage_hist(short, centers, 0.7, nbins=5000, **kw)
    assert coverage_hist.COVERAGE_REDUCE_KERNEL.launches == before
    ps = coverage_hist.coverage_hist_plain(short, centers, 0.7, nbins=5000, **kw)
    assert torch.equal(ks != 0, ps != 0) and int((ks != 0).sum()) > 0
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-12)
    # The histograms live in global memory: a million bins run, and equal plain.
    few = centers[:3]
    big = coverage_hist.coverage_hist(segs, few, 0.7, nbins=1_000_000, **kw)
    big_p = coverage_hist.coverage_hist_plain(segs, few, 0.7, nbins=1_000_000, **kw)
    assert torch.equal(big != 0, big_p != 0) and int((big != 0).sum()) > 0
    torch.testing.assert_close(big, big_p, rtol=1e-5, atol=1e-12)
    with pytest.raises(ValueError, match="bins"):
        coverage_hist.coverage_hist(segs, few, 0.7, nbins=2**31, **kw)


def test_coverage_kernel_takes_receivers_in_groups(cuda, monkeypatch):
    """More receivers than the planes' memory budget allows go in several
    launches, and nothing in the result shows it: each row is the same bits."""
    segs = _room_segments(cuda, 70_000)
    centers = _room_receivers(100)
    kw = dict(nbins=4000, light_speed_mps=2.998e8, sample_rate_hz=100e9)
    whole = coverage_hist.coverage_hist(segs, centers, 0.7, **kw)
    n_slabs = coverage_hist.coverage_slabs(70_000)
    monkeypatch.setattr(coverage_hist, "PLANES_BYTES", 4 * n_slabs * 4000 * 7)  # 7 receivers
    before = coverage_hist.COVERAGE_HIST_KERNEL.launches
    parts = coverage_hist.coverage_hist(segs, centers, 0.7, **kw)
    assert coverage_hist.COVERAGE_HIST_KERNEL.launches == before + 15
    assert parts.shape == whole.shape == (100, 4000) and int((whole != 0).sum()) > 0
    assert torch.equal(parts, whole)


def test_coverage_reduce_kernel_matches_plain(cuda):
    """The slab reduction: planes added per bin in plane order, an element
    count that is no multiple of a block."""
    planes = torch.from_numpy(np.random.default_rng(3).random((5, 37, 1001)).astype(np.float32))
    before = coverage_hist.COVERAGE_REDUCE_KERNEL.launches
    got = coverage_hist.reduce_planes(planes.to(cuda))
    assert coverage_hist.COVERAGE_REDUCE_KERNEL.launches == before + 1
    torch.cuda.synchronize()
    assert got.shape == (37, 1001)
    assert torch.equal(got.cpu(), coverage_hist.reduce_planes_plain(planes))
    one = coverage_hist.reduce_planes(planes[:1].to(cuda))
    assert torch.equal(one.cpu(), planes[0])


def test_coverage_engines_on_card(cuda):
    """engine='auto' takes the coverage kernel on the card and agrees with
    the map engine; the phasor metric on the card agrees with the CPU on the
    same segments."""
    room = make_room()
    n = 65_536
    dirs = morton_sphere_directions(n, generator=torch.Generator(cuda).manual_seed(8), device=cuda)
    centers = _room_receivers(41)
    kw = dict(max_bounces=2, nbins=10_000, num_rays=n, light_speed_mps=2.998e8,
              sample_rate_hz=100e9)
    scene = Scene.from_mesh(room, cuda)
    assert coverage_hist.coverage_slabs(n) > 1
    before = coverage_hist.COVERAGE_HIST_KERNEL.launches
    auto = coverage.coverage_irs(scene, [3.0, 2.0, 2.0], dirs, centers, 0.8, **kw)
    assert coverage_hist.COVERAGE_HIST_KERNEL.launches == before + 1
    mapped = coverage.coverage_irs(scene, [3.0, 2.0, 2.0], dirs, centers, 0.8, engine="map", **kw)
    assert coverage_hist.COVERAGE_HIST_KERNEL.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(auto != 0, mapped != 0) and int((auto != 0).any(dim=1).sum()) > 30
    torch.testing.assert_close(auto, mapped, rtol=1e-5, atol=1e-12)

    segs = trace_env(scene, [3.0, 2.0, 2.0], dirs, max_bounces=2)
    fkw = dict(num_rays=n, sample_window_s=100e-9, sample_rate_hz=100e9, carrier_hz=2.4e9,
               light_speed_mps=2.998e8, tx_power=1.0, rx_batch=16)
    phasor = (coverage_hist.PHASOR_TABLE_KERNEL, coverage_hist.COVERAGE_PHASOR_KERNEL,
              coverage_hist.COVERAGE_SPREAD_KERNEL)
    before = [k.launches for k in phasor]
    card = [x.cpu() for x in coverage._dbm_cancel_from_segments(segs, centers, 0.8, **fkw)]
    # The table, one walk, the spread over its lists.
    assert [k.launches - b for k, b in zip(phasor, before)] == [1, 1, 1]
    host = coverage._dbm_cancel_from_segments(
        EnvSegments(*(t.cpu() for t in segs)), centers, 0.8, **fkw)
    ok = torch.isfinite(host[0])
    assert torch.equal(torch.isfinite(card[0]), ok) and int(ok.sum()) > 30
    torch.testing.assert_close(card[0][ok], host[0][ok], rtol=0, atol=1e-3)
    for a, b in zip(card[1:], host[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=0)


def _sparse_irs(cuda, m, nbins, seed=25):
    """(m, nbins) IRs shaped like the coverage sweep's: rows of 0.2% to 5%
    nonzero bins of either sign at 1e-9..1e-6, a row of 30%, an empty row, and
    rows of one bin at 0, at the centre lo and at nbins - 1."""
    g = np.random.default_rng(seed)
    share = g.uniform(0.002, 0.05, (m, 1))
    share[1] = 0.3
    ir = np.where(g.random((m, nbins)) < share,
                  g.uniform(1e-9, 1e-6, (m, nbins)) * g.choice([-1.0, 1.0], (m, nbins)), 0.0)
    ir[2:6] = 0.0
    for row, k in ((3, 0), (4, (nbins - 1) // 2), (5, nbins - 1)):
        ir[row, k] = 3.5e-7
    return torch.from_numpy(ir.astype(np.float32)).to(cuda)


def _assert_power_close(k, p):
    """The kernel's (dBm, signal) against the plain version's: the same
    nonzero samples; the signal within rtol 1e-5, with an absolute floor of
    1e-5 of the largest sample where a sample's taps cancel (the two add a
    sample's taps in other orders); dBm within 1e-4 dB, -inf alike."""
    (dk, ok), (dp, op) = k, p
    assert torch.equal(ok != 0, op != 0)
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-5 * float(op.abs().max()))
    fin = torch.isfinite(dp)
    assert torch.equal(torch.isfinite(dk), fin)
    assert float((dk[fin] - dp[fin]).abs().max()) < 1e-4


@pytest.mark.parametrize("nbins", [10_000, 20_001])
def test_rx_power_kernel_matches_plain(cuda, nbins):
    """The coverage sweep's bins (even) and the single IR's width, odd: one
    launch for all rows, the plain version's nonzero samples and values, the
    same bits from run to run, and a row the same bits alone as in the batch."""
    irs = _sparse_irs(cuda, 37, nbins)
    window = nbins / 100e9
    before = cir.RX_POWER_KERNEL.launches
    a = cir.rx_power_dbm(irs, window)
    b = cir.rx_power_dbm(irs, window)
    assert cir.RX_POWER_KERNEL.launches == before + 2
    p = cir.rx_power_dbm_plain(irs, window)
    torch.cuda.synchronize()
    assert a[0].shape == (37,) and a[1].shape == (37, nbins)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _assert_power_close(a, p)
    assert int((a[1][0] != 0).sum()) > nbins // 2 and not a[1][2].any()
    assert a[0][2] == -np.inf
    lo = (nbins - 1) // 2
    carrier = cir._carrier(nbins, window, 2.4e9, cuda)
    j = torch.arange(nbins, device=cuda)
    for row, k in ((3, 0), (4, lo), (5, nbins - 1)):  # one tap a sample: the product itself
        idx = j + lo - k
        inside = (idx >= 0) & (idx < nbins)
        want = torch.where(inside, irs[row, k] * carrier[idx.clamp(0, nbins - 1)], 0.0)
        assert torch.equal(a[1][row], want), row
    for r in (0, 1, 2, 3, 5, 36):
        before = cir.RX_POWER_KERNEL.launches
        dbm, out = cir.rx_power_dbm(irs[r], window)
        assert cir.RX_POWER_KERNEL.launches == before + 1
        assert dbm.shape == () and out.shape == (nbins,)
        assert torch.equal(out, a[1][r]) and torch.equal(dbm, a[0][r]), r
    group = cir.rx_power_dbm(irs[7:30], window)
    assert torch.equal(group[1], a[1][7:30]) and torch.equal(group[0], a[0][7:30])


def test_rx_power_kernel_requires_grad_raises(cuda):
    """A CUDA IR that requires grad no longer raises: the forward launches
    the RX-power kernel and the backward its backward kernel, once each, and
    the gradient equals the plain version's on the card and the CPU's
    (autograd through rx_power_dbm_plain, the dense convolution's adjoint).
    Under no_grad nothing is kept and no backward runs."""
    irs = _sparse_irs(cuda, 7, 2000)[[0, 1, 3, 6]]
    before = (cir.RX_POWER_KERNEL.launches, cir.RX_POWER_BACKWARD_KERNEL.launches)
    with torch.no_grad():
        cir.rx_power_dbm(irs.clone().requires_grad_(), 20e-9)
    assert cir.RX_POWER_KERNEL.launches == before[0] + 1
    grads = []
    for dev, fn in ((cuda, cir.rx_power_dbm), (cuda, cir.rx_power_dbm_plain),
                    (torch.device("cpu"), cir.rx_power_dbm_plain)):
        x = irs.detach().to(dev).requires_grad_()
        dbm, _ = fn(x, 20e-9)
        dbm.sum().backward()
        grads.append(x.grad.cpu())
    torch.cuda.synchronize()
    assert (cir.RX_POWER_KERNEL.launches, cir.RX_POWER_BACKWARD_KERNEL.launches) == (
        before[0] + 2, before[1] + 1)
    for g in grads[:2]:
        torch.testing.assert_close(g, grads[2], rtol=1e-4, atol=1e-5 * float(grads[2].abs().max()))


def _power_backward_inputs(cuda, irs, window, seed=3):
    """The forward's signal and sums of `irs` on the card, and cotangents of
    the dBm (one a row) and of the signal."""
    out, _, sums = cir._rx_power_launch(irs, cir.carrier_cached(irs.shape[1], window, 2.4e9, cuda))
    g = np.random.default_rng(seed)
    g_dbm = torch.from_numpy(g.standard_normal(irs.shape[0]).astype(np.float32)).to(cuda)
    g_out = torch.from_numpy(g.standard_normal(irs.shape).astype(np.float32)).to(cuda) * 1e6
    return out, sums, g_dbm, g_out


def _assert_backward_close(k, p):
    """The kernel's g_ir against the plain version's: each output adds its
    taps in ascending j in f32, the plain version in float64, so rtol 1e-4
    with an absolute floor of 1e-5 of the largest entry (the taps of a sample
    alternate in sign and cancel)."""
    torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-5 * float(p.abs().max()))


@pytest.mark.parametrize("nbins", [1998, 10_000, 20_001])
@pytest.mark.parametrize("cotangent", ["dbm", "signal", "both"])
def test_rx_power_backward_kernel_matches_plain(cuda, nbins, cotangent):
    """The backward kernel against its plain version on the same forward: 37
    rows (an empty row among them, one of 30% nonzero bins, rows of one bin),
    cotangents on the dBm, on the signal or on both; one launch for all rows,
    the same bits from run to run, a row alone (or a group) the same bits as
    in the batch; dense in the bins (a zero bin gets a gradient)."""
    irs = _sparse_irs(cuda, 37, nbins)
    window = nbins / 100e9
    out, sums, g_dbm, g_out = _power_backward_inputs(cuda, irs, window)
    g_dbm = g_dbm if cotangent != "signal" else None
    g_out = g_out if cotangent != "dbm" else None
    count, sq = cir._power_sums_plain(out)  # the forward's epilogue: each row's count and squares
    assert torch.equal(sums[:, 1], count.float()) and float(sums[2, 1]) == 0.0
    torch.testing.assert_close(sums[:, 0], sq, rtol=1e-5, atol=0)
    before = cir.RX_POWER_BACKWARD_KERNEL.launches
    a = cir.rx_power_backward(g_dbm, g_out, out, sums, window)
    b = cir.rx_power_backward(g_dbm, g_out, out, sums, window)
    assert cir.RX_POWER_BACKWARD_KERNEL.launches == before + 2
    kern = cir.carrier_cached(nbins, window, 2.4e9, cuda)
    p = cir.rx_power_backward_plain(g_dbm, g_out, out, sums, kern)
    torch.cuda.synchronize()
    assert a.shape == (37, nbins) and torch.equal(a, b)
    _assert_backward_close(a, p)
    assert int((a[0] != 0).sum()) > int((irs[0] != 0).sum())
    if cotangent == "dbm":
        assert not a[2].any()  # an empty row: no dBm term, no signal cotangent
    for r in (0, 2, 5, 36):
        alone = cir.rx_power_backward(None if g_dbm is None else g_dbm[r:r + 1],
                                      None if g_out is None else g_out[r:r + 1], out[r:r + 1],
                                      sums[r:r + 1], window)
        assert torch.equal(alone[0], a[r]), r
    group = cir.rx_power_backward(None if g_dbm is None else g_dbm[7:30],
                                  None if g_out is None else g_out[7:30], out[7:30], sums[7:30],
                                  window)
    assert torch.equal(group, a[7:30])


def test_rx_power_backward_kernel_single_long_row(cuda):
    """The forward request's shape, one 20,000-bin IR through autograd: one
    forward and one backward launch; the gradient equals the plain
    version's, and a row's gradient is the same bits alone as in a batch."""
    g = np.random.default_rng(41)
    ir = np.zeros(20_000, np.float32)
    ir[g.choice(np.arange(1500, 4000), 900, replace=False)] = g.uniform(1e-9, 1e-6, 900)
    ir[g.choice(np.arange(4000, 20_000), 360, replace=False)] = -g.uniform(1e-9, 1e-6, 360)
    x = torch.from_numpy(ir).to(cuda).requires_grad_()
    before = (cir.RX_POWER_KERNEL.launches, cir.RX_POWER_BACKWARD_KERNEL.launches)
    dbm, _ = cir.rx_power_dbm(x, 200e-9)
    dbm.backward()
    assert (cir.RX_POWER_KERNEL.launches, cir.RX_POWER_BACKWARD_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)
    y = x.detach().clone().requires_grad_()
    cir.rx_power_dbm_plain(y, 200e-9)[0].backward()
    batch = torch.stack([x.detach().flip(0), x.detach(), x.detach() * 0.5]).requires_grad_()
    cir.rx_power_dbm(batch, 200e-9)[0].sum().backward()
    torch.cuda.synchronize()
    _assert_backward_close(x.grad, y.grad)
    assert torch.equal(batch.grad[1], x.grad)
    assert int((x.grad != 0).sum()) > 15_000


def test_rx_power_backward_kernel_edges(cuda):
    """No rows, rows with no nonzero sample (the dBm term absent: the
    gradient is the signal's cotangent's alone), and no cotangent at all."""
    none = cir.rx_power_backward(torch.zeros(0, device=cuda), None,
                                 torch.zeros((0, 100), device=cuda),
                                 torch.zeros((0, 2), device=cuda), 1e-9)
    assert none.shape == (0, 100)
    zeros = torch.zeros((3, 1000), device=cuda, requires_grad=True)
    dbm, sig = cir.rx_power_dbm(zeros, 10e-9)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 1000)).astype(np.float32))
    (torch.where(torch.isfinite(dbm), dbm, 0.0).sum() + (sig * w.to(cuda)).sum()).backward()
    host = torch.zeros((3, 1000), requires_grad=True)
    d2, s2 = cir.rx_power_dbm_plain(host, 10e-9)
    (torch.where(torch.isfinite(d2), d2, 0.0).sum() + (s2 * w).sum()).backward()
    torch.cuda.synchronize()
    assert bool((dbm == -np.inf).all())
    _assert_backward_close(zeros.grad.cpu(), host.grad)
    out, _, sums = cir._rx_power_launch(zeros.detach(), cir.carrier_cached(1000, 10e-9, 2.4e9, cuda))
    assert not cir.rx_power_backward(None, None, out, sums, 10e-9).any()


@pytest.mark.parametrize("nbins", [1024, 1025, 20_001])
def test_rx_power_backward_kernel_last_segment_rows(cuda, nbins):
    """One whole segment, one bin past it, and the odd single-IR width: 20
    rows, the first ten with a cotangent only in the last 1,024-bin segment
    of j (and none on the dBm), against the plain version; every row alone,
    and a group, the same bits as in the batch."""
    irs = _sparse_irs(cuda, 20, nbins)
    window = nbins / 100e9
    out, sums, _, g_out = _power_backward_inputs(cuda, irs, window)
    last = (nbins - 1) // 1024 * 1024
    g_out[:10, :last] = 0.0
    a = cir.rx_power_backward(None, g_out, out, sums, window)
    p = cir.rx_power_backward_plain(None, g_out, out, sums,
                                    cir.carrier_cached(nbins, window, 2.4e9, cuda))
    torch.cuda.synchronize()
    _assert_backward_close(a, p)
    assert bool(a[:10].any(dim=1).all())
    for r in range(20):
        alone = cir.rx_power_backward(None, g_out[r:r + 1], out[r:r + 1], sums[r:r + 1], window)
        assert torch.equal(alone[0], a[r]), r
    group = cir.rx_power_backward(None, g_out[3:14], out[3:14], sums[3:14], window)
    assert torch.equal(group, a[3:14])


def test_rx_power_backward_kernel_lone_ir_equals_its_row_in_batches(cuda):
    """The lone 20,000-bin IR's gradient (g_dbm = 1) is the same bits as
    its row in batches of 1, 3, 64 and 128 rows: launches split over the
    segments (few blocks) and not split (128 rows fill the card)."""
    g = np.random.default_rng(41)
    ir = np.zeros(20_000, np.float32)
    ir[g.choice(np.arange(1500, 4000), 900, replace=False)] = g.uniform(1e-9, 1e-6, 900)
    ir[g.choice(np.arange(4000, 20_000), 360, replace=False)] = -g.uniform(1e-9, 1e-6, 360)
    x = torch.from_numpy(ir).to(cuda)
    kern = cir.carrier_cached(20_000, 200e-9, 2.4e9, cuda)
    others = _sparse_irs(cuda, 128, 20_000)

    def grad(rows):
        sig, _, sums = cir._rx_power_launch(rows, kern)
        return cir.rx_power_backward(torch.ones(rows.shape[0], device=cuda), None, sig, sums,
                                     200e-9)

    lone = grad(x[None])[0]
    sig, _, sums = cir._rx_power_launch(x[None], kern)
    p = cir.rx_power_backward_plain(torch.ones(1, device=cuda), None, sig, sums, kern)[0]
    torch.cuda.synchronize()
    _assert_backward_close(lone, p)
    assert cir._backward_partials(1, 20_000) > 0 and cir._backward_partials(128, 20_000) == 0
    for m, at in ((3, 1), (64, 37), (128, 100)):
        rows = others[:m].clone()
        rows[at] = x
        assert torch.equal(grad(rows)[at], lone), m


def test_rx_power_kernel_edges(cuda):
    none = cir.rx_power_dbm(torch.zeros((0, 100), device=cuda), 1e-9)
    assert none[0].shape == (0,) and none[1].shape == (0, 100)
    zeros = cir.rx_power_dbm(torch.zeros((3, 100), device=cuda), 1e-9)
    torch.cuda.synchronize()
    assert bool((zeros[0] == -np.inf).all()) and not zeros[1].any()
    with pytest.raises(ValueError, match="bins"):
        cir.rx_power_dbm(torch.zeros((1, 65535 * 256 + 1), device=cuda), 1e-6)


def _phasor_launches():
    return [k.launches for k in (coverage_hist.PHASOR_TABLE_KERNEL,
                                 coverage_hist.COVERAGE_PHASOR_KERNEL,
                                 coverage_hist.COVERAGE_SPREAD_KERNEL)]


PHASOR_CARD_KW = dict(nbins=10_000, light_speed_mps=2.998e8, sample_rate_hz=100e9,
                      sample_window_s=100e-9, carrier_hz=2.4e9)


def test_coverage_phasor_kernel_matches_plain(cuda):
    """The phasor metric's kernels against their plain version on the room's
    segments: 531 receivers (a short last tile), 100,003 rays (four slabs,
    the last one short), 3 bounces, a receiver nothing reaches. A call is
    one launch each of the table, the walk and the spread over its lists.
    dBm within 1e-3 dB, ratio and spread within rtol 1e-4, the same bits from
    run to run and for a receiver alone or in any group; an input that
    requires grad runs the same kernels, and the backward kernel once."""
    segs = _room_segments(cuda, 100_003)
    centers = _room_receivers(531)
    kw = PHASOR_CARD_KW
    before = _phasor_launches()
    k1 = coverage_hist.coverage_phasor(segs, centers, 0.7, **kw)
    k2 = coverage_hist.coverage_phasor(segs, centers, 0.7, **kw)
    assert [a - b for a, b in zip(_phasor_launches(), before)] == [2, 2, 2]
    p = coverage._dbm_cancel_plain(segs, centers, 0.7, num_rays=1, tx_power=1.0, rx_batch=64,
                                   **{k: v for k, v in kw.items() if k != "nbins"})
    torch.cuda.synchronize()
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)
    ok = torch.isfinite(p[0])
    assert torch.equal(torch.isfinite(k1[0]), ok) and int(ok.sum()) > 200 and not bool(ok[-1])
    assert float((k1[0][ok] - p[0][ok]).abs().max()) < 1e-3
    for a, b in zip(k1[1:], p[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=0)
    assert float((p[2] > 0).sum()) > 100 and bool((p[1][ok] < 0.5).any())
    for i in (0, 4, 5, 15, 16, 530):
        alone = coverage_hist.coverage_phasor(segs, centers[i:i + 1], 0.7, **kw)
        for a, b in zip(alone, k1):
            assert torch.equal(a[0], b[i]), i
    group = coverage_hist.coverage_phasor(segs, centers[7:44], 0.7, **kw)
    for a, b in zip(group, k1):
        assert torch.equal(a, b[7:44])
    # Segments that require grad run the same kernels, and the backward's.
    wanted = segs._replace(amplitude=segs.amplitude.clone().requires_grad_())
    before = _phasor_launches() + [coverage_hist.PHASOR_BACKWARD_KERNEL.launches]
    dbm, _, _ = coverage._dbm_cancel_from_segments(
        wanted, centers[:40], 0.7, num_rays=1, tx_power=1.0, rx_batch=16,
        **{k: v for k, v in kw.items() if k != "nbins"})
    torch.where(torch.isfinite(dbm), dbm, 0.0).sum().backward()
    after = _phasor_launches() + [coverage_hist.PHASOR_BACKWARD_KERNEL.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    assert torch.equal(dbm.detach(), k1[0][:40]) and bool(wanted.amplitude.grad.any())


@pytest.mark.parametrize("pool", [(0, 1), (0, 40)], ids=["one_chunk", "some_chunks"])
def test_coverage_phasor_kernel_lost_lists_walk_again(cuda, monkeypatch, pool):
    """Where the capture lists' pool runs out (one chunk in all, or forty),
    the regions that found it spent are walked again, and the three outputs
    are the same bits as with every list kept; with the default pool no list
    is lost here."""
    segs = _room_segments(cuda, 100_003)
    centers = _room_receivers(531)
    kept = coverage_hist.coverage_phasor(segs, centers, 0.7, **PHASOR_CARD_KW)
    _, walks = coverage_hist._phasor_sums(segs, torch.as_tensor(centers, device=cuda), 0.7,
                                          **PHASOR_CARD_KW)
    captures, lost = coverage_hist.phasor_lists_spent(walks)
    assert captures > 10_000 and lost == 0
    monkeypatch.setattr(coverage_hist, "PHASOR_CHUNKS_A_REGION", pool[0])
    monkeypatch.setattr(coverage_hist, "PHASOR_SPARE_CHUNKS", pool[1])
    _, walks = coverage_hist._phasor_sums(segs, torch.as_tensor(centers, device=cuda), 0.7,
                                          **PHASOR_CARD_KW)
    assert coverage_hist.phasor_lists_spent(walks)[1] > 500
    spent = coverage_hist.coverage_phasor(segs, centers, 0.7, **PHASOR_CARD_KW)
    torch.cuda.synchronize()
    for a, b in zip(kept, spent):
        assert torch.equal(a, b)


def _phasor_backward_case(cuda, segs, centers, radius, kw, seed=7):
    """The forward's sums and spread of `segs` on the card and coefficients
    for random cotangents of all three outputs."""
    sums, walks = coverage_hist._phasor_sums(segs, torch.as_tensor(centers, device=cuda), radius,
                                             **kw)
    spread = coverage_hist._phasor_spread(walks, sums[:, 5] / sums[:, 4])
    spread = torch.where(sums[:, 3] > 0, torch.sqrt(torch.clamp_min(spread / sums[:, 4], 0.0)),
                         0.0)
    g = np.random.default_rng(seed)
    cot = [torch.from_numpy(g.standard_normal(len(centers)).astype(np.float32)).to(cuda)
           for _ in range(3)]
    return sums, coverage_hist.phasor_coefficients(sums, spread, *cot)


def _assert_phasor_backward(cuda, segs, centers, radius, kw):
    """The backward kernel against its plain version on the same
    coefficients: NaN alike (a receiver whose spread is 0 with a spread
    cotangent, as under jax.grad), rtol 1e-4 with an absolute floor of 1e-6
    of the largest entry elsewhere (the two add a segment's receivers in
    other orders on the card); one launch a call, the same bits twice."""
    sums, coef = _phasor_backward_case(cuda, segs, centers, radius, kw)
    before = coverage_hist.PHASOR_BACKWARD_KERNEL.launches
    a = coverage_hist.phasor_backward(segs, centers, radius, coef, **kw)
    b = coverage_hist.phasor_backward(segs, centers, radius, coef, **kw)
    assert coverage_hist.PHASOR_BACKWARD_KERNEL.launches == before + 2
    p = coverage_hist.phasor_backward_plain(segs, centers, radius, coef, rx_batch=64, **kw)
    torch.cuda.synchronize()
    assert a.shape == segs.t_env.shape and torch.equal(a.isnan(), b.isnan())
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert torch.equal(a.isnan(), p.isnan())
    ok = ~p.isnan()
    torch.testing.assert_close(a[ok], p[ok], rtol=1e-4, atol=1e-6 * float(p[ok].abs().max()))
    assert int((a[ok] != 0).sum()) > 100 and int((sums[:, 3] > 0).sum()) > len(centers) // 4
    return a


def test_phasor_backward_kernel_matches_plain(cuda):
    """The room's segments (100,003 rays, 3 bounces: a ray's bounces held in
    registers), 531 receivers and one outside the room; the gradient through
    coverage_phasor's autograd equals the kernel's direct call bit for bit."""
    segs = _room_segments(cuda, 100_003)
    centers = _room_receivers(531)
    kw = PHASOR_CARD_KW
    a = _assert_phasor_backward(cuda, segs, centers, 0.7, kw)
    amp = segs.amplitude.clone().requires_grad_()
    out = coverage_hist.coverage_phasor(segs._replace(amplitude=amp), centers, 0.7, **kw)
    g = np.random.default_rng(7)
    loss = sum((torch.where(torch.isfinite(o), o, 0.0) * torch.from_numpy(
        g.standard_normal(len(centers)).astype(np.float32)).to(cuda)).sum() for o in out)
    loss.backward()
    torch.cuda.synchronize()
    assert torch.equal(torch.nan_to_num(amp.grad), torch.nan_to_num(a))


def test_phasor_backward_kernel_many_bounces_and_terrain(cuda):
    """Ten bounces in the room (more than the kernel holds in registers: it
    reads them again for each receiver) and a terrain, each against the
    plain version."""
    _assert_phasor_backward(cuda, _room_segments(cuda, 20_000, max_bounces=10),
                            _room_receivers(97), 0.7, PHASOR_CARD_KW)
    terrain = make_terrain(grid=40, extent=40.0, seed=5)
    dirs = morton_sphere_directions(65_536, generator=torch.Generator(cuda).manual_seed(4),
                                    device=cuda)
    segs = trace_env(Scene.from_mesh(terrain, cuda), [10.0, 0.0, 25.0], dirs, max_bounces=2)
    segs = segs._replace(amplitude=segs.amplitude * (torch.tensor(1.0) / 65_536).to(cuda))
    g = np.random.default_rng(12)
    centers = np.column_stack([g.uniform(-20, 20, 300), g.uniform(-20, 20, 300),
                               g.uniform(5, 20, 300)]).astype(np.float32)
    _assert_phasor_backward(cuda, segs, centers, 1.0, PHASOR_CARD_KW)


def test_phasor_backward_kernel_mostly_dead_rays(cuda):
    """Where ~70% of the rays have no live segment (a mask over the room's
    rays) and the ray count is a multiple of neither the walk's block (256)
    nor the scan's (1,024): the scan lists exactly the live rays, every
    segment of a dead ray gets 0, and the rest matches the plain version."""
    n = 100_003
    segs = _room_segments(cuda, n)
    g = np.random.default_rng(31)
    keep = torch.from_numpy(g.random(n) < 0.3).to(cuda)
    segs = segs._replace(alive=segs.alive & keep)
    centers = _room_receivers(531)
    _assert_phasor_backward(cuda, segs, centers, 0.7, PHASOR_CARD_KW)
    _, coef = _phasor_backward_case(cuda, segs, centers, 0.7, PHASOR_CARD_KW)
    got, live = coverage_hist._phasor_backward_launch(segs, centers, 0.7, coef, **PHASOR_CARD_KW)
    torch.cuda.synchronize()
    live_rays = segs.alive.any(dim=0)
    assert int(live) == int(live_rays.sum()) and 0.2 * n < int(live) < 0.4 * n
    assert not got[:, ~live_rays].any()


def test_phasor_backward_kernel_first_win_across_bounces(cuda):
    """Hand-made segments, 300 rays of which two are live. Ray 0 reaches
    receiver A at bounce 0 and again at bounce 1: only bounce 0 takes A's
    term. Ray 1's bounce-0 line meets receiver B beyond the environment's hit
    (a positive discriminant, no win), and its bounce 1 wins B. Against the
    plain version, and exactly: with only A's coefficients nonzero, ray 0's
    bounce 1 gets 0; with only B's, ray 1's bounce 0 gets 0."""
    n = 300
    origin = torch.zeros((2, n, 3))
    direction = torch.zeros((2, n, 3))
    direction[..., 2] = 1.0
    t_env = torch.full((2, n), 1e30)
    dist = torch.zeros((2, n))
    alive = torch.zeros((2, n), dtype=torch.bool)
    # Ray 0: +x through A at (5, 0, 0), then back along -x through A again.
    origin[0, 0] = torch.tensor([0.0, 0.0, 0.0])
    direction[0, 0] = torch.tensor([1.0, 0.0, 0.0])
    t_env[0, 0], alive[0, 0] = 20.0, True
    origin[1, 0] = torch.tensor([20.0, 0.0, 0.0])
    direction[1, 0] = torch.tensor([-1.0, 0.0, 0.0])
    t_env[1, 0], dist[1, 0], alive[1, 0] = 30.0, 20.0, True
    # Ray 1: toward B at (8, 3, 0) but the environment at t = 6, then on to B.
    origin[0, 1] = torch.tensor([0.0, 3.0, 0.0])
    direction[0, 1] = torch.tensor([1.0, 0.0, 0.0])
    t_env[0, 1], alive[0, 1] = 6.0, True
    origin[1, 1] = torch.tensor([6.0, 3.0, 0.0])
    direction[1, 1] = torch.tensor([1.0, 0.0, 0.0])
    t_env[1, 1], dist[1, 1], alive[1, 1] = 30.0, 6.0, True
    amp = torch.from_numpy(np.random.default_rng(3).uniform(1e-4, 1e-3, (2, n)).astype(np.float32))
    segs = EnvSegments(*(t.to(cuda) for t in (origin, direction, t_env, amp, dist, alive)))
    centers = np.array([[5.0, 0.0, 0.0], [8.0, 3.0, 0.0], [50.0, 50.0, 50.0]], np.float32)
    coef = torch.tensor([[1.0, 0.5, 2.0, 0.25, 0.5, 1e-8, 1e-17, 0.0]] * 3, device=cuda)
    got = coverage_hist.phasor_backward(segs, centers, 0.5, coef, **PHASOR_CARD_KW)
    want = coverage_hist.phasor_backward_plain(segs, centers, 0.5, coef, **PHASOR_CARD_KW)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))
    assert float(got[0, 0]) != 0.0 and float(got[1, 1]) != 0.0 and not got[:, 2:].any()
    only = torch.zeros_like(coef)
    for r, (zero, nonzero) in ((0, ((1, 0), (0, 0))), (1, ((0, 1), (1, 1)))):
        only.zero_()
        only[r] = coef[r]
        one = coverage_hist.phasor_backward(segs, centers, 0.5, only, **PHASOR_CARD_KW)
        torch.cuda.synchronize()
        assert float(one[zero]) == 0.0 and float(one[nonzero]) != 0.0, r


def test_coverage_kernel_refuses_a_gradient(cuda):
    """The coverage kernel has no backward (nor has rfx's batched engine):
    segments that require grad under grad mode raise, naming it and the map
    engine, before any launch; the hybrid's exact branch then raises too;
    under no_grad the kernel runs; the map engine gives the gradient."""
    room = make_room()
    dirs = morton_sphere_directions(8192, generator=torch.Generator(cuda).manual_seed(8),
                                    device=cuda)
    scene = Scene.from_mesh(room, cuda)
    centers = _room_receivers(20)
    n1 = torch.tensor(5.0, device=cuda, requires_grad=True)
    segs = trace_env(scene, [3.0, 2.0, 2.0], dirs, max_bounces=2, n1=n1)
    assert segs.amplitude.requires_grad
    kw = dict(nbins=10_000, light_speed_mps=2.998e8, sample_rate_hz=100e9)
    before = coverage_hist.COVERAGE_HIST_KERNEL.launches
    with pytest.raises(RuntimeError, match='rfx_coverage_hist.*engine="map"'):
        coverage_hist.coverage_hist(segs, centers, 0.8, **kw)
    assert coverage_hist.COVERAGE_HIST_KERNEL.launches == before
    with torch.no_grad():
        coverage_hist.coverage_hist(segs, centers, 0.8, **kw)
    assert coverage_hist.COVERAGE_HIST_KERNEL.launches == before + 1
    # Every receiver flagged (ratio below infinity): the exact branch runs.
    hkw = dict(max_bounces=2, num_rays=8192, sample_window_s=100e-9,
               cancel_threshold=float("inf"))
    with pytest.raises(RuntimeError, match="rfx_coverage_hist"):
        coverage.coverage_dbm_hybrid(scene, [3.0, 2.0, 2.0], dirs, centers, 0.8, n1=n1, **hkw)
    dbm = coverage.coverage_dbm(scene, [3.0, 2.0, 2.0], dirs, centers, 0.8, n1=n1, max_bounces=2,
                                num_rays=8192, sample_window_s=100e-9, engine="map")
    torch.where(torch.isfinite(dbm), dbm, 0.0).sum().backward()
    torch.cuda.synchronize()
    assert n1.grad is not None and bool(torch.isfinite(n1.grad)) and float(n1.grad) != 0.0


@pytest.mark.parametrize("nbins", [1998, 10_000, 20_001])
def test_phasor_table_kernel_matches_plain(cuda, nbins):
    """The table on the card against its torch form on the card: sqrt s_k and
    t_k bit for bit (IEEE operations), cos and sin within 2e-7 (both are the
    card's single-precision cos and sin, the phase up to ~1,500 rad)."""
    step, omega = coverage_hist._phasor_constants(nbins, nbins / 100e9, 2.4e9)
    before = coverage_hist.PHASOR_TABLE_KERNEL.launches
    k = coverage_hist.phasor_table(nbins, step, omega, cuda)
    assert coverage_hist.PHASOR_TABLE_KERNEL.launches == before + 1
    p = coverage_hist.phasor_table_plain(nbins, step, omega, cuda)
    torch.cuda.synchronize()
    assert k.shape == (nbins, 4)
    assert torch.equal(k[:, 0], p[:, 0]) and torch.equal(k[:, 3], p[:, 3])
    torch.testing.assert_close(k[:, 1:3], p[:, 1:3], rtol=0, atol=2e-7)


def test_rx_power_kernel_single_long_row(cuda):
    """One 20,000-bin IR like the forward request's, whose nonzero bins span
    every segment of the kernel's list (1,260 of them, in a band and spread
    out), against the plain version, and the same bits as in a batch."""
    g = np.random.default_rng(41)
    ir = np.zeros(20_000, np.float32)
    ir[g.choice(np.arange(1500, 4000), 900, replace=False)] = g.uniform(1e-9, 1e-6, 900)
    ir[g.choice(np.arange(4000, 20_000), 360, replace=False)] = -g.uniform(1e-9, 1e-6, 360)
    x = torch.from_numpy(ir).to(cuda)
    before = cir.RX_POWER_KERNEL.launches
    a = cir.rx_power_dbm(x, 200e-9)
    assert cir.RX_POWER_KERNEL.launches == before + 1
    p = cir.rx_power_dbm_plain(x, 200e-9)
    batch = cir.rx_power_dbm(torch.stack([x.flip(0), x, x * 0.5]), 200e-9)
    torch.cuda.synchronize()
    assert a[0].shape == () and a[1].shape == (20_000,) and int((x != 0).sum()) == 1260
    _assert_power_close(a, p)
    assert torch.equal(batch[1][1], a[1]) and torch.equal(batch[0][1], a[0])


@pytest.mark.parametrize("m", [1, 2, 2048])
def test_rx_power_kernel_rows_alone_equal_the_batch(cuda, m):
    """The kernel tiles a launch of few rows otherwise than one of many; a
    row's signal and dBm are the same bits whichever the launch took. At m
    = 1 and 2 the rows match the plain version by _assert_power_close; of
    the 2,048 the first 64 match its signal within the same tolerance (among
    so many random rows one sample's taps cancel: row 27, sample 4,697 is
    1.7e-13 added in ascending k and exactly 0 in the plain version's order,
    so the count of nonzero samples, and with it the dBm, differs there)."""
    irs = _sparse_irs(cuda, max(m, 7), 10_000)[:m]
    a = cir.rx_power_dbm(irs, 100e-9)
    torch.cuda.synchronize()
    for r in range(m) if m <= 64 else range(0, m, 31):
        alone = cir.rx_power_dbm(irs[r], 100e-9)
        assert torch.equal(alone[1], a[1][r]) and torch.equal(alone[0], a[0][r]), r
    if m <= 64:
        _assert_power_close(a, cir.rx_power_dbm_plain(irs, 100e-9))
    else:
        p = cir.rx_power_dbm_plain(irs[:64], 100e-9)[1]
        torch.testing.assert_close(a[1][:64], p, rtol=1e-5, atol=1e-5 * float(p.abs().max()))


@pytest.mark.parametrize("n", [1, 1000, 65_536 + 7])
def test_counted_fused_kernel_matches_plain_walk(cuda, n):
    """The counted instantiation: counters equal the plain walk's integer for
    integer, the trace equals the uncounted kernel's bit for bit (a ragged
    last warp and block included)."""
    ft = fused.make_fused_tracer(make_terrain(grid=48, extent=40.0, seed=3), max_bounces=4,
                                 count_stats=True, device=cuda)
    dirs = morton_sphere_directions(n, generator=torch.Generator(cuda).manual_seed(4),
                                    device=cuda)
    args = ([2.0, 1.0, 12.0], [-5.0, 2.0, 6.0], 2.0)
    before = (fused.FUSED_TRACE_COUNTED_KERNEL.launches, fused.FUSED_TRACE_KERNEL.launches)
    (k, kf, stats) = ft(dirs, *args, record_faces=True)
    assert (fused.FUSED_TRACE_COUNTED_KERNEL.launches, fused.FUSED_TRACE_KERNEL.launches) == (
        before[0] + 1, before[1])
    u, uf = fused.fused_trace(ft.bvh, dirs, *args, max_bounces=4, record_faces=True)
    p, pf, p_stats = fused.fused_trace_walk_plain(ft.bvh, dirs, *args, max_bounces=4,
                                                  record_faces=True, count_stats=True)
    torch.cuda.synchronize()
    assert stats.dtype == torch.int64 and stats.shape == (4, 4)
    assert torch.equal(stats, p_stats), (stats.tolist(), p_stats.tolist())
    assert int(stats[0, 0]) >= n and bool((stats[:, 3] * fused.WARP >= stats[:, 0]).all())
    for a, b in zip((*k[:4], kf), (*u[:4], uf)):
        assert torch.equal(a, b)
    _assert_trace_equal(k, p)
    assert torch.equal(kf, pf)
    stats2 = ft(dirs, *args)[1]
    assert torch.equal(stats2, stats)  # integer atomics: the same sums every run


@pytest.mark.parametrize("style", micro_vote.STYLES)
def test_micro_vote_kernel_matches_plain(cuda, style):
    x = torch.from_numpy(np.random.default_rng(0).random((8, 128)).astype(np.float32)).to(cuda)
    before = micro_vote.MICRO_VOTE_KERNEL.launches
    got = micro_vote.micro_vote(x, 500, style)
    assert micro_vote.MICRO_VOTE_KERNEL.launches == before + 1
    want = micro_vote.micro_vote_plain(x, 500, style)
    torch.cuda.synchronize()
    assert got.shape == () and torch.equal(got, want)
    assert float(got) == 0.0 if style == "novec" else float(got) > 0.0
    # A tile that passes only 7 of the 8 thresholds, and one that passes none.
    for fill, steps in ((0.25, 300), (-9.0, 300)):
        tile = torch.full((8, 128), fill, device=cuda)
        assert torch.equal(micro_vote.micro_vote(tile, steps, style),
                           micro_vote.micro_vote_plain(tile, steps, style)), fill
    assert float(micro_vote.micro_vote(x, 0, style)) == 0.0


def test_two_rank_sharded_paths_on_card(cuda, tmp_path):
    """Two gloo ranks sharing the card (scripts/torch_multiproc_worker.py,
    the CPU tests' room workload): sharded_cir on {'rays': 2} through the
    histogram kernel and the coverage tiles on {'rays': 1, 'rx': 2} through
    the map engine (K-S and the histogram's record entry), against the
    unsharded paths on the card; the ranks hold the same IR bits."""
    import os
    import sys

    from rfx_torch.parallel.launch import result_of, run_ranks

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cir.HISTOGRAM_KERNEL.load()  # built once, before the ranks load it
    outs = run_ranks(lambda r, c: [sys.executable, os.path.join(repo, "scripts",
                                                                "torch_multiproc_worker.py"),
                                   c, "2", str(r), str(tmp_path / f"rank{r}.npz"), "--device",
                                   "cuda", "--cases", "cir,coverage"],
                     2, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    infos = [result_of(o) for o in outs]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert all(i["backend"] == "gloo" and i["cir"]["launches"]["rfx_ir_histogram"] > 0
               and i["coverage"]["launches"]["rfx_ir_histogram_record"] > 0 for i in infos)
    assert np.array_equal(ranks[0]["cir_ir"], ranks[1]["cir_ir"])

    from rfx_torch.graft_entry import uniform_sphere_directions

    c, rate = 2.998e8, 100e9
    nbins = int(100e-9 * rate)
    scene = Scene.from_mesh(make_room(), cuda)
    dirs = torch.from_numpy(uniform_sphere_directions(4096, seed=31)).to(cuda)
    r = trace_to_rx(scene, [5.0, 0.0, 5.0], dirs, [-8.0, 2.0, 4.0], 0.8, max_bounces=3,
                    rx_mode="analytic")
    want = cir.cir_from_trace(r, tx_power=1.0, num_rays=4096, nbins=nbins, light_speed_mps=c,
                              sample_rate_hz=rate).cpu().numpy()
    got = ranks[0]["cir_ir"]
    assert np.array_equal(got != 0, want != 0) and got.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)

    centers = coverage.make_grid(range(-12, 13, 6), [-6, 6], [2, 8])[:16]
    cdirs = torch.from_numpy(uniform_sphere_directions(2048, seed=13)).to(cuda)
    want = coverage.coverage_irs(scene, [5.0, 0.0, 5.0], cdirs, centers, 0.8, max_bounces=2,
                                 nbins=nbins, num_rays=2048, light_speed_mps=c,
                                 sample_rate_hz=rate, rx_batch=4, engine="map").cpu().numpy()
    got = np.concatenate([ranks[0]["coverage_tile"], ranks[1]["coverage_tile"]])
    assert np.array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


MAP_KW = dict(nbins=10_000, light_speed_mps=2.998e8, sample_rate_hz=100e9)
MAP_SCALE = 1.0 / 1024  # tx_power / num_rays, exact in f32


def _map_launches(rx_mode="analytic"):
    """Launches of K-S, its backward, the histogram's record entry and its
    dense entry (their icosphere instantiations for the icosphere)."""
    if rx_mode == "icosphere":
        return (map_capture.MAP_CAPTURE_ICO_KERNEL.launches,
                map_capture.MAP_CAPTURE_BACKWARD_ICO_KERNEL.launches,
                cir.HISTOGRAM_RECORD_ICO_KERNEL.launches, cir.HISTOGRAM_KERNEL.launches)
    return (map_capture.MAP_CAPTURE_KERNEL.launches,
            map_capture.MAP_CAPTURE_BACKWARD_KERNEL.launches,
            cir.HISTOGRAM_RECORD_KERNEL.launches, cir.HISTOGRAM_KERNEL.launches)


def _assert_map_record(segs, centers, radius, rx_mode="analytic"):
    """K-S's record (K-S/ico's for the icosphere) == map_record_plain's byte
    for byte, two runs the same; K-S/ico's t_first bit for bit at every
    capture the record names; returns the record."""
    before = _map_launches(rx_mode)[0]
    if rx_mode == "icosphere":
        k1, t1 = map_capture.map_record(segs, centers, radius, rx_mode, t_first=True)
        k2, t2 = map_capture.map_record(segs, centers, radius, rx_mode, t_first=True)
        p, pt = map_capture.map_record_plain(segs, centers, radius, rx_mode, t_first=True)
        cap = p != map_capture.NO_CAPTURE
        assert t1.dtype == torch.float32 and t1.shape == p.shape
        assert torch.equal(t1[cap], t2[cap]) and torch.equal(t1[cap], pt[cap])
    else:
        k1 = map_capture.map_record(segs, centers, radius, rx_mode)
        k2 = map_capture.map_record(segs, centers, radius, rx_mode)
        p = map_capture.map_record_plain(segs, centers, radius, rx_mode)
    assert _map_launches(rx_mode)[0] == before + 2
    torch.cuda.synchronize()
    assert k1.dtype == torch.uint8 and k1.shape == (centers.shape[0], segs.t_env.shape[1])
    assert torch.equal(k1, k2) and torch.equal(k1, p)
    return k1


def _assert_map_backward(segs, centers, radius, soft, seed=5, rx_mode="analytic"):
    """The backward kernel, given K-S's record, against its plain version for
    a seeded cotangent: the segments' gradients (origin, direction,
    amplitude, distance) bit for bit; the centers' and the scale's and
    radius's sums within rtol 1e-5 (an absolute floor of 1e-6 of the largest
    entry, for the centers' sums, which add in another order); every output
    the same bits from run to run; returns the kernel's outputs. The
    icosphere's (B11/ico, given K-S/ico's record) the same way."""
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(centers.shape[0], MAP_KW["nbins"])).astype(np.float32)).to(centers.device)
    kw = dict(scale=MAP_SCALE, soft=soft, rx_mode=rx_mode, **MAP_KW)
    record = map_capture.map_record(segs, centers, radius, rx_mode)
    before = _map_launches(rx_mode)[1]
    k1 = map_capture.map_capture_backward(segs, centers, radius, g, record, **kw)
    k2 = map_capture.map_capture_backward(segs, centers, radius, g, record, **kw)
    assert _map_launches(rx_mode)[1] == before + 2
    p = map_capture.map_capture_backward_plain(segs, centers, radius, g, **kw)
    torch.cuda.synchronize()
    names = ("origin", "direction", "amplitude", "distance", "centers", "scale", "radius")
    assert len(k1) == len(k2) == len(p) == len(names)
    for name, a, b, c in zip(names, k1, k2, p):
        assert torch.equal(a, b), name
        if name in names[:4]:
            assert torch.equal(a, c), name
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6 * float(c.abs().max()), msg=name)
    assert float(k1[2].abs().max()) > 0 and (float(k1[0].abs().max()) > 0) == soft
    assert float(k1[5]) != 0.0 and (float(k1[6]) != 0.0) == soft
    return k1, g


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_map_capture_kernel_matches_plain(cuda, soft):
    """K-S on the room's segments: 100,003 rays (ragged against a block), 3
    bounces, 71 receivers (three tiles, the last short, and one outside the
    room), a 100 ns window that drops the longer paths. The record is
    map_record_plain's byte for byte; map_irs is one launch of K-S and one
    of the histogram's record entry, and its IRs are the plain map engine's
    bits (its dense rows through the dense entry); the backward kernel
    against its plain version, and through map_irs's autograd (the scale and
    the radius host tensors that require grad) the same bits as its direct
    call."""
    segs = _room_segments(cuda, 100_003)
    centers = torch.from_numpy(_room_receivers(71)).to(cuda)
    record = _assert_map_record(segs, centers, 0.7)
    plain = map_capture.map_capture_plain(segs, centers, 0.7, MAP_SCALE)
    assert int((record != map_capture.NO_CAPTURE).sum()) > 10_000
    assert bool((record[-1] == map_capture.NO_CAPTURE).all())
    before = _map_launches()
    irs = map_capture.map_irs(segs, centers, 0.7, scale=MAP_SCALE, soft=soft, **MAP_KW)
    assert [a - b for a, b in zip(_map_launches(), before)] == [1, 0, 1, 0]
    want = cir.histogram_rows(*plain, soft=soft, **MAP_KW)
    torch.cuda.synchronize()
    assert torch.equal(irs, want) and int((irs != 0).any(dim=1).sum()) > 40
    want, g = _assert_map_backward(segs, centers, 0.7, soft)
    leaves = [t.clone().requires_grad_() for t in (segs.origin, segs.direction, segs.amplitude,
                                                    segs.distance, centers)] + [
        torch.tensor(v, requires_grad=True) for v in (MAP_SCALE, 0.7)]
    s = segs._replace(origin=leaves[0], direction=leaves[1], amplitude=leaves[2],
                      distance=leaves[3])
    out = map_capture.map_irs(s, leaves[4], leaves[6], scale=leaves[5], soft=soft, **MAP_KW)
    before = _map_launches()
    got = torch.autograd.grad(out, leaves, g)
    assert [a - b for a, b in zip(_map_launches(), before)] == [0, 1, 0, 0]
    torch.cuda.synchronize()
    assert got[5].device.type == got[6].device.type == "cpu"
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_histogram_record_kernel_matches_the_rows_histogram(cuda, soft):
    """The histogram's record entry against the dense entry on the plain map
    engine's rows, bit for bit: 100,003 room rays x 3 bounces, a receiver
    around tx (every ray's first capture on bounce 0: 100,003 captures, 49
    chunks of its row taking turns), one far outside the room (an empty
    row) and 30 others; two runs the same."""
    segs = _room_segments(cuda, 100_003)
    ring = np.vstack([[[3.0, 2.0, 2.0]], _room_receivers(31)]).astype(np.float32)
    centers = torch.from_numpy(ring).to(cuda)
    record = map_capture.map_record(segs, centers, 0.7)
    rows = map_capture.map_capture_plain(segs, centers, 0.7, MAP_SCALE)
    hkw = dict(soft=soft, **MAP_KW)
    before = cir.HISTOGRAM_RECORD_KERNEL.launches
    k1 = cir.histogram_record(record, segs, centers, 0.7, MAP_SCALE, **hkw)
    k2 = cir.histogram_record(record, segs, centers, 0.7, MAP_SCALE, **hkw)
    assert cir.HISTOGRAM_RECORD_KERNEL.launches == before + 2
    want = cir.histogram_rows(*rows, **hkw)
    torch.cuda.synchronize()
    per_row = rows[2].sum(dim=1)
    assert int(per_row[0]) == 100_003 and int(per_row[-1]) == 0
    assert torch.equal(k1, k2) and torch.equal(k1, want)
    assert float(k1[0].sum()) > 0 and not bool(k1[-1].any())


def test_map_capture_kernel_many_receivers_and_bounces(cuda):
    """Ten bounces, 20,011 rays and 600 receivers (three groups of the
    backward's bounces, three stages of its staged centers, the last short;
    K-S's last tile short), soft binning: the record byte for byte, the IRs
    the plain rows' bits, the backward against its plain version; a
    receiver alone is the same bits as in the batch."""
    segs = _room_segments(cuda, 20_011, max_bounces=10)
    centers = torch.from_numpy(_room_receivers(600)).to(cuda)
    record = _assert_map_record(segs, centers, 0.7)
    late = (record >= 5) & (record != map_capture.NO_CAPTURE)
    assert int(late.sum()) > 0  # late bounces capture too
    _assert_map_backward(segs, centers, 0.7, True, seed=9)
    irs = map_capture.map_irs(segs, centers, 0.7, scale=MAP_SCALE, soft=True, **MAP_KW)
    want = cir.histogram_rows(*map_capture.map_capture_plain(segs, centers, 0.7, MAP_SCALE),
                              soft=True, **MAP_KW)
    torch.cuda.synchronize()
    assert torch.equal(irs, want)
    for k in (0, 31, 32, 599):
        one = map_capture.map_irs(segs, centers[k:k + 1], 0.7, scale=MAP_SCALE, soft=True,
                                  **MAP_KW)
        assert torch.equal(one[0], irs[k]), k


def test_map_capture_kernel_grazing_and_first_capture(cuda):
    """Hand-made segments: 32 rays along +x at y = 1 that graze the unit
    sphere at the origin (|q.d| under the clamp 1e-6 r where they hit), 64
    rays through both spheres on bounce 0 and back through both on bounce 1
    (only the first capture of each receiver counts), a fifth blocked by the
    environment first and a tenth dead: record and backward against the
    plain version; the grazing rays take the clamped gradient."""
    g = np.random.default_rng(17)
    xs = (-3.4526698e-4 + np.arange(-3000, 3000) * 2.9e-11).astype(np.float32)
    o = torch.from_numpy(np.stack([xs, np.ones_like(xs), np.zeros_like(xs)], 1))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand_as(o)
    t = intersect.sphere_t(o, d, torch.zeros(3), torch.tensor(1.0))
    qd = intersect.dot3(o + torch.where(t < 1e29, t, 0.0)[:, None] * d, d)
    graze = o[(t < 1e29) & (qd.abs() < 1e-6)][:32]
    assert graze.shape[0] == 32
    yz = torch.from_numpy(g.uniform(-1.2, 1.2, (64, 2)).astype(np.float32))
    through = torch.cat([torch.full((64, 1), -5.0), yz], 1)
    back = torch.cat([torch.full((64, 1), 8.0), yz.flip(0)], 1)
    origin = torch.stack([torch.cat([through, graze]), torch.cat([back, graze])])
    direction = torch.zeros_like(origin)
    direction[0, :, 0], direction[1, :, 0] = 1.0, -1.0
    n = origin.shape[1]
    t_env = torch.from_numpy(np.where(g.random((2, n)) < 0.2, g.uniform(0.5, 3.0, (2, n)),
                                      1e30).astype(np.float32))
    alive = torch.from_numpy(g.random((2, n)) > 0.1)
    t_env[:, 64:], alive[:, 64:] = 1e30, True
    amp = torch.from_numpy(g.uniform(0.1, 1.0, (2, n)).astype(np.float32))
    dist = torch.from_numpy(g.uniform(0.0, 12.0, (2, n)).astype(np.float32))
    segs = EnvSegments(*(x.contiguous().to(cuda) for x in (origin, direction, t_env, amp, dist,
                                                           alive)))
    centers = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]], device=cuda)
    record = _assert_map_record(segs, centers, 1.0)
    cap = map_capture.map_capture_plain(segs, centers, 1.0, MAP_SCALE)[2].reshape(2, 2, n)
    assert bool((record[0, 64:] == 0).all())  # grazed
    assert int((record[:, :64] == 1).sum()) > 0  # bounce 1 won
    assert not bool((cap[:, 0] & cap[:, 1]).any())  # one capture a ray and receiver
    (g_o, *_), _ = _assert_map_backward(segs, centers, 1.0, True, seed=13)
    assert float(g_o[0, 64:].abs().max()) > 1e3 * float(g_o[0, :64].abs().max())


def test_map_engine_on_card_takes_the_capture_kernels(cuda, monkeypatch):
    """coverage_irs(engine='map', soft=True) on the card: one launch of K-S
    and of the histogram's record entry per receiver batch (none of the
    dense entry), one of the backward kernel per batch in the backward,
    never the plain first-capture composition, also where
    tx_power requires grad; the IRs and the tx gradient are the same bits
    either way, and the tx_power gradient is within rtol 1e-5 of the plain
    backward's on the same segments."""
    n = 65_536
    dirs = morton_sphere_directions(n, generator=torch.Generator(cuda).manual_seed(8), device=cuda)
    centers = _room_receivers(41)
    kw = dict(max_bounces=2, nbins=10_000, num_rays=n, light_speed_mps=2.998e8,
              sample_rate_hz=100e9, soft=True, engine="map", rx_batch=16)
    scene = Scene.from_mesh(make_room(), cuda)
    w = torch.from_numpy(np.random.default_rng(4).normal(size=(41, 10_000)).astype(np.float32)).to(cuda)
    calls = []
    first_capture = coverage._first_capture
    monkeypatch.setattr(coverage, "_first_capture",
                        lambda *a, **k: calls.append(1) or first_capture(*a, **k))

    def run(tx_power):
        tx = torch.tensor([3.0, 2.0, 2.0], device=cuda, requires_grad=True)
        irs = coverage.coverage_irs(scene, tx, dirs, centers, 0.8, tx_power=tx_power, **kw)
        grads = torch.autograd.grad((irs * w).sum(), [tx] + (
            [tx_power] if isinstance(tx_power, torch.Tensor) else []))
        return irs.detach(), grads

    before = _map_launches()
    irs, (g_tx,) = run(1.0)
    assert [a - b for a, b in zip(_map_launches(), before)] == [3, 3, 3, 0]
    before = _map_launches()
    irs_p, (g_p, g_power) = run(torch.tensor(1.0, device=cuda, requires_grad=True))
    assert [a - b for a, b in zip(_map_launches(), before)] == [3, 3, 3, 0] and calls == []
    torch.cuda.synchronize()
    assert int((irs != 0).any(dim=1).sum()) > 30 and float(g_tx.abs().max()) > 0
    assert torch.equal(irs, irs_p) and torch.equal(g_tx, g_p)
    with torch.no_grad():
        segs = trace_env(scene, [3.0, 2.0, 2.0], dirs, max_bounces=2)
    centers = torch.from_numpy(centers).to(cuda)
    g_scale = sum(map_capture.map_capture_backward_plain(
        segs, centers[k:k + 16], 0.8, w[k:k + 16], scale=1.0 / n, soft=True,
        **MAP_KW)[5].cpu() for k in range(0, 41, 16))
    assert g_power.device.type == "cuda" and float(g_power) != 0.0
    torch.testing.assert_close(g_power.cpu(), g_scale / n, rtol=1e-5, atol=0)


def test_capture_rule_shared_with_the_coverage_kernel(cuda):
    """K3 and K-S take their capture rule from one header (sphere.cuh): on
    the room's segments K3's hard IRs have exactly K-S's nonzero bins, and
    agree within rtol 1e-5 (their sums run in other orders)."""
    segs = _room_segments(cuda, 100_003)
    centers = _room_receivers(71)
    k3 = coverage_hist.coverage_hist(segs, centers, 0.7, **MAP_KW)
    ks = map_capture.map_irs(segs, centers, 0.7, scale=1.0, soft=False, **MAP_KW)
    torch.cuda.synchronize()
    assert torch.equal(k3 != 0, ks != 0) and int((ks != 0).sum()) > 1000
    torch.testing.assert_close(k3, ks, rtol=1e-5, atol=1e-12)


def _tie_mesh(n_tris, seed, reach=None):
    """(v0, e1, e2) of n_tris random triangles, the second half copies of
    the first (exact ties: the lower face must win). With `reach` (center,
    radius): every vertex inside that ball, as the cull assumes."""
    g = np.random.default_rng(seed)
    half = (n_tris + 1) // 2
    if reach is None:
        verts = g.uniform(-3.0, 3.0, size=(half, 3, 3))
    else:
        center, radius = reach
        p = g.normal(size=(half, 3, 3))
        p *= (g.uniform(0.2, 0.999, size=(half, 3, 1)) ** (1 / 3)) / np.linalg.norm(
            p, axis=2, keepdims=True)
        verts = center + radius * p
    verts = np.concatenate([verts, verts])[:n_tris].astype(np.float32)
    v = torch.from_numpy(verts)
    return v[:, 0].contiguous(), (v[:, 1] - v[:, 0]).contiguous(), (v[:, 2] - v[:, 0]).contiguous()


def _brute_rays(cuda, n, center, radius, seed):
    """n rays from 1.5 to 60 radii away aimed within two radii of `center`
    (many hits, many grazing misses), and 1,024 parked at 1e9."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    aim = center + radius * g.uniform(-2.0, 2.0, size=(n, 3))
    o = aim - d * radius * g.uniform(1.5, 60.0, size=(n, 1))
    o[-1024:] = 1e9
    as_card = lambda x: torch.from_numpy(x.astype(np.float32)).to(cuda)  # noqa: E731
    return as_card(o), as_card(d)


def vote_pass(o, d, v0, e1, e2):
    """(N, T) bool: K-B's warp vote after u for rays (N, 3) against
    triangles (T, 3) in brute_hit.cuh's f32 expressions and order (mt_head,
    mt_may_hit): |det| > 1e-12, u >= 0 and u <= 1. Where it is False the
    test cannot accept: a warp none of whose testing lanes pass skips the
    rest of that face's test."""
    o, d = o[:, None, :], d[:, None, :]
    v0, e1, e2 = v0[None], e1[None], e2[None]
    px = d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1]
    py = d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2]
    pz = d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    valid = det.abs() > 1e-12
    inv = torch.where(valid, 1.0 / torch.where(valid, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    t = o - v0
    u = (t[..., 0] * px + t[..., 1] * py + t[..., 2] * pz) * inv
    return valid & (u >= 0.0) & (u <= 1.0)


def _brute_warp_rays(cuda, n, v0, e1, e2, center, seed):
    """n rays in warps of 32 aimed alike: warp k at one point of face k %
    T (barycentric (a, b) drawn from [-0.3, 1.3], so that lanes fall on
    both sides of the face's edges) from 1.5 to 20 units away, each lane
    jittered by 2% of the face; every fifth warp aimed 10 units off
    `center` (beside the cull's ball); rays [n // 2, n // 2 + 1024) parked
    at 1e9. So whole warps fail the vote after u for most faces, and some
    warps split on it; n not a multiple of 32 leaves a ragged last warp.
    Returns (o, d, the parked slice)."""
    g = np.random.default_rng(seed)
    v0, e1, e2 = (x.cpu().numpy().astype(np.float64) for x in (v0, e1, e2))
    warps = -(-n // 32)
    f = np.arange(warps) % v0.shape[0]
    ab = g.uniform(-0.3, 1.3, size=(warps, 2))
    aim = v0[f] + ab[:, :1] * e1[f] + ab[:, 1:] * e2[f]
    aim = np.where((np.arange(warps) % 5 == 4)[:, None], center + 10.0, aim)
    src = aim + g.normal(size=(warps, 3)) * g.uniform(1.5, 20.0, size=(warps, 1))
    lane_ab = ab[:, None, :] + 0.02 * g.normal(size=(warps, 32, 2))
    pts = (v0[f][:, None] + lane_ab[..., :1] * e1[f][:, None] + lane_ab[..., 1:] * e2[f][:, None])
    pts = np.where((np.arange(warps) % 5 == 4)[:, None, None], aim[:, None], pts)
    o = np.repeat(src, 32, axis=0)[:n]
    d = (pts.reshape(-1, 3)[:n] - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    parked = slice(n // 2, n // 2 + 1024)
    o[parked] = 1e9
    as_card = lambda x: torch.from_numpy(x.astype(np.float32)).to(cuda)  # noqa: E731
    return as_card(o), as_card(d), parked


@pytest.mark.parametrize("aim", ["scattered", "warps"])
@pytest.mark.parametrize("cull", [False, True], ids=["all", "cull"])
@pytest.mark.parametrize("n_tris", [1, 12, 80, 257, 2048])
def test_brute_hit_kernel_matches_plain(cuda, n_tris, cull, aim):
    """K-B against `_brute_forward` on the card, t and face torch.equal:
    random meshes of 1, 12, 80, 257 (two tiles, the last of one face) and
    2,048 faces whose second half repeats the first (ties go to the lower
    face), 100,003 rays (ragged against a block and a warp) and 1,024
    parked rays; with the cull, every vertex inside the cull's ball.
    `scattered`: rays from all sides within two radii of the mesh; `warps`:
    each warp's rays aimed alike (`_brute_warp_rays`), so that whole warps
    skip a face after the vote on u (`vote_pass`, counted on the first
    8,192 rays) and others split on it. Two runs the same bits; one launch a
    call."""
    center, radius = np.array([1.0, -2.0, 3.0]), 1.5
    v0, e1, e2 = (x.to(cuda) for x in _tie_mesh(n_tris, n_tris, (center, radius) if cull else None))
    n = 100_003
    if aim == "scattered":
        o, d = _brute_rays(cuda, n, center if cull else np.zeros(3), radius if cull else 3.0,
                           seed=n_tris)
        parked = slice(n - 1024, n)
    else:
        o, d, parked = _brute_warp_rays(cuda, n, v0, e1, e2, center, seed=n_tris)
        votes = vote_pass(o[:8192], d[:8192], v0, e1, e2).reshape(256, 32, -1)
        some = votes.any(dim=1)
        assert int((~some).sum()) > 0 and int((some & ~votes.all(dim=1)).sum()) > 0
    c = torch.tensor([*center, radius], dtype=torch.float32, device=cuda) if cull else None
    before = intersect.BRUTE_HIT_KERNEL.launches
    k1 = intersect.brute_hit(o, d, v0, e1, e2, cull=c)
    k2 = intersect.brute_hit(o, d, v0, e1, e2, cull=c)
    assert intersect.BRUTE_HIT_KERNEL.launches == before + 2
    p = intersect._brute_forward(o, d, v0, e1, e2, intersect.T_MIN_EPS, intersect.T_MAX, None)
    torch.cuda.synchronize()
    for a, b, w in zip(k1, k2, p):
        assert torch.equal(a, b) and torch.equal(a, w)
    assert int((k1[1] >= 0).sum()) > 100 and bool((k1[1][parked] == -1).all())
    if n_tris > 1:
        assert int(k1[1].max()) < (n_tris + 1) // 2  # ties to the lower copy
    if cull:
        assert not bool(intersect.cull_pass(o, d, c).all())


@pytest.mark.parametrize("radius", [0.1, 1.0])
def test_brute_hit_kernel_icosphere_with_its_cull(cuda, radius):
    """K-B on the receiver icosphere with its own bounding sphere as the
    cull: 100,000 rays through its vertices and edge midpoints, nearly
    tangent there and pushed out or in by up to 1% of the radius, from 1.5
    to 10^4 radii away; t and face == the plain version's, and the cull
    rejects some."""
    g = np.random.default_rng(int(radius * 10))
    tri = tracer._UNIT_ICO_TRI.astype(np.float64)
    anchors = np.concatenate([tri.reshape(-1, 3), (tri + np.roll(tri, 1, axis=1)).reshape(-1, 3)])
    n = 100_000
    p = anchors[g.integers(0, len(anchors), n)]
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    side = g.normal(size=(n, 3))
    side -= (side * p).sum(1, keepdims=True) * p
    d = side / np.linalg.norm(side, axis=1, keepdims=True) + g.normal(size=(n, 1)) * 1e-3 * p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    center = np.array([12.0, -7.0, 3.0])
    dist = 10.0 ** g.uniform(np.log10(1.5), 4.0, size=(n, 1))
    o = center + p * radius * (1.0 + g.uniform(-1e-2, 1e-2, size=(n, 1))) - d * dist * radius
    o, d = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (o, d))
    c = torch.tensor([*center, radius], dtype=torch.float32, device=cuda)
    v0, e1, e2 = tracer.icosphere_soa(c[:3], radius)
    k = intersect.brute_hit(o, d, v0, e1, e2, cull=c)
    p_t, p_face = intersect._brute_forward(o, d, v0, e1, e2, intersect.T_MIN_EPS,
                                           intersect.T_MAX, None)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p_t) and torch.equal(k[1], p_face)
    assert int((p_face >= 0).sum()) > 1000 and not bool(intersect.cull_pass(o, d, c).all())


def test_scan_tracer_icosphere_on_card_matches_plain(cuda, monkeypatch):
    """trace_to_rx(rx_mode="icosphere") on the card, K-B for the receiver
    (one launch a bounce, with the cull) and for the room's brute
    environment, against the same trace with `brute_hit` swapped for its
    plain version: the same captures, bounces, amplitudes and distances,
    bit for bit; and the gradient through both the same bits."""
    dirs = morton_sphere_directions(200_003, generator=torch.Generator(cuda).manual_seed(2),
                                    device=cuda)
    scene = Scene.from_mesh(make_room(), cuda)

    def run():
        tx = torch.tensor([3.0, 2.0, 2.0], device=cuda, requires_grad=True)
        res = trace_to_rx(scene, tx, dirs, (-4.0, 1.0, 3.0), 0.5, max_bounces=3,
                          rx_mode="icosphere")
        (g,) = torch.autograd.grad(res.distance.sum(), tx)
        return res, g

    before = intersect.BRUTE_HIT_KERNEL.launches
    k, gk = run()
    assert intersect.BRUTE_HIT_KERNEL.launches == before + 6  # receiver and room, 3 bounces
    monkeypatch.setattr(intersect, "brute_hit", lambda o, d, v0, e1, e2, t_min, t_max, chunk, cull:
                        intersect._brute_forward(o, d, v0, e1, e2, t_min, t_max, chunk))
    before = intersect.BRUTE_HIT_KERNEL.launches
    p, gp = run()
    assert intersect.BRUTE_HIT_KERNEL.launches == before
    torch.cuda.synchronize()
    assert int(k.captured.sum()) > 100
    for a, b in zip(k[:4], p[:4]):
        assert torch.equal(a, b)
    assert torch.equal(gk, gp) and float(gk.abs().sum()) > 0


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_map_capture_ico_kernels_match_plain(cuda, soft):
    """The icosphere's capture pass on the room's segments (100,003 rays, 3
    bounces, 71 receivers of radius 0.7, one outside the room): K-S/ico's
    record == map_record_plain's byte for byte; the record entry/ico's IRs ==
    the plain map engine's dense rows through the dense entry, bit for bit;
    B11/ico against its plain version (rtol 1e-5, the segments' gradients bit
    for bit), two runs the same bits; map_irs one launch of each forward
    kernel, its autograd one of B11/ico, the same bits as the direct call."""
    segs = _room_segments(cuda, 100_003)
    centers = torch.from_numpy(_room_receivers(71)).to(cuda)
    record = _assert_map_record(segs, centers, 0.7, "icosphere")
    assert int((record != map_capture.NO_CAPTURE).sum()) > 10_000
    assert bool((record[-1] == map_capture.NO_CAPTURE).all())
    rows = map_capture.map_capture_plain(segs, centers, 0.7, MAP_SCALE, "icosphere")
    want = cir.histogram_rows(*rows, soft=soft, **MAP_KW)
    _, t_first = map_capture.map_record(segs, centers, 0.7, "icosphere", t_first=True)
    before = _map_launches("icosphere")
    k1 = cir.histogram_record(record, segs, centers, 0.7, MAP_SCALE, soft=soft,
                              rx_mode="icosphere", t_first=t_first, **MAP_KW)
    irs = map_capture.map_irs(segs, centers, 0.7, scale=MAP_SCALE, soft=soft, rx_mode="icosphere",
                              **MAP_KW)
    assert [a - b for a, b in zip(_map_launches("icosphere"), before)] == [1, 0, 2, 0]
    torch.cuda.synchronize()
    assert torch.equal(k1, want) and torch.equal(irs, want)
    assert int((irs != 0).any(dim=1).sum()) > 40
    want, g = _assert_map_backward(segs, centers, 0.7, soft, rx_mode="icosphere")
    leaves = [t.clone().requires_grad_() for t in (segs.origin, segs.direction, segs.amplitude,
                                                    segs.distance, centers)] + [
        torch.tensor(v, requires_grad=True) for v in (MAP_SCALE, 0.7)]
    s = segs._replace(origin=leaves[0], direction=leaves[1], amplitude=leaves[2],
                      distance=leaves[3])
    out = map_capture.map_irs(s, leaves[4], leaves[6], scale=leaves[5], soft=soft,
                              rx_mode="icosphere", **MAP_KW)
    before = _map_launches("icosphere")
    got = torch.autograd.grad(out, leaves, g)
    assert [a - b for a, b in zip(_map_launches("icosphere"), before)] == [0, 1, 0, 0]
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


def test_map_capture_ico_many_receivers_and_bounces(cuda):
    """Ten bounces, 20,011 rays, 600 icosphere receivers (K-S/ico's last tile
    short, three stages of B11/ico's centers), soft: the record byte for
    byte, the backward against its plain version, a receiver alone the same
    bits as in the batch."""
    segs = _room_segments(cuda, 20_011, max_bounces=10)
    centers = torch.from_numpy(_room_receivers(600)).to(cuda)
    record = _assert_map_record(segs, centers, 0.7, "icosphere")
    assert int(((record >= 5) & (record != map_capture.NO_CAPTURE)).sum()) > 0
    _assert_map_backward(segs, centers, 0.7, True, seed=9, rx_mode="icosphere")
    irs = map_capture.map_irs(segs, centers, 0.7, scale=MAP_SCALE, soft=True, rx_mode="icosphere",
                              **MAP_KW)
    for k in (0, 31, 32, 599):
        one = map_capture.map_irs(segs, centers[k:k + 1], 0.7, scale=MAP_SCALE, soft=True,
                                  rx_mode="icosphere", **MAP_KW)
        assert torch.equal(one[0], irs[k]), k


def _ico_tie_segments(n, bounces, m, radius, seed, hot=3_000):
    """(segments, centers, aim) on the CPU, made with numpy from `seed`: m
    icosphere receivers of `radius` 1.6 radii apart (a 5 x 5 x 5 grid's
    first m points), so that a line through one passes the cull of its
    neighbours, and n rays x `bounces` segments, segment (b, i) aimed at
    receiver aim[b, i] = (i // 8 + 3 b) % m (eight rays of a warp at one
    receiver; receiver 0 for the first `hot` rays at bounce 0, a row of more
    than 2,048 captures), exactly at one of its vertices or edge midpoints,
    where adjacent faces can return an equal t, entering there, from 1.5 to
    40 radii away. A tenth aim nowhere (aim -1); a tenth of t_env stop short
    of the receiver, a tenth beyond it, the rest MISS; 15% of the segments
    are dead."""
    g = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*(np.arange(5),) * 3, indexing="ij"), -1).reshape(-1, 3)
    centers = (np.array([2.0, -3.0, 4.0]) + 1.6 * radius * grid[:m]).astype(np.float32)
    tri = tracer._UNIT_ICO_TRI.astype(np.float64)
    anchors = np.concatenate([tri.reshape(-1, 3),
                              0.5 * (tri + np.roll(tri, 1, axis=1)).reshape(-1, 3)])
    shape = (bounces, n)
    i, b = np.arange(n)[None, :], np.arange(bounces)[:, None]
    aim = np.where((i < hot) & (b == 0), 0, (i // 8 + 3 * b) % m)
    p = anchors[g.integers(0, len(anchors), shape)]
    d = g.normal(size=shape + (3,))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(((d * p).sum(-1) > 0)[..., None], -d, d)  # entering through p
    away = g.uniform(1.5, 40.0, shape) * radius
    o = centers.astype(np.float64)[aim] + radius * p - d * away[..., None]
    nowhere = g.random(shape) < 0.1
    o = np.where(nowhere[..., None], o + 50.0 * radius, o)
    u = g.random(shape)
    t_env = np.where(u < 0.8, 1e30, away * np.where(u < 0.9, g.uniform(0.5, 0.99, shape),
                                                     g.uniform(1.01, 3.0, shape)))
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))  # noqa: E731
    segs = EnvSegments(f32(o), f32(d), f32(t_env), f32(g.uniform(0.1, 1.0, shape)),
                       f32(g.uniform(0.0, 20.0, shape)), torch.from_numpy(g.random(shape) > 0.15))
    return segs, torch.from_numpy(centers), torch.from_numpy(np.where(nowhere, -1, aim))


@pytest.mark.parametrize("n, bounces, m", [(12_345, 10, 37), (16_384, 3, 71)],
                         ids=["ragged-37rx-10b", "aligned-71rx-3b"])
def test_map_capture_ico_ties_and_long_rows(cuda, n, bounces, m):
    """K-S/ico and the record entry/ico on `_ico_tie_segments`: rays through
    the receivers' vertices and edge midpoints (a tenth of the hits tie two
    faces' t bit for bit; tests/test_torch_icosphere.py holds that in the
    plain version), several lanes of a warp passing the cull for one
    receiver and for several; m not a multiple of 32 (37; 71, a second tile
    of 7), 10 bounces, ragged (12,345) and 16-byte aligned (16,384) rows:
    the record byte for byte and t_first bit for bit at every capture
    against map_record_plain; receiver 0's row over 2,048 captures (two
    chunks of the record entry); the IRs, hard and soft, bit for bit against
    the plain map engine's dense rows through the dense entry (whose chunks
    add as the record entry's do; histogram_record_plain's index_add_ adds a
    bin's captures in another order on the card: within rtol 1e-5 of it);
    two runs the same bits."""
    segs_cpu, centers_cpu, _ = _ico_tie_segments(n, bounces, m, 0.5, seed=n)
    segs = EnvSegments(*(t.to(cuda) for t in segs_cpu))
    centers = centers_cpu.to(cuda)
    record = _assert_map_record(segs, centers, 0.5, "icosphere")
    captured = record != map_capture.NO_CAPTURE
    assert int(captured[0].sum()) > 2048 and int(captured.sum(dim=1).min()) > 0
    assert int((record[:, :32] != map_capture.NO_CAPTURE).sum()) > 8
    _, t_first = map_capture.map_record(segs, centers, 0.5, "icosphere", t_first=True)
    rows = map_capture.map_capture_plain(segs, centers, 0.5, MAP_SCALE, "icosphere")
    for soft in (False, True):
        before = _map_launches("icosphere")[2]
        k1, k2 = (cir.histogram_record(record, segs, centers, 0.5, MAP_SCALE, soft=soft,
                                       rx_mode="icosphere", t_first=t_first, **MAP_KW)
                  for _ in range(2))
        assert _map_launches("icosphere")[2] == before + 2
        want = cir.histogram_rows(*rows, soft=soft, **MAP_KW)
        plain = map_capture.histogram_record_plain(record, segs, centers, 0.5, MAP_SCALE,
                                                   soft=soft, rx_mode="icosphere", **MAP_KW)
        torch.cuda.synchronize()
        assert torch.equal(k1, k2) and torch.equal(k1, want), soft
        torch.testing.assert_close(k1, plain, rtol=1e-5, atol=1e-12)
        assert int((k1 != 0).any(dim=1).sum()) > m // 2


@pytest.mark.parametrize("n, bounces, m", [(12_345, 10, 37), (16_384, 3, 71)],
                         ids=["ragged-37rx-10b", "aligned-71rx-3b"])
def test_map_capture_backward_ico_ties_match_plain(cuda, n, bounces, m):
    """B11/ico on `_ico_tie_segments` (rays through the receivers' vertices
    and edge midpoints), soft: at many captures two or more faces give the
    capture's t bit for bit, often faces that different lanes of the warp
    test (f and f' not equal mod 32), and the VJP of the next tied face
    differs from the lowest's; the segments' gradients equal the plain
    version's bit for bit (it takes the lowest tied face, torch.argmin's),
    the centers', scale's and radius's within rtol 1e-5; two runs the same
    bits (`_assert_map_backward`)."""
    segs_cpu, centers_cpu, _ = _ico_tie_segments(n, bounces, m, 0.5, seed=n + 1)
    segs = EnvSegments(*(t.to(cuda) for t in segs_cpu))
    centers = centers_cpu.to(cuda)
    record = map_capture.map_record(segs, centers, 0.5, "icosphere")
    k, i = (record != map_capture.NO_CAPTURE).nonzero(as_tuple=True)
    bb = record[k, i].long()
    o, d = segs.origin[bb, i], segs.direction[bb, i]
    tied = across = differs = 0
    for r in range(m):
        sel = (k == r).nonzero().squeeze(1)
        v0, e1, e2 = tracer.icosphere_soa(centers[r], 0.5)
        per_face = torch.stack([intersect._mt_chunk(o[sel], d[sel], v0[f:f + 1], e1[f:f + 1],
                                                    e2[f:f + 1], intersect.T_MIN_EPS,
                                                    intersect.T_MAX)[0] for f in range(80)], 1)
        at_best = per_face == per_face.min(dim=1).values[:, None]
        tie = at_best.sum(dim=1) >= 2
        first = at_best.int().argmax(dim=1)
        second = (at_best & (torch.arange(80, device=cuda) > first[:, None])).int().argmax(dim=1)
        tied += int(tie.sum())
        across += int((tie & (first % 32 != second % 32)).sum())
        g = torch.ones(int(tie.sum()), device=cuda)
        lo = intersect.closed_form_t_vjp(o[sel][tie], d[sel][tie], v0[first[tie]], e1[first[tie]],
                                         e2[first[tie]], g)
        hi = intersect.closed_form_t_vjp(o[sel][tie], d[sel][tie], v0[second[tie]],
                                         e1[second[tie]], e2[second[tie]], g)
        differs += int((lo[1] != hi[1]).any(dim=1).sum())
    assert tied > 100 and across > 50 and differs > 50
    _assert_map_backward(segs, centers, 0.5, True, seed=n, rx_mode="icosphere")


def test_coverage_icosphere_on_card_takes_the_ico_kernels(cuda, monkeypatch):
    """coverage_irs(rx_mode="icosphere", soft=True) on the card: per
    receiver batch one launch of K-S/ico and of the record entry/ico, one of
    B11/ico in the backward, K-B for the room's environment, never the plain
    first-capture composition nor the plain brute hit; the IRs are the plain
    composition's bits (`_first_capture` and the dense histogram)."""
    n = 65_536
    dirs = morton_sphere_directions(n, generator=torch.Generator(cuda).manual_seed(8), device=cuda)
    centers = _room_receivers(41)
    kw = dict(max_bounces=2, nbins=10_000, num_rays=n, light_speed_mps=2.998e8,
              sample_rate_hz=100e9, soft=True, engine="map", rx_batch=16, rx_mode="icosphere")
    scene = Scene.from_mesh(make_room(), cuda)
    calls = []
    first_capture, plain_hit = coverage._first_capture, intersect._brute_forward
    monkeypatch.setattr(coverage, "_first_capture",
                        lambda *a, **k: calls.append(1) or first_capture(*a, **k))
    monkeypatch.setattr(intersect, "_brute_forward",
                        lambda *a, **k: calls.append(2) or plain_hit(*a, **k))
    tx = torch.tensor([3.0, 2.0, 2.0], device=cuda, requires_grad=True)
    before, b_hit = _map_launches("icosphere"), intersect.BRUTE_HIT_KERNEL.launches
    irs = coverage.coverage_irs(scene, tx, dirs, centers, 0.8, **kw)
    (g_tx,) = torch.autograd.grad(irs.square().sum(), tx)
    assert [a - b for a, b in zip(_map_launches("icosphere"), before)] == [3, 3, 3, 0]
    assert intersect.BRUTE_HIT_KERNEL.launches == b_hit + 2 and calls == []
    monkeypatch.undo()
    with torch.no_grad():
        segs = trace_env(scene, [3.0, 2.0, 2.0], dirs, max_bounces=2)
        t_rx, first = coverage._first_capture(segs, torch.from_numpy(centers).to(cuda), 0.8,
                                              "icosphere")
        zero = torch.zeros((), device=cuda)
        scale = coverage._amp_scale(1.0, n, cuda)
        amp = (torch.where(first, segs.amplitude, zero) * scale).reshape(41, -1)
        dist = torch.where(first, segs.distance + t_rx, zero).reshape(41, -1)
        want = cir.histogram_rows(amp, dist, first.reshape(41, -1), soft=True, nbins=10_000,
                                  light_speed_mps=2.998e8, sample_rate_hz=100e9)
    torch.cuda.synchronize()
    assert torch.equal(irs.detach(), want) and int((want != 0).any(dim=1).sum()) > 20
    assert bool(torch.isfinite(g_tx).all()) and float(g_tx.abs().max()) > 0


_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def _is_sync(name: str) -> bool:
    return name in _SYNCS or (name.startswith("cudaMemcpy") and "Async" not in name)


@pytest.mark.parametrize("unit", ["analytic", "icosphere", "sweep"])
def test_every_host_wait_of_a_unit_is_named(cuda, unit):
    """Under the profiler, each synchronize and synchronous copy of the
    runtime inside the facade's spans lies inside an `rfx.wait.*` span, and
    no device record carries an `rfx.*` name: one CIR request with each
    receiver (the fused trace; the scan tracer on K2 and K-B) and one exact
    sweep (K-B, K3, the batched K-P), each warmed up first."""
    from torch.profiler import ProfilerActivity, profile

    dirs = morton_sphere_directions(65_536, generator=torch.Generator(cuda).manual_seed(5),
                                    device=cuda)
    if unit == "sweep":
        t = Tracer(make_room(), 2.998e8, 100e9, 100e-9, 2, 65_536, device=cuda)
        centers = _room_receivers(64)

        def request():
            t.rx_power_dbm(t.compute_coverage((3.0, 2.0, 2.0), 1.0, centers, 0.5,
                                              directions=dirs))
    else:
        t = Tracer(make_terrain(grid=48, extent=40.0, seed=3), 2.998e8, 100e9, 200e-9, 4,
                   65_536, rx_mode=unit, device=cuda)

        def request():
            _, ir = t.compute_cir((2.0, 1.0, 12.0), 1.0, (-5.0, 2.0, 6.0), 1.0,
                                  directions=dirs, record_paths=False)
            t.rx_power_dbm(ir)

    request()
    torch.cuda.synchronize()
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request()
        torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in profiling.counters().items()}
    events = [(e.time_range.start, e.time_range.end, e.name, str(e.device_type))
              for e in prof.events()]
    host = [e for e in events if "CUDA" not in e[3]]
    facade = [e for e in host if e[2].startswith("rfx.api.")]
    waits = [e for e in host if e[2].startswith("rfx.wait.")]
    inside = lambda e, spans: any(a <= e[0] and e[1] <= b for a, b, *_ in spans)  # noqa: E731
    syncs = [e for e in host if _is_sync(e[2]) and inside(e, facade)]
    assert len(facade) == 2 and syncs and waits
    layer = {"analytic": "rfx.tracer.fused", "icosphere": "rfx.ops.rx_hit",
             "sweep": "rfx.coverage.hist"}[unit]
    assert layer in {e[2] for e in host}
    assert [e[2] for e in syncs if not inside(e, waits)] == []
    assert [e[2] for e in events if "CUDA" in e[3] and e[2].startswith("rfx.")] == []
    assert moved["bytes_to_host"] > 0 and moved["bytes_to_device"] > 0


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32)


def test_coverage_irs_come_back_in_page_locked_memory_that_no_later_call_reuses(cuda,
                                                                                 monkeypatch):
    """An exact sweep of 64 room receivers x 10,000 bins (2.56 MB, over
    `PINNED_MIN_BYTES`): the array lives in page-locked memory and holds the
    very bits of the IRs the trace made; it keeps them while three further
    sweeps on other rays come and go; and its dBm is the dBm of a pageable
    copy, bit for bit."""
    from rfx_torch import api

    made = []

    def keep(*args, **kwargs):
        made.append(coverage.coverage_irs(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(api, "coverage_irs", keep)
    t = Tracer(make_room(), 2.998e8, 100e9, 100e-9, 2, 65_536, device=cuda)
    centers = _room_receivers(64)
    gen = torch.Generator(cuda).manual_seed(8)

    def sweep():
        dirs = morton_sphere_directions(65_536, generator=gen, device=cuda)
        return t.compute_coverage((3.0, 2.0, 2.0), 1.0, centers, 0.5, directions=dirs)

    a = sweep()
    assert a.nbytes >= profiling.PINNED_MIN_BYTES
    assert torch.from_numpy(a).is_pinned()
    want = made[0].cpu().numpy()
    assert np.array_equal(_bits(a), _bits(want)) and int((want != 0).any(axis=1).sum()) > 20
    for _ in range(3):
        later = sweep()
        assert not np.array_equal(later, want)
        del later
    assert np.array_equal(_bits(a), _bits(want))
    pageable = np.array(a, copy=True)
    assert not torch.from_numpy(pageable).is_pinned()
    assert np.array_equal(_bits(t.rx_power_dbm(a)), _bits(t.rx_power_dbm(pageable)))


def test_only_payloads_of_a_mebibyte_cross_through_page_locked_memory(cuda):
    """Under the profiler the counters see the same bytes as before the
    page-locked path: a sweep's IRs go both ways through page-locked memory
    and nothing else does; a CIR request's 80 KB IR takes `.cpu()`."""
    from torch.profiler import ProfilerActivity, profile

    dirs = morton_sphere_directions(65_536, generator=torch.Generator(cuda).manual_seed(5),
                                    device=cuda)
    t = Tracer(make_room(), 2.998e8, 100e9, 100e-9, 2, 65_536, device=cuda)
    centers = _room_receivers(64)

    def sweep():
        irs = t.compute_coverage((3.0, 2.0, 2.0), 1.0, centers, 0.5, directions=dirs)
        return irs, t.rx_power_dbm(irs)

    sweep()  # the carrier is made once, on the first call
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        irs, dbm = sweep()
    moved = {k: v - before[k] for k, v in profiling.counters().items() if k.startswith("bytes_")}
    # To the card: tx (3 floats), the 64 centers, the amplitude scale and the IRs.
    assert moved == {"bytes_to_host": irs.nbytes + dbm.nbytes,
                     "bytes_to_device": 4 * (3 + 64 * 3 + 1) + irs.nbytes,
                     "bytes_pinned_to_host": irs.nbytes,
                     "bytes_pinned_to_device": irs.nbytes}

    t = Tracer(make_terrain(grid=48, extent=40.0, seed=3), 2.998e8, 100e9, 200e-9, 4, 65_536,
               device=cuda)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _, ir = t.compute_cir((2.0, 1.0, 12.0), 1.0, (-5.0, 2.0, 6.0), 1.0, directions=dirs,
                              record_paths=False)
        t.rx_power_dbm(ir)
    moved = {k: v - before[k] for k, v in profiling.counters().items()}
    assert ir.nbytes == 80_000 and not torch.from_numpy(ir).is_pinned()
    assert moved["bytes_to_host"] > ir.nbytes and moved["bytes_to_device"] > ir.nbytes
    assert moved["bytes_pinned_to_host"] == moved["bytes_pinned_to_device"] == 0
