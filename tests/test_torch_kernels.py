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
from rfx_torch.ops import bvh_trace, bvh_traverse, coverage_hist, fused, intersect, micro_vote
from rfx_torch.sampler import morton_sphere_directions
from rfx_torch.tracer import EnvSegments, Scene, trace_env, trace_to_rx

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
    card = [x.cpu() for x in coverage._dbm_cancel_from_segments(segs, centers, 0.8, **fkw)]
    host = coverage._dbm_cancel_from_segments(
        EnvSegments(*(t.cpu() for t in segs)), centers, 0.8, **fkw)
    ok = torch.isfinite(host[0])
    assert torch.equal(torch.isfinite(card[0]), ok) and int(ok.sum()) > 30
    torch.testing.assert_close(card[0][ok], host[0][ok], rtol=0, atol=1e-3)
    for a, b in zip(card[1:], host[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=0)


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
    the CPU tests' room workload): sharded_cir on {'rays': 2} and the
    coverage tiles on {'rays': 1, 'rx': 2} through the histogram kernel,
    against the unsharded paths on the card; the ranks hold the same IR bits."""
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
               and i["coverage"]["launches"]["rfx_ir_histogram"] > 0 for i in infos)
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
