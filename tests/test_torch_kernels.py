"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and nvcc and skips elsewhere. On a machine
with a card, and without JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

(`--noconftest`: tests/conftest.py configures JAX for the other test files;
this file imports neither JAX nor the JAX-only parts of rfx).
"""

import numpy as np
import pytest
import torch

from rfx.geometry import make_terrain
from rfx_torch import cir
from rfx_torch.api import Tracer
from rfx_torch.ops import fused
from rfx_torch.sampler import morton_sphere_directions

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


@pytest.mark.parametrize("n", [1, 1000, 65_536])
def test_fused_kernel_matches_plain(cuda, n):
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


@pytest.mark.parametrize("mode", [cir.HARD, cir.SOFT_LO, cir.SOFT_HI])
def test_histogram_kernel_matches_plain_and_is_deterministic(cuda, mode):
    g = np.random.default_rng(17)
    n = 300_000
    amp = torch.from_numpy(g.random(n).astype(np.float32)).to(cuda)
    dist = torch.from_numpy((g.random(n) * 70.0).astype(np.float32)).to(cuda)
    cap = torch.from_numpy(g.random(n) < 0.3).to(cuda)
    kw = dict(nbins=20_000, light_speed_mps=2.998e8, sample_rate_hz=100e9, mode=mode)
    before = cir.HISTOGRAM_KERNEL.launches
    a = cir.histogram(amp, dist, cap, **kw)
    b = cir.histogram(amp, dist, cap, **kw)
    assert cir.HISTOGRAM_KERNEL.launches == before + 2
    p = cir.histogram_plain(amp, dist, cap, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a != 0, p != 0)
    assert torch.allclose(a, p, rtol=1e-5, atol=1e-5)


def test_histogram_kernel_edges(cuda):
    empty = torch.zeros(0, device=cuda)
    ir = cir.histogram(empty, empty, empty.bool(), nbins=100, light_speed_mps=1.0,
                       sample_rate_hz=1.0)
    torch.cuda.synchronize()
    assert torch.equal(ir, torch.zeros(100, device=cuda))
    with pytest.raises(ValueError, match="bins"):
        cir.histogram(empty, empty, empty.bool(), nbins=1_000_000, light_speed_mps=1.0,
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
