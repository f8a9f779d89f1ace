"""rfx_torch.api.Tracer against rfx.api.Tracer on the same mesh and
directions: the brute branch (at most 2048 triangles) and the fused branch
(above), the RX-power metric, and rfx_torch.convert."""

import numpy as np
import pytest
import torch

import jax

from oracle import sample_sphere_directions
from rfx import sampler as jsampler
from rfx.api import Tracer as JTracer
from rfx.geometry import make_terrain
from rfx_torch import convert, coverage
from rfx_torch.api import Tracer

torch.set_num_threads(1)

C, RATE, WINDOW = 2.998e8, 100e9, 200e-9
TX = np.array([10.0, 0.0, 5.0])
RX = np.array([-10.0, 0.0, 5.0])


@pytest.mark.parametrize("rx_mode", ["analytic", "icosphere"])
def test_brute_branch_matches_rfx(box_room, rx_mode):
    dirs = sample_sphere_directions(3000, seed=6)
    jt = JTracer(box_room, C, RATE, WINDOW, max_bounces=3, tx_num_rays=3000, rx_mode=rx_mode)
    t = convert.tracer_from_rfx(jt, device="cpu")
    assert t.backend == "brute" and t.rx_mode == rx_mode
    paths, ir = t.compute_cir(TX, 1.0, RX, 1.0, directions=dirs)  # "auto" records paths
    j_paths, j_ir = jt.compute_cir(TX, 1.0, RX, 1.0, directions=dirs)
    assert isinstance(ir, np.ndarray) and ir.shape == (t.nbins,) and ir.sum() > 0
    np.testing.assert_allclose(ir, j_ir, rtol=1e-4, atol=1e-9)
    assert len(paths) == len(j_paths) > 0
    for p, jp in zip(paths, j_paths):
        np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-4)
    assert all(np.allclose(p[0], TX) for p in paths)
    np.testing.assert_allclose(t.rx_power_dbm(ir), jt.rx_power_dbm(j_ir), atol=1e-3)


def test_coverage_metrics_match_rfx_facade(box_room):
    """Tracer.compute_coverage_dbm_fast / _hybrid against the JAX facade's on
    the same directions (the brute branch, 20 receivers)."""
    dirs = sample_sphere_directions(4096, seed=12)
    centers = np.asarray([[x, y, z] for x in (-8.0, -3.0, 2.0, 7.0, 12.0) for y in (-5.0, 5.0)
                          for z in (2.0, 8.0)], np.float32)
    jt = JTracer(box_room, C, 10e9, 100e-9, max_bounces=2, tx_num_rays=4096)
    t = convert.tracer_from_rfx(jt, device="cpu")
    tx = np.asarray([3.0, 2.0, 2.0])
    with jax.disable_jit():  # eager binning: divide, then multiply (ROADMAP C)
        j_fast = jt.compute_coverage_dbm_fast(tx, 1.0, centers, 1.2, directions=dirs)
        j_hyb, j_n = jt.compute_coverage_dbm_hybrid(tx, 1.0, centers, 1.2, directions=dirs)
    fast = t.compute_coverage_dbm_fast(tx, 1.0, centers, 1.2, directions=dirs)
    hyb, n = t.compute_coverage_dbm_hybrid(tx, 1.0, centers, 1.2, directions=dirs)
    assert n == j_n and np.isfinite(j_fast).sum() > 10
    for got, want in ((fast, j_fast), (hyb, np.asarray(j_hyb))):
        ok = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), ok)
        diff = np.abs(got[ok] - want[ok])
        # rfx's sphere hit sums its dot products through einsum, the port x +
        # y + z: a t_rx an ulp apart can move a path across a bin boundary,
        # which turns its phasor by 2 pi f / rate (0.15 rad at 10 GHz). Here
        # that moves one receiver's fast dBm by 0.2 dB (ROADMAP C).
        assert (diff > 1e-3).sum() <= 1 and diff.max() < 0.5, diff
    # The facade is the module functions on its own directions and env_hit.
    kw = dict(max_bounces=2, num_rays=4096, sample_window_s=100e-9, sample_rate_hz=10e9,
              env_hit=t.env_hit)
    dirs_t = torch.from_numpy(dirs)
    np.testing.assert_array_equal(
        fast, coverage.coverage_dbm_fast(t.scene, tx, dirs_t, centers, 1.2, **kw).numpy())
    np.testing.assert_array_equal(
        hyb, coverage.coverage_dbm_hybrid(t.scene, tx, dirs_t, centers, 1.2, **kw)[0].numpy())


def test_fused_branch_matches_rfx():
    mesh = make_terrain(grid=40, extent=40.0, seed=5)
    assert mesh.num_faces == 3042
    n = 4096
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(3), n))
    tx, rx = np.array([4.0, 0.0, 14.0]), np.array([-6.0, 1.0, 7.0])
    t = Tracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, device="cpu")
    assert t.backend == "fused"
    paths, ir = t.compute_cir(tx, 1.0, rx, 1.5, directions=dirs, record_paths=False)
    # The JAX side takes its brute scan path: the same semantics, fast on the CPU.
    jt = JTracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, backend="brute")
    _, j_ir = jt.compute_cir(tx, 1.0, rx, 1.5, directions=dirs, record_paths=False)
    assert paths == [] and ir.sum() > 0
    np.testing.assert_array_equal(ir != 0, j_ir != 0)
    np.testing.assert_allclose(ir, j_ir, rtol=1e-4, atol=1e-9)


def test_fused_branch_refuses_what_needs_unported_kernels():
    mesh = make_terrain(grid=40, extent=40.0, seed=5)
    t = Tracer(mesh, max_bounces=2, tx_num_rays=64, device="cpu")
    # The coverage metrics are ported: they run on the fused branch's env_hit.
    centers = np.stack([RX, RX + 3.0]).astype(np.float32)
    fast = t.compute_coverage_dbm_fast(TX, 1.0, centers, 1.0)
    assert isinstance(fast, np.ndarray) and fast.shape == (2,)
    hybrid, n_flagged = t.compute_coverage_dbm_hybrid(TX, 1.0, centers, 1.0)
    assert isinstance(hybrid, np.ndarray) and hybrid.shape == (2,)
    assert isinstance(n_flagged, int) and 0 <= n_flagged <= 2
    # The `bvh` backend is the plain walk under the scan tracer: no fused
    # tracer, the fused branch's answers.
    walk = Tracer(mesh, max_bounces=2, tx_num_rays=64, backend="bvh", device="cpu")
    assert walk.backend == "bvh" and walk._fused is None
    np.testing.assert_allclose(walk.compute_coverage_dbm_fast(TX, 1.0, centers, 1.0), fast,
                               rtol=0, atol=1e-3)
    with pytest.raises(ValueError):
        Tracer(mesh, backend="pallas", device="cpu")


def test_record_paths_auto_and_fresh_directions(box_room):
    t = Tracer(box_room, C, RATE, WINDOW, max_bounces=2, tx_num_rays=2048, seed=1, device="cpu")
    paths, ir1 = t.compute_cir([0, 0, 5.0], 1.0, [5, 0, 5.0], 1.0)
    assert len(paths) > 0 and ir1.sum() > 0
    t.AUTO_PATHS_MAX_RAYS = 1024
    paths2, ir2 = t.compute_cir([0, 0, 5.0], 1.0, [5, 0, 5.0], 1.0)
    assert paths2 == [] and ir2.sum() > 0
    assert not np.array_equal(ir1, ir2)  # each call draws fresh directions
    again = Tracer(box_room, C, RATE, WINDOW, max_bounces=2, tx_num_rays=2048, seed=1,
                   device="cpu")
    np.testing.assert_array_equal(again.compute_cir([0, 0, 5.0], 1.0, [5, 0, 5.0], 1.0)[1], ir1)


def test_convert_carries_scene_and_config(box_room):
    from rfx.bvh import build_bvh
    from rfx.tracer import Scene as JScene

    jt = JTracer(box_room, 3.0e8, 50e9, 100e-9, max_bounces=2, tx_num_rays=777, n1=3.0,
                 n2=1.2, rx_mode="icosphere")
    cfg = convert.tracer_config(jt)
    assert cfg == dict(light_speed_mps=3.0e8, sample_rate_hz=50e9, sample_window_s=100e-9,
                       max_bounces=2, tx_num_rays=777, n1=3.0, n2=1.2, rx_mode="icosphere")
    t = convert.tracer_from_rfx(jt, device="cpu")
    assert t.nbins == jt.nbins and t.tx_num_rays == 777 and t.n1 == 3.0
    scene = convert.scene_from_rfx(JScene.from_mesh(box_room), device="cpu")
    np.testing.assert_array_equal(scene.vertices.numpy(), box_room.vertices)
    np.testing.assert_array_equal(scene.faces.numpy(), box_room.faces)
    packed = convert.bvh_from_rfx(build_bvh(box_room, method="numpy"), device="cpu")
    assert packed.n_padded_tris >= box_room.num_faces
    with pytest.raises(TypeError):
        convert.tracer_config(object())
    with pytest.raises(TypeError):
        convert.bvh_from_rfx(box_room, device="cpu")
