"""The port's coverage engine (the map engine over `trace_env`) against
rfx.coverage.coverage_irs(engine="map") on the same directions, hard and
soft binning, analytic and icosphere receiver; and the facade's
`compute_coverage` and recorded paths on a fused-backend mesh, which run
the per-query kernel's plain version here, against the JAX facade's brute
backend."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oracle import sample_sphere_directions
from rfx import sampler as jsampler
from rfx.api import Tracer as JTracer
from rfx.coverage import coverage_irs as jcoverage_irs
from rfx.coverage import make_grid as jmake_grid
from rfx.geometry import make_terrain
from rfx.tracer import Scene as JScene
from rfx_torch import coverage
from rfx_torch.api import Tracer
from rfx_torch.tracer import Scene

torch.set_num_threads(1)

C, RATE, WINDOW = 2.998e8, 100e9, 200e-9
CENTERS = np.asarray([[-6.0, -4.0, 5.0], [6.0, 0.0, 5.0], [0.0, 3.0, 2.0], [-3.0, 2.0, 7.0],
                      [7.0, -5.0, 3.0]], np.float32)


@pytest.mark.parametrize("rx_mode", ["analytic", "icosphere"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_coverage_irs_matches_rfx_map_engine(box_room, soft, rx_mode):
    dirs = sample_sphere_directions(1024, seed=31)
    kw = dict(max_bounces=2, nbins=512, num_rays=1024, light_speed_mps=C, sample_rate_hz=10e9,
              tx_power=2.0, soft=soft, rx_mode=rx_mode)
    tx = np.asarray([4.0, 3.0, 6.0], np.float32)
    with jax.disable_jit():  # eager binning: divide, then multiply (ROADMAP C)
        want = np.asarray(jcoverage_irs(JScene.from_mesh(box_room), jnp.asarray(tx),
                                        jnp.asarray(dirs), jnp.asarray(CENTERS), 2.0,
                                        rx_batch=2, engine="map", **kw))
    got = coverage.coverage_irs(Scene.from_mesh(box_room, "cpu"), tx, torch.from_numpy(dirs),
                                CENTERS, 2.0, rx_batch=2, **kw)
    assert got.shape == (5, 512) and want.shape == (5, 512)
    assert (want.sum(axis=1) > 0).all()
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    # Soft binning splits a path by the fraction of its delay: path lengths
    # that agree to a few f32 ulps (the sphere hit sums in another order)
    # move a path's share by up to ~1e-3 of its amplitude.
    atol = (1e-4 if soft else 1e-9) * float(want.max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=atol)


def test_coverage_make_grid_dbm_and_engines(box_room):
    grid = coverage.make_grid(range(-3, 4, 3), range(-2, 3, 2), range(2, 7, 4))
    np.testing.assert_array_equal(grid, jmake_grid(range(-3, 4, 3), range(-2, 3, 2),
                                                   range(2, 7, 4)))
    dirs = torch.from_numpy(sample_sphere_directions(512, seed=3))
    scene = Scene.from_mesh(box_room, "cpu")
    kw = dict(max_bounces=2, num_rays=512)
    dbm = coverage.coverage_dbm(scene, [0.0, 0.0, 5.0], dirs, grid, 2.0,
                                sample_window_s=WINDOW, **kw)
    assert dbm.shape == (len(grid),) and torch.isfinite(dbm).any()
    with pytest.raises(NotImplementedError, match="B4"):
        coverage.coverage_irs(scene, [0.0, 0.0, 5.0], dirs, grid, 2.0, nbins=64,
                              engine="batched", **kw)
    assert coverage.coverage_irs(scene, [0.0, 0.0, 5.0], dirs, grid[:0], 2.0, nbins=64,
                                 **kw).shape == (0, 64)


TERRAIN = dict(grid=40, extent=40.0, seed=5)
TX, RX = np.array([4.0, 0.0, 14.0]), np.array([-6.0, 1.0, 7.0])


def test_fused_backend_records_paths_through_the_kernel():
    mesh = make_terrain(**TERRAIN)
    n = 2048
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(3), n))
    t = Tracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, device="cpu")
    assert t.backend == "fused"
    paths, ir = t.compute_cir(TX, 1.0, RX, 1.5, directions=dirs)  # "auto" records paths
    jt = JTracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, backend="brute")
    j_paths, j_ir = jt.compute_cir(TX, 1.0, RX, 1.5, directions=dirs, record_paths=True)
    assert len(paths) == len(j_paths) > 0
    for p, jp in zip(paths, j_paths):
        np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-4)
    assert all(np.allclose(p[0], TX) for p in paths)
    np.testing.assert_allclose(ir, j_ir, rtol=1e-4, atol=1e-9)
    _, ir_fused = t.compute_cir(TX, 1.0, RX, 1.5, directions=dirs, record_paths=False)
    np.testing.assert_array_equal(ir_fused != 0, ir != 0)

    ico = Tracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, rx_mode="icosphere",
                 device="cpu")
    assert ico.backend == "fused" and ico._fused is None
    paths_i, ir_i = ico.compute_cir(TX, 1.0, RX, 1.5, directions=dirs)
    jt_i = JTracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, backend="brute",
                   rx_mode="icosphere")
    j_paths_i, j_ir_i = jt_i.compute_cir(TX, 1.0, RX, 1.5, directions=dirs, record_paths=True)
    assert len(paths_i) == len(j_paths_i) > 0
    np.testing.assert_allclose(ir_i, j_ir_i, rtol=1e-4, atol=1e-9)


def test_fused_backend_compute_coverage_matches_rfx():
    mesh = make_terrain(**TERRAIN)
    n = 2048
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(5), n))
    centers = np.asarray([RX, [0.0, -6.0, 6.0], [8.0, 8.0, 9.0]], np.float32)
    t = Tracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, device="cpu")
    irs = t.compute_coverage(TX, 1.0, centers, 2.0, directions=dirs, rx_batch=2)
    jt = JTracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, backend="brute")
    j_irs = jt.compute_coverage(TX, 1.0, centers, 2.0, directions=dirs, rx_batch=2)
    assert irs.shape == (3, t.nbins) and (irs.sum(axis=1) > 0).all()
    np.testing.assert_allclose(irs, j_irs, rtol=1e-4, atol=1e-9 * float(j_irs.max()))
