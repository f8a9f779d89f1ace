"""rfx_torch.tracer.trace_to_rx against rfx.tracer.trace_to_rx on the same
numpy directions: analytic and icosphere receivers, recorded paths, padding
rays."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracle import sample_sphere_directions
from rfx.tracer import Scene as JScene
from rfx.tracer import extract_paths as jextract_paths
from rfx.tracer import trace_to_rx as jtrace_to_rx
from rfx_torch.tracer import Scene, extract_paths, trace_to_rx

torch.set_num_threads(1)

TX = np.array([10.0, 0.0, 5.0], np.float32)
RX = np.array([-10.0, 0.0, 5.0], np.float32)


def _assert_match(ref, out):
    m = np.asarray(ref.captured)
    assert m.sum() > 0
    np.testing.assert_array_equal(out.captured.numpy(), m)
    np.testing.assert_array_equal(out.num_bounces.numpy(), np.asarray(ref.num_bounces))
    np.testing.assert_allclose(out.amplitude.numpy()[m], np.asarray(ref.amplitude)[m],
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(out.distance.numpy()[m], np.asarray(ref.distance)[m],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rx_mode,bounces", [("analytic", 2), ("analytic", 4), ("icosphere", 3)])
def test_trace_to_rx_matches_rfx(box_room, rx_mode, bounces):
    dirs = sample_sphere_directions(3000, seed=42)
    kw = dict(max_bounces=bounces, rx_mode=rx_mode, n1=3.0, n2=1.2)
    ref = jtrace_to_rx(JScene.from_mesh(box_room), jnp.asarray(TX), jnp.asarray(dirs),
                       jnp.asarray(RX), 1.0, **kw)
    out = trace_to_rx(Scene.from_mesh(box_room, "cpu"), TX, torch.from_numpy(dirs), RX, 1.0, **kw)
    _assert_match(ref, out)


def test_record_paths_match_rfx(box_room):
    dirs = sample_sphere_directions(1500, seed=21)
    ref = jtrace_to_rx(JScene.from_mesh(box_room), jnp.asarray(TX), jnp.asarray(dirs),
                       jnp.asarray(RX), 1.0, max_bounces=3, rx_mode="icosphere",
                       record_paths=True)
    out = trace_to_rx(Scene.from_mesh(box_room, "cpu"), TX, torch.from_numpy(dirs), RX, 1.0,
                      max_bounces=3, rx_mode="icosphere", record_paths=True)
    assert out.path_vertices.shape == (3, 1500, 3)
    j_paths = jextract_paths(TX, ref)
    t_paths = extract_paths(TX, out)
    assert len(t_paths) == len(j_paths) > 0
    for pj, pt in zip(j_paths, t_paths):
        assert pj.shape == pt.shape
        np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-4)
    assert len(extract_paths(TX, out, max_paths=3)) == 3
    with pytest.raises(ValueError):
        extract_paths(TX, trace_to_rx(Scene.from_mesh(box_room, "cpu"), TX,
                                      torch.from_numpy(dirs[:10]), RX, 1.0, max_bounces=1))


def test_padding_rays_do_not_contribute(box_room):
    dirs = sample_sphere_directions(1000, seed=8)
    scene = Scene.from_mesh(box_room, "cpu")
    r1 = trace_to_rx(scene, TX, torch.from_numpy(dirs), RX, 1.0, max_bounces=2)
    padded = torch.from_numpy(np.concatenate([dirs, dirs[:24]]))
    active = torch.arange(1024) < 1000
    r2 = trace_to_rx(scene, TX, padded, RX, 1.0, max_bounces=2, active=active)
    assert int(r2.captured[1000:].sum()) == 0
    assert torch.equal(r1.captured, r2.captured[:1000])
    assert torch.equal(r1.amplitude, r2.amplitude[:1000])


def test_per_ray_origins_match_single_emitter(box_room):
    dirs = torch.from_numpy(sample_sphere_directions(800, seed=3))
    scene = Scene.from_mesh(box_room, "cpu")
    r1 = trace_to_rx(scene, TX, dirs, RX, 1.0, max_bounces=2, rx_mode="analytic")
    r2 = trace_to_rx(scene, np.tile(TX, (800, 1)), dirs, RX, 1.0, max_bounces=2,
                     rx_mode="analytic")
    assert int(r1.captured.sum()) > 0
    for a, b in zip(r1[:4], r2[:4]):
        assert torch.equal(a, b)


def test_warp_quirk_compat_not_ported(box_room):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trace_to_rx(Scene.from_mesh(box_room, "cpu"), TX, torch.zeros(4, 3), RX, 1.0,
                    max_bounces=1, warp_quirk_compat=True)
