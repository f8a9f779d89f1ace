"""The fused trace with the reference's 80-face icosphere receiver, on the
CPU: its plain PyTorch version (what a CPU tensor runs, and what the CUDA
kernel is held against in tests/test_torch_kernels.py) against the port's
and rfx's scan tracers with rx_mode="icosphere" on the same directions, at
tests/test_torch_fused.py's sizes and tolerances; the facade's dispatch of
icosphere requests; and the faces the kernel forms from the unit table."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rfx import sampler as jsampler
from rfx.api import Tracer as JTracer
from rfx.geometry import make_terrain
from rfx.tracer import Scene as JScene
from rfx.tracer import trace_to_rx as jtrace_to_rx
from rfx_torch import api
from rfx_torch.api import Tracer
from rfx_torch.ops import fused
from rfx_torch.ops.intersect import icosphere_tris, unit_icosphere_tris
from rfx_torch.tracer import Scene, trace_to_rx

torch.set_num_threads(1)

# tests/test_torch_fused.py's cases: grid, extent, seed, rays, bounces, tx,
# rx, rx_radius, n1, n2, key.
CASES = {
    "grid16": (16, 30.0, 3, 2048, 3, [2.0, 1.0, 9.0], [-5.0, 2.0, 6.0], 1.0, 5.0, 1.0, 4),
    "grid12": (12, 24.0, 9, 700, 2, [1.0, -2.0, 7.0], [-4.0, 3.0, 5.0], 1.5, 3.0, 1.2, 1),
    "grid16_materials": (16, 30.0, 3, 700, 3, [2.0, 1.0, 9.0], [-5.0, 2.0, 6.0], 1.5, 3.0, 1.2, 1),
}


def _assert_trace_match(out, captured, num_bounces, amplitude, distance):
    """tests/test_fused.py's bar: identical masks and bounce counts,
    amplitude rtol 2e-5 / atol 1e-7 and distance rtol 1e-5 / atol 1e-4 on
    the captured rays, at least one of them."""
    m = np.asarray(captured)
    assert m.sum() > 0
    np.testing.assert_array_equal(out.captured.numpy(), m)
    np.testing.assert_array_equal(out.num_bounces.numpy(), np.asarray(num_bounces))
    np.testing.assert_allclose(out.amplitude.numpy()[m], np.asarray(amplitude)[m],
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(out.distance.numpy()[m], np.asarray(distance)[m],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_plain_icosphere_matches_both_scan_tracers(case):
    grid, extent, seed, n, bounces, tx, rx, radius, n1, n2, key = CASES[case]
    mesh = make_terrain(grid=grid, extent=extent, seed=seed)
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(key), n))
    kw = dict(max_bounces=bounces, rx_mode="icosphere", n1=n1, n2=n2)
    ref = jtrace_to_rx(JScene.from_mesh(mesh), jnp.asarray(tx), jnp.asarray(dirs),
                       jnp.asarray(rx), radius, **kw)
    scan = trace_to_rx(Scene.from_mesh(mesh, "cpu"), tx, torch.from_numpy(dirs), rx, radius, **kw)
    ft = fused.make_fused_tracer(mesh, max_bounces=bounces, device="cpu")
    d = torch.from_numpy(dirs)
    out = ft(d, tx, rx, radius, n1=n1, n2=n2, rx_mode="icosphere")
    assert torch.equal(d, torch.from_numpy(dirs))  # the input is not written to
    assert out.captured.dtype == torch.bool and out.num_bounces.dtype == torch.int32
    _assert_trace_match(out, ref.captured, ref.num_bounces, ref.amplitude, ref.distance)
    _assert_trace_match(out, scan.captured, scan.num_bounces, scan.amplitude.detach(),
                        scan.distance.detach())
    # The receivers differ: the icosphere's captures are not the sphere's.
    analytic = ft(d, tx, rx, radius, n1=n1, n2=n2)
    assert not torch.equal(analytic.captured, out.captured) or not torch.equal(
        analytic.distance, out.distance)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_plain_icosphere_face_record_and_chunking(case, monkeypatch):
    """The face record does not depend on the receiver's form: with
    `record_faces` the trace is the same, and its faces are -1 after each
    ray's last bounce; 37-ray chunks of the environment's plain closest hit
    give the same bits."""
    from rfx_torch.ops import bvh_trace

    grid, extent, seed, n, bounces, tx, rx, radius, n1, n2, key = CASES[case]
    ft = fused.make_fused_tracer(make_terrain(grid=grid, extent=extent, seed=seed),
                                 max_bounces=bounces, device="cpu")
    d = torch.from_numpy(np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(key), n)))
    args = (tx, rx, radius, n1, n2)
    whole = ft(d, *args, rx_mode="icosphere")
    res, faces = ft(d, *args, record_faces=True, rx_mode="icosphere")
    assert faces.shape == (bounces, n) and faces.dtype == torch.int32
    for a, b in zip(whole[:4], res[:4]):
        assert torch.equal(a, b)
    made = torch.arange(bounces)[:, None] < res.num_bounces[None, :]
    assert bool((faces[made] >= 0).all()) and bool((faces[~made] == -1).all())
    monkeypatch.setattr(bvh_trace, "_PLAIN_PAIRS", 37 * ft.bvh.n_padded_tris)
    chunked = ft(d, *args, rx_mode="icosphere")
    assert int(whole.captured.sum()) > 0
    for a, b in zip(whole[:4], chunked[:4]):
        assert torch.equal(a, b)


def test_fused_trace_refuses_what_it_has_no_form_for():
    ft = fused.make_fused_tracer(make_terrain(grid=6, extent=10.0, seed=1), max_bounces=2,
                                 device="cpu")
    d = torch.tensor([[0.0, 0.0, -1.0]])
    with pytest.raises(ValueError, match="rx_mode"):
        ft(d, [0.0, 0.0, 5.0], [1.0, 0.0, 2.0], 0.5, rx_mode="sphere")
    with pytest.raises(ValueError, match="count_stats"):
        fused.fused_trace(ft.bvh, d, [0.0, 0.0, 5.0], [1.0, 0.0, 2.0], 0.5, max_bounces=2,
                          count_stats=True, rx_mode="icosphere")
    empty = ft(torch.zeros((0, 3)), [0.0, 0.0, 5.0], [1.0, 0.0, 2.0], 0.5, rx_mode="icosphere")
    assert all(t.shape == (0,) for t in empty[:4])


# The CIR cells' receivers (x, y on an 8 x 8 grid over [-20, 20], z = 8) and
# the cases' and the bench's, with the radii they take.
_CENTERS = np.concatenate([
    np.stack(np.meshgrid(np.linspace(-20.0, 20.0, 8), np.linspace(-20.0, 20.0, 8),
                         [8.0], indexing="ij"), -1).reshape(-1, 3),
    [c[6] for c in CASES.values()], [[-10.0, 0.0, 8.0], [1e3, -2e-3, 7.25]]]).astype(np.float32)


@pytest.mark.parametrize("radius", [0.1, 1.0, 1.5, 0.37])
def test_kernel_face_formula_gives_icosphere_tris_bits(radius):
    """The fused kernel forms face f of the receiver from the unit table as
    unit_v0 * r + c, unit_e1 * r, unit_e2 * r (a product, then a sum, in
    f32): that formula, written in torch, gives icosphere_tris' bits (what
    the scan tracer's receiver tests) for every receiver of the cells."""
    unit = unit_icosphere_tris("cpu")
    r = torch.tensor(np.float32(radius))
    centers = torch.from_numpy(_CENTERS)
    tris = icosphere_tris(centers, float(np.float32(radius)))
    for k in range(centers.shape[0]):
        assert torch.equal(unit[:, 0:3] * r + centers[k], tris[k, :, 0:3])
        assert torch.equal(unit[:, 3:9] * r, tris[k, :, 3:9])


def test_facade_sends_icosphere_requests_without_paths_to_the_fused_trace(monkeypatch):
    """Tracer(rx_mode="icosphere", backend="fused"): compute_cir without
    recorded paths runs the fused trace with the icosphere receiver and not
    the scan tracer; with recorded paths the scan tracer, on the same packed
    BVH. The two IRs, and rfx's brute-backend IR, agree within the facade
    tests' tolerances."""
    mesh = make_terrain(grid=24, extent=30.0, seed=5)
    n = 2048
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(7), n))
    tx, rx, radius = np.array([4.0, 0.0, 14.0]), np.array([-6.0, 1.0, 7.0]), 1.5
    t = Tracer(mesh, 2.998e8, 100e9, 200e-9, max_bounces=3, tx_num_rays=n,
               rx_mode="icosphere", backend="fused", device="cpu")
    assert t.backend == "fused" and t._fused is not None
    calls = {"fused": [], "scan": []}
    real_fused, real_scan = fused.fused_trace, api.trace_to_rx

    def spy_fused(*a, **k):
        calls["fused"].append(k.get("rx_mode"))
        return real_fused(*a, **k)

    def spy_scan(*a, **k):
        calls["scan"].append(k.get("rx_mode"))
        return real_scan(*a, **k)

    monkeypatch.setattr(fused, "fused_trace", spy_fused)
    monkeypatch.setattr(api, "trace_to_rx", spy_scan)
    paths, ir = t.compute_cir(tx, 1.0, rx, radius, directions=dirs, record_paths=False)
    assert calls == {"fused": ["icosphere"], "scan": []} and paths == []
    scan_paths, scan_ir = t.compute_cir(tx, 1.0, rx, radius, directions=dirs, record_paths=True)
    assert calls == {"fused": ["icosphere"], "scan": ["icosphere"]} and len(scan_paths) > 0
    assert ir.sum() > 0
    np.testing.assert_array_equal(ir != 0, scan_ir != 0)
    np.testing.assert_allclose(ir, scan_ir, rtol=1e-4, atol=1e-9)
    jt = JTracer(mesh, 2.998e8, 100e9, 200e-9, max_bounces=3, tx_num_rays=n,
                 rx_mode="icosphere", backend="brute")
    _, j_ir = jt.compute_cir(tx, 1.0, rx, radius, directions=dirs, record_paths=False)
    np.testing.assert_array_equal(ir != 0, j_ir != 0)
    np.testing.assert_allclose(ir, j_ir, rtol=1e-4, atol=1e-9)
