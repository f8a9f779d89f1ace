"""rfx_torch physics and intersection primitives against rfx on the same
numpy inputs (JAX on the CPU, the port with device="cpu")."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rfx import physics as jphysics
from rfx.geometry import make_terrain
from rfx.ops import intersect as jisect
from rfx_torch import physics
from rfx_torch.device import resolve_device
from rfx_torch.ops import intersect

torch.set_num_threads(1)


def _rand_unit(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_reflect_and_bend_angle_match_rfx():
    d, n = _rand_unit(513, 0), _rand_unit(513, 1)
    r = physics.reflect(torch.from_numpy(d), torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(r, np.asarray(jphysics.reflect(jnp.asarray(d), jnp.asarray(n))),
                               rtol=0, atol=1e-6)
    ang = physics.bend_angle(torch.from_numpy(d), torch.from_numpy(r)).numpy()
    jang = np.asarray(jphysics.bend_angle(jnp.asarray(d), jnp.asarray(r)))
    np.testing.assert_allclose(ang, jang, rtol=0, atol=2e-4)


@pytest.mark.parametrize("n1,n2", [(5.0, 1.0), (3.0, 1.2), (1.0, 1.5)])
def test_fresnel_matches_rfx(n1, n2):
    angles = np.linspace(0.0, np.pi, 361).astype(np.float32)
    got = physics.fresnel_bounce_amplitude(torch.from_numpy(angles), n1, n2).numpy()
    want = np.asarray(jphysics.fresnel_bounce_amplitude(jnp.asarray(angles), n1, n2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all((got >= 0.0) & (got <= 1.0))
    assert float(physics.fresnel_bounce_amplitude(torch.tensor(float("nan")))) == 0.0


def _terrain_soa():
    mesh = make_terrain(grid=12, extent=24.0, seed=9)
    return mesh, intersect.mesh_soa(torch.from_numpy(mesh.vertices), torch.from_numpy(mesh.faces))


def test_mesh_soa_and_normals_match_rfx():
    mesh, (v0, e1, e2) = _terrain_soa()
    jv0, je1, je2, jn = jisect.mesh_soa(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces))
    nrm = intersect.hit_normal_from_edges(e1, e2, torch.arange(e1.shape[0]))
    for a, b in ((v0, jv0), (e1, je1), (e2, je2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(nrm.numpy(), np.asarray(jn), rtol=0, atol=1e-6)
    face = torch.tensor([0, 5, -1, 17], dtype=torch.int32)
    got = intersect.hit_normal_from_edges(e1, e2, face).numpy()
    want = np.asarray(jisect.hit_normal_from_edges(je1, je2, jnp.asarray(face.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ray_chunk", [None, 97])
def test_brute_closest_hit_matches_rfx(ray_chunk):
    mesh, (v0, e1, e2) = _terrain_soa()
    rng = np.random.default_rng(3)
    n = 600
    o = np.concatenate([rng.uniform(-10, 10, (n, 2)), rng.uniform(4, 9, (n, 1))], 1).astype(np.float32)
    d = _rand_unit(n, 4)
    t, f = intersect.ray_mesh_closest_hit_brute(torch.from_numpy(o), torch.from_numpy(d),
                                                v0, e1, e2, ray_chunk=ray_chunk)
    jt, jf = jisect.ray_mesh_closest_hit_brute(
        jnp.asarray(o), jnp.asarray(d), *jisect.mesh_soa(jnp.asarray(mesh.vertices),
                                                          jnp.asarray(mesh.faces))[:3])
    hit = intersect.is_hit(t).numpy()
    assert 50 < hit.sum() < n  # both hits and misses are exercised
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(hit, np.asarray(jisect.is_hit(jt)))
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit], rtol=1e-5, atol=1e-5)
    assert f.dtype == torch.int32 and np.all(f.numpy()[~hit] == -1)


def test_closed_form_t_matches_brute_hits():
    mesh, (v0, e1, e2) = _terrain_soa()
    o = torch.tensor([[0.5, 0.3, 9.0]]).expand(64, 3)
    d = torch.from_numpy(_rand_unit(64, 8))
    d[:, 2] = -d[:, 2].abs()
    d = d / d.norm(dim=1, keepdim=True)
    t, f = intersect.ray_mesh_closest_hit_brute(o, d, v0, e1, e2)
    h = intersect.is_hit(t)
    fl = f[h].long()
    tc = intersect.closed_form_t(o[h], d[h], v0[fl], e1[fl], e2[fl])
    jtc = jisect.closed_form_t(*(jnp.asarray(a.numpy()) for a in (o[h], d[h], v0[fl], e1[fl], e2[fl])))
    np.testing.assert_allclose(tc.numpy(), t[h].numpy(), rtol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jtc), rtol=1e-6)


def test_ray_sphere_hit_matches_rfx():
    rng = np.random.default_rng(5)
    n = 2000
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = _rand_unit(n, 6)
    center, radius = np.array([0.5, -0.3, 0.2], np.float32), 1.7
    t = intersect.ray_sphere_hit(torch.from_numpy(o), torch.from_numpy(d), center, radius).numpy()
    jt = np.asarray(jisect.ray_sphere_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(center), radius))
    hit = t < intersect.MISS_THRESHOLD
    assert 100 < hit.sum() < n
    np.testing.assert_array_equal(hit, jt < jisect.MISS_THRESHOLD)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=1e-5)
    assert np.all(t[~hit] == np.float32(intersect.MISS))


def test_constants_match_rfx():
    assert intersect.T_MIN_EPS == jisect.T_MIN_EPS
    assert np.float32(intersect.MISS) == np.asarray(jisect.MISS)
    assert intersect.MISS_THRESHOLD == jisect.MISS_THRESHOLD


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
