"""rfx_torch.sampler: Morton keys equal to rfx's on the same directions, and
the distribution and coherence checks of tests/test_sampler.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rfx import sampler as jsampler
from rfx_torch import sampler

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _uniformity_checks(d):
    d = d.numpy()
    n = d.shape[0]
    assert d.dtype == np.float32
    assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    assert np.all(np.abs(d.mean(axis=0)) < 5.0 / np.sqrt(3 * n))
    z = d[:, 2]
    assert abs(z.mean()) < 5.0 / np.sqrt(n)
    assert abs(z.var() - 1.0 / 3.0) < 0.02
    oct_id = (d[:, 0] > 0) * 4 + (d[:, 1] > 0) * 2 + (d[:, 2] > 0)
    counts = np.bincount(oct_id, minlength=8)
    assert np.all(np.abs(counts - n / 8) < 5 * np.sqrt(n / 8) + 10)


def _tile_coherence(d, tile=1024):
    dn = d.numpy().reshape(-1, tile, 3)
    m = dn.mean(axis=1)
    m /= np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-9)
    return np.einsum("tj,tkj->tk", m, dn).mean()


def test_morton_keys_match_rfx():
    d = np.array(jsampler.sphere_directions(jax.random.PRNGKey(5), 100_000))
    got = sampler.direction_morton_keys(torch.from_numpy(d)).numpy()
    want = np.asarray(jsampler.direction_morton_keys(jnp.asarray(d))).astype(np.int64)
    assert got.dtype == np.int64
    # f32 arctan2 (and the phi scaling) may land one ulp apart at a cell edge.
    assert (got == want).mean() >= 0.999
    assert got.min() >= 0 and got.max() < 2**20


@pytest.mark.parametrize("fn", ["sphere_directions", "stratified_sphere_directions"])
def test_samplers_uniform(fn):
    _uniformity_checks(getattr(sampler, fn)(40_000, generator=_gen(1), device="cpu"))


def test_morton_directions_uniform_and_coherent():
    d = sampler.morton_sphere_directions(40_960, generator=_gen(2), device="cpu")
    _uniformity_checks(d)
    assert _tile_coherence(d) > 0.9
    keys = sampler.direction_morton_keys(d)
    assert torch.all(keys[1:] >= keys[:-1])
    plain = sampler.sphere_directions(40_960, generator=_gen(2), device="cpu")
    assert _tile_coherence(plain) < 0.5


def test_generator_makes_runs_reproducible():
    g1, g2 = _gen(7), _gen(7)
    a = sampler.sphere_directions(1000, generator=g1, device="cpu")
    b = sampler.sphere_directions(1000, generator=g2, device="cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, sampler.sphere_directions(1000, generator=g1, device="cpu"))


def test_pad_directions():
    d = sampler.sphere_directions(1000, generator=_gen(0), device="cpu")
    padded, n = sampler.pad_directions(d, 1024)
    assert n == 1000 and padded.shape == (1024, 3)
    assert torch.equal(padded[:1000], d)
    assert torch.equal(padded[1000:], torch.tensor([[0.0, 0.0, 1.0]]).expand(24, 3))
    same, n2 = sampler.pad_directions(padded, 1024)
    assert same is padded and n2 == 1024
