"""The fused trace's plain PyTorch version (what a CPU tensor runs) against
rfx.tracer.trace_to_rx(rx_mode="analytic") on the same directions, with the
tolerances of tests/test_fused.py:_assert_trace_match; and the BVH packing.
The JAX side runs its plain reference (the scan tracer), not interpret mode.
The CUDA kernel itself is held against this plain version in
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rfx import sampler as jsampler
from rfx.bvh import build_bvh
from rfx.geometry import make_terrain
from rfx.tracer import Scene as JScene
from rfx.tracer import trace_to_rx as jtrace_to_rx
from rfx_torch.ops import bvh_trace, fused
from rfx_torch.ops.bvh_pack import pack_bvh

torch.set_num_threads(1)

CASES = {
    # grid, extent, seed, rays, bounces, tx, rx, rx_radius, n1, n2, key
    "grid16": (16, 30.0, 3, 2048, 3, [2.0, 1.0, 9.0], [-5.0, 2.0, 6.0], 1.0, 5.0, 1.0, 4),
    "grid12": (12, 24.0, 9, 700, 2, [1.0, -2.0, 7.0], [-4.0, 3.0, 5.0], 1.5, 3.0, 1.2, 1),
    "grid16_materials": (16, 30.0, 3, 700, 3, [2.0, 1.0, 9.0], [-5.0, 2.0, 6.0], 1.5, 3.0, 1.2, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_plain_matches_scan_tracer(case):
    grid, extent, seed, n, bounces, tx, rx, radius, n1, n2, key = CASES[case]
    mesh = make_terrain(grid=grid, extent=extent, seed=seed)
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(key), n))
    ref = jtrace_to_rx(JScene.from_mesh(mesh), jnp.asarray(tx), jnp.asarray(dirs),
                       jnp.asarray(rx), radius, max_bounces=bounces, rx_mode="analytic",
                       n1=n1, n2=n2)
    ft = fused.make_fused_tracer(mesh, max_bounces=bounces, device="cpu")
    d = torch.from_numpy(dirs)
    out = ft(d, tx, rx, radius, n1=n1, n2=n2)
    assert torch.equal(d, torch.from_numpy(dirs))  # the input is not written to

    m = np.asarray(ref.captured)
    assert m.sum() > 0
    np.testing.assert_array_equal(out.captured.numpy(), m)
    np.testing.assert_array_equal(out.num_bounces.numpy(), np.asarray(ref.num_bounces))
    np.testing.assert_allclose(out.amplitude.numpy()[m], np.asarray(ref.amplitude)[m],
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(out.distance.numpy()[m], np.asarray(ref.distance)[m],
                               rtol=1e-5, atol=1e-4)
    assert out.captured.dtype == torch.bool and out.num_bounces.dtype == torch.int32


def test_fused_plain_chunking_and_empty_batch(monkeypatch):
    mesh = make_terrain(grid=12, extent=24.0, seed=9)
    ft = fused.make_fused_tracer(mesh, max_bounces=2, device="cpu")
    d = torch.from_numpy(np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(1), 700)))
    args = ([1.0, -2.0, 7.0], [-4.0, 3.0, 5.0], 1.5)
    whole = ft(d, *args)
    monkeypatch.setattr(bvh_trace, "_PLAIN_PAIRS", 37 * ft.bvh.n_padded_tris)  # 37-ray chunks
    chunked = ft(d, *args)
    assert int(whole.captured.sum()) > 0
    for a, b in zip(whole[:4], chunked[:4]):
        assert torch.equal(a, b)
    empty = ft(torch.zeros((0, 3)), *args)
    assert all(t.shape == (0,) for t in empty[:4])


def test_pack_bvh_layout():
    mesh = make_terrain(grid=12, extent=24.0, seed=9)
    flat = build_bvh(mesh, leaf_size=8, method="numpy")
    p = pack_bvh(flat, torch.device("cpu"))
    assert p.n_nodes == flat.n_nodes and p.n_padded_tris == flat.n_padded_tris
    # Boxes are the builder's min/max, not center +- half extent.
    np.testing.assert_array_equal(p.nodes[:, 0:3].numpy(), flat.aabb_min)
    np.testing.assert_array_equal(p.nodes[:, 4:7].numpy(), flat.aabb_max)
    np.testing.assert_array_equal(p.tri_start.numpy(), flat.tri_start)
    np.testing.assert_array_equal(p.tri_count.numpy(), flat.tri_count)
    np.testing.assert_array_equal(p.skip.numpy(), flat.skip)
    assert p.tri_face.dtype == torch.int32
    np.testing.assert_array_equal(p.tri_face.numpy(), flat.tri_face)
    np.testing.assert_array_equal(p.tri[:, 0:9].numpy(),
                                  np.concatenate([flat.tri_v0, flat.tri_e1, flat.tri_e2], 1))
    real = flat.tri_face >= 0
    np.testing.assert_allclose(np.linalg.norm(p.tri[real, 9:12].numpy(), axis=1), 1.0, atol=1e-6)
    for t in (p.nodes, p.tri):
        assert t.is_contiguous()


@pytest.mark.parametrize("method, leaf_size", [("numpy", 8), ("numpy", 16), ("native", 8)])
def test_packed_nodes_round_trip(method, leaf_size):
    """A node is one 32-byte row: skip, tri_start and tri_count read back
    from the int32 bit patterns in the box's two free lanes equal the
    FlatBVH's, an internal node's leaf lane is 0, and the box lanes are the
    builder's floats untouched."""
    from rfx_torch import bvh as tbvh
    from rfx_torch.ops import bvh_pack, native_lib

    if method == "native" and not native_lib.native_available():
        pytest.skip(f"no native builder here: {native_lib.unavailable_reason()}")
    flat = tbvh.build_bvh(make_terrain(grid=20, extent=30.0, seed=4), leaf_size=leaf_size,
                          method=method)
    p = pack_bvh(flat, torch.device("cpu"))
    assert p.nodes.shape == (flat.n_nodes, 8) and p.nodes.dtype == torch.float32
    bits = p.nodes.numpy().view(np.int32)
    leaf = flat.tri_count > 0
    assert leaf.any() and (~leaf).any()
    np.testing.assert_array_equal(bits[:, 3], flat.skip)
    np.testing.assert_array_equal(bits[:, 7] >> bvh_pack.COUNT_BITS,
                                  np.where(leaf, flat.tri_start, 0))
    np.testing.assert_array_equal(bits[:, 7] & bvh_pack.MAX_LEAF_TRIS, flat.tri_count)
    assert np.all(bits[~leaf, 7] == 0) and np.all(bits[leaf, 7] != 0)
    for got, want in ((p.skip, flat.skip), (p.tri_count, flat.tri_count),
                      (p.tri_start[torch.from_numpy(leaf)], flat.tri_start[leaf])):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(p.nodes[:, [0, 1, 2, 4, 5, 6]].numpy(),
                                  np.concatenate([flat.aabb_min, flat.aabb_max], 1))


def test_pack_bvh_rejects_what_a_node_cannot_hold():
    from rfx_torch.ops import bvh_pack

    flat = build_bvh(make_terrain(grid=6, extent=10.0, seed=1), leaf_size=8, method="numpy")
    flat.leaf_size = 128
    flat.tri_count = flat.tri_count.copy()
    flat.tri_count[flat.tri_count > 0] = bvh_pack.MAX_LEAF_TRIS + 1
    with pytest.raises(ValueError, match="per leaf"):
        pack_bvh(flat, torch.device("cpu"))


def test_pack_bvh_rejects_broken_skips():
    flat = build_bvh(make_terrain(grid=6, extent=10.0, seed=1), leaf_size=8, method="numpy")
    flat.skip = flat.skip.copy()
    flat.skip[0] = 0
    with pytest.raises(ValueError, match="skip"):
        pack_bvh(flat, torch.device("cpu"))


def test_fused_rejects_bad_input():
    ft = fused.make_fused_tracer(make_terrain(grid=6, extent=10.0, seed=1), max_bounces=1,
                                 device="cpu")
    with pytest.raises(ValueError):
        fused.fused_trace(ft.bvh, torch.zeros(4, 2), [0, 0, 5], [1, 0, 5], 1.0, max_bounces=1)
    with pytest.raises(TypeError):
        fused.fused_trace(ft.bvh, torch.zeros(4, 3, dtype=torch.float64), [0, 0, 5], [1, 0, 5],
                          1.0, max_bounces=1)
    before = fused.FUSED_TRACE_KERNEL.launches
    ft(torch.tensor([[0.0, 0.0, 1.0]]), [0, 0, 5], [1, 0, 5], 1.0)
    assert fused.FUSED_TRACE_KERNEL.launches == before  # a CPU tensor runs the plain version
