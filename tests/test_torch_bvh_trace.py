"""The per-query BVH kernel's plain version (what a CPU tensor runs) and its
`env_hit` wrappers against the JAX package: forward and VJP against
`rfx`'s brute intersector in both modes, and the forward against the Pallas
kernel in interpret mode (as tests/test_pallas.py runs it); and every
`make_env_intersector` backend's gradient of t against the written-out VJP.
The CUDA kernel itself is held against this plain version in
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rfx.bvh import build_bvh
from rfx.geometry import make_room, make_terrain
from rfx.ops import intersect as jintersect
from rfx.ops.pallas_trace import make_pallas_env_hit
from rfx_torch.ops import bvh_trace, intersect
from rfx_torch.ops.bvh_pack import pack_bvh

torch.set_num_threads(1)

F32 = np.float32


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


def _soa(mesh):
    return tuple(np.asarray(a) for a in jintersect.mesh_soa(jnp.asarray(mesh.vertices),
                                                            jnp.asarray(mesh.faces)))


def _rays(n, seed, lo, hi):
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(F32)
    d = g.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)


SCENES = {
    "room": (make_room, ([-9, -7, 1], [9, 7, 9])),
    "terrain": (lambda: make_terrain(grid=16, extent=30.0, seed=7), ([-15, -15, 0], [15, 15, 15])),
}


@pytest.mark.parametrize("differentiable_tris", [False, True], ids=["baked", "difftris"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernel_env_hit_plain_matches_rfx_brute(scene, differentiable_tris):
    make, (lo, hi) = SCENES[scene]
    mesh = make()
    v0, e1, e2, nn = _soa(mesh)
    n = 500
    o, d = _rays(n, 11, lo, hi)
    o[::9] = 1e9  # parked rays miss at the root box
    g = np.random.default_rng(12)
    wt, wn = g.normal(size=n).astype(F32), g.normal(size=(n, 3)).astype(F32)
    jenv = jintersect.make_env_intersector("brute")

    def jloss(*a):
        t, face, nrm = jenv(*a, nn)
        hit = jintersect.is_hit(t)
        loss = jnp.sum(jnp.where(hit, t, 0.0) * wt)
        if differentiable_tris:
            loss = loss + jnp.sum(jnp.where(hit[:, None], nrm, 0.0) * wn)
        return loss, (t, face, nrm)

    (_, (jt, jf, jn)), want = jax.value_and_grad(jloss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, (o, d, v0, e1, e2)))
    jt, jf, jn = map(np.asarray, (jt, jf, jn))

    env = intersect.make_env_intersector("kernel", mesh=mesh, device="cpu",
                                         differentiable_tris=differentiable_tris)
    args = [_t(a, True) for a in (o, d, v0, e1, e2)]
    t, face, nrm = env(*args)
    hit = intersect.is_hit(t)
    jhit = jt < 1e29
    np.testing.assert_array_equal(hit.numpy(), jhit)
    assert 0 < int(hit.sum()) < n and not hit[::9].any()
    np.testing.assert_allclose(t.detach().numpy()[jhit], jt[jhit], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(face.numpy(), np.where(jhit, jf, -1))
    np.testing.assert_allclose(nrm.detach().numpy()[jhit], jn[jhit], atol=1e-5)
    assert not nrm[~hit].any()
    loss = (torch.where(hit, t, 0.0) * torch.from_numpy(wt)).sum()
    if differentiable_tris:
        loss = loss + (torch.where(hit[:, None], nrm, 0.0) * torch.from_numpy(wn)).sum()
    loss.backward()
    for k, (a, wg) in enumerate(zip(args, want)):
        if k >= 2 and not differentiable_tris:
            assert a.grad is None  # baked triangles: no triangle cotangents
            continue
        wg = np.asarray(wg)
        assert np.all(np.isfinite(a.grad.numpy()))
        np.testing.assert_allclose(a.grad.numpy(), wg, rtol=1e-4,
                                   atol=1e-6 * max(float(np.abs(wg).max()), 1e-30))


def test_kernel_plain_matches_pallas_interpret():
    room = make_room()
    v0, e1, e2, nn = map(jnp.asarray, _soa(room))
    o, d = _rays(128, 0, [-9, -7, 1], [9, 7, 9])
    jt, jf, jn = map(np.asarray, make_pallas_env_hit(room, interpret=True)(
        jnp.asarray(o), jnp.asarray(d), v0, e1, e2, nn))
    t, face, nrm = intersect.make_env_intersector("kernel", mesh=room, device="cpu")(
        _t(o), _t(d), *(_t(a) for a in (v0, e1, e2)))
    jhit = jt < 1e29
    assert jhit.all()  # every ray inside the closed room hits a wall
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(face.numpy(), jf)
    np.testing.assert_allclose(nrm.numpy(), jn, atol=1e-5)


def test_closest_hit_plain_outputs_and_live_tri():
    mesh = make_terrain(grid=12, extent=24.0, seed=9)
    bvh = pack_bvh(build_bvh(mesh, leaf_size=8, method="numpy"), torch.device("cpu"))
    o, d = _rays(300, 3, [-12, -12, 0], [12, 12, 12])
    o[:5] = 1e9
    t, idx, face, nrm = bvh_trace.closest_hit(bvh, _t(o), _t(d))
    assert t.dtype == torch.float32 and idx.dtype == face.dtype == torch.int32
    assert nrm.shape == (300, 3)
    miss = t >= 1e29
    assert miss[:5].all() and 0 < int((~miss).sum()) < 300
    assert (idx[miss] == -1).all() and (face[miss] == -1).all() and not nrm[miss].any()
    np.testing.assert_array_equal(face[~miss].numpy(), bvh.tri_face[idx[~miss].long()].numpy())
    torch.testing.assert_close(nrm[~miss], bvh.tri[idx[~miss].long(), 9:12])

    v0, e1, e2, _ = _soa(mesh)
    live = bvh_trace.live_tri(bvh, _t(v0), _t(e1), _t(e2))
    assert live.shape == bvh.tri.shape and live.is_contiguous()
    pad = bvh.tri_face < 0
    assert not live[pad].any()
    torch.testing.assert_close(live[:, :9], bvh.tri[:, :9])
    torch.testing.assert_close(live[:, 9:], bvh.tri[:, 9:], rtol=0, atol=1e-6)
    t2, idx2, face2, _ = bvh_trace.closest_hit(bvh, _t(o), _t(d), live)
    assert torch.equal(face2, face) and torch.equal(idx2, idx)
    empty = bvh_trace.closest_hit(bvh, torch.zeros((0, 3)), torch.zeros((0, 3)))
    assert all(a.shape[0] == 0 for a in empty)


def test_make_env_intersector_backends():
    room = make_room()
    # 'bvh' is the plain walk: the answers of the brute intersector and of
    # the 'kernel' backend's plain version, on a tree of its own.
    o, d = _rays(500, 3, [-8, -8, 1], [8, 8, 9])
    soa = intersect.mesh_soa(torch.as_tensor(room.vertices), torch.as_tensor(room.faces))
    got = {b: intersect.make_env_intersector(b, mesh=room, device="cpu")(_t(o), _t(d), *soa)
           for b in ("bvh", "kernel", "brute")}
    assert int(intersect.is_hit(got["brute"][0]).sum()) == 500  # a closed room
    for b in ("bvh", "kernel"):
        torch.testing.assert_close(got[b][0], got["brute"][0], rtol=1e-5, atol=1e-5)
        assert int((got[b][1] != got["brute"][1]).sum()) <= 5  # ties at shared edges
    assert torch.equal(got["bvh"][0], got["kernel"][0])
    with pytest.raises(ValueError):
        intersect.make_env_intersector("bvh", device="cpu")
    with pytest.raises(ValueError):
        intersect.make_env_intersector("kernel", device="cpu")
    with pytest.raises(ValueError):
        intersect.make_env_intersector("pallas", mesh=room, device="cpu")
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        bvh_trace.closest_hit(bvh_trace.make_kernel_env_hit(room, device="cpu").bvh,
                              torch.zeros((4, 2)), torch.zeros((4, 2)))
    flat = build_bvh(room, leaf_size=8, method="numpy")
    packed = pack_bvh(flat, torch.device("cpu"))
    assert bvh_trace.make_kernel_env_hit(packed).bvh is packed
    env = intersect.make_env_intersector("kernel", flat_bvh=flat, device="cpu")
    assert env.bvh.n_padded_tris == flat.n_padded_tris


BACKENDS = [("brute", False), ("kernel", False), ("kernel", True), ("bvh", False), ("bvh", True)]


@pytest.mark.parametrize("backend,differentiable_tris", BACKENDS,
                         ids=["brute", "kernel", "kernel-difftris", "bvh", "bvh-difftris"])
def test_env_hit_t_gradient_is_the_written_out_vjp(backend, differentiable_tris):
    """The gradient of sum(t w) through each backend, with a cotangent on
    every lane: at hits `closed_form_t_vjp` of the selected rows (the
    caller's (v0, e1, e2) at the face; on baked triangles the table's row,
    which takes no gradient), scatter-added into the faces; at misses and at
    parked rays finite zeros."""
    mesh = make_terrain(grid=16, extent=30.0, seed=7)
    n = 600
    o, d = _rays(n, 11, [-15, -15, 0], [15, 15, 15])
    o[::9] = 1e9
    w = _t(np.random.default_rng(12).normal(size=n))
    env = intersect.make_env_intersector(backend, mesh=mesh, device="cpu",
                                         differentiable_tris=differentiable_tris)
    baked = backend != "brute" and not differentiable_tris
    args = [_t(a, True) for a in (o, d, *_soa(mesh)[:3])]
    t, face, _ = env(*args)
    (t * w).sum().backward()
    hit = intersect.is_hit(t)
    assert 0 < int(hit.sum()) < n and not hit[::9].any()
    f = face[hit].long()
    if baked:
        padded = torch.nonzero(env.bvh.tri_face >= 0).flatten()
        row = torch.empty(len(mesh.faces), dtype=torch.long)
        row[env.bvh.tri_face[padded].long()] = padded
        tri = env.bvh.tri[row[f]]
        rows = (tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    else:
        rows = tuple(a.detach()[f] for a in args[2:])
    want = intersect.closed_form_t_vjp(_t(o)[hit], _t(d)[hit], *rows, w[hit])
    for a, wg in zip(args[:2], want[:2]):
        assert torch.equal(a.grad[hit], wg)
        assert torch.equal(a.grad[~hit], torch.zeros_like(a.grad[~hit]))
    for a, wg in zip(args[2:], want[2:]):
        if baked:
            assert a.grad is None
            continue
        assert bool(torch.isfinite(a.grad).all())
        torch.testing.assert_close(a.grad, torch.zeros_like(a.grad).index_add_(0, f, wg),
                                   rtol=1e-6, atol=0)


def _scalar_walk_counts(bvh, o, d):
    """One ray's walk, node by node in numpy f32: (nodes visited, leaves
    entered, triangles tested, t of the closest hit)."""
    nodes = bvh.nodes.numpy()
    skip, start, count = (a.numpy() for a in (bvh.skip, bvh.tri_start, bvh.tri_count))
    ok = np.abs(d) > F32(1e-30)
    inv = np.where(ok, F32(1.0) / np.where(ok, d, F32(1.0)), F32(1e30)).astype(F32)
    t_best, n_nodes, n_leaves, n_tris, i = F32(1e30), 0, 0, 0, 0
    while i < len(nodes):
        n_nodes += 1
        lo = (nodes[i, 0:3] - o) * inv
        hi = (nodes[i, 4:7] - o) * inv
        t_near, t_far = np.minimum(lo, hi).max(), np.maximum(lo, hi).min()
        if not (t_near <= min(t_far, t_best) and t_far >= F32(1e-4)):
            i = skip[i]
        elif count[i] == 0:
            i += 1
        else:
            n_leaves += 1
            n_tris += int(count[i])
            rows = bvh.tri[start[i]:start[i] + count[i]][None]
            t = float(bvh_trace.mt_block(_t(o[None]), _t(d[None]), rows).min())
            t_best = min(t_best, F32(t))
            i = skip[i]
    return n_nodes, n_leaves, n_tris, t_best


def test_counted_closest_hit_counts_the_walk_ray_by_ray():
    """`closest_hit(count=True)` on a CPU tensor: `closest_hit_plain`'s four
    outputs unchanged, and per query the nodes, leaves and triangles that a
    scalar walk of the same tree visits."""
    mesh = make_terrain(grid=12, extent=30.0, seed=4)
    bvh = pack_bvh(build_bvh(mesh, leaf_size=8), torch.device("cpu"))
    o, d = _rays(48, 5, [-12, -12, 6], [12, 12, 14])
    d[:, 2] = -np.abs(d[:, 2])  # downwards: most rays reach the terrain
    o[::7] = 1e9  # parked rays stop at the root box
    *hit, counts = bvh_trace.closest_hit(bvh, _t(o), _t(d), count=True)
    plain = bvh_trace.closest_hit_plain(bvh, _t(o), _t(d))
    for a, b in zip(hit, plain):
        assert torch.equal(a, b)
    assert counts.dtype == torch.int64 and counts.shape == (48, 3)
    assert int((hit[1] >= 0).sum()) > 10
    for r in range(48):
        n_nodes, n_leaves, n_tris, t = _scalar_walk_counts(bvh, o[r], d[r])
        assert counts[r].tolist() == [n_nodes, n_leaves, n_tris], r
        assert float(hit[0][r]) == float(t), r
    assert counts[::7].tolist() == [[1, 0, 0]] * 7
    assert len(bvh_trace.closest_hit(bvh, _t(o), _t(d))) == 4  # uncounted: four outputs
