"""The large-mesh path on the CPU at small sizes, against the JAX package on
the same numpy inputs: the plain stackless walk (rfx_torch.ops.bvh_traverse)
and its gradients, the `bvh` backend of the facade, `warp_quirk_compat`, the
native builder against the numpy one, the fused trace's walk counters
against the brute plain version and the TPU kernel in interpret mode, and
the vote micro-kernel's plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oracle import OracleTracer, sample_sphere_directions
from rfx import sampler as jsampler
from rfx.api import Tracer as JTracer
from rfx.bvh import build_bvh as jbuild_bvh
from rfx.cir import cir_from_trace as jcir_from_trace
from rfx.geometry import make_terrain as jmake_terrain
from rfx.ops import intersect as jintersect
from rfx.ops.bvh_traverse import make_bvh_env_hit as jmake_bvh_env_hit
from rfx.ops.pallas_fused import FusedTracer as JFusedTracer
from rfx.tracer import Scene as JScene
from rfx.tracer import trace_to_rx as jtrace_to_rx
from rfx_torch import bvh as tbvh
from rfx_torch import cir
from rfx_torch.api import Tracer
from rfx_torch.geometry import make_room, make_terrain
from rfx_torch.ops import bvh_trace, bvh_traverse, fused, intersect, micro_vote, native_lib
from rfx_torch.ops.bvh_pack import pack_bvh
from rfx_torch.tracer import Scene, TraceResult, trace_to_rx

torch.set_num_threads(1)

F32 = np.float32
CPU = torch.device("cpu")


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


def _rays(n, seed, lo, hi):
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(F32)
    d = g.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)


def _soa(mesh):
    return tuple(np.asarray(a) for a in jintersect.mesh_soa(jnp.asarray(mesh.vertices),
                                                            jnp.asarray(mesh.faces)))


def _off_ties(t, mesh, o, d):
    """Rays whose closest hit is not shared by two faces within 1e-5 (abutting
    terrain triangles: either face may win such a tie)."""
    v0, e1, e2, _ = (_t(a) for a in _soa(mesh))
    ts = bvh_trace.mt_block(_t(o), _t(d), torch.cat([v0, e1, e2], dim=1)[None])
    second = torch.topk(ts, 2, dim=1, largest=False).values[:, 1].numpy()
    return np.abs(second - t) > 1e-5 * np.maximum(np.abs(t), 1.0)


def test_walk_matches_rfx_bvh_walk():
    """The plain walk against rfx.ops.bvh_traverse on a make_terrain(grid=34)
    tree: identical hit masks, identical faces off ties, t within rtol 1e-5
    (the JAX walk sums its dot products through einsum)."""
    mesh = make_terrain(grid=34, extent=30.0, seed=1)
    jmesh = jmake_terrain(grid=34, extent=30.0, seed=1)
    v0, e1, e2, nn = _soa(mesh)
    o, d = _rays(1500, 5, [-15, -15, 1], [15, 15, 14])
    o[::11] = 1e9  # parked rays miss at the root box
    jt, jf, jn = map(np.asarray, jmake_bvh_env_hit(jbuild_bvh(jmesh, method="numpy"))(
        *map(jnp.asarray, (o, d, v0, e1, e2, nn))))
    env = intersect.make_env_intersector("bvh", mesh=mesh, device="cpu")
    t, face, nrm = env(*(_t(a) for a in (o, d, v0, e1, e2)))
    hit = jt < 1e29
    np.testing.assert_array_equal(intersect.is_hit(t).numpy(), hit)
    assert 300 < hit.sum() < 1500 and not hit[::11].any()
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-5)
    assert (face.numpy()[~hit] == -1).all() and (t.numpy()[~hit] >= 1e29).all()
    clear = hit & _off_ties(jt, mesh, o, d)
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(face.numpy()[clear], jf[clear])
    np.testing.assert_allclose(nrm.numpy()[clear], jn[clear], atol=1e-5)
    # The walk and the brute plain version of the kernels agree exactly on
    # the same packed tree (ties to the lowest padded index in both).
    bt, bidx, bface, _ = bvh_trace.closest_hit_plain(env.bvh, _t(o), _t(d))
    wt, widx = bvh_traverse.walk_closest_hit(env.bvh, _t(o), _t(d))
    assert torch.equal(wt, bt) and torch.equal(widx.int(), bidx) and torch.equal(face, bface)


@pytest.mark.parametrize("differentiable_tris", [False, True], ids=["baked", "difftris"])
def test_walk_gradients_match_jax(differentiable_tris):
    """Ray, and with differentiable_tris vertex, gradients of a loss over t
    and the normal against jax.grad through rfx's bvh backend."""
    mesh = make_terrain(grid=16, extent=30.0, seed=7)
    jmesh = jmake_terrain(grid=16, extent=30.0, seed=7)
    faces = np.asarray(mesh.faces)
    n = 600
    o, d = _rays(n, 11, [-15, -15, 0], [15, 15, 15])
    o[::9] = 1e9
    g = np.random.default_rng(12)
    wt, wn = g.normal(size=n).astype(F32), g.normal(size=(n, 3)).astype(F32)
    jenv = jintersect.make_env_intersector("bvh", mesh=jmesh,
                                           differentiable_tris=differentiable_tris)

    def jloss(o_, d_, verts):
        v0, e1, e2, nn = jintersect.mesh_soa(verts, jnp.asarray(faces))
        t, _, nrm = jenv(o_, d_, v0, e1, e2, nn)
        hit = jintersect.is_hit(t)
        return (jnp.sum(jnp.where(hit, t, 0.0) * wt)
                + jnp.sum(jnp.where(hit[:, None], nrm, 0.0) * wn))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (o, d, mesh.vertices)))
    env = intersect.make_env_intersector("bvh", mesh=mesh, device="cpu",
                                         differentiable_tris=differentiable_tris)
    args = [_t(a, True) for a in (o, d, mesh.vertices)]
    t, _, nrm = env(args[0], args[1], *intersect.mesh_soa(args[2], torch.as_tensor(faces)))
    hit = intersect.is_hit(t)
    assert 0 < int(hit.sum()) < n
    ((torch.where(hit, t, 0.0) * torch.from_numpy(wt)).sum()
     + (torch.where(hit[:, None], nrm, 0.0) * torch.from_numpy(wn)).sum()).backward()
    for a, wg in zip(args, want):
        wg = np.asarray(wg)
        assert np.all(np.isfinite(a.grad.numpy())) and np.abs(wg).sum() > 0
        np.testing.assert_allclose(a.grad.numpy(), wg, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(wg).max()))


def test_bvh_backend_vertex_gradient_fd(box_room):
    """tests/test_gradients.py::test_vertex_gradient_fd with its bars (8%)
    through the port's `bvh` backend with differentiable_tris."""
    mesh = make_room()
    scene = Scene.from_mesh(mesh, "cpu")
    env = intersect.make_env_intersector("bvh", mesh=mesh, differentiable_tris=True, device="cpu")
    dirs = torch.from_numpy(sample_sphere_directions(2048, seed=21))
    tx, rxp = _t([4.0, 3.0, 6.0]), _t([-6.0, -4.0, 5.0])

    def loss(v):
        r = trace_to_rx(Scene(v, scene.faces), tx, dirs, rxp, 2.0, max_bounces=2,
                        rx_mode="analytic", env_hit=env)
        return torch.where(r.captured, r.amplitude * r.distance, 0.0).sum()

    v0 = scene.vertices.clone().requires_grad_()
    loss(v0).backward()
    g = v0.grad
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    u = _t(np.random.default_rng(5).normal(size=tuple(v0.shape)))
    u = u / torch.linalg.norm(u)
    with torch.no_grad():
        fd = (float(loss(v0 + 2e-3 * u)) - float(loss(v0 - 2e-3 * u))) / 4e-3
    ad = float((g * u).sum())
    assert abs(ad - fd) < 0.08 * max(abs(fd), abs(ad), 1e-3), (ad, fd)


def test_facade_bvh_backend_matches_rfx():
    """Tracer(backend="bvh") against rfx.api.Tracer(backend="bvh") on the
    same mesh and directions, with recorded paths."""
    mesh = make_terrain(grid=40, extent=40.0, seed=5)
    jmesh = jmake_terrain(grid=40, extent=40.0, seed=5)
    n = 4096
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(3), n))
    tx, rx = np.array([4.0, 0.0, 14.0]), np.array([-6.0, 1.0, 7.0])
    kw = dict(max_bounces=3, tx_num_rays=n, backend="bvh")
    t = Tracer(mesh, 2.998e8, 100e9, 200e-9, device="cpu", **kw)
    assert t.backend == "bvh" and t._fused is None
    paths, ir = t.compute_cir(tx, 1.0, rx, 1.5, directions=dirs, record_paths=True)
    jt = JTracer(jmesh, 2.998e8, 100e9, 200e-9, **kw)
    j_paths, j_ir = jt.compute_cir(tx, 1.0, rx, 1.5, directions=dirs, record_paths=True)
    assert ir.sum() > 0 and len(paths) == len(j_paths) > 0
    np.testing.assert_array_equal(ir != 0, j_ir != 0)
    np.testing.assert_allclose(ir, j_ir, rtol=1e-4, atol=1e-9)
    for p, jp in zip(paths, j_paths):
        np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-4)
    # The fused backend answers the same request within f32 rounding.
    _, ir_f = Tracer(mesh, 2.998e8, 100e9, 200e-9, max_bounces=3, tx_num_rays=n,
                     backend="fused", device="cpu").compute_cir(tx, 1.0, rx, 1.5, directions=dirs,
                                               record_paths=False)
    np.testing.assert_array_equal(ir != 0, ir_f != 0)
    np.testing.assert_allclose(ir, ir_f, rtol=1e-4, atol=1e-9)
    irs = t.compute_coverage(tx, 1.0, np.stack([rx, rx + 3.0]).astype(F32), 1.5, directions=dirs)
    np.testing.assert_allclose(irs[0], ir, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("rx_mode", ["analytic", "icosphere"])
def test_warp_quirk_compat_matches_rfx_and_oracle(box_room, rx_mode):
    """tests/test_tracer_parity.py::test_warp_quirk_compat_matches_oracle for
    the port, with its bars, and the JAX tracer's quirk mode ray for ray."""
    c, rate, window = 2.998e8, 100e9, 200e-9
    nbins = int(window * rate)
    tx, rx = np.array([10.0, 0.0, 5.0]), np.array([-10.0, 0.0, 5.0])
    dirs = sample_sphere_directions(3000, seed=11)
    paths_o, ir_o = OracleTracer(box_room, c, rate, window, 4, rx_mode=rx_mode,
                                 warp_quirk_compat=True).compute_cir(tx, 1.0, rx, 1.5, dirs)
    scene = Scene.from_mesh(box_room, "cpu")
    kw = dict(max_bounces=4, rx_mode=rx_mode)
    out = trace_to_rx(scene, tx, torch.from_numpy(dirs), rx, 1.5, warp_quirk_compat=True, **kw)
    ref = jtrace_to_rx(JScene.from_mesh(box_room), jnp.asarray(tx, jnp.float32),
                       jnp.asarray(dirs), jnp.asarray(rx, jnp.float32), 1.5,
                       warp_quirk_compat=True, **kw)
    m = np.asarray(ref.captured)
    np.testing.assert_array_equal(out.captured.numpy(), m)
    np.testing.assert_array_equal(out.num_bounces.numpy(), np.asarray(ref.num_bounces))
    np.testing.assert_allclose(out.amplitude.numpy()[m], np.asarray(ref.amplitude)[m],
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(out.distance.numpy()[m], np.asarray(ref.distance)[m],
                               rtol=1e-5, atol=1e-4)
    ir = cir.cir_from_trace(out, tx_power=1.0, num_rays=3000, nbins=nbins, light_speed_mps=c,
                            sample_rate_hz=rate).numpy()
    assert int(out.captured.sum()) == len(paths_o)
    mismatch = ~np.isclose(ir, ir_o, rtol=2e-4, atol=1e-9 * max(1.0, ir_o.max()))
    assert mismatch.sum() <= 4, f"{int(mismatch.sum())} mismatched bins"
    np.testing.assert_allclose(ir.sum(), ir_o.sum(), rtol=1e-3)
    plain = trace_to_rx(scene, tx, torch.from_numpy(dirs), rx, 1.5, **kw)
    d_q, d_d = out.distance[out.captured].numpy(), plain.distance[plain.captured].numpy()
    assert not (d_q.shape == d_d.shape and np.allclose(d_q, d_d)), "the quirk did not bite"


def _valid_layout(flat, mesh):
    n = flat.n_nodes
    skip = flat.skip.astype(np.int64)
    assert (skip > np.arange(n)).all() and (skip <= n).all() and skip[0] == n
    leaf = flat.tri_count > 0
    assert (flat.tri_count[leaf] <= flat.leaf_size).all()
    assert (skip[leaf] == np.arange(n)[leaf] + 1).all()
    assert (flat.tri_start[leaf] % flat.leaf_size == 0).all()
    real = flat.tri_face >= 0
    assert sorted(flat.tri_face[real].tolist()) == list(range(mesh.num_faces))  # every face once
    tri = mesh.triangles()[flat.tri_face[real]]
    np.testing.assert_array_equal(flat.tri_v0[real], tri[:, 0])
    np.testing.assert_array_equal(flat.tri_e1[real], tri[:, 1] - tri[:, 0])
    assert not flat.tri_e1[~real].any() and not flat.tri_e2[~real].any()
    # Every leaf's triangles lie inside its box, every child's box inside its parent's.
    for i in np.nonzero(leaf)[0][:: max(1, leaf.sum() // 50)]:
        rows = slice(flat.tri_start[i], flat.tri_start[i] + flat.tri_count[i])
        corners = mesh.triangles()[flat.tri_face[rows]].reshape(-1, 3)
        assert (corners >= flat.aabb_min[i] - 1e-6).all() and (corners <= flat.aabb_max[i] + 1e-6).all()
    for i in np.nonzero(~leaf)[0][:: max(1, (~leaf).sum() // 50)]:
        for c in flat.children(int(i)):
            assert (flat.aabb_min[c] >= flat.aabb_min[i]).all()
            assert (flat.aabb_max[c] <= flat.aabb_max[i]).all()


@pytest.mark.parametrize("leaf", [8, 16])
def test_native_builder_against_numpy_builder(leaf):
    """The same layout contract, every face once, and the same closest hits
    on 4,096 rays (off ties: the two builders give different trees)."""
    if not native_lib.native_available():
        pytest.skip(f"no native builder here: {native_lib.unavailable_reason()}")
    mesh = make_terrain(grid=48, extent=40.0, seed=3)
    native = tbvh.build_bvh(mesh, leaf_size=leaf, method="native")
    numpy_ = tbvh.build_bvh(mesh, leaf_size=leaf, method="numpy")
    for flat in (native, numpy_):
        assert flat.leaf_size == leaf
        _valid_layout(flat, mesh)
    o, d = _rays(4096, 8, [-20, -20, 1], [20, 20, 18])
    got = [bvh_traverse.walk_closest_hit(pack_bvh(f, CPU), _t(o), _t(d)) for f in (native, numpy_)]
    (t_a, i_a), (t_b, i_b) = got
    hit = (t_b < 1e29).numpy()
    np.testing.assert_array_equal((t_a < 1e29).numpy(), hit)
    assert hit.sum() > 1000
    np.testing.assert_array_equal(t_a.numpy(), t_b.numpy())  # the same triangles, the same t
    clear = hit & _off_ties(t_b.numpy(), mesh, o, d)
    f_a = native.tri_face[i_a.numpy().clip(0)]
    f_b = numpy_.tri_face[i_b.numpy().clip(0)]
    np.testing.assert_array_equal(f_a[clear], f_b[clear])


def test_build_method_auto_and_errors(monkeypatch, caplog):
    mesh = make_terrain(grid=12, extent=24.0, seed=9)
    small = tbvh.build_bvh(mesh)  # auto: below NATIVE_MIN_FACES the numpy builder
    np.testing.assert_array_equal(small.skip, tbvh.build_bvh(mesh, method="numpy").skip)
    with pytest.raises(ValueError, match="method"):
        tbvh.build_bvh(mesh, method="gpu")
    monkeypatch.setattr(tbvh, "NATIVE_MIN_FACES", 100)
    if native_lib.native_available():
        auto = tbvh.build_bvh(mesh)
        np.testing.assert_array_equal(auto.skip, tbvh.build_bvh(mesh, method="native").skip)
    # Without a compiler: `native` raises, `auto` logs and takes numpy.
    monkeypatch.setattr(native_lib._Native, "lib", None)
    monkeypatch.setattr(native_lib._Native, "reason", "g++ not found")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tbvh.build_bvh(mesh, method="native")
    import logging

    logger = logging.getLogger("rfx_torch")
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger="rfx_torch"):
        fallback = tbvh.build_bvh(mesh)
    np.testing.assert_array_equal(fallback.skip, small.skip)
    assert "numpy builder" in caplog.text and "g++ not found" in caplog.text


def _counted_scene(leaf=8):
    mesh = make_terrain(grid=34, extent=30.0, seed=1)
    flat = tbvh.build_bvh(mesh, leaf_size=leaf, method="numpy")
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(2), 2048))
    return mesh, flat, dirs, ([0.5, -1.0, 9.0], [3.0, 0.0, 6.0], 2.0)


def test_walk_counters_and_trace_match_brute_plain():
    _, flat, dirs, args = _counted_scene()
    ft = fused.FusedTracer(flat, max_bounces=6, count_stats=True, device="cpu")
    res, faces, stats = ft(dirs, *args, record_faces=True)
    p_res, p_faces = fused.fused_trace_plain(ft.bvh, torch.from_numpy(dirs), *args, max_bounces=6,
                                             record_faces=True)
    for a, b in zip(res[:4], p_res[:4]):
        assert torch.equal(a, b)
    assert torch.equal(faces, p_faces) and int(res.captured.sum()) > 0
    assert stats.shape == (6, 4) and stats.dtype == torch.int64
    nodes, leaves, tris, steps = stats.T
    live = int(res.num_bounces.max())  # bounce `live` still walks; later ones do not
    assert 0 < live < 5
    assert (nodes[: live + 1] > 0).all() and not stats[live + 1:].any()
    assert (nodes >= leaves).all() and (tris <= leaves * flat.leaf_size).all()
    assert (steps * fused.WARP >= nodes).all() and (steps <= nodes).all()
    assert int(nodes[0]) >= 2048  # every ray visits the root on bounce 0
    # Bounce 0 by hand: the per-ray counts of the walk itself.
    o = torch.tensor(args[0]).expand(2048, 3)
    _, _, per_ray = bvh_traverse.walk_closest_hit(ft.bvh, o, torch.from_numpy(dirs), count=True)
    assert torch.equal(per_ray.sum(0), stats[0, :3])
    assert int(per_ray[:, 0].view(-1, fused.WARP).amax(1).sum()) == int(steps[0])
    # Uncounted tracers return no counters; a ragged ray count pads the last group.
    assert isinstance(fused.FusedTracer(flat, max_bounces=2, device="cpu")(dirs[:7], *args),
                      TraceResult)
    _, s7 = fused.fused_trace(ft.bvh, torch.from_numpy(dirs[:70]), *args, max_bounces=2,
                              count_stats=True)
    assert s7.shape == (2, 4) and int(s7[0, 0]) >= 70


def test_walk_counters_against_tpu_kernel_interpret():
    """The TPU kernel (interpret mode, count_stats) counts per TILE of 128
    rays: windows of 8 speculative nodes, and leaves pushed when ANY ray of
    the tile hits their box, drained in groups so that t_best lags. Neither
    is the port's per-ray count. What is comparable, on the same leaf-16 tree
    at bounce 0: a tile's leaf pushes are at least the most leaves any one of
    its rays enters in the port's walk (the tile visits the union of its
    rays' leaves under a later, so looser, t_best) and at most the sum over
    its rays; its windows are at least a k-th of the most nodes any ray
    visits. The traces agree as tests/test_torch_fused.py holds them."""
    _, flat, dirs, args = _counted_scene(leaf=16)
    dirs = dirs[:512]
    jflat = jbuild_bvh(jmake_terrain(grid=34, extent=30.0, seed=1), leaf_size=16, method="numpy")
    np.testing.assert_array_equal(jflat.skip, flat.skip)
    jft = JFusedTracer(jflat, max_bounces=2, tile_rays=128, interpret=True, count_stats=True)
    jres, jstats = jft(jnp.asarray(dirs), *(jnp.asarray(a, jnp.float32) for a in args))
    jstats = np.asarray(jstats)  # (tiles, 2B): windows_b0, leaves_b0, windows_b1, ...
    assert jstats.shape == (4, 4)
    res, stats = fused.FusedTracer(flat, max_bounces=2, count_stats=True, device="cpu")(dirs, *args)
    np.testing.assert_array_equal(res.captured.numpy(), np.asarray(jres.captured))
    np.testing.assert_array_equal(res.num_bounces.numpy(), np.asarray(jres.num_bounces))
    bvh = pack_bvh(flat, CPU)
    o = torch.tensor(args[0]).expand(512, 3)
    _, _, per_ray = bvh_traverse.walk_closest_hit(bvh, o, torch.from_numpy(dirs), count=True)
    per_tile = per_ray.view(4, 128, 3).numpy()
    k_spec = jft.k_spec
    for tile in range(4):
        windows, pushes = int(jstats[tile, 0]), int(jstats[tile, 1])
        assert per_tile[tile, :, 1].max() <= pushes <= per_tile[tile, :, 1].sum(), tile
        assert windows * k_spec >= per_tile[tile, :, 0].max(), tile
    assert int(stats[0, 1]) == per_tile[:, :, 1].sum()


@pytest.mark.parametrize("style", micro_vote.STYLES)
def test_micro_vote_plain_gives_the_carry_the_body_implies(style):
    """With x in [0, 1) every mask k >= 1 is full and mask 0 has a member
    above 0.5, so all 8 flags are set: s = 8 and the carry is 8e-9 summed
    `steps` times in f32 (0 for `novec`, whose s is 0 as in the reference)."""
    x = torch.from_numpy(np.random.default_rng(0).random((8, 128)).astype(F32))
    steps = 300
    want = F32(0.0)
    for _ in range(steps):
        want = F32(want + F32(F32(8.0) * F32(1e-9)))
    got = micro_vote.micro_vote(x, steps, style)
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == (0.0 if style == "novec" else float(want))
    # A tile below the threshold for mask 0 only: 7 flags.
    low = micro_vote.micro_vote_plain(torch.full((8, 128), 0.25), 10, style)
    seven = F32(0.0)
    for _ in range(10):
        seven = F32(seven + F32(F32(7.0) * F32(1e-9)))
    assert float(low) == (0.0 if style == "novec" else float(seven))
    assert micro_vote.MICRO_VOTE_KERNEL.launches == 0  # a CPU tensor runs the plain version


def test_micro_vote_rejects_bad_input():
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="style"):
        micro_vote.micro_vote(x, 1, "ballot")
    with pytest.raises(ValueError, match="tile"):
        micro_vote.micro_vote(torch.zeros((4, 128)), 1)
    with pytest.raises(ValueError, match="tile"):
        micro_vote.micro_vote(x.double(), 1)
    with pytest.raises(ValueError, match="steps"):
        micro_vote.micro_vote(x, -1)
    assert float(micro_vote.micro_vote(x, 0)) == 0.0
