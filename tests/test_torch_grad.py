"""The port's gradients against the JAX package's on the same numpy inputs:
the IR histogram's backward (hard and soft binning), the custom backwards of
`ray_sphere_hit` and the brute intersector, the scan tracer through the
per-query kernel's plain version, `replay_from_faces`, and the
differentiable fused tracer against the scan tracer (tests/test_fused.py:
159-194, whose JAX version is slow only because of interpret mode), and the
coverage metrics end to end (the fast metric, and the exact one with soft
binning: the map engine, the histogram's and the RX-power metric's
backwards)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rfx import cir as jcir
from rfx import sampler as jsampler
from rfx.geometry import make_room, make_terrain
from rfx.ops import intersect as jintersect
from rfx.ops.pallas_fused import replay_from_faces as jreplay
from rfx.tracer import Scene as JScene
from rfx.tracer import trace_to_rx as jtrace_to_rx
from rfx_torch import cir
from rfx_torch.ops import fused, intersect
from rfx_torch.tracer import Scene, trace_to_rx

torch.set_num_threads(1)

F32 = np.float32
HKW = dict(nbins=20_000, light_speed_mps=2.998e8, sample_rate_hz=100e9)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


def _close(got, want, rtol, atol_frac=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol_frac * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_histogram_gradient_matches_jax(soft):
    g = np.random.default_rng(3)
    n = 6000
    amp = g.random(n).astype(F32)
    dist = (g.random(n) * 70.0).astype(F32)  # up to 23,349 bins: some fall out of the window
    dist[:8] = np.float32(20_000 * 2.998e8 / 100e9) - g.random(8).astype(F32) * 1e-3  # last bin
    cap = g.random(n) < 0.6
    w = g.normal(size=HKW["nbins"]).astype(F32)

    def jloss(a, d):
        ir = jcir.bin_impulse_response(a, d, jnp.asarray(cap), soft=soft, method="scatter", **HKW)
        return jnp.sum(ir * w)

    ga, gd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(amp), jnp.asarray(dist))
    a, d = _t(amp, True), _t(dist, True)
    ir = cir.bin_impulse_response(a, d, torch.from_numpy(cap), soft=soft, **HKW)
    assert ir.requires_grad
    (ir * torch.from_numpy(w)).sum().backward()
    _close(a.grad, ga, rtol=1e-5)
    _close(d.grad, gd, rtol=1e-5)
    assert (np.abs(np.asarray(gd)).max() > 0) == soft  # hard binning is flat in distance


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_batched_histogram_gradient_matches_jax(soft):
    """(R, n) rows through the sparse backward against jax.grad of the vmapped
    scatter: a dense row, a sparse one, a row with no capture, and a row
    whose paths sit in the window's last bin, where the high half leaves it
    and the low half stays."""
    g = np.random.default_rng(8)
    n = 3001
    amp = g.random((4, n)).astype(F32)
    dist = (g.random((4, n)) * 70.0).astype(F32)
    cap = g.random((4, n)) < np.array([0.6, 0.01, 0.0, 0.4])[:, None]
    dist[3] = np.float32(20_000 * 2.998e8 / 100e9) - (g.random(n) * 2e-3).astype(F32)
    w = g.normal(size=(4, HKW["nbins"])).astype(F32)

    def jloss(a, d):
        irs = jax.vmap(lambda a_, d_, c_: jcir.bin_impulse_response(
            a_, d_, c_, soft=soft, method="scatter", **HKW))(a, d, jnp.asarray(cap))
        return jnp.sum(irs * w)

    with jax.disable_jit():
        ga, gd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(amp), jnp.asarray(dist))
    a, d = _t(amp, True), _t(dist, True)
    irs = cir.bin_impulse_response(a, d, torch.from_numpy(cap), soft=soft, **HKW)
    assert irs.shape == (4, HKW["nbins"]) and irs.requires_grad
    (irs * torch.from_numpy(w)).sum().backward()
    _close(a.grad, ga, rtol=1e-5)
    _close(d.grad, gd, rtol=1e-5)
    assert not a.grad[2].any() and not d.grad[2].any()  # nothing captured, no gradient
    assert not a.grad[~torch.from_numpy(cap)].any()
    if soft:  # in the last bin only the low half counts: d ir / d dist < 0 for w > 0
        last = torch.from_numpy(cap[3]) & (irs[3, -1] != 0)
        assert bool(last.any()) and float(d.grad[3].abs().max()) > 0
    # Each row's gradient is that of the row alone.
    for r in range(4):
        a1, d1 = _t(amp[r], True), _t(dist[r], True)
        ir = cir.bin_impulse_response(a1, d1, torch.from_numpy(cap[r]), soft=soft, **HKW)
        (ir * torch.from_numpy(w[r])).sum().backward()
        assert torch.equal(a1.grad, a.grad[r]) and torch.equal(d1.grad, d.grad[r]), r


def test_histogram_backward_needs_no_dense_temporaries():
    """Only the inputs that ask for a gradient get one, and a tensor that
    asks for none saves nothing."""
    g = np.random.default_rng(9)
    amp, dist = _t(g.random((2, 500)), True), _t(g.random((2, 500)) * 50.0)
    cap = torch.from_numpy(g.random((2, 500)) < 0.1)
    ir = cir.bin_impulse_response(amp, dist, cap, soft=True, **HKW)
    ir.sum().backward()
    assert dist.grad is None and amp.grad.shape == (2, 500)
    assert int((amp.grad != 0).sum()) <= int(cap.sum())
    plain = cir.bin_impulse_response(amp.detach(), dist, cap, soft=True, **HKW)
    assert not plain.requires_grad and torch.equal(plain, ir.detach())


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_histogram_gradient_matches_autograd_of_plain(soft):
    """The Function's backward equals autograd through the plain version's
    index_add_ (floor is flat, so the soft halves' fraction carries d/d dist)."""
    g = np.random.default_rng(4)
    amp, dist = _t(g.random(500), True), _t(g.random(500) * 50.0, True)
    cap = torch.from_numpy(g.random(500) < 0.7)
    w = torch.from_numpy(g.normal(size=HKW["nbins"]).astype(F32))
    (cir.bin_impulse_response(amp, dist, cap, soft=soft, **HKW) * w).sum().backward()
    got = amp.grad.clone(), dist.grad.clone()
    amp.grad = dist.grad = None
    modes = (cir.SOFT_LO, cir.SOFT_HI) if soft else (cir.HARD,)
    ir = sum(cir.histogram_plain(amp, dist, cap, mode=m, **HKW) for m in modes)
    (ir * w).sum().backward()
    dist_want = torch.zeros_like(dist) if dist.grad is None else dist.grad
    torch.testing.assert_close(got[0], amp.grad, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got[1], dist_want, rtol=1e-4, atol=1e-3)


def test_ray_sphere_hit_vjp_matches_jax():
    g = np.random.default_rng(5)
    n = 300
    c = np.asarray([-8.0, 0.0, 5.0], F32)
    o = g.uniform(-14, 14, (n, 3)).astype(F32)
    tgt = c + g.normal(size=(n, 3)) * 0.9
    tgt[::5] = g.uniform(-14, 14, (len(tgt[::5]), 3))  # most of these miss
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    d = d.astype(F32)
    w = g.normal(size=n).astype(F32)

    def jloss(o_, d_, c_, r_):
        t = jintersect.ray_sphere_hit(o_, d_, c_, r_)
        return jnp.sum(jnp.where(jintersect.is_hit(t), t, 0.0) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(jnp.asarray(o), jnp.asarray(d),
                                                jnp.asarray(c), jnp.float32(1.3))
    args = [_t(o, True), _t(d, True), _t(c, True), _t(1.3, True)]
    t = intersect.ray_sphere_hit(*args)
    hit = intersect.is_hit(t)
    assert 0 < int(hit.sum()) < n
    (torch.where(hit, t, 0.0) * torch.from_numpy(w)).sum().backward()
    for a, wg in zip(args, want):
        _close(a.grad, wg, rtol=1e-4)


def _room_rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform([-9, -7, 1], [9, 7, 9], (n, 3)).astype(F32)
    o[::7] = g.uniform(40, 60, (len(o[::7]), 3))  # outside the room: many miss
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)
    return o, d


def test_brute_env_hit_vjp_matches_jax():
    room = make_room()
    v0, e1, e2, nn = (np.asarray(a) for a in jintersect.mesh_soa(
        jnp.asarray(room.vertices), jnp.asarray(room.faces)))
    o, d = _room_rays(400, 6)
    g = np.random.default_rng(7)
    wt, wn = g.normal(size=400).astype(F32), g.normal(size=(400, 3)).astype(F32)
    jenv = jintersect.make_env_intersector("brute")

    def jloss(*a):
        t, face, nrm = jenv(*a, nn)
        hit = jintersect.is_hit(t)
        return jnp.sum(jnp.where(hit, t, 0.0) * wt) + jnp.sum(jnp.where(hit[:, None], nrm, 0.0) * wn)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, (o, d, v0, e1, e2)))
    args = [_t(a, True) for a in (o, d, v0, e1, e2)]
    t, face, nrm = intersect.make_env_intersector("brute")(*args)
    hit = intersect.is_hit(t)
    assert 0 < int(hit.sum()) < 400
    loss = ((torch.where(hit, t, 0.0) * torch.from_numpy(wt)).sum()
            + (torch.where(hit[:, None], nrm, 0.0) * torch.from_numpy(wn)).sum())
    loss.backward()
    for a, wg in zip(args, want):
        _close(a.grad, wg, rtol=1e-4)


TERRAIN = dict(grid=16, extent=30.0, seed=3)
TX, RX = np.asarray([2.0, 1.0, 9.0], F32), np.asarray([-5.0, 2.0, 6.0], F32)


def _terrain_dirs(n, key=4):
    return np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(key), n))


@pytest.mark.parametrize("differentiable_tris", [False, True], ids=["baked", "difftris"])
def test_scan_gradients_through_kernel_plain_match_jax_brute(differentiable_tris):
    mesh = make_terrain(**TERRAIN)
    dirs = _terrain_dirs(1024)
    jscene = JScene.from_mesh(mesh)

    def jloss(txp, n1, verts):
        r = jtrace_to_rx(JScene(verts, jscene.faces), txp, jnp.asarray(dirs), jnp.asarray(RX),
                         1.0, max_bounces=3, rx_mode="analytic", n1=n1)
        return jnp.sum(jnp.where(r.captured, r.amplitude * r.distance, 0.0))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(TX), jnp.float32(5.0), jscene.vertices)
    env = intersect.make_env_intersector("kernel", mesh=mesh, device="cpu",
                                         differentiable_tris=differentiable_tris)
    tx, n1, verts = _t(TX, True), _t(5.0, True), _t(mesh.vertices, True)
    r = trace_to_rx(Scene(verts, torch.from_numpy(mesh.faces)), tx, torch.from_numpy(dirs),
                    _t(RX), 1.0, max_bounces=3, rx_mode="analytic", n1=n1, env_hit=env)
    assert int(r.captured.sum()) > 0
    torch.where(r.captured, r.amplitude * r.distance, 0.0).sum().backward()
    _close(tx.grad, want[0], rtol=2e-3, atol_frac=1e-8)
    _close(n1.grad, want[1], rtol=2e-3, atol_frac=1e-8)
    if differentiable_tris:
        _close(verts.grad, want[2], rtol=1e-2)
        assert float(verts.grad.abs().sum()) > 0
    else:
        assert verts.grad is None or float(verts.grad.abs().sum()) == 0.0


def _plain_record(mesh, dirs, bounces):
    ft = fused.make_fused_tracer(mesh, max_bounces=bounces, device="cpu")
    return ft(torch.from_numpy(dirs), TX, RX, 1.0, record_faces=True)


def test_replay_from_faces_matches_jax_and_the_trace():
    mesh = make_terrain(**TERRAIN)
    dirs = _terrain_dirs(2048)
    result, bf = _plain_record(mesh, dirs, 3)
    m = result.captured.numpy()
    assert m.sum() > 0
    nb = result.num_bounces.numpy()
    assert bf.shape == (3, 2048) and bf.dtype == torch.int32
    np.testing.assert_array_equal((bf.numpy() >= 0).sum(axis=0), nb)
    assert np.all(bf.numpy()[np.arange(3)[:, None] < nb[None, :]] >= 0)

    jargs = (jnp.asarray(mesh.faces), jnp.asarray(TX), jnp.asarray(dirs), jnp.asarray(RX),
             jnp.float32(1.0), jnp.asarray(bf.numpy()), jnp.asarray(m), jnp.asarray(nb))
    (ja, jd), jvjp = jax.vjp(lambda v, t: jreplay(v, jargs[0], t, *jargs[2:]),
                             jnp.asarray(mesh.vertices), jnp.asarray(TX))
    verts, tx = _t(mesh.vertices, True), _t(TX, True)
    amp, dist = fused.replay_from_faces(verts, torch.from_numpy(mesh.faces), tx,
                                        torch.from_numpy(dirs), _t(RX), _t(1.0), bf,
                                        result.captured, result.num_bounces)
    _close(amp[m], np.asarray(ja)[m], rtol=1e-5)
    _close(dist[m], np.asarray(jd)[m], rtol=1e-5)
    np.testing.assert_allclose(amp.detach().numpy()[m], result.amplitude.numpy()[m],
                               rtol=5e-5, atol=1e-7)
    np.testing.assert_allclose(dist.detach().numpy()[m], result.distance.numpy()[m],
                               rtol=2e-5, atol=2e-4)
    g = np.random.default_rng(8)
    ga, gd = (np.where(m, g.normal(size=2048), 0.0).astype(F32) for _ in range(2))
    jgv, jgt = jvjp((jnp.asarray(ga), jnp.asarray(gd)))
    torch.autograd.backward((amp, dist), (torch.from_numpy(ga), torch.from_numpy(gd)))
    _close(tx.grad, jgt, rtol=1e-4)
    _close(verts.grad, jgv, rtol=1e-3)


def test_diff_fused_gradients_match_scan_path():
    mesh = make_terrain(**TERRAIN)
    dirs = torch.from_numpy(_terrain_dirs(1024))
    faces = torch.from_numpy(mesh.faces)
    dt = fused.make_diff_fused_tracer(mesh, faces, max_bounces=3, device="cpu")

    def loss_fused(txp, verts):
        r = dt(verts, txp, dirs, _t(RX), 1.0)
        return torch.where(r.captured, r.amplitude * r.distance, 0.0).sum()

    def loss_scan(txp, verts):
        r = trace_to_rx(Scene(verts, faces), txp, dirs, _t(RX), 1.0, max_bounces=3,
                        rx_mode="analytic")
        return torch.where(r.captured, r.amplitude * r.distance, 0.0).sum()

    grads = {}
    for name, fn in (("fused", loss_fused), ("scan", loss_scan)):
        tx, verts = _t(TX, True), _t(mesh.vertices, True)
        loss = fn(tx, verts)
        loss.backward()
        grads[name] = (float(loss.detach()), tx.grad.numpy(), verts.grad.numpy())
    (lf, gf_tx, gf_v), (ls, gs_tx, gs_v) = grads["fused"], grads["scan"]
    assert abs(lf - ls) < 1e-4 * max(abs(ls), 1e-6)
    assert np.all(np.isfinite(gf_tx))
    np.testing.assert_allclose(gf_tx, gs_tx, rtol=2e-3, atol=1e-8)
    np.testing.assert_allclose(gf_v, gs_v, rtol=1e-2, atol=1e-6 * max(1.0, float(np.abs(gs_v).max())))


def test_diff_fused_grads_follow_requires_grad():
    """Inputs without requires_grad get no gradient; the direction gradient
    lands on the captured rows only."""
    mesh = make_terrain(**TERRAIN)
    dirs = torch.from_numpy(_terrain_dirs(1024))
    faces = torch.from_numpy(mesh.faces)
    dt = fused.make_diff_fused_tracer(mesh, faces, max_bounces=3, device="cpu")
    for with_dirs in (False, True):
        tx, verts, rx = _t(TX, True), _t(mesh.vertices), _t(RX)
        d = dirs.clone().requires_grad_(with_dirs)
        r = dt(verts, tx, d, rx, 1.0)
        assert int(r.captured.sum()) > 3
        torch.where(r.captured, r.amplitude * r.distance, 0.0).sum().backward()
        assert torch.isfinite(tx.grad).all() and float(tx.grad.abs().sum()) > 0
        assert verts.grad is None and rx.grad is None
        if with_dirs:
            assert torch.isfinite(d.grad).all()
            assert float(d.grad[~r.captured].abs().sum()) == 0.0
            assert float(d.grad[r.captured].abs().sum()) > 0
        else:
            assert d.grad is None


COV_DIRS_SEED = 77
COV_TX = np.asarray([3.0, 2.0, 2.0], F32)
COV_KW = dict(max_bounces=2, num_rays=8192, sample_window_s=100e-9, sample_rate_hz=10e9,
              rx_batch=10)


def _coverage_inputs():
    from oracle import sample_sphere_directions
    from rfx.coverage import make_grid as jmake_grid

    dirs = sample_sphere_directions(8192, seed=COV_DIRS_SEED)
    centers = np.asarray(jmake_grid(range(-12, 13, 6), range(-12, 13, 6), [2, 8]), F32)
    return dirs, centers


def _mean_finite(dbm, xp):
    fin = xp.isfinite(dbm)
    return xp.sum(xp.where(fin, dbm, 0.0)) / xp.sum(fin)


def _port_coverage_grads(fn, dirs, centers, **kw):
    """d (mean of the finite dBm) / d (n1, tx) through the port on the CPU;
    an input the loss does not reach gets zeros."""
    from rfx_torch import coverage

    n1 = torch.tensor(5.0, requires_grad=True)
    tx = torch.tensor(COV_TX, requires_grad=True)
    dbm = getattr(coverage, fn)(Scene.from_mesh(make_room(), "cpu"), tx, torch.from_numpy(dirs),
                                centers, 1.0, n1=n1, **COV_KW, **kw)
    g_n1, g_tx = torch.autograd.grad(_mean_finite(dbm, torch), [n1, tx], allow_unused=True,
                                     materialize_grads=True)
    return float(g_n1), g_tx.numpy()


def test_coverage_dbm_fast_gradient_matches_jax():
    """The fast metric's gradient (rfx.coverage.coverage_dbm_fast under
    jax.grad) on the room: 8,192 rays, 2 bounces, 50 receivers of radius 1,
    100 ns at 10 GHz, loss the mean of the finite dBm. Only the paths'
    amplitudes carry a gradient (the delay bins are integer casts, the
    capture a boolean), so d / d tx is exactly 0 in both; d / d n1 within rtol
    1e-4 (measured 2.3e-7)."""
    from rfx.coverage import coverage_dbm_fast as jfast

    dirs, centers = _coverage_inputs()

    def jloss(n1, tx):
        return _mean_finite(jfast(JScene.from_mesh(make_room()), tx, jnp.asarray(dirs),
                                  jnp.asarray(centers), jnp.float32(1.0), n1=n1, **COV_KW), jnp)

    with jax.disable_jit():
        want_n1, want_tx = jax.grad(jloss, argnums=(0, 1))(jnp.float32(5.0), jnp.asarray(COV_TX))
    got_n1, got_tx = _port_coverage_grads("coverage_dbm_fast", dirs, centers)
    assert np.asarray(want_tx).tolist() == [0.0, 0.0, 0.0] and got_tx.tolist() == [0.0, 0.0, 0.0]
    assert abs(float(want_n1)) > 0.01
    np.testing.assert_allclose(got_n1, float(want_n1), rtol=1e-4)


def test_coverage_dbm_soft_gradient_matches_jax():
    """The exact metric with soft binning (coverage_dbm(soft=True): the map
    engine, the histogram's backward, the RX-power metric's backward) on the
    inputs of test_coverage_dbm_fast_gradient_matches_jax, d / d tx and d /
    d n1 against jax.grad of rfx's composition receiver by receiver
    (rfx.tracer.trace_env, rfx.coverage._rx_ir_from_segments, the function
    that rfx.coverage.coverage_irs maps over the receivers, and
    rfx.cir.rx_power_dbm), eager: rtol 1e-4 (measured 1.3e-5). rfx's
    coverage_irs vmaps the sphere test, and batched it rounds the receiver's
    hit distance otherwise, by up to 1.7 mm here (the f32 root of a far
    sphere cancels), which moves soft-binned shares and the tx gradient by
    tens of percent: the port computes the unbatched arithmetic, bit for bit
    the same t_rx as _rx_ir_from_segments."""
    from rfx.coverage import _rx_ir_from_segments as jone
    from rfx.tracer import trace_env as jtrace_env

    dirs, centers = _coverage_inputs()
    room = make_room()

    def jloss(n1, tx):
        segs = jtrace_env(JScene.from_mesh(room), tx, jnp.asarray(dirs), max_bounces=2, n1=n1)
        irs = jnp.stack([jone(segs, jnp.asarray(c), jnp.float32(1.0), tx_power=1.0, num_rays=8192,
                              nbins=1000, light_speed_mps=2.998e8, sample_rate_hz=10e9, soft=True)
                         for c in centers])
        return _mean_finite(jcir.rx_power_dbm(irs, 100e-9)[0], jnp)

    with jax.disable_jit():
        want_n1, want_tx = jax.grad(jloss, argnums=(0, 1))(jnp.float32(5.0), jnp.asarray(COV_TX))
    got_n1, got_tx = _port_coverage_grads("coverage_dbm", dirs, centers, soft=True)
    assert np.abs(np.asarray(want_tx)).min() > 1.0
    np.testing.assert_allclose(got_n1, float(want_n1), rtol=1e-4)
    np.testing.assert_allclose(got_tx, np.asarray(want_tx), rtol=1e-4)
