"""The map engine's capture pass (rfx_torch.ops.map_capture) against rfx on
the CPU: the port's `map_irs` (plain versions here) against the function that
rfx's map engine maps over the receivers, rfx.coverage._rx_ir_from_segments,
forward and through jax.vjp, and against torch autograd of the port's plain
composition (coverage._first_capture, the `where`s and the histogram
Function); the gradients in the segments, the centers, tx_power and the
radius. The first-capture record (`map_record_plain`) against rfx's first
captures, bounce for bounce, and its histogram (`histogram_record_plain`)
against the plain map engine's rows through the histogram.

Two sets of segments, each from a numpy seed: the port's trace_env of the
box room (2,048 rays, 2 bounces, four receivers), and a synthetic set of
axis-aligned rays through two spheres on both bounces, among them rays that
graze a sphere so closely that |q.d| falls under the backward's clamp
(1e-6 r), segments that the environment blocks first and dead segments.

rfx is called receiver by receiver and eagerly: its vmapped batch rounds the
sphere's root otherwise (tests/test_torch_grad.py,
test_coverage_dbm_soft_gradient_matches_jax), while the port computes the
unbatched arithmetic."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oracle import sample_sphere_directions
from rfx.coverage import _rx_ir_from_segments as jone
from rfx.ops.intersect import is_hit, ray_sphere_hit
from rfx.tracer import EnvSegments as JSegments
from rfx_torch import cir, coverage
from rfx_torch.ops import map_capture as mc
from rfx_torch.ops.intersect import dot3, sphere_t
from rfx_torch.tracer import EnvSegments, Scene, trace_env

torch.set_num_threads(1)

C, RATE, NBINS = 2.998e8, 10e9, 512
TX_POWER, NUM_RAYS = 2.0, 2048
SCALE = 2.0 / 2048  # tx_power / num_rays, exact in f32
KW = dict(nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE)
ROOM_CENTERS = np.asarray([[-6.0, -4.0, 5.0], [6.0, 0.0, 5.0], [0.0, 3.0, 2.0],
                           [-3.0, 2.0, 7.0]], np.float32)
SYN_CENTERS = np.asarray([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]], np.float32)
CASES = {"room": 2.0, "synthetic": 1.0}  # the receivers' radius


def _grazing_origins() -> np.ndarray:
    """x of origins (x, 1, 0) whose ray along +x grazes the unit sphere at
    the origin: a hit with |q.d| < 1e-6 at the hit point."""
    xs = (-3.4526698e-4 + np.arange(-3000, 3000) * 2.9e-11).astype(np.float32)
    o = torch.from_numpy(np.stack([xs, np.ones_like(xs), np.zeros_like(xs)], 1))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand_as(o)
    t = sphere_t(o, d, torch.zeros(3), torch.tensor(1.0))
    qd = dot3(o + torch.where(t < 1e29, t, 0.0)[:, None] * d, d)
    keep = (t < 1e29) & (qd.abs() < 1e-6)
    return xs[keep.numpy()][:8]


def _synthetic_segments() -> EnvSegments:
    """2 bounces of 72 rays: 64 along +x then back along -x through both
    spheres (offsets in y, z inside the unit disc for most), with random
    amplitudes and path lengths, a tenth of the segments dead and a fifth
    blocked by the environment before the first sphere; 8 grazing rays."""
    rng = np.random.default_rng(7)
    n_rand = 64
    yz = rng.uniform(-1.2, 1.2, size=(n_rand, 2)).astype(np.float32)
    o0 = np.concatenate([np.full((n_rand, 1), -5.0, np.float32), yz], 1)
    o1 = np.concatenate([np.full((n_rand, 1), 8.0, np.float32), yz[::-1]], 1)
    gx = _grazing_origins()
    assert gx.shape == (8,)
    og = np.stack([gx, np.ones_like(gx), np.zeros_like(gx)], 1)
    origin = np.stack([np.concatenate([o0, og]), np.concatenate([o1, og])])
    dx = np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], np.float32)
    direction = np.broadcast_to(dx[:, None, :], origin.shape).copy()
    n = origin.shape[1]
    t_env = np.where(rng.uniform(size=(2, n)) < 0.2, rng.uniform(0.5, 3.0, size=(2, n)),
                     1e30).astype(np.float32)
    t_env[:, n_rand:] = 1e30
    alive = rng.uniform(size=(2, n)) > 0.1
    alive[:, n_rand:] = True
    amp = rng.uniform(0.1, 1.0, size=(2, n)).astype(np.float32)
    dist = rng.uniform(0.0, 12.0, size=(2, n)).astype(np.float32)
    return EnvSegments(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in (origin, direction, t_env, amp, dist, alive)))


def _segments(case: str, box_room) -> tuple:
    if case == "synthetic":
        return _synthetic_segments(), torch.from_numpy(SYN_CENTERS)
    dirs = sample_sphere_directions(NUM_RAYS, seed=41)
    with torch.no_grad():
        segs = trace_env(Scene.from_mesh(box_room, "cpu"), [4.0, 3.0, 6.0], torch.from_numpy(dirs),
                         max_bounces=2)
    return segs, torch.from_numpy(ROOM_CENTERS)


def _cotangent(m: int) -> np.ndarray:
    return np.random.default_rng(11).normal(size=(m, NBINS)).astype(np.float32)


def _rfx_irs(segs: EnvSegments, centers: np.ndarray, radius: float, soft: bool):
    """rfx's IRs and the vjp in (origin, direction, amplitude, distance,
    centers, tx_power, radius), receiver by receiver, eager."""
    t_env, alive = jnp.asarray(segs.t_env.numpy()), jnp.asarray(segs.alive.numpy())

    def irs(o, d, amp, dist, ctr, tx_power, rad):
        js = JSegments(o, d, t_env, amp, dist, alive)
        return jnp.stack([jone(js, ctr[k], rad, tx_power=tx_power, num_rays=NUM_RAYS, soft=soft,
                               **KW) for k in range(ctr.shape[0])])

    args = [jnp.asarray(t.numpy()) for t in (segs.origin, segs.direction, segs.amplitude,
                                             segs.distance)] + [
        jnp.asarray(centers), jnp.float32(TX_POWER), jnp.float32(radius)]
    with jax.disable_jit():
        out, vjp = jax.vjp(irs, *args)
        grads = vjp(jnp.asarray(_cotangent(centers.shape[0])))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _leaves(segs: EnvSegments, centers: torch.Tensor, radius: float) -> list:
    """Leaves that require grad: origin, direction, amplitude, distance,
    centers, tx_power and the radius."""
    return [t.clone().requires_grad_() for t in (segs.origin, segs.direction, segs.amplitude,
                                                  segs.distance, centers)] + [
        torch.tensor(v, requires_grad=True) for v in (TX_POWER, radius)]


def _old_composition(segs: EnvSegments, centers: torch.Tensor, radius: float, soft: bool):
    """The plain map engine before the capture pass had its Function: the
    differentiable sphere test, the first captures, the `where`s and the
    histogram Function; (IRs, autograd's gradients in origin, direction,
    amplitude, distance, the centers, tx_power and the radius)."""
    leaves = _leaves(segs, centers, radius)
    s = segs._replace(origin=leaves[0], direction=leaves[1], amplitude=leaves[2],
                      distance=leaves[3])
    t_rx, first = coverage._first_capture(s, leaves[4], leaves[6], "analytic")
    zero = torch.zeros(())
    m = centers.shape[0]
    amp = torch.where(first, s.amplitude, zero) * coverage._amp_scale(leaves[5], NUM_RAYS, "cpu")
    dist = torch.where(first, s.distance + t_rx, zero)
    irs = cir.bin_impulse_response(amp.reshape(m, -1), dist.reshape(m, -1), first.reshape(m, -1),
                                   soft=soft, **KW)
    grads = torch.autograd.grad(irs, leaves, torch.from_numpy(_cotangent(m)), allow_unused=True)
    # Hard binning has no gradient in the lengths, so none in the radius.
    return irs.detach(), [np.zeros(()) if g is None else g.numpy() for g in grads]


def _port(segs: EnvSegments, centers: torch.Tensor, radius: float, soft: bool):
    """map_irs's IRs and map_capture_backward_plain's gradients (origin,
    direction, amplitude, distance, centers, tx_power, radius) for the
    seeded cotangent."""
    irs = mc.map_irs(segs, centers, radius, scale=SCALE, soft=soft, **KW)
    *grads, g_scale, g_radius = mc.map_capture_backward_plain(
        segs, centers, radius, torch.from_numpy(_cotangent(centers.shape[0])), scale=SCALE,
        soft=soft, **KW)
    return irs, [g.numpy() for g in grads] + [(g_scale / NUM_RAYS).numpy(), g_radius.numpy()]


NAMES = ("origin", "direction", "amplitude", "distance", "centers", "tx_power", "radius")


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_map_irs_forward_matches_rfx(box_room, case, soft):
    """The plain forward's IRs against rfx's: rtol 1e-5 (the same captures
    and bins; the bins' sums in another order)."""
    segs, centers = _segments(case, box_room)
    want, _ = _rfx_irs(segs, centers.numpy(), CASES[case], soft)
    got = mc.map_irs(segs, centers, CASES[case], scale=SCALE, soft=soft, **KW)
    assert got.shape == (centers.shape[0], NBINS) and bool((got.sum(dim=1) > 0).all())
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_map_capture_backward_plain_matches_jax_vjp(box_room, case, soft):
    """map_capture_backward_plain against jax.vjp of rfx's pass for a seeded
    cotangent: amplitude, distance and tx_power rtol 1e-4, origin,
    direction, the centers and the radius rtol 2e-3 / atol 1e-8
    (tests/test_fused.py:189-190's bar: rfx sums q.d and the centers' and
    radius's gradients in another order)."""
    segs, centers = _segments(case, box_room)
    _, want = _rfx_irs(segs, centers.numpy(), CASES[case], soft)
    _, got = _port(segs, centers, CASES[case], soft)
    assert len(got) == len(want) == len(NAMES)
    for name, g, w in zip(NAMES, got, want):
        tol = (dict(rtol=1e-4, atol=0) if name in ("amplitude", "distance", "tx_power")
               else dict(rtol=2e-3, atol=1e-8))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    assert (np.abs(got[0]).max() > 0) == soft  # hard binning has no gradient in the lengths
    if case == "synthetic" and soft:  # the grazing rays reach the clamp: |gg| = |g_dist| / 1e-6
        assert np.abs(got[0][0, -8:]).max() > 1e3 * np.abs(got[0][0, :64]).max()


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_map_capture_matches_the_old_plain_composition(box_room, case, soft):
    """The Function's IRs are the old plain composition's bits, and its
    gradients (through map_irs and autograd, tx_power through the scale) are
    map_capture_backward_plain's and, within rtol 1e-5, autograd's through
    the old composition (the receivers' terms summed in another order)."""
    segs, centers = _segments(case, box_room)
    want_irs, want = _old_composition(segs, centers, CASES[case], soft)
    _, plain = _port(segs, centers, CASES[case], soft)
    leaves = _leaves(segs, centers, CASES[case])
    s = segs._replace(origin=leaves[0], direction=leaves[1], amplitude=leaves[2],
                      distance=leaves[3])
    irs = mc.map_irs(s, leaves[4], leaves[6], scale=coverage._amp_scale(leaves[5], NUM_RAYS, "cpu"),
                     soft=soft, **KW)
    assert torch.equal(irs.detach(), want_irs)
    got = torch.autograd.grad(irs, leaves, torch.from_numpy(_cotangent(centers.shape[0])))
    assert float(got[5]) != 0.0 and (float(got[6]) != 0.0) == soft
    for name, g, p, w in zip(NAMES, got, plain, want):
        np.testing.assert_array_equal(g.numpy(), p, err_msg=name)
        np.testing.assert_allclose(p, w, rtol=1e-5, atol=1e-7 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_map_capture_receiver_alone_equals_it_in_a_batch(box_room, case):
    """A receiver's first-capture record, IR and gradients are the same bits
    alone and in the batch (the other receivers' cotangent rows zero)."""
    segs, centers = _segments(case, box_room)
    k = 1
    batch_record = mc.map_record(segs, centers, CASES[case])
    alone_record = mc.map_record(segs, centers[k:k + 1], CASES[case])
    assert torch.equal(alone_record[0], batch_record[k])
    assert int((batch_record[k] != mc.NO_CAPTURE).sum()) > 0
    g = torch.zeros((centers.shape[0], NBINS))
    g[k] = torch.from_numpy(_cotangent(1)[0])
    for soft in (False, True):
        irs = mc.map_irs(segs, centers, CASES[case], scale=SCALE, soft=soft, **KW)
        one = mc.map_irs(segs, centers[k:k + 1], CASES[case], scale=SCALE, soft=soft, **KW)
        assert torch.equal(one[0], irs[k]) and float(one.sum()) > 0
        kw = dict(scale=SCALE, soft=soft, **KW)
        batch = mc.map_capture_backward_plain(segs, centers, CASES[case], g, **kw)
        alone = mc.map_capture_backward_plain(segs, centers[k:k + 1], CASES[case], g[k:k + 1], **kw)
        for name, a, b in zip(NAMES[:4] + NAMES[5:], alone[:4] + alone[5:], batch[:4] + batch[5:]):
            assert torch.equal(a, b), name
        assert torch.equal(alone[4][0], batch[4][k])


def _rfx_record(segs: EnvSegments, centers: np.ndarray, radius: float) -> np.ndarray:
    """(R, N) uint8: rfx's first capture of each receiver along each ray, by
    _rx_ir_from_segments's rule (the sphere through ray_sphere_hit, a win
    where alive, hit and before the environment, the first win along the
    bounce axis), receiver by receiver, eager; 255 where none."""
    b, n = segs.t_env.shape
    o = jnp.asarray(segs.origin.numpy().reshape(b * n, 3))
    d = jnp.asarray(segs.direction.numpy().reshape(b * n, 3))
    t_env, alive = jnp.asarray(segs.t_env.numpy()), jnp.asarray(segs.alive.numpy())
    out = []
    with jax.disable_jit():
        for ctr in centers:
            t_rx = ray_sphere_hit(o, d, jnp.asarray(ctr), jnp.float32(radius)).reshape(b, n)
            win = alive & is_hit(t_rx) & (t_env > t_rx)
            seen_before = jnp.cumsum(win.astype(jnp.int32), axis=0) - win.astype(jnp.int32)
            first = np.asarray(win & (seen_before == 0))
            out.append(np.where(first.any(axis=0), first.argmax(axis=0), 255).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_map_record_plain_matches_rfx_first_captures(box_room, case):
    """The first-capture record names the bounce of rfx's first capture for
    every receiver and ray, exactly: the box room's four receivers, and the
    synthetic set's grazing rays, rays through both spheres on both bounces
    (the second pass is no capture) and segments the environment blocks."""
    segs, centers = _segments(case, box_room)
    got = mc.map_record_plain(segs, centers, CASES[case])
    want = _rfx_record(segs, centers.numpy(), CASES[case])
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    captured = got != mc.NO_CAPTURE
    assert bool(captured.any(dim=1).all()) and int((got == 1).sum()) > 0  # bounce 1 captures too
    if case == "synthetic":
        assert bool((got[0, -8:] == 0).all())  # the grazing rays, captured on bounce 0


def _wide_case(box_room) -> tuple:
    """4,096 rays from tx over 2 bounces of the box room; receivers: one
    around tx (every ray's first capture, 4,096 in its row), one far outside
    the room (none), and the room's four; radius 1.5."""
    dirs = sample_sphere_directions(4096, seed=5)
    with torch.no_grad():
        segs = trace_env(Scene.from_mesh(box_room, "cpu"), [4.0, 3.0, 6.0], torch.from_numpy(dirs),
                         max_bounces=2)
    centers = torch.from_numpy(np.concatenate(
        [np.asarray([[4.0, 3.0, 6.0], [100.0, 100.0, 100.0]], np.float32), ROOM_CENTERS]))
    return segs, centers, 1.5


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_histogram_record_plain_equals_the_rows_histogram(box_room, soft):
    """The record expanded to rows is map_capture_plain's rows bit for bit,
    and its histogram is cir.histogram_rows of those rows bit for bit, with
    a row of more than 2,048 captures and a row of none; map_irs on the CPU
    is that composition."""
    segs, centers, radius = _wide_case(box_room)
    record = mc.map_record_plain(segs, centers, radius)
    rows = mc.map_capture_plain(segs, centers, radius, SCALE)
    per_row = rows[2].sum(dim=1)
    assert int(per_row[0]) > 2048 and int(per_row[1]) == 0 and int(per_row[2:].sum()) > 0
    for a, b in zip(mc.record_rows(record, segs, centers, radius, SCALE), rows):
        assert torch.equal(a, b)
    got = mc.histogram_record_plain(record, segs, centers, radius, SCALE, soft=soft, **KW)
    want = cir.histogram_rows(*rows, soft=soft, **KW)
    assert torch.equal(got, want)
    assert float(got[0].sum()) > 0 and not bool(got[1].any())
    irs = mc.map_irs(segs, centers, radius, scale=SCALE, soft=soft, **KW)
    assert torch.equal(irs, want)


def test_map_capture_more_than_254_bounces_raises():
    """A record byte names at most 254 bounces: 255 raise in map_irs and in
    the record's plain version, on the CPU too; 254 do not."""
    def segs_of(b):
        g = np.random.default_rng(3)
        origin = torch.from_numpy(g.normal(size=(b, 4, 3)).astype(np.float32))
        direction = torch.nn.functional.normalize(torch.from_numpy(
            g.normal(size=(b, 4, 3)).astype(np.float32)), dim=-1)
        full = torch.full((b, 4), 1e30)
        return EnvSegments(origin, direction, full, torch.ones(b, 4), torch.zeros(b, 4),
                           torch.ones(b, 4, dtype=torch.bool))

    centers = torch.zeros((1, 3))
    with pytest.raises(ValueError, match="254 bounces"):
        mc.map_irs(segs_of(255), centers, 1.0, scale=SCALE, **KW)
    with pytest.raises(ValueError, match="254 bounces"):
        mc.map_record_plain(segs_of(255), centers, 1.0)
    record = mc.map_record_plain(segs_of(254), centers, 1.0)
    assert tuple(record.shape) == (1, 4) and bool(((record < 254) | (record == mc.NO_CAPTURE)).all())


def test_map_capture_cpu_never_touches_a_kernel(box_room, monkeypatch):
    """On CPU tensors map_irs, its backward and the coverage engine's map
    branch run the plain versions: no kernel handle is loaded or launched."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel handle")

    for kernel in (mc.MAP_CAPTURE_KERNEL, mc.MAP_CAPTURE_BACKWARD_KERNEL, cir.HISTOGRAM_KERNEL,
                   cir.HISTOGRAM_RECORD_KERNEL):
        monkeypatch.setattr(kernel, "launch", refuse)
        monkeypatch.setattr(kernel, "load", refuse)
    segs, centers = _segments("room", box_room)
    amp = segs.amplitude.clone().requires_grad_()
    scale, radius = (torch.tensor(v, requires_grad=True) for v in (SCALE, 2.0))
    irs = mc.map_irs(segs._replace(amplitude=amp), centers, radius, scale=scale, soft=True, **KW)
    irs.square().sum().backward()
    assert float(amp.grad.abs().sum()) > 0 and float(scale.grad) > 0 and float(radius.grad) != 0
    assert mc.MAP_CAPTURE_KERNEL.launches == mc.MAP_CAPTURE_BACKWARD_KERNEL.launches == 0


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_coverage_map_engine_takes_the_capture_pass(box_room, monkeypatch, soft):
    """The map engine's analytic branch goes through map_irs, never the
    plain first-capture composition, also where tx_power requires grad: the
    IRs and the tx gradient are the same bits either way, and the tx_power
    gradient is within rtol 1e-5 of autograd's through the old composition
    on the same segments."""
    dirs = torch.from_numpy(sample_sphere_directions(1024, seed=43))
    scene = Scene.from_mesh(box_room, "cpu")
    kw = dict(max_bounces=2, num_rays=1024, rx_batch=3, engine="map", soft=soft, **KW)
    w = torch.from_numpy(_cotangent(4))

    def run(tx_power):
        tx = torch.tensor([4.0, 3.0, 6.0], requires_grad=True)
        irs = coverage.coverage_irs(scene, tx, dirs, ROOM_CENTERS, 2.0, tx_power=tx_power, **kw)
        grads = torch.autograd.grad((irs * w).sum(), [tx] + (
            [tx_power] if isinstance(tx_power, torch.Tensor) else []))
        return irs.detach(), grads

    calls = []
    first_capture = coverage._first_capture
    monkeypatch.setattr(coverage, "_first_capture",
                        lambda *a, **k: calls.append(1) or first_capture(*a, **k))
    irs, (g_tx,) = run(TX_POWER)
    p = torch.tensor(TX_POWER, requires_grad=True)
    irs_p, (g_tx_p, g_power) = run(p)
    assert calls == [] and bool((irs.sum(dim=1) > 0).all())
    assert torch.equal(irs, irs_p) and torch.equal(g_tx, g_tx_p)
    assert (float(g_tx.abs().max()) > 0) == soft
    with torch.no_grad():
        segs = trace_env(scene, [4.0, 3.0, 6.0], dirs, max_bounces=2)
    leaves = _leaves(segs, torch.from_numpy(ROOM_CENTERS), 2.0)
    s = segs._replace(origin=leaves[0], direction=leaves[1], amplitude=leaves[2],
                      distance=leaves[3])
    t_rx, first = first_capture(s, leaves[4], 2.0, "analytic")
    amp = torch.where(first, s.amplitude, 0.0) * coverage._amp_scale(leaves[5], 1024, "cpu")
    dist = torch.where(first, s.distance + t_rx, 0.0)
    old = cir.bin_impulse_response(amp.reshape(4, -1), dist.reshape(4, -1), first.reshape(4, -1),
                                   soft=soft, **KW)
    assert torch.equal(old.detach(), irs)
    (want,) = torch.autograd.grad((old * w).sum(), leaves[5])
    assert float(want) != 0.0
    torch.testing.assert_close(g_power, want, rtol=1e-5, atol=0)
