"""The reference's 80-face icosphere receiver in the port, on the CPU: the
brute closest hit's plain version and its cull, the map engine's icosphere
capture pass (rfx_torch.ops.map_capture with rx_mode="icosphere": the
first-capture record, its histogram and the backward's plain version)
against rfx on JAX-CPU.

The segments are the port's trace_env of the box room (1,024 rays of a
numpy seed, 2 bounces) and five receivers of radius 2; rfx is called
receiver by receiver and eagerly, as tests/test_torch_map_capture.py does
for the analytic receiver. The cull's predicate (intersect.cull_pass, the
kernel's expressions in torch) is held by hypothesis against the plain
80-face test over grazing rays from 1.5 to 10^4 radii away."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from oracle import sample_sphere_directions
from rfx.coverage import _rx_ir_from_segments as jone
from rfx.coverage import _rx_query_t
from rfx.coverage import coverage_irs as jcoverage_irs
from rfx.ops.intersect import closed_form_t as jclosed_form_t
from rfx.ops.intersect import is_hit
from rfx.tracer import EnvSegments as JSegments
from rfx.tracer import Scene as JScene
from rfx_torch import cir, coverage
from rfx_torch.ops import intersect
from rfx_torch.ops import map_capture as mc
from rfx_torch.tracer import (
    _UNIT_ICO_TRI,
    EnvSegments,
    Scene,
    icosphere_soa,
    icosphere_tris,
    trace_env,
    trace_to_rx,
)

torch.set_num_threads(1)

C, RATE, NBINS = 2.998e8, 10e9, 512
TX = (4.0, 3.0, 6.0)
TX_POWER, NUM_RAYS = 2.0, 1024
SCALE = 2.0 / 1024  # tx_power / num_rays, exact in f32
RADIUS = 2.0
KW = dict(nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE)
CENTERS = np.asarray([[-6.0, -4.0, 5.0], [6.0, 0.0, 5.0], [0.0, 3.0, 2.0], [-3.0, 2.0, 7.0],
                      [7.0, -5.0, 3.0]], np.float32)
NAMES = ("origin", "direction", "amplitude", "distance", "centers", "tx_power", "radius")


def _dirs() -> np.ndarray:
    return sample_sphere_directions(NUM_RAYS, seed=31)


def _segments(box_room) -> EnvSegments:
    with torch.no_grad():
        return trace_env(Scene.from_mesh(box_room, "cpu"), list(TX), torch.from_numpy(_dirs()),
                         max_bounces=2)


def _cotangent(m: int) -> np.ndarray:
    return np.random.default_rng(11).normal(size=(m, NBINS)).astype(np.float32)


def _rfx_record(segs: EnvSegments, centers: np.ndarray) -> np.ndarray:
    """(R, N) uint8: rfx's first capture of each icosphere receiver along
    each ray, by _rx_ir_from_segments's rule (rfx/coverage.py:63-70): t_rx
    of _rx_query_t(rx_mode="icosphere"), a win where alive, hit and before
    the environment, the first win along the bounce axis; 255 where none."""
    b, n = segs.t_env.shape
    o = jnp.asarray(segs.origin.numpy().reshape(b * n, 3))
    d = jnp.asarray(segs.direction.numpy().reshape(b * n, 3))
    t_env, alive = jnp.asarray(segs.t_env.numpy()), jnp.asarray(segs.alive.numpy())
    out = []
    with jax.disable_jit():
        for ctr in centers:
            t_rx = _rx_query_t(o, d, jnp.asarray(ctr), jnp.float32(RADIUS),
                               "icosphere").reshape(b, n)
            win = alive & is_hit(t_rx) & (t_env > t_rx)
            seen_before = jnp.cumsum(win.astype(jnp.int32), axis=0) - win.astype(jnp.int32)
            first = np.asarray(win & (seen_before == 0))
            out.append(np.where(first.any(axis=0), first.argmax(axis=0), 255).astype(np.uint8))
    return np.stack(out)


def _rfx_vjp(segs: EnvSegments, centers: np.ndarray, soft: bool):
    """rfx's icosphere IRs and the vjp in (origin, direction, amplitude,
    distance, centers, tx_power, radius) for the seeded cotangent, receiver
    by receiver, eager."""
    t_env, alive = jnp.asarray(segs.t_env.numpy()), jnp.asarray(segs.alive.numpy())

    def irs(o, d, amp, dist, ctr, tx_power, rad):
        js = JSegments(o, d, t_env, amp, dist, alive)
        return jnp.stack([jone(js, ctr[k], rad, tx_power=tx_power, num_rays=NUM_RAYS, soft=soft,
                               rx_mode="icosphere", **KW) for k in range(ctr.shape[0])])

    args = [jnp.asarray(t.numpy()) for t in (segs.origin, segs.direction, segs.amplitude,
                                             segs.distance)] + [
        jnp.asarray(centers), jnp.float32(TX_POWER), jnp.float32(RADIUS)]
    with jax.disable_jit():
        out, vjp = jax.vjp(irs, *args)
        grads = vjp(jnp.asarray(_cotangent(centers.shape[0])))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_backward(segs: EnvSegments, centers: torch.Tensor, soft: bool, g=None):
    """map_capture_backward_plain's gradients for the seeded cotangent, in
    NAMES' order (tx_power through the scale)."""
    g = torch.from_numpy(_cotangent(centers.shape[0])) if g is None else g
    *grads, g_scale, g_radius = mc.map_capture_backward_plain(
        segs, centers, RADIUS, g, scale=SCALE, soft=soft, rx_mode="icosphere", **KW)
    return grads + [g_scale / NUM_RAYS, g_radius]


def test_icosphere_tris_are_icosphere_soa_bits():
    """The (R, 80, 9) faces the icosphere kernels read are, row for row,
    icosphere_soa's (v0, e1, e2) of each center, bit for bit."""
    centers = torch.from_numpy(CENTERS)
    tris = icosphere_tris(centers, 0.37)
    assert tris.shape == (5, 80, 9) and tris.dtype == torch.float32
    for k in range(5):
        v0, e1, e2 = icosphere_soa(centers[k], 0.37)
        assert torch.equal(tris[k], torch.cat([v0, e1, e2], dim=1))


def test_brute_hit_cpu_is_the_plain_version():
    """On CPU tensors the brute closest hit is `_brute_forward`, with or
    without a cull (the plain version tests every ray), ties to the lowest
    face: two copies of a mesh give the first copy's faces."""
    g = np.random.default_rng(2)
    v0 = torch.from_numpy(g.uniform(-1, 1, size=(12, 3)).astype(np.float32))
    e1 = torch.from_numpy(g.uniform(-1, 1, size=(12, 3)).astype(np.float32))
    e2 = torch.from_numpy(g.uniform(-1, 1, size=(12, 3)).astype(np.float32))
    o = torch.from_numpy(g.uniform(-4, 4, size=(2048, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(-o + torch.from_numpy(
        g.uniform(-0.5, 0.5, size=(2048, 3)).astype(np.float32)), dim=1)
    want = intersect._brute_forward(o, d, v0, e1, e2, intersect.T_MIN_EPS, intersect.T_MAX, None)
    cull = torch.tensor([0.0, 0.0, 0.0, 0.1])
    for got in (intersect.brute_hit(o, d, v0, e1, e2),
                intersect.brute_hit(o, d, v0, e1, e2, cull=cull),
                intersect.ray_mesh_closest_hit_brute(o, d, v0, e1, e2, cull=cull)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[1] >= 0).sum()) > 100
    doubled = intersect.brute_hit(o, d, *(torch.cat([x, x]) for x in (v0, e1, e2)))
    assert torch.equal(doubled[0], want[0]) and torch.equal(doubled[1], want[1])


def test_closed_form_t_vjp_matches_autograd_and_jax():
    """closed_form_t_vjp, the backward kernel's arithmetic, against torch
    autograd of closed_form_t and jax.vjp of rfx's: rtol 1e-4 with a floor
    of 1e-6 of each output's largest entry (another order of the sums)."""
    g = np.random.default_rng(5)
    n = 512
    v0, e1, e2 = (torch.from_numpy(g.uniform(-1, 1, size=(n, 3)).astype(np.float32))
                  for _ in range(3))
    o = torch.from_numpy(g.uniform(-5, 5, size=(n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(n, 3)).astype(np.float32)), dim=1)
    cot = torch.from_numpy(g.normal(size=n).astype(np.float32))
    got = intersect.closed_form_t_vjp(o, d, v0, e1, e2, cot)
    leaves = [x.clone().requires_grad_() for x in (o, d, v0, e1, e2)]
    want_torch = torch.autograd.grad(intersect.closed_form_t(*leaves), leaves, cot)
    _, vjp = jax.vjp(jclosed_form_t, *(jnp.asarray(x.numpy()) for x in (o, d, v0, e1, e2)))
    want_jax = vjp(jnp.asarray(cot.numpy()))
    for k, a in enumerate(got):
        for w in (want_torch[k].numpy(), np.asarray(want_jax[k])):
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-6 * np.abs(w).max())


def test_icosphere_record_plain_matches_rfx_first_captures(box_room):
    """The icosphere record names the bounce of rfx's first capture for every
    receiver and ray, exactly."""
    segs = _segments(box_room)
    got = mc.map_record_plain(segs, torch.from_numpy(CENTERS), RADIUS, "icosphere")
    want = _rfx_record(segs, CENTERS)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    captured = got != mc.NO_CAPTURE
    assert bool(captured.any(dim=1).all()) and int((got == 1).sum()) > 0  # bounce 1 captures too


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_icosphere_map_irs_matches_rfx_coverage_irs(box_room, soft):
    """map_irs(rx_mode="icosphere") on the port's segments against rfx's
    coverage_irs(engine="map", rx_mode="icosphere") on the same directions,
    with tests/test_torch_coverage.py:59-64's tolerances: the same nonzero
    bins, rtol 1e-4, atol 1e-9 (hard) or 1e-4 (soft: a path's share moves
    with its length's last ulps) of the largest bin."""
    segs = _segments(box_room)
    got = mc.map_irs(segs, CENTERS, RADIUS, scale=SCALE, soft=soft, rx_mode="icosphere", **KW)
    with jax.disable_jit():  # eager binning: divide, then multiply (ROADMAP C)
        want = np.asarray(jcoverage_irs(
            JScene.from_mesh(box_room), jnp.asarray(TX, jnp.float32), jnp.asarray(_dirs()),
            jnp.asarray(CENTERS), RADIUS, max_bounces=2, num_rays=NUM_RAYS, tx_power=TX_POWER,
            soft=soft, rx_batch=5, engine="map", rx_mode="icosphere", **KW))
    assert got.shape == want.shape == (5, NBINS) and (want.sum(axis=1) > 0).all()
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    atol = (1e-4 if soft else 1e-9) * float(want.max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_icosphere_histogram_record_plain_is_the_dense_rows(box_room, soft):
    """The icosphere record expanded to rows is map_capture_plain's rows bit
    for bit (t_rx recomputed at the captures alone), its histogram is
    histogram_rows of those rows bit for bit, and map_irs is that."""
    segs = _segments(box_room)
    centers = torch.from_numpy(CENTERS)
    record = mc.map_record_plain(segs, centers, RADIUS, "icosphere")
    rows = mc.map_capture_plain(segs, centers, RADIUS, SCALE, "icosphere")
    assert int(rows[2].sum()) == int((record != mc.NO_CAPTURE).sum()) > 0
    for a, b in zip(mc.record_rows(record, segs, centers, RADIUS, SCALE, "icosphere"), rows):
        assert torch.equal(a, b)
    got = mc.histogram_record_plain(record, segs, centers, RADIUS, SCALE, soft=soft,
                                    rx_mode="icosphere", **KW)
    assert torch.equal(got, cir.histogram_rows(*rows, soft=soft, **KW))
    irs = mc.map_irs(segs, centers, RADIUS, scale=SCALE, soft=soft, rx_mode="icosphere", **KW)
    assert torch.equal(irs, got) and float(got.sum()) > 0


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_icosphere_backward_plain_matches_jax_vjp(box_room, soft):
    """map_capture_backward_plain(rx_mode="icosphere") against jax.vjp of
    rfx's icosphere pass (the brute hit's custom VJP, rfx/ops/intersect.py:
    159-185, through v0 = unit r + C) for a seeded cotangent: origin,
    direction, amplitude, distance, the centers, tx_power and the radius
    rtol 1e-4, with an absolute floor of 1e-6 of each output's largest
    entry (rfx sums with einsum in another order, and an entry that cancels
    keeps only the floor's digits); soft d / d amplitude with a floor of
    1e-4, the soft IRs' bar of tests/test_torch_coverage.py:59-64: rfx's
    t_rx differs from the port's by an ulp at about a fifth of the captures,
    and a path's share of its two bins, which d / d amplitude reads, moves
    with it."""
    segs = _segments(box_room)
    _, want = _rfx_vjp(segs, CENTERS, soft)
    got = [g.numpy() for g in _port_backward(segs, torch.from_numpy(CENTERS), soft)]
    assert len(got) == len(want) == len(NAMES)
    for name, g, w in zip(NAMES, got, want):
        floor = 1e-4 if soft and name == "amplitude" else 1e-6
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=floor * float(np.abs(w).max()),
                                   err_msg=name)
    assert (np.abs(got[0]).max() > 0) == soft  # hard binning has no gradient in the lengths
    assert (float(got[6]) != 0.0) == soft and (np.abs(got[4]).max() > 0) == soft


def test_icosphere_map_irs_gradients_are_the_plain_backward(box_room):
    """Through map_irs and autograd (tx_power through the scale, the radius
    a tensor), the icosphere's gradients are map_capture_backward_plain's
    bits."""
    segs = _segments(box_room)
    leaves = [t.clone().requires_grad_() for t in (segs.origin, segs.direction, segs.amplitude,
                                                   segs.distance, torch.from_numpy(CENTERS))] + [
        torch.tensor(v, requires_grad=True) for v in (TX_POWER, RADIUS)]
    s = segs._replace(origin=leaves[0], direction=leaves[1], amplitude=leaves[2],
                      distance=leaves[3])
    irs = mc.map_irs(s, leaves[4], leaves[6], scale=coverage._amp_scale(leaves[5], NUM_RAYS, "cpu"),
                     soft=True, rx_mode="icosphere", **KW)
    got = torch.autograd.grad(irs, leaves, torch.from_numpy(_cotangent(5)))
    want = _port_backward(segs, torch.from_numpy(CENTERS), True)
    for name, a, b in zip(NAMES, got, want):
        assert torch.equal(a, b), name


def test_icosphere_receiver_alone_equals_it_in_a_batch(box_room):
    """A receiver's icosphere record, IRs (hard and soft) and gradients are
    the same bits alone and in the batch (the others' cotangent rows 0)."""
    segs = _segments(box_room)
    centers = torch.from_numpy(CENTERS)
    k = 3
    batch = mc.map_record_plain(segs, centers, RADIUS, "icosphere")
    alone = mc.map_record_plain(segs, centers[k:k + 1], RADIUS, "icosphere")
    assert torch.equal(alone[0], batch[k]) and int((batch[k] != mc.NO_CAPTURE).sum()) > 0
    g = torch.zeros((5, NBINS))
    g[k] = torch.from_numpy(_cotangent(1)[0])
    for soft in (False, True):
        kw = dict(scale=SCALE, soft=soft, rx_mode="icosphere", **KW)
        irs = mc.map_irs(segs, centers, RADIUS, **kw)
        one = mc.map_irs(segs, centers[k:k + 1], RADIUS, **kw)
        assert torch.equal(one[0], irs[k]) and float(one.sum()) > 0
        many = mc.map_capture_backward_plain(segs, centers, RADIUS, g, **kw)
        lone = mc.map_capture_backward_plain(segs, centers[k:k + 1], RADIUS, g[k:k + 1], **kw)
        for name, a, b in zip(NAMES[:4] + NAMES[5:], lone[:4] + lone[5:], many[:4] + many[5:]):
            assert torch.equal(a, b), name
        assert torch.equal(lone[4][0], many[4][k])


def _grazing_rays(seed: int, dist: float, radius: float, n: int = 4096):
    """n rays whose lines pass within 1% of `radius` of an icosphere of that
    radius about a random center, from `dist` radii away: through its
    vertices, its edge midpoints and random points of its sphere, nearly
    tangent to the sphere there, pushed out or in by up to 1% of the
    radius. (o, d, center) as f32 tensors."""
    g = np.random.default_rng(seed)
    tri = _UNIT_ICO_TRI.astype(np.float64)
    anchors = np.concatenate([tri.reshape(-1, 3), (tri + np.roll(tri, 1, axis=1)).reshape(-1, 3),
                              g.normal(size=(240, 3))])
    p = anchors[g.integers(0, len(anchors), n)]
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    side = g.normal(size=(n, 3))
    side -= (side * p).sum(1, keepdims=True) * p
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    tilt = g.normal(size=(n, 1)) * g.choice([0.0, 1e-5, 1e-3, 3e-2], size=(n, 1))
    d = side + tilt * p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    center = g.uniform(-50.0, 50.0, size=3)
    through = center + p * radius * (1.0 + g.uniform(-1e-2, 1e-2, size=(n, 1)))
    o = through - d * dist * radius
    as32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))  # noqa: E731
    return as32(o), as32(d), as32(center)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), log_dist=st.floats(np.log10(1.5), 4.0),
       radius=st.floats(0.1, 2.0))
def test_cull_never_rejects_a_hit(seed, log_dist, radius):
    """The brute closest-hit kernel's cull, written in torch as the kernel
    writes it (intersect.cull_pass), passes every grazing ray that the plain
    80-face test hits, from 1.5 to 10^4 radii away and for radii 0.1 to
    2.0; and it does cull (rays that pass outside the reach)."""
    o, d, center = _grazing_rays(seed, 10.0 ** log_dist, radius)
    v0, e1, e2 = icosphere_soa(center, radius)
    t, face = intersect._brute_forward(o, d, v0, e1, e2, intersect.T_MIN_EPS, intersect.T_MAX,
                                       None)
    passed = intersect.cull_pass(o, d, torch.cat([center, torch.tensor([radius])]))
    hit = face >= 0
    assert int(hit.sum()) > 0
    assert bool(passed[hit].all()), f"culled {int((hit & ~passed).sum())} hits"
    far = intersect.cull_pass(o, d, torch.cat([center + 10.0 * radius, torch.tensor([radius])]))
    assert not bool(far.all())


def test_icosphere_cpu_never_touches_a_kernel(box_room, monkeypatch):
    """On CPU tensors the icosphere's map engine, its backward, the scan
    tracer's icosphere receiver and the brute backend run the plain
    versions: no kernel handle is loaded or launched."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel handle")

    for kernel in (intersect.BRUTE_HIT_KERNEL, mc.MAP_CAPTURE_ICO_KERNEL,
                   mc.MAP_CAPTURE_BACKWARD_ICO_KERNEL, cir.HISTOGRAM_RECORD_ICO_KERNEL,
                   mc.MAP_CAPTURE_KERNEL, mc.MAP_CAPTURE_BACKWARD_KERNEL, cir.HISTOGRAM_KERNEL,
                   cir.HISTOGRAM_RECORD_KERNEL):
        monkeypatch.setattr(kernel, "launch", refuse)
        monkeypatch.setattr(kernel, "load", refuse)
    scene = Scene.from_mesh(box_room, "cpu")
    tx = torch.tensor(TX, requires_grad=True)
    irs = coverage.coverage_irs(scene, tx, torch.from_numpy(_dirs()), CENTERS, RADIUS,
                                max_bounces=2, num_rays=NUM_RAYS, soft=True, rx_mode="icosphere",
                                engine="map", **KW)
    res = trace_to_rx(scene, tx, torch.from_numpy(_dirs()), CENTERS[1], RADIUS, max_bounces=2,
                      rx_mode="icosphere")
    (irs.square().sum() * 1e6 + res.distance.sum()).backward()
    assert float(irs.detach().sum()) > 0 and int(res.captured.sum()) > 0
    assert bool(torch.isfinite(tx.grad).all()) and float(tx.grad.abs().sum()) > 0
    assert intersect.BRUTE_HIT_KERNEL.launches == mc.MAP_CAPTURE_ICO_KERNEL.launches == 0


def test_cli_takes_the_configs_rx_mode_to_the_tracer(tmp_path, monkeypatch, capsys):
    """`python -m rfx_torch.cli cir --config x.json` with rx_mode
    "icosphere" traces with the icosphere receiver (rfx.cli's path)."""
    import rfx_torch.api as api
    from rfx_torch.cli import main
    from rfx_torch.config import TraceConfig

    seen = []
    trace = api.trace_to_rx
    monkeypatch.setattr(api, "trace_to_rx",
                        lambda *a, **k: seen.append(k["rx_mode"]) or trace(*a, **k))
    cfg = tmp_path / "ico.json"
    cfg.write_text(TraceConfig(rx_mode="icosphere").to_json())
    argv = ["cir", "--config", str(cfg), "--scene", "room", "--bounces", "2", "--tx", "5", "5",
            "2", "--rx", "-5", "-5", "2", "--rx-radius", "1.5", "--rays", "2000", "--no-viz",
            "--device", "cpu"]
    assert main(argv) == 0
    assert seen == ["icosphere"] and "RX power" in capsys.readouterr().out
