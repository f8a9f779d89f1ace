"""The port's coverage engine against rfx.coverage on the same directions:
the map engine (hard and soft binning, analytic and icosphere receiver), the
batched engine (the coverage kernel's plain version here, also fed rfx's own
segments beside rfx's Pallas kernel in interpret mode), the phasor metric
and the hybrid metric; and the facade's `compute_coverage` and recorded
paths on a fused-backend mesh, which run the per-query kernel's plain
version here, against the JAX facade's brute backend."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oracle import sample_sphere_directions
from rfx import sampler as jsampler
from rfx.api import Tracer as JTracer
from rfx.coverage import coverage_dbm_fast as jcoverage_dbm_fast
from rfx.coverage import coverage_dbm_hybrid as jcoverage_dbm_hybrid
from rfx.coverage import coverage_irs as jcoverage_irs
from rfx.coverage import make_grid as jmake_grid
from rfx.geometry import make_terrain
from rfx.ops.pallas_coverage import coverage_hist_pallas
from rfx.tracer import Scene as JScene
from rfx.tracer import trace_env as jtrace_env
from rfx_torch import cir as cir_mod
from rfx_torch import convert, coverage
from rfx_torch.api import Tracer
from rfx_torch.ops import coverage_hist
from rfx_torch.tracer import EnvSegments, Scene

torch.set_num_threads(1)

C, RATE, WINDOW = 2.998e8, 100e9, 200e-9
CENTERS = np.asarray([[-6.0, -4.0, 5.0], [6.0, 0.0, 5.0], [0.0, 3.0, 2.0], [-3.0, 2.0, 7.0],
                      [7.0, -5.0, 3.0]], np.float32)


@pytest.mark.parametrize("rx_mode", ["analytic", "icosphere"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_coverage_irs_matches_rfx_map_engine(box_room, soft, rx_mode):
    dirs = sample_sphere_directions(1024, seed=31)
    kw = dict(max_bounces=2, nbins=512, num_rays=1024, light_speed_mps=C, sample_rate_hz=10e9,
              tx_power=2.0, soft=soft, rx_mode=rx_mode)
    tx = np.asarray([4.0, 3.0, 6.0], np.float32)
    with jax.disable_jit():  # eager binning: divide, then multiply (ROADMAP C)
        want = np.asarray(jcoverage_irs(JScene.from_mesh(box_room), jnp.asarray(tx),
                                        jnp.asarray(dirs), jnp.asarray(CENTERS), 2.0,
                                        rx_batch=2, engine="map", **kw))
    got = coverage.coverage_irs(Scene.from_mesh(box_room, "cpu"), tx, torch.from_numpy(dirs),
                                CENTERS, 2.0, rx_batch=2, **kw)
    assert got.shape == (5, 512) and want.shape == (5, 512)
    assert (want.sum(axis=1) > 0).all()
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    # Soft binning splits a path by the fraction of its delay: path lengths
    # that agree to a few f32 ulps (the sphere hit sums in another order)
    # move a path's share by up to ~1e-3 of its amplitude.
    atol = (1e-4 if soft else 1e-9) * float(want.max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_map_engine_bins_a_receiver_batch_in_one_call(box_room, soft):
    """The map engine hands each batch of receivers to the histogram as rows
    of one call: the IRs and their gradient in tx do not depend on how the
    five receivers are cut into batches (1, 2 + 2 + 1, 3 + 2, all five)."""
    dirs = torch.from_numpy(sample_sphere_directions(1024, seed=32))
    scene = Scene.from_mesh(box_room, "cpu")
    kw = dict(max_bounces=2, nbins=512, num_rays=1024, light_speed_mps=C, sample_rate_hz=10e9,
              soft=soft, engine="map")
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 512)).astype(np.float32))
    out = []
    for rx_batch in (1, 2, 3, 5):
        tx = torch.tensor([4.0, 3.0, 6.0], requires_grad=True)
        irs = coverage.coverage_irs(scene, tx, dirs, CENTERS, 2.0, rx_batch=rx_batch, **kw)
        (irs * w).sum().backward()
        out.append((irs.detach(), tx.grad))
    assert out[0][0].shape == (5, 512) and bool((out[0][0].sum(dim=1) > 0).all())
    # Flat walls: the Fresnel amplitudes do not depend on tx, the delays do.
    assert (float(out[0][1].abs().sum()) > 0) == soft
    for irs, grad in out[1:]:
        assert torch.equal(irs, out[0][0])
        torch.testing.assert_close(grad, out[0][1], rtol=1e-5, atol=0)


def test_coverage_make_grid_dbm_and_engines(box_room):
    grid = coverage.make_grid(range(-3, 4, 3), range(-2, 3, 2), range(2, 7, 4))
    np.testing.assert_array_equal(grid, jmake_grid(range(-3, 4, 3), range(-2, 3, 2),
                                                   range(2, 7, 4)))
    dirs = torch.from_numpy(sample_sphere_directions(512, seed=3))
    scene = Scene.from_mesh(box_room, "cpu")
    kw = dict(max_bounces=2, num_rays=512)
    dbm = coverage.coverage_dbm(scene, [0.0, 0.0, 5.0], dirs, grid, 2.0,
                                sample_window_s=WINDOW, **kw)
    assert dbm.shape == (len(grid),) and torch.isfinite(dbm).any()
    # On the CPU, 'batched' runs the coverage kernel's plain version.
    irs = {e: coverage.coverage_irs(scene, [0.0, 0.0, 5.0], dirs, grid, 2.0, nbins=64,
                                    sample_rate_hz=1e9, engine=e, **kw)
           for e in ("batched", "map", "auto")}
    assert irs["map"].sum() > 0
    torch.testing.assert_close(irs["batched"], irs["map"], rtol=1e-5, atol=1e-12)
    torch.testing.assert_close(irs["auto"], irs["map"], rtol=0, atol=0)  # 'auto' is 'map' here
    for bad in (dict(soft=True), dict(rx_mode="icosphere")):
        with pytest.raises(ValueError, match="batched"):
            coverage.coverage_irs(scene, [0.0, 0.0, 5.0], dirs, grid, 2.0, nbins=64,
                                  engine="batched", **kw, **bad)
    with pytest.raises(ValueError, match="engine"):
        coverage.coverage_irs(scene, [0.0, 0.0, 5.0], dirs, grid, 2.0, nbins=64,
                              engine="pallas", **kw)
    for engine in ("map", "batched"):
        assert coverage.coverage_irs(scene, [0.0, 0.0, 5.0], dirs, grid[:0], 2.0, nbins=64,
                                     engine=engine, **kw).shape == (0, 64)


TERRAIN = dict(grid=40, extent=40.0, seed=5)
TX, RX = np.array([4.0, 0.0, 14.0]), np.array([-6.0, 1.0, 7.0])


def test_fused_backend_records_paths_through_the_kernel():
    mesh = make_terrain(**TERRAIN)
    n = 2048
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(3), n))
    t = Tracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, backend="fused",
               device="cpu")
    assert t.backend == "fused"
    paths, ir = t.compute_cir(TX, 1.0, RX, 1.5, directions=dirs)  # "auto" records paths
    jt = JTracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, backend="brute")
    j_paths, j_ir = jt.compute_cir(TX, 1.0, RX, 1.5, directions=dirs, record_paths=True)
    assert len(paths) == len(j_paths) > 0
    for p, jp in zip(paths, j_paths):
        np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-4)
    assert all(np.allclose(p[0], TX) for p in paths)
    np.testing.assert_allclose(ir, j_ir, rtol=1e-4, atol=1e-9)
    _, ir_fused = t.compute_cir(TX, 1.0, RX, 1.5, directions=dirs, record_paths=False)
    np.testing.assert_array_equal(ir_fused != 0, ir != 0)

    ico = Tracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, rx_mode="icosphere",
                 backend="fused", device="cpu")
    assert ico.backend == "fused" and ico._fused is None
    paths_i, ir_i = ico.compute_cir(TX, 1.0, RX, 1.5, directions=dirs)
    jt_i = JTracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, backend="brute",
                   rx_mode="icosphere")
    j_paths_i, j_ir_i = jt_i.compute_cir(TX, 1.0, RX, 1.5, directions=dirs, record_paths=True)
    assert len(paths_i) == len(j_paths_i) > 0
    np.testing.assert_allclose(ir_i, j_ir_i, rtol=1e-4, atol=1e-9)


def test_fused_backend_compute_coverage_matches_rfx():
    mesh = make_terrain(**TERRAIN)
    n = 2048
    dirs = np.array(jsampler.morton_sphere_directions(jax.random.PRNGKey(5), n))
    centers = np.asarray([RX, [0.0, -6.0, 6.0], [8.0, 8.0, 9.0]], np.float32)
    t = Tracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, backend="fused",
               device="cpu")
    irs = t.compute_coverage(TX, 1.0, centers, 2.0, directions=dirs, rx_batch=2)
    jt = JTracer(mesh, C, RATE, WINDOW, max_bounces=3, tx_num_rays=n, backend="brute")
    j_irs = jt.compute_coverage(TX, 1.0, centers, 2.0, directions=dirs, rx_batch=2)
    assert irs.shape == (3, t.nbins) and (irs.sum(axis=1) > 0).all()
    np.testing.assert_allclose(irs, j_irs, rtol=1e-4, atol=1e-9 * float(j_irs.max()))


# The exact coverage kernel (K3) and the phasor / hybrid metrics, held
# against rfx at tests/test_coverage.py's sizes.
COV_TX = np.asarray([5.0, 3.0, 5.0], np.float32)
COV_CENTERS = np.asarray([[-10.0, 0.0, 5.0], [0.0, 8.0, 2.0], [7.0, -7.0, 9.0],
                          [12.0, 12.0, 1.0], [0.0, 0.0, 15.0]], np.float32)


def _jax_segments(mesh, tx, dirs, max_bounces, scale=1.0):
    segs = jtrace_env(JScene.from_mesh(mesh), jnp.asarray(tx, jnp.float32), jnp.asarray(dirs),
                      max_bounces=max_bounces)
    return segs._replace(amplitude=segs.amplitude * scale)


def test_coverage_hist_plain_matches_pallas_interpret(box_room):
    """K3's plain version and rfx's K3 (interpret mode) on the same segments:
    2,048 rays, 2 bounces, 3 receivers, 1,000 bins."""
    dirs = sample_sphere_directions(2048, seed=9)
    segs = _jax_segments(box_room, COV_TX, dirs, 2, scale=2.0 / 2048)
    kw = dict(nbins=1000, light_speed_mps=C, sample_rate_hz=10e9)
    want = np.asarray(coverage_hist_pallas(segs, jnp.asarray(COV_CENTERS[:3]), jnp.float32(1.5),
                                           interpret=True, **kw))
    psegs = convert.segments_from_rfx(segs, device="cpu")
    got = coverage_hist.coverage_hist_plain(psegs, COV_CENTERS[:3], 1.5, **kw).numpy()
    assert got.shape == want.shape == (3, 1000) and (want.sum(axis=1) > 0).all()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    # The wrapper takes the plain version for a CPU tensor.
    np.testing.assert_array_equal(coverage_hist.coverage_hist(psegs, COV_CENTERS[:3], 1.5,
                                                              **kw).numpy(), got)


@pytest.mark.parametrize("n_rays", [1, 127, 128, 129, 32_768, 32_769, 100_003, 1_048_576,
                                    5_242_880])
def test_coverage_slabs_depend_on_the_ray_count_alone(n_rays):
    """The card's slab partition: chunk j of CHUNK_RAYS rays belongs to slab
    j % n_slabs, one slab per MIN_SLAB_RAYS rays up to MAX_SLABS. Nothing of
    the receivers enters it, so M = 1 and M = 2,048 get the same edges."""
    ch = coverage_hist
    n_slabs = ch.coverage_slabs(n_rays)
    assert n_slabs == max(1, min(ch.MAX_SLABS, -(-n_rays // ch.MIN_SLAB_RAYS)))
    slab = ch.slab_of_ray(n_rays)
    assert slab.shape == (n_rays,) and int(slab.min()) == 0 and int(slab.max()) <= n_slabs - 1
    assert torch.equal(slab, ch.slab_of_ray(n_rays))
    # Whole chunks, dealt out in turn.
    probe = torch.arange(0, n_rays, max(1, n_rays // 1000))
    assert torch.equal(slab[probe], (probe // ch.CHUNK_RAYS) % n_slabs)
    if n_rays >= ch.CHUNK_RAYS * n_slabs:
        assert len(torch.unique(slab)) == n_slabs
    import inspect
    for fn in (ch.coverage_slabs, ch.slab_of_ray):
        assert list(inspect.signature(fn).parameters) == ["num_rays"]


@pytest.mark.parametrize("n_rays, m", [(70_000, 1), (70_000, 5), (2048, 3)])
def test_coverage_hist_plain_summed_slab_by_slab(box_room, n_rays, m):
    """The order of the card's sum, spelled with the plain versions: the
    plain histogram of each slab's rays alone, the planes added in slab
    order (`reduce_planes_plain`, which `reduce_planes` takes for a CPU
    tensor), equals the one-pass plain version within rtol 1e-5, on the
    same nonzero bins; a receiver alone gets the row it gets in the group."""
    ch = coverage_hist
    dirs = sample_sphere_directions(n_rays, seed=11)
    segs = convert.segments_from_rfx(_jax_segments(box_room, COV_TX, dirs, 2, scale=1.0 / n_rays),
                                     device="cpu")
    kw = dict(nbins=2000, light_speed_mps=C, sample_rate_hz=20e9)
    centers = COV_CENTERS[:m]
    want = ch.coverage_hist_plain(segs, centers, 1.2, **kw)
    assert (want != 0).any()
    n_slabs = ch.coverage_slabs(n_rays)
    assert n_slabs == (3 if n_rays == 70_000 else 1)
    slab = ch.slab_of_ray(n_rays)
    planes = torch.stack([
        ch.coverage_hist_plain(type(segs)(*(t[:, slab == h] for t in segs)), centers, 1.2, **kw)
        for h in range(n_slabs)])
    got = ch.reduce_planes(planes)
    assert torch.equal(got, ch.reduce_planes_plain(planes)) and got.shape == want.shape
    assert torch.equal(got != 0, want != 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-12)
    alone = torch.stack([
        ch.coverage_hist_plain(type(segs)(*(t[:, slab == h] for t in segs)), centers[:1], 1.2, **kw)
        for h in range(n_slabs)])
    assert torch.equal(ch.reduce_planes(alone)[0], got[0])


def test_reduce_planes_refuses_what_it_cannot_add():
    with pytest.raises(ValueError, match="planes"):
        coverage_hist.reduce_planes(torch.zeros(4))
    with pytest.raises(ValueError, match="planes"):
        coverage_hist.reduce_planes(torch.zeros((2, 3), dtype=torch.float64))
    one = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
    assert torch.equal(coverage_hist.reduce_planes(one), one[0])


def test_batched_engine_matches_rfx_map_engine(box_room):
    """engine='batched' (K3's plain version here) against rfx's map engine,
    5 receivers (an odd count), 3 bounces, tx_power 2."""
    dirs = sample_sphere_directions(3000, seed=9)
    kw = dict(max_bounces=3, nbins=10_000, num_rays=3000, light_speed_mps=C, sample_rate_hz=RATE,
              tx_power=2.0)
    with jax.disable_jit():  # eager binning: divide, then multiply (ROADMAP C)
        want = np.asarray(jcoverage_irs(JScene.from_mesh(box_room), jnp.asarray(COV_TX),
                                        jnp.asarray(dirs), jnp.asarray(COV_CENTERS), 0.8,
                                        rx_batch=2, engine="map", **kw))
    got = coverage.coverage_irs(Scene.from_mesh(box_room, "cpu"), COV_TX, torch.from_numpy(dirs),
                                COV_CENTERS, 0.8, rx_batch=2, engine="batched", **kw)
    assert got.shape == want.shape == (5, 10_000) and (want != 0).any()
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-12)


FAST_KW = dict(max_bounces=2, num_rays=4096, sample_window_s=200e-9, sample_rate_hz=10e9,
               carrier_hz=2.4e9, rx_batch=4)
FAST_TX = np.asarray([3.0, 2.0, 2.0], np.float32)


def test_coverage_dbm_fast_matches_rfx(box_room):
    """tests/test_coverage.py:101-141's inputs: 12 receivers, 4,096 rays; and
    one receiver outside the room, which nothing reaches."""
    dirs = sample_sphere_directions(4096, seed=77)
    centers = np.concatenate([jmake_grid(range(-12, 13, 8), [-4, 4], [2, 8])[:12],
                              [[40.0, 40.0, 40.0]]]).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jcoverage_dbm_fast(JScene.from_mesh(box_room), jnp.asarray(FAST_TX),
                                             jnp.asarray(dirs), jnp.asarray(centers),
                                             jnp.float32(1.5), **FAST_KW))
    got = coverage.coverage_dbm_fast(Scene.from_mesh(box_room, "cpu"), FAST_TX,
                                     torch.from_numpy(dirs), centers, 1.5, **FAST_KW).numpy()
    ok = np.isfinite(want)
    assert ok.sum() >= 6 and (~ok).any()
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_array_equal(got[~ok], want[~ok])  # -inf where nothing arrived
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-3)


def test_dbm_cancel_from_segments_matches_rfx(box_room):
    """The phasor metric's (dBm, ratio, spread) on the same segments."""
    from rfx.coverage import _dbm_cancel_from_segments as j_cancel

    dirs = sample_sphere_directions(8192, seed=77)
    centers = jmake_grid(range(-12, 13, 6), range(-12, 13, 6), [2, 8])
    segs = _jax_segments(box_room, FAST_TX, dirs, 2)
    kw = dict(num_rays=8192, sample_window_s=100e-9, sample_rate_hz=10e9, carrier_hz=2.4e9,
              light_speed_mps=C, tx_power=1.0, rx_batch=10)
    with jax.disable_jit():
        want = [np.asarray(x) for x in j_cancel(segs, jnp.asarray(centers), 1.0, **kw)]
    got = [x.numpy() for x in coverage._dbm_cancel_from_segments(
        convert.segments_from_rfx(segs, device="cpu"), centers, 1.0, **kw)]
    ok = np.isfinite(want[0])
    assert ok.sum() > 20 and (want[1][ok] < 0.5).any() and (want[2] > 0).any()
    np.testing.assert_array_equal(np.isfinite(got[0]), ok)
    np.testing.assert_allclose(got[0][ok], want[0][ok], rtol=0, atol=1e-3)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)


@pytest.mark.parametrize("frac", [1.0, 0.0], ids=["subset", "wholesale"])
def test_coverage_dbm_hybrid_matches_rfx(box_room, frac):
    """tests/test_coverage.py:144-190's inputs: 50 receivers, 8,192 rays, of
    which 41 are flagged; a fallback fraction of 1 re-evaluates exactly the
    flagged subset, 0 every receiver (the default, 0.15, does too here)."""
    dirs = sample_sphere_directions(8192, seed=77)
    centers = jmake_grid(range(-12, 13, 6), range(-12, 13, 6), [2, 8])
    kw = dict(max_bounces=2, num_rays=8192, sample_window_s=100e-9, sample_rate_hz=10e9,
              rx_batch=10, exact_fallback_frac=frac)
    with jax.disable_jit():
        want, j_flagged = jcoverage_dbm_hybrid(JScene.from_mesh(box_room), jnp.asarray(FAST_TX),
                                               jnp.asarray(dirs), jnp.asarray(centers),
                                               jnp.float32(1.0), **kw)
    got, n_flagged = coverage.coverage_dbm_hybrid(Scene.from_mesh(box_room, "cpu"), FAST_TX,
                                                  torch.from_numpy(dirs), centers, 1.0, **kw)
    want, got = np.asarray(want), got.numpy()
    assert n_flagged == j_flagged > 0
    assert n_flagged < len(centers)  # some receivers keep the phasor's dBm
    ok = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-3)


# The phasor kernel's wrapper (`coverage_phasor`: the first pass's sums and
# capture lists, the metric's formulas, the spread over the lists) and the
# dispatch of `_dbm_cancel_from_segments`.
PHASOR_KW = dict(num_rays=8192, sample_window_s=100e-9, sample_rate_hz=10e9, carrier_hz=2.4e9,
                 light_speed_mps=C, tx_power=1.0, rx_batch=10)


def _phasor_inputs(box_room):
    dirs = sample_sphere_directions(8192, seed=77)
    centers = np.concatenate([jmake_grid(range(-12, 13, 6), range(-12, 13, 6), [2, 8]),
                              [[40.0, 40.0, 40.0]]]).astype(np.float32)  # the last: outside
    return _jax_segments(box_room, FAST_TX, dirs, 2), centers


def _coverage_phasor_kw(kw):
    return dict(nbins=int(kw["sample_window_s"] * kw["sample_rate_hz"]),
                light_speed_mps=kw["light_speed_mps"], sample_rate_hz=kw["sample_rate_hz"],
                sample_window_s=kw["sample_window_s"], carrier_hz=kw["carrier_hz"])


def _seq(x):
    """The f32 sum of x in its order, one add after another (as a lane adds)."""
    return np.cumsum(np.asarray(x, np.float32), dtype=np.float32)[-1] if len(x) else np.float32(0)


def _walk_captures(segs, centers, rx_radius, *, nbins, light_speed_mps, sample_rate_hz,
                   sample_window_s, carrier_hz):
    """Per (slab, receiver) region, its first captures in the phasor kernel's
    walk order (chunk, bounce, ray slot, lane: within a chunk of 128 rays,
    bounce before ray), each as the table's row of its bin and its amplitude."""
    t_rx, first = coverage._first_capture(segs, centers, rx_radius, "analytic")
    bins = ((segs.distance + t_rx) / torch.tensor(light_speed_mps)
            * torch.tensor(sample_rate_hz)).to(torch.int32)
    valid = (first & (bins >= 0) & (bins < nbins)).numpy()
    step, omega = coverage_hist._phasor_constants(nbins, sample_window_s, carrier_hz)
    table = coverage_hist.phasor_table_plain(nbins, step, omega).numpy()
    b, n = segs.t_env.shape
    n_slabs = coverage_hist.coverage_slabs(n)
    chunk = np.arange(n) // coverage_hist.CHUNK_RAYS
    key = (chunk[None, :] * b + np.arange(b)[:, None]) * coverage_hist.CHUNK_RAYS + (
        np.arange(n) % coverage_hist.CHUNK_RAYS)[None, :]
    amp = segs.amplitude.numpy()
    regions = {}
    for r in range(centers.shape[0]):
        for h in range(n_slabs):
            bb, ii = np.nonzero(valid[r] & (chunk % n_slabs == h)[None, :])
            order = np.argsort(key[bb, ii], kind="stable")
            bb, ii = bb[order], ii[order]
            regions[h, r] = (table[bins[r, bb, ii].numpy()], amp[bb, ii])
    return regions, n_slabs


def _phasor_sums_spelled_out(segs, centers, rx_radius, **kw):
    """What the phasor kernel's first pass gives, spelled out in torch and
    numpy on the CPU: per region, over its captures in walk order, w = amp
    sqrt(s_k) from the table, sums of w cos, w sin, w^2 and w^2 t_k added one
    after another, max s_k and any capture; the slabs combined in slab order;
    and each region's list of (w^2, t_k), taken from a pool of chunks of
    PHASOR_CHUNK pairs (PHASOR_CHUNKS_A_REGION a region and
    PHASOR_SPARE_CHUNKS more) in region order here: a region that finds the
    pool spent keeps no list."""
    regions, n_slabs = _walk_captures(segs, centers, rx_radius, **kw)
    m = centers.shape[0]
    hi = kw["nbins"] - 1 - (kw["nbins"] - 1) // 2
    left = coverage_hist.PHASOR_CHUNKS_A_REGION * n_slabs * m + coverage_hist.PHASOR_SPARE_CHUNKS
    partials = np.zeros((n_slabs, m, 6), np.float32)
    lists = {}
    for (h, r), (rows, amp) in regions.items():
        aw = amp * rows[:, 0]
        wgt = aw * aw
        s_k = np.minimum(np.round(rows[:, 0] ** 2), kw["nbins"])  # s_k, exactly, from sqrt(s_k)
        assert (s_k >= hi + 1).all()
        partials[h, r] = [_seq(aw * rows[:, 1]), _seq(aw * rows[:, 2]),
                          s_k.max() if len(s_k) else 0.0, float(len(s_k) > 0), _seq(wgt),
                          _seq(wgt * rows[:, 3])]
        chunks = -(-len(wgt) // coverage_hist.PHASOR_CHUNK)
        if chunks <= left:
            left -= chunks
            lists[h, r] = np.stack([wgt, rows[:, 3]], axis=1)
    sums = partials[0].copy()
    for h in range(1, n_slabs):
        sums[:, [0, 1, 4, 5]] += partials[h][:, [0, 1, 4, 5]]
        sums[:, [2, 3]] = np.maximum(sums[:, [2, 3]], partials[h][:, [2, 3]])
    return torch.from_numpy(sums), (regions, lists, n_slabs, m)


def _phasor_spread_spelled_out(walks, t_mean):
    """The spread pass over `_phasor_sums_spelled_out`'s lists: per region,
    sum w^2 (t_k - t_mean)^2 in the recorded order, or, where the region kept
    no list, the same terms from its captures walked again; the slabs
    combined in slab order."""
    regions, lists, n_slabs, m = walks
    tm = t_mean.numpy()
    parts = np.zeros((n_slabs, m), np.float32)
    for (h, r), (rows, amp) in regions.items():
        if (h, r) in lists:
            wgt, t_k = lists[h, r][:, 0], lists[h, r][:, 1]
        else:
            aw = amp * rows[:, 0]
            wgt, t_k = aw * aw, rows[:, 3]
        dt = t_k - tm[r]
        parts[h, r] = _seq(wgt * (dt * dt))
    out = parts[0].copy()
    for h in range(1, n_slabs):
        out += parts[h]
    return torch.from_numpy(out)


def test_coverage_phasor_matches_rfx(box_room, monkeypatch):
    """What the card runs around the kernel's passes (the first pass's fields
    in order, the mean delay the metric hands to the spread, the shared
    formulas), here on the passes spelled out in torch and numpy, with the
    rays in four slabs, against rfx on the same segments:
    test_dbm_cancel_from_segments_matches_rfx's bars, ratio 1 and spread 0
    where nothing arrived. The kernel runs on the card only: on a CPU tensor
    its first pass raises, naming the plain version, and counts no launch;
    `_dbm_cancel_from_segments` runs the plain version."""
    from rfx.coverage import _dbm_cancel_from_segments as j_cancel

    segs, centers = _phasor_inputs(box_room)
    with jax.disable_jit():
        want = [np.asarray(x) for x in j_cancel(segs, jnp.asarray(centers), 1.0, **PHASOR_KW)]
    psegs = convert.segments_from_rfx(segs, device="cpu")
    scaled = psegs._replace(amplitude=psegs.amplitude * (torch.tensor(1.0) / 8192))
    kernels = (coverage_hist.PHASOR_TABLE_KERNEL, coverage_hist.COVERAGE_PHASOR_KERNEL,
               coverage_hist.COVERAGE_SPREAD_KERNEL)
    before = [k.launches for k in kernels]
    with pytest.raises(ValueError, match="CUDA.*_dbm_cancel_plain"):
        coverage_hist.coverage_phasor(scaled, centers, 1.0, **_coverage_phasor_kw(PHASOR_KW))
    plain = [x.numpy() for x in coverage._dbm_cancel_from_segments(psegs, centers, 1.0,
                                                                   **PHASOR_KW)]
    assert [k.launches for k in kernels] == before
    monkeypatch.setattr(coverage_hist, "MIN_SLAB_RAYS", 2048)
    assert coverage_hist.coverage_slabs(8192) == 4
    monkeypatch.setattr(coverage_hist, "_phasor_sums", _phasor_sums_spelled_out)
    monkeypatch.setattr(coverage_hist, "_phasor_spread", _phasor_spread_spelled_out)
    got = [x.numpy() for x in coverage_hist.coverage_phasor(scaled, centers, 1.0,
                                                            **_coverage_phasor_kw(PHASOR_KW))]
    ok = np.isfinite(want[0])
    assert ok.sum() > 20 and (~ok).any()
    for g in (got, plain):
        np.testing.assert_array_equal(np.isfinite(g[0]), ok)
        np.testing.assert_allclose(g[0][ok], want[0][ok], rtol=0, atol=1e-3)
        for a, w in zip(g[1:], want[1:]):
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=0)
        assert (g[1][~ok] == 1.0).all() and (g[2][~ok] == 0.0).all()


def test_coverage_phasor_lost_lists_walk_again(box_room, monkeypatch):
    """The spread is the same bits whether the lists hold every capture or
    the pool runs out (one chunk in all; every other region walks again),
    spelled out as in test_coverage_phasor_matches_rfx."""
    segs, centers = _phasor_inputs(box_room)
    psegs = convert.segments_from_rfx(segs, device="cpu")
    scaled = psegs._replace(amplitude=psegs.amplitude * (torch.tensor(1.0) / 8192))
    kw = _coverage_phasor_kw(PHASOR_KW)
    monkeypatch.setattr(coverage_hist, "MIN_SLAB_RAYS", 2048)
    monkeypatch.setattr(coverage_hist, "_phasor_sums", _phasor_sums_spelled_out)
    monkeypatch.setattr(coverage_hist, "_phasor_spread", _phasor_spread_spelled_out)
    whole = coverage_hist.coverage_phasor(scaled, centers, 1.0, **kw)
    _, (_, lists, n_slabs, m) = _phasor_sums_spelled_out(scaled, torch.from_numpy(centers), 1.0,
                                                         **kw)
    assert len(lists) == n_slabs * m
    monkeypatch.setattr(coverage_hist, "PHASOR_CHUNKS_A_REGION", 0)
    monkeypatch.setattr(coverage_hist, "PHASOR_SPARE_CHUNKS", 1)
    _, (regions, lists, _, _) = _phasor_sums_spelled_out(scaled, torch.from_numpy(centers), 1.0,
                                                         **kw)
    lost = [key for key, (rows, _) in regions.items() if len(rows) and key not in lists]
    assert len(lost) > 100
    spent = coverage_hist.coverage_phasor(scaled, centers, 1.0, **kw)
    assert float((whole[2] > 0).sum()) > 20
    for a, b in zip(whole, spent):
        assert torch.equal(a, b)


def test_phasor_spread_plain_matches_the_lists(box_room):
    """The spread's plain version (broadcast sphere tests, a torch.sum per
    receiver) against the spread over the first pass's lists spelled out, at
    each receiver's mean delay from the spelled-out sums: rtol 1e-5 (other
    orders of the same f32 terms)."""
    segs, centers = _phasor_inputs(box_room)
    psegs = convert.segments_from_rfx(segs, device="cpu")
    scaled = psegs._replace(amplitude=psegs.amplitude * (torch.tensor(1.0) / 8192))
    kw = _coverage_phasor_kw(PHASOR_KW)
    sums, walks = _phasor_sums_spelled_out(scaled, torch.from_numpy(centers), 1.0, **kw)
    t_mean = sums[:, 5] / sums[:, 4]
    want = _phasor_spread_spelled_out(walks, t_mean)
    got = coverage_hist.phasor_spread_plain(scaled, centers, 1.0, t_mean, rx_batch=7, **kw)
    hit = sums[:, 3] > 0
    assert int(hit.sum()) > 20 and int((want[hit] > 0).sum()) > 20
    torch.testing.assert_close(got[hit], want[hit], rtol=1e-5, atol=0)
    assert not bool(got[~hit].any())


def test_phasor_table_plain_is_the_per_capture_arithmetic():
    """The table's torch form gives, bit for bit, what
    rfx_torch.cir.rx_power_dbm_phasor evaluates for a capture in bin k: the
    inputs of its sqrt (s_k) and cos (the phase) and the outputs of its sqrt,
    cos and sin, recorded while it runs on one path per bin; t_k is the
    phase's factor."""
    from torch.overrides import TorchFunctionMode

    class Record(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = {}

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.sqrt, torch.cos, torch.sin):
                self.seen[func.__name__] = (args[0].clone(), out.clone())
            return out

    for nbins in (1998, 1999, 10_000):
        window = nbins / 10e9
        step, omega = coverage_hist._phasor_constants(nbins, window, 2.4e9)
        # One path in each bin: distance (k + 0.5) / rate * c, checked below.
        k = torch.arange(nbins)
        dist = ((k.double() + 0.5) / 10e9 * C).float()[None]
        assert torch.equal((dist / torch.tensor(C) * torch.tensor(10e9)).to(torch.int32)[0],
                           k.to(torch.int32))
        with Record() as rec:
            cir_mod.rx_power_dbm_phasor(torch.ones_like(dist), dist,
                                        torch.ones_like(dist, dtype=torch.bool),
                                        sample_window_s=window, nbins=nbins, light_speed_mps=C,
                                        sample_rate_hz=10e9)
        table = coverage_hist.phasor_table_plain(nbins, step, omega)
        s_k, sqrt_s = rec.seen["sqrt"]
        phase, cos = rec.seen["cos"]
        hi = nbins - 1 - (nbins - 1) // 2
        assert torch.equal(s_k[0], torch.clamp_max(k + hi + 1, nbins).float())  # bin k's path
        assert torch.equal(table[:, 0], sqrt_s[0])
        assert torch.equal(table[:, 1], cos[0]) and torch.equal(table[:, 2], rec.seen["sin"][1][0])
        assert torch.equal(torch.tensor(omega, dtype=torch.float32) * table[:, 3], phase[0])
        assert torch.equal(table[:, 3], k.float() * torch.tensor(step, dtype=torch.float32))


def test_phasor_gradient_takes_the_plain_version(box_room):
    """CPU segments whose amplitude requires grad run the plain version (no
    launch: on the CPU `_dbm_cancel_from_segments` routes there); its gradient of the summed dBm of the reached receivers equals
    jax.grad of rfx's phasor metric within rtol 1e-4 (an absolute floor of
    1e-6 of the largest entry for the near-cancelling ones)."""
    from rfx.coverage import _dbm_cancel_from_segments as j_cancel

    segs, centers = _phasor_inputs(box_room)
    with jax.disable_jit():
        reached = np.isfinite(np.asarray(j_cancel(segs, jnp.asarray(centers), 1.0,
                                                  **PHASOR_KW)[0]))
        centers = np.asarray(centers)[reached]
        want = np.asarray(jax.grad(lambda a: jnp.sum(j_cancel(
            segs._replace(amplitude=a), jnp.asarray(centers), 1.0, **PHASOR_KW)[0]))(
                segs.amplitude))
    psegs = convert.segments_from_rfx(segs, device="cpu")
    amp = psegs.amplitude.clone().requires_grad_()
    before = coverage_hist.COVERAGE_PHASOR_KERNEL.launches
    dbm, _, _ = coverage._dbm_cancel_from_segments(psegs._replace(amplitude=amp), centers, 1.0,
                                                   **PHASOR_KW)
    assert coverage_hist.COVERAGE_PHASOR_KERNEL.launches == before
    assert bool(torch.isfinite(dbm).all()) and len(centers) > 20
    dbm.sum().backward()
    got = amp.grad.numpy()
    assert (got != 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


PHASOR_OUTPUTS = ["dbm", "ratio", "spread", "weighted"]


def _phasor_loss(outs, weights, output):
    """The loss of a case: one output (or all three) against per-receiver
    weights, a receiver that received nothing giving its -inf dBm none."""
    picks = {"dbm": (0,), "ratio": (1,), "spread": (2,), "weighted": (0, 1, 2)}[output]
    return sum(torch.sum(torch.where(torch.isfinite(outs[k]), outs[k], 0.0) * weights[k])
               for k in picks)


def _phasor_weights(m, seed=3):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal(m).astype(np.float32)) for _ in range(3)]


@pytest.mark.parametrize("output", PHASOR_OUTPUTS)
def test_phasor_backward_plain_matches_autograd_of_plain(box_room, output):
    """The phasor backward's closed form (phasor_coefficients, then
    phasor_backward_plain over the first captures) against autograd through
    the metric's plain version, _dbm_cancel_plain, on the same segments: each
    output, and a weighted sum of the three; 50 receivers and one outside the
    room (no capture: it adds nothing). The closed form takes the amplitude
    scaled by tx_power / num_rays, as the kernel does: the chain rule's factor
    is applied here. rtol 1e-4 with an absolute floor of 1e-6 of the largest
    entry (the closed form and autograd round differently)."""
    segs, centers = _phasor_inputs(box_room)
    psegs = convert.segments_from_rfx(segs, device="cpu")
    weights = _phasor_weights(len(centers))
    amp = psegs.amplitude.clone().requires_grad_()
    outs = coverage._dbm_cancel_plain(psegs._replace(amplitude=amp), centers, 1.0, **PHASOR_KW)
    _phasor_loss(outs, weights, output).backward()
    scale = torch.tensor(1.0) / 8192
    scaled = psegs._replace(amplitude=psegs.amplitude * scale)
    kw = _coverage_phasor_kw(PHASOR_KW)
    sums, _ = _phasor_sums_spelled_out(scaled, torch.from_numpy(centers), 1.0, **kw)
    cot = [torch.where(torch.isfinite(o), w, 0.0) if k == 0 else w
           for k, (o, w) in enumerate(zip(outs, weights))]
    picks = {"dbm": (0,), "ratio": (1,), "spread": (2,), "weighted": (0, 1, 2)}[output]
    coef = coverage_hist.phasor_coefficients(
        sums, outs[2].detach(), *(cot[k] if k in picks else None for k in range(3)))
    assert not coef[-1].any()  # the receiver outside the room
    got = coverage_hist.phasor_backward_plain(scaled, centers, 1.0, coef, rx_batch=7, **kw) * scale
    want = amp.grad
    assert int((want != 0).sum()) > 1000 and bool(torch.isfinite(want).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))


def test_phasor_gradient_at_zero_spread_matches_jax():
    """A receiver whose one capture makes its spread exactly 0, beside one
    with two captures and one that nothing reaches. jax.grad of rfx's phasor
    metric with a cotangent on the spread gives NaN for that capture (sqrt's
    derivative at 0 times a zero deviation) and finite values elsewhere; the
    port's autograd and its closed form (phasor_backward_plain) give NaN at
    the same entries and agree elsewhere (rtol 1e-4). Without a cotangent on
    the spread the closed form skips its part and stays finite, as jax.grad."""
    from rfx.coverage import _dbm_cancel_from_segments as j_cancel
    from rfx.tracer import EnvSegments as JEnvSegments

    # Ray 0 crosses receiver 0 at 5 mm from its origin (delay bin 0: t = 0,
    # so its mean delay is exactly t); rays 1 and 2 cross receiver 1 at 4.99
    # and 21.99 m of path; ray 3 is dead.
    origin = np.asarray([[[0, 0, 0], [0, 0, 0], [0, -10, 0], [0, 0, 0]]], np.float32)
    direction = np.asarray([[[1, 0, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1]]], np.float32)
    fields = dict(origin=origin, direction=direction,
                  t_env=np.full((1, 4), 1e30, np.float32),
                  amplitude=np.asarray([[0.9, 0.7, 0.4, 0.5]], np.float32),
                  distance=np.asarray([[0.0, 0.0, 7.0, 0.0]], np.float32),
                  alive=np.asarray([[True, True, True, False]]))
    centers = np.asarray([[0.015, 0, 0], [0, 5, 0], [40, 40, 40]], np.float32)
    kw = dict(num_rays=1, sample_window_s=100e-9, sample_rate_hz=10e9, carrier_hz=2.4e9,
              light_speed_mps=C, tx_power=1.0, rx_batch=2)
    jsegs = JEnvSegments(**{k: jnp.asarray(v) for k, v in fields.items()})
    psegs = EnvSegments(**{k: torch.from_numpy(v) for k, v in fields.items()})
    w = [np.asarray([0.3, -1.2, 0.7], np.float32), np.asarray([0.5, 0.25, -2.0], np.float32),
         np.asarray([1.5, -0.5, 1.0], np.float32)]
    for picks in ((0, 1, 2), (0, 1)):
        def jloss(a):
            outs = j_cancel(jsegs._replace(amplitude=a), jnp.asarray(centers), 0.01, **kw)
            return sum(jnp.sum(jnp.where(jnp.isfinite(outs[k]), outs[k], 0.0) * w[k])
                       for k in picks)

        with jax.disable_jit():
            outs_j = [np.asarray(x) for x in j_cancel(jsegs, jnp.asarray(centers), 0.01, **kw)]
            want = np.asarray(jax.grad(jloss)(jsegs.amplitude))
        assert outs_j[2][0] == 0.0 and outs_j[2][1] > 0.0 and not np.isfinite(outs_j[0][2])
        amp = psegs.amplitude.clone().requires_grad_()
        outs = coverage._dbm_cancel_plain(psegs._replace(amplitude=amp), centers, 0.01, **kw)
        assert float(outs[2][0].detach()) == 0.0
        sum(torch.sum(torch.where(torch.isfinite(outs[k]), outs[k], 0.0) * torch.from_numpy(w[k]))
            for k in picks).backward()
        cot = [torch.from_numpy(np.where(np.isfinite(outs_j[0]), w[0], 0.0).astype(np.float32)),
               torch.from_numpy(w[1]), torch.from_numpy(w[2])]
        coef = coverage_hist.phasor_coefficients(
            torch.from_numpy(_zero_spread_sums(psegs, centers, kw)), outs[2].detach(),
            *(cot[k] if k in picks else None for k in range(3)))
        closed = coverage_hist.phasor_backward_plain(psegs, centers, 0.01, coef,
                                                     **_coverage_phasor_kw(kw)).numpy()
        nan = np.isnan(want)
        assert nan.tolist() == [[2 in picks, False, False, False]]
        for got in (amp.grad.numpy(), closed):
            np.testing.assert_array_equal(np.isnan(got), nan)
            np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-4,
                                       atol=1e-6 * np.abs(want[~nan]).max())


def _zero_spread_sums(psegs, centers, kw):
    """The first pass's per-receiver sums of the zero-spread case, from its
    captures: the phasor kernel's fields (re, im, max s_k, any, w^2, w^2
    t_k), in float64 then rounded (one or two captures a receiver)."""
    kw = _coverage_phasor_kw(kw)
    bins, valid = coverage_hist._first_wins(psegs, torch.from_numpy(centers), 0.01,
                                            nbins=kw["nbins"], light_speed_mps=C,
                                            sample_rate_hz=kw["sample_rate_hz"])
    table = coverage_hist.phasor_table_plain(
        kw["nbins"], *coverage_hist._phasor_constants(kw["nbins"], kw["sample_window_s"],
                                                      kw["carrier_hz"]))
    out = np.zeros((len(centers), 6), np.float32)
    for r in range(len(centers)):
        rows = table[bins[r][valid[r]]].numpy()
        aw = psegs.amplitude[valid[r]].numpy() * rows[:, 0]
        if len(aw):
            out[r] = [_seq(aw * rows[:, 1]), _seq(aw * rows[:, 2]), rows[:, 0].max() ** 2, 1.0,
                      _seq(aw * aw), _seq(aw * aw * rows[:, 3])]
    return out


def test_coverage_phasor_backward_runs_the_plain_version_on_the_cpu(box_room, monkeypatch):
    """coverage_phasor's autograd Function on CPU tensors (its first pass
    spelled out, as in test_coverage_phasor_matches_rfx): the backward is
    phasor_backward_plain (no launch), and the gradient equals autograd
    through _dbm_cancel_plain at the bar of
    test_phasor_backward_plain_matches_autograd_of_plain."""
    segs, centers = _phasor_inputs(box_room)
    psegs = convert.segments_from_rfx(segs, device="cpu")
    weights = _phasor_weights(len(centers), seed=4)
    amp = psegs.amplitude.clone().requires_grad_()
    _phasor_loss(coverage._dbm_cancel_plain(psegs._replace(amplitude=amp), centers, 1.0,
                                            **PHASOR_KW), weights, "weighted").backward()
    monkeypatch.setattr(coverage_hist, "_phasor_sums", _phasor_sums_spelled_out)
    monkeypatch.setattr(coverage_hist, "_phasor_spread", _phasor_spread_spelled_out)
    mine = psegs.amplitude.clone().requires_grad_()
    before = coverage_hist.PHASOR_BACKWARD_KERNEL.launches
    outs = coverage_hist.coverage_phasor(psegs._replace(amplitude=mine * (torch.tensor(1.0) / 8192)),
                                         centers, 1.0, **_coverage_phasor_kw(PHASOR_KW))
    _phasor_loss(outs, weights, "weighted").backward()
    assert coverage_hist.PHASOR_BACKWARD_KERNEL.launches == before
    torch.testing.assert_close(mine.grad, amp.grad, rtol=1e-4,
                               atol=1e-6 * float(amp.grad.abs().max()))
