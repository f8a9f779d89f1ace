"""The port's distribution (rfx_torch.parallel) against rfx.parallel and
rfx.solver(mesh=) on the same inputs.

torch has no fake devices, so the reference's eight-device cases become gloo
ranks: OS processes of scripts/torch_multiproc_worker.py and
scripts/torch_multiproc_solver_worker.py on a free localhost port, each with
one intra-op thread, under a time limit (rfx_torch.parallel.launch). The
reference runs in this process on the conftest's 8 fake CPU devices. A
one-rank group runs in this process. Tolerances are the reference's own:
rtol 1e-6 / atol 1e-15 for IRs (tests/test_dist.py:42,60), rtol 1e-5 /
atol 1e-10 for a solver step (tests/test_multiprocess.py:167); partial sums
over 2 shards group differently from 8 shards and from one run.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from oracle import sample_sphere_directions
from rfx import parallel as jparallel
from rfx.geometry import make_room as jmake_room
from rfx.solver import make_inverse_solver as jmake_inverse_solver
from rfx.tracer import Scene as JScene
from rfx_torch.cir import cir_from_trace
from rfx_torch.coverage import coverage_irs, make_grid
from rfx_torch.geometry import make_room
from rfx_torch.parallel import dist as pdist
from rfx_torch.parallel import make_mesh, sharded_cir, sharded_coverage_irs
from rfx_torch.parallel.launch import one_rank_group, result_of, run_ranks
from rfx_torch.solver import make_inverse_solver
from rfx_torch.tracer import Scene, trace_to_rx

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_multiproc_worker.py")
SOLVER_WORKER = os.path.join(REPO, "scripts", "torch_multiproc_solver_worker.py")
C = 2.998e8
RATE = 100e9
NBINS = int(100e-9 * RATE)
TX = np.array([5.0, 0.0, 5.0], np.float32)
RX = np.array([-8.0, 2.0, 4.0], np.float32)
CENTERS = make_grid(range(-12, 13, 6), [-6, 6], [2, 8])[:16]  # tests/test_dist.py:48-49
SOLVER_CENTERS = np.stack([np.linspace(-10, 10, 8), np.zeros(8), np.full(8, 5.0)],
                          axis=1).astype(np.float32)


def _launch(tmp_path, script, world, *extra):
    """Run `script` on `world` gloo ranks; (each rank's arrays, each rank's
    RESULT line)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = run_ranks(lambda r, c: [sys.executable, script, c, str(world), str(r),
                                   str(tmp_path / f"rank{r}.npz"), "--device", "cpu", *extra],
                     world, timeout=240, env=env)
    return ([dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)],
            [result_of(o) for o in outs])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("cir"), WORKER, 2, "--cases", "cir")


@pytest.fixture(scope="module")
def coverage_2x2(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("coverage"), WORKER, 4, "--cases", "coverage")


@pytest.fixture(scope="module")
def solver_2x2(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("solver"), SOLVER_WORKER, 4)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (fake) devices")
    return jax.devices()[:8]


def _port_cir(dirs, radius, *, max_bounces, soft=False, tx=TX):
    scene = Scene.from_mesh(make_room(), "cpu")
    r = trace_to_rx(scene, tx, torch.from_numpy(dirs), RX, radius, max_bounces=max_bounces,
                    rx_mode="analytic")
    return cir_from_trace(r, tx_power=1.0, num_rays=dirs.shape[0], nbins=NBINS,
                          light_speed_mps=C, sample_rate_hz=RATE, soft=soft)


def test_two_rank_sharded_cir_matches_rfx(two_ranks, eight_devices):
    """tests/test_dist.py:30-42: box room, 4,096 rays; rfx on 8 devices."""
    arrays, infos = two_ranks
    dirs = sample_sphere_directions(4096, seed=31)
    want = np.asarray(jparallel.sharded_cir(
        JScene.from_mesh(jmake_room()), TX, jnp.asarray(dirs), RX, 0.8,
        jparallel.make_mesh({"rays": 8}, eight_devices), max_bounces=3, nbins=NBINS,
        light_speed_mps=C, sample_rate_hz=RATE))
    got = arrays[0]["cir_ir"]
    assert got.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-15)
    np.testing.assert_array_equal(arrays[1]["cir_ir"], got)  # both ranks hold the same bits
    for info in infos:
        assert info["backend"] == "gloo" and info["cir"]["repeat_equal"]
        assert info["cir"]["all_reduces"] == [["rays", [NBINS]]]


def test_two_rank_sharded_cir_matches_unsharded(two_ranks):
    arrays, _ = two_ranks
    want = _port_cir(sample_sphere_directions(4096, seed=31), 0.8, max_bounces=3).numpy()
    np.testing.assert_allclose(arrays[0]["cir_ir"], want, rtol=1e-6, atol=1e-15)


def test_two_rank_soft_gradient_matches_unsharded(two_ranks):
    """tests/test_dist.py:79-97: d(sum(ir * bin))/d tx under soft binning,
    through the exit and the entry Functions, against the port's unsharded
    gradient."""
    arrays, _ = two_ranks
    g = arrays[0]["cir_grad"]
    assert np.all(np.isfinite(g)) and np.any(g != 0.0)
    np.testing.assert_array_equal(arrays[1]["cir_grad"], g)
    tx = torch.tensor(TX, requires_grad=True)
    ir = _port_cir(sample_sphere_directions(1024, seed=55), 1.5, max_bounces=2, soft=True, tx=tx)
    torch.sum(ir * torch.arange(NBINS, dtype=torch.float32)).backward()
    np.testing.assert_allclose(g, tx.grad.numpy(), rtol=1e-5)


def test_two_by_two_coverage_matches_rfx(coverage_2x2, eight_devices):
    """tests/test_dist.py:45-60: 2,048 rays, 16 receivers, the map engine;
    rfx on a {'rays': 4, 'rx': 2} mesh, the port's tiles in rank order."""
    arrays, infos = coverage_2x2
    want = np.asarray(jparallel.sharded_coverage_irs(
        JScene.from_mesh(jmake_room()), TX, jnp.asarray(sample_sphere_directions(2048, seed=13)),
        jnp.asarray(CENTERS), 0.8, jparallel.make_mesh({"rays": 4, "rx": 2}, eight_devices),
        max_bounces=2, nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE, rx_batch=4))
    tiles = [a["coverage_tile"] for a in arrays]
    assert [i["coverage"]["coords"] for i in infos] == [
        {"rays": r, "rx": x} for r in range(2) for x in range(2)]
    for r in (2, 3):  # the 'rays' replicas of a tile hold the same bits
        np.testing.assert_array_equal(tiles[r], tiles[r - 2])
    got = np.concatenate(tiles[:2])
    assert got.shape == (16, NBINS) and (got.sum(axis=1) > 0).sum() > 4
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-15)
    for info in infos:
        assert info["coverage"]["repeat_equal"]
        assert info["coverage"]["all_reduces"] == [["rays", [8, NBINS]]]


def test_two_by_two_coverage_matches_unsharded(coverage_2x2):
    arrays, _ = coverage_2x2
    want = coverage_irs(Scene.from_mesh(make_room(), "cpu"), TX,
                        torch.from_numpy(sample_sphere_directions(2048, seed=13)), CENTERS, 0.8,
                        max_bounces=2, nbins=NBINS, num_rays=2048, light_speed_mps=C,
                        sample_rate_hz=RATE, rx_batch=4, engine="map").numpy()
    got = np.concatenate([arrays[0]["coverage_tile"], arrays[1]["coverage_tile"]])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-15)


def _step_row(tx, log_n1, loss):
    return np.concatenate([np.ravel(tx), [float(log_n1)], [float(loss)]]).astype(np.float64)


def test_two_by_two_solver_step_matches_rfx(solver_2x2, eight_devices):
    """tests/test_multiprocess.py:139-167: the room, 512 rays, 8 receivers,
    256 bins at 10 GHz; rfx's step on a {'rays': 4, 'rx': 2} mesh."""
    arrays, _ = solver_2x2
    mesh = jparallel.make_mesh({"rays": 4, "rx": 2}, eight_devices)
    dirs = jax.device_put(jnp.asarray(sample_sphere_directions(512, seed=0)),
                          NamedSharding(mesh, P("rays")))
    centers = jax.device_put(jnp.asarray(SOLVER_CENTERS), NamedSharding(mesh, P("rx")))
    init_fn, step_fn = jmake_inverse_solver(
        JScene.from_mesh(jmake_room()), dirs, centers, 1.0, jnp.zeros((8,), jnp.float32),
        max_bounces=2, nbins=256, sample_rate_hz=10e9, mesh=mesh)
    params, opt_state = init_fn(tx0=[5.0, 0.0, 5.0])
    params, _, loss = step_fn(params, opt_state)
    want = _step_row(np.asarray(params.tx_pos), params.log_n1, loss)
    rows = [_step_row(a["solver_tx"], a["solver_log_n1"], a["solver_loss"]) for a in arrays]
    for row in rows[1:]:  # every rank holds the same bits
        np.testing.assert_array_equal(row, rows[0])
    assert np.all(np.isfinite(rows[0])) and rows[0][-1] > 0
    np.testing.assert_allclose(rows[0], want, rtol=1e-5, atol=1e-10)


def test_two_by_two_solver_step_matches_unsharded(solver_2x2):
    arrays, _ = solver_2x2
    init_fn, step_fn = make_inverse_solver(
        Scene.from_mesh(make_room(), "cpu"), sample_sphere_directions(512, seed=0),
        SOLVER_CENTERS, 1.0, np.zeros(8, np.float32), max_bounces=2, nbins=256,
        sample_rate_hz=10e9)
    params, opt = init_fn([5.0, 0.0, 5.0])
    params, opt, loss = step_fn(params, opt)
    np.testing.assert_allclose(
        _step_row(arrays[0]["solver_tx"], arrays[0]["solver_log_n1"], arrays[0]["solver_loss"]),
        _step_row(params.tx_pos.detach(), params.log_n1.detach(), loss), rtol=1e-5, atol=1e-10)
    for a in arrays:
        np.testing.assert_array_equal(a["solver_grad_tx"], arrays[0]["solver_grad_tx"])
        np.testing.assert_allclose(a["solver_grad_tx"], params.tx_pos.grad.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(params.tx_pos.grad.numpy()).max()))


def test_solver_step_collective_volume(solver_2x2):
    """tests/test_dist.py:100-137's bound, counted by the port's log: at most
    two IR-sized and two small all-reduces a step. The port makes one of
    each kind it needs: the (M / rx, nbins) tile over 'rays', the squared
    error over 'rx', the flattened gradients (tx, log_n1) over every rank."""
    _, infos = solver_2x2
    for info in infos:
        log = [(axis, tuple(shape)) for axis, shape in info["solver"]["all_reduces"]]
        ir = tuple(info["solver"]["ir_shape"])
        assert ir == (4, 256)
        n_ir = sum(1 for _, s in log if s == ir)
        assert n_ir <= 2 and len(log) - n_ir <= 2, log
        assert log == [("rays", ir), ("rx", ()), ("world", (4,))]
        assert info["solver"]["repeat_equal"]  # two steps from the start, the same bits


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_one_rank_group_equals_unsharded_bit_for_bit(soft):
    dirs = sample_sphere_directions(2048, seed=31)
    want = _port_cir(dirs, 0.8, max_bounces=3, soft=soft)
    scene = Scene.from_mesh(make_room(), "cpu")
    kw = dict(max_bounces=3, nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE, soft=soft)
    assert torch.equal(sharded_cir(scene, TX, dirs, RX, 0.8, make_mesh(device="cpu"), **kw), want)
    with one_rank_group("gloo"):
        mesh = make_mesh(device="cpu")
        pdist.ALL_REDUCE_LOG.clear()
        got = sharded_cir(scene, TX, dirs, RX, 0.8, mesh, **kw)
        assert list(pdist.ALL_REDUCE_LOG) == [("rays", (NBINS,))]
        assert torch.equal(got, want)
        tiles = sharded_coverage_irs(scene, TX, dirs, CENTERS, 0.8,
                                     make_mesh({"rays": 1, "rx": 1}, device="cpu"),
                                     max_bounces=2, nbins=NBINS, light_speed_mps=C,
                                     sample_rate_hz=RATE)
    assert torch.equal(tiles, coverage_irs(scene, TX, torch.from_numpy(dirs), CENTERS, 0.8,
                                           max_bounces=2, nbins=NBINS, num_rays=2048,
                                           light_speed_mps=C, sample_rate_hz=RATE, rx_batch=8,
                                           engine="map"))


def _fake_mesh(**shape):
    """A Mesh of this one process laid out as if over sum(shape) ranks (no
    group): enough to reach the divisibility checks."""
    return pdist.Mesh(shape, dict.fromkeys(shape, 0), dict.fromkeys(shape), None,
                      torch.device("cpu"))


def test_make_mesh_raises_as_rfx(eight_devices):
    with pytest.raises(ValueError, match="do not cover"):
        jparallel.make_mesh({"rays": 3}, eight_devices)
    with pytest.raises(ValueError, match="do not cover"):
        make_mesh({"rays": 2}, device="cpu")  # this process alone is a world of one
    with pytest.raises(ValueError, match="do not cover"):
        make_mesh({"rays": 1, "rx": 2}, device="cpu")
    mesh = make_mesh({"rays": 1, "rx": 1}, device="cpu")
    assert mesh.axis_names == ("rays", "rx") and mesh.coords == {"rays": 0, "rx": 0}
    assert mesh.group("rays") is None and mesh.group() is None


@pytest.mark.parametrize("case", ["cir", "coverage_rays", "coverage_rx", "solver_rays",
                                  "solver_rx"])
def test_divisibility_checks_raise_as_rfx(case, eight_devices):
    scene, jscene = Scene.from_mesh(make_room(), "cpu"), JScene.from_mesh(jmake_room())
    dirs = sample_sphere_directions(4096 + 2, seed=1)  # 4,098 = 2 x 3 x 683: not over 4
    centers = CENTERS if case.endswith("rays") else CENTERS[:15]
    if case == "cir":
        mesh = _fake_mesh(rays=4)
        run = lambda: sharded_cir(scene, TX, dirs, RX, 0.8, mesh, max_bounces=1, nbins=16)
        jrun = lambda: jparallel.sharded_cir(jscene, TX, jnp.asarray(dirs), RX, 0.8,
                                             jparallel.make_mesh({"rays": 8}, eight_devices),
                                             max_bounces=1, nbins=16)
    elif case.startswith("coverage"):
        mesh = _fake_mesh(rays=4, rx=2)
        run = lambda: sharded_coverage_irs(scene, TX, dirs if case.endswith("rays") else dirs[:4096],
                                           centers, 0.8, mesh, max_bounces=1, nbins=16)
        jrun = lambda: jparallel.sharded_coverage_irs(
            jscene, TX, jnp.asarray(dirs if case.endswith("rays") else dirs[:4096]),
            jnp.asarray(centers), 0.8,
            jparallel.make_mesh({"rays": 4, "rx": 2}, eight_devices), max_bounces=1, nbins=16)
    else:
        mesh = _fake_mesh(rays=4, rx=2)
        run = lambda: make_inverse_solver(scene, dirs if case.endswith("rays") else dirs[:4096],
                                          centers, 1.0, np.zeros(len(centers), np.float32),
                                          max_bounces=1, nbins=16, mesh=mesh)
        jrun = None  # rfx's solver leaves the sharding of its arguments to jax.device_put
    with pytest.raises(ValueError, match="not divisible"):
        run()
    if jrun is not None:
        with pytest.raises(ValueError, match="not divisible"):
            jrun()


def test_dryrun_multichip_four_ranks():
    """__graft_entry__.py:46's dry run as the port runs it: 4 gloo ranks, a
    {'rays': 2, 'rx': 2} mesh, one step; every rank the same finite loss."""
    from rfx_torch.graft_entry import dryrun_multichip

    loss = dryrun_multichip(4, device="cpu", timeout=240)
    assert np.isfinite(loss) and loss > 0


def test_entry_forward_matches_graft_entry():
    import __graft_entry__

    from rfx_torch.graft_entry import entry

    fn, args = entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with torch.no_grad():
        got = fn(*args).numpy()
    want = np.asarray(jfn(*jargs))  # eager: rfx's jit folds rate / c into one multiply
    assert got.shape == (2000,) and got.sum() > 0
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
