"""The port's inverse solver against rfx.solver on the same inputs: one Adam
step's parameters and loss, through rfx_torch.convert.inverse_params_from_rfx;
the 20-step loss decrease of tests/test_gradients.py:109-137; the vertex
leaf; and the FD checks of the soft-IR energy gradients."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracle import sample_sphere_directions
from rfx.solver import coverage_irs_soft as jcoverage_irs_soft
from rfx.solver import make_inverse_solver as jmake_inverse_solver
from rfx.tracer import Scene as JScene
from rfx_torch import convert
from rfx_torch.solver import InverseParams, coverage_irs_soft, make_inverse_solver
from rfx_torch.tracer import Scene

torch.set_num_threads(1)

RXC = np.asarray([[-6.0, 0.0, 5.0], [6.0, 0.0, 5.0]], np.float32)
KW = dict(max_bounces=2, nbins=512, sample_rate_hz=10e9)


def _target(scene, dirs, true_tx):
    irs = coverage_irs_soft(scene.vertices, scene.faces, true_tx, 5.0, dirs, RXC, 2.5,
                            num_rays=dirs.shape[0], light_speed_mps=2.998e8, **KW)
    return torch.sum(irs * irs, dim=1)


def test_one_solver_step_matches_rfx(box_room):
    dirs = sample_sphere_directions(2048, seed=13)
    jscene = JScene.from_mesh(box_room)
    jirs = jcoverage_irs_soft(jscene.vertices, jscene.faces, jnp.asarray([3.0, 0.0, 5.0]), 5.0,
                              jnp.asarray(dirs), jnp.asarray(RXC), 2.5, num_rays=2048,
                              light_speed_mps=2.998e8, **KW)
    target = np.asarray(jnp.sum(jirs * jirs, axis=1))
    j_init, j_step = jmake_inverse_solver(jscene, jnp.asarray(dirs), jnp.asarray(RXC), 2.5,
                                          jnp.asarray(target), learning_rate=0.1, **KW)
    # A start where every gradient is far above Adam's eps (1e-8): there the
    # first step is lr * g / (|g| + eps), which amplifies the gradients' own
    # f32 differences (sums of soft-binned paths in another order) where
    # |g| ~ eps.
    tx0 = [-2.0, 1.5, 4.0]
    jp, jo = j_init(tx0=tx0)
    jp2, _, jloss = j_step(jp, jo)

    scene = Scene.from_mesh(box_room, "cpu")
    init_fn, step_fn = make_inverse_solver(scene, dirs, RXC, 2.5, target, learning_rate=0.1,
                                           **KW)
    params, opt = init_fn(tx0=tx0)
    from_rfx = convert.inverse_params_from_rfx(jp, device="cpu")
    torch.testing.assert_close(from_rfx.tx_pos, params.tx_pos, rtol=0, atol=0)
    torch.testing.assert_close(from_rfx.log_n1, params.log_n1, rtol=0, atol=0)
    assert from_rfx.vertices is None and from_rfx.tx_pos.requires_grad
    params, opt, loss = step_fn(params, opt)
    assert float(loss) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    want = convert.inverse_params_from_rfx(jp2, device="cpu")
    np.testing.assert_allclose(params.tx_pos.detach().numpy(), want.tx_pos.detach().numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(float(params.log_n1), float(want.log_n1), rtol=1e-4)


def test_inverse_solver_reduces_loss(box_room):
    scene = Scene.from_mesh(box_room, "cpu")
    dirs = torch.from_numpy(sample_sphere_directions(4096, seed=13))
    target = _target(scene, dirs, [3.0, 0.0, 5.0])
    init_fn, step_fn = make_inverse_solver(scene, dirs, RXC, 2.5, target, learning_rate=0.1,
                                           **KW)
    params, opt = init_fn(tx0=[0.0, 1.0, 6.0])
    losses = []
    for _ in range(20):
        params, opt, loss = step_fn(params, opt)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.99 * losses[0], losses


def test_inverse_solver_vertex_leaf_and_mesh(box_room):
    scene = Scene.from_mesh(box_room, "cpu")
    dirs = torch.from_numpy(sample_sphere_directions(1024, seed=15))
    target = _target(scene, dirs, [3.0, 0.0, 5.0])
    rng = np.random.default_rng(7)
    v0 = scene.vertices + torch.from_numpy(rng.normal(scale=0.4, size=scene.vertices.shape)
                                           .astype(np.float32))
    init_fn, step_fn = make_inverse_solver(scene, dirs, RXC, 2.5, target, learning_rate=0.01,
                                           **KW)
    params, opt = init_fn(tx0=[3.0, 0.0, 5.0], vertices0=v0)
    assert isinstance(params, InverseParams) and params.vertices.requires_grad
    params, opt, loss = step_fn(params, opt)
    assert np.isfinite(float(loss))
    assert float((params.vertices.detach() - v0).abs().max()) > 0
    with pytest.raises(NotImplementedError, match="A11"):
        make_inverse_solver(scene, dirs, RXC, 2.5, target, mesh=object(), **KW)


def _energy_fn(box_room, seed):
    scene = Scene.from_mesh(box_room, "cpu")
    dirs = torch.from_numpy(sample_sphere_directions(2048, seed=seed))

    def energy(tx, n1):
        irs = coverage_irs_soft(scene.vertices, scene.faces, tx, n1, dirs,
                                np.asarray([[-6.0, -4.0, 5.0]], np.float32), 2.0,
                                num_rays=2048, light_speed_mps=2.998e8, **KW)
        return torch.sum(irs * irs) * 1e12

    return energy


def test_energy_gradients_match_finite_differences(box_room):
    """tests/test_gradients.py:56-106 in the port: d(IR energy)/d(tx) at
    eps 1e-3 (8%) and d/d(n1) at eps 1e-2 (5%)."""
    energy = _energy_fn(box_room, 11)
    tx0 = torch.tensor([4.0, 3.0, 6.0], requires_grad=True)
    energy(tx0, 5.0).backward()
    g = tx0.grad.numpy()
    assert np.all(np.isfinite(g))
    eps = 1e-3
    with torch.no_grad():
        for a in range(3):
            tp, tm = tx0.detach().clone(), tx0.detach().clone()
            tp[a] += eps
            tm[a] -= eps
            fd = (float(energy(tp, 5.0)) - float(energy(tm, 5.0))) / (2 * eps)
            assert abs(g[a] - fd) < 0.08 * max(abs(fd), abs(g[a])), (a, g[a], fd)
    energy = _energy_fn(box_room, 12)
    n1 = torch.tensor(5.0, requires_grad=True)
    energy(torch.tensor([4.0, 3.0, 6.0]), n1).backward()
    with torch.no_grad():
        fd = (float(energy(torch.tensor([4.0, 3.0, 6.0]), torch.tensor(5.01)))
              - float(energy(torch.tensor([4.0, 3.0, 6.0]), torch.tensor(4.99)))) / 0.02
    assert np.isfinite(float(n1.grad)) and abs(float(n1.grad) - fd) < 0.05 * max(abs(fd), 1e-6)
