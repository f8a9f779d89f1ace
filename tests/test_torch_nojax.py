"""rfx_torch imports neither JAX nor the JAX package: a fresh interpreter
imports the port, runs a tiny CPU compute_cir through the three backends, a
counted fused trace, a soft coverage gradient, a hybrid coverage metric and
the coverage command line, and finds no `jax` and no `rfx` module. matplotlib is blocked throughout: the card's machine has none, and
`coverage --no-viz` must not need it."""

import os
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import sys
sys.modules["matplotlib"] = None  # any import of it raises ImportError
import torch
torch.set_num_threads(1)
import rfx_torch
from rfx_torch import convert, sampler
from rfx_torch.api import Tracer
from rfx_torch.ops import fused
from rfx_torch.geometry import make_room, make_terrain
dirs = sampler.morton_sphere_directions(512, generator=torch.Generator().manual_seed(0),
                                        device="cpu")
_, ir = Tracer(make_room(), max_bounces=2, tx_num_rays=512, device="cpu").compute_cir(
    [10.0, 0.0, 5.0], 1.0, [-10.0, 0.0, 5.0], 2.0, directions=dirs, record_paths=False)
tr = Tracer(make_terrain(grid=34, extent=30.0, seed=1), max_bounces=2, tx_num_rays=512,
            device="cpu")
assert tr.backend == "fused"
_, ir2 = tr.compute_cir([0.0, 0.0, 9.0], 1.0, [3.0, 0.0, 6.0], 2.0, directions=dirs,
                        record_paths=False)
_, ir3 = Tracer(make_terrain(grid=34, extent=30.0, seed=1), max_bounces=2, tx_num_rays=512,
                backend="bvh", device="cpu").compute_cir(
    [0.0, 0.0, 9.0], 1.0, [3.0, 0.0, 6.0], 2.0, directions=dirs, record_paths=False)
assert abs(float(ir3.sum()) - float(ir2.sum())) <= 1e-4 * float(ir2.sum())
_, stats = fused.fused_trace(tr._fused.bvh, dirs, [0.0, 0.0, 9.0], [3.0, 0.0, 6.0], 2.0,
                             max_bounces=2, count_stats=True)
assert stats.shape == (2, 4) and int(stats[0, 0]) >= 512
from rfx_torch import coverage, solver
from rfx_torch.tracer import Scene
room = make_room()
scene = Scene.from_mesh(room, "cpu")
tx = torch.tensor([4.0, 3.0, 6.0], requires_grad=True)
irs = solver.coverage_irs_soft(scene.vertices, scene.faces, tx, 5.0, dirs[:256],
                               coverage.make_grid([-6.0], [-4.0, 4.0], [5.0]), 2.0,
                               num_rays=256, max_bounces=2, nbins=512,
                               light_speed_mps=2.998e8, sample_rate_hz=10e9)
(irs * irs).sum().backward()
assert torch.isfinite(tx.grad).all() and float(tx.grad.abs().sum()) > 0
dbm, n_flagged = Tracer(room, max_bounces=2, tx_num_rays=256, sample_window_s=100e-9,
                        device="cpu").compute_coverage_dbm_hybrid(
    [3.0, 2.0, 2.0], 1.0, coverage.make_grid([-6.0, 6.0], [-4.0, 4.0], [2.0]), 2.0,
    directions=dirs[:256])
assert dbm.shape == (4,) and 0 <= n_flagged <= 4
from rfx_torch import cli
from rfx_torch.utils import profiling
assert cli.main(["coverage", "--rays", "256", "--device", "cpu", "--no-viz", "--metric",
                 "exact"]) == 0
print(float(ir.sum()), float(ir2.sum()), tr.rx_power_dbm(ir2))
bad = sorted(m for m in sys.modules
             if m in ("jax", "rfx") or m.startswith(("jax.", "jaxlib", "rfx.")))
print("JAX_MODULES", bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "JAX_MODULES []", proc.stdout
    ir_sum, ir2_sum = (float(x) for x in lines[-2].split()[:2])
    assert ir_sum > 0 and ir2_sum > 0
