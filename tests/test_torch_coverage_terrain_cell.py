"""The exact coverage configuration over the terrain on the CPU, as the
benchmark's `coverage.terrain.exact` drives it: the environment trace on the
per-query BVH intersector (`make_kernel_env_hit`, whose CPU branch is
`closest_hit_plain`) against the plain reference's `env_trace`; the facade's
`compute_coverage` and `rx_power_dbm` against the reference under the cell's
own limits, the environment trace's own among them; the cell's CPU
rehearsal ends correct and refuses its `half_batch`, `alter` and `env_miss`
faults; the environment's gaps and K2's roofline reader on synthetic
records. No JAX."""

import json
import math

import numpy as np
import pytest
import torch

from gpubench.drivers.coverage_env import env_gaps, port_env, ref_env
from gpubench.harness import compare
from gpubench.harness.inputs import receivers
from gpubench.harness.profile import Trace
from gpubench.harness.spec import load_metric
from gpubench.reference import geometry as ref_geometry
from gpubench.reference import trace as ref
from gpubench.reference.counts_env import k2_work
from gpubench.reference.peaks import bound_s
from gpubench.reference.sampler import sphere_directions
from gpubench.tests.conftest import ROOT, run_cell
from rfx_torch.api import Tracer
from rfx_torch.geometry import TriangleMesh
from rfx_torch.ops.bvh_trace import make_kernel_env_hit
from rfx_torch.ops.intersect import is_hit
from rfx_torch.tracer import Scene, trace_env

torch.set_num_threads(1)

CELL = "coverage.terrain.exact"
WORKLOAD = json.loads((ROOT / "gpubench" / "workloads" / f"{CELL}.json").read_text())
CONFIG = json.loads((ROOT / "gpubench" / "configs" / "rfx_coverage_terrain.json").read_text())
TRAFFIC = json.loads((ROOT / "gpubench" / "traffic" / "sweeps.terrain.grid2048.json").read_text())
PHYS = CONFIG["physics"]
NBINS, C, RATE, WINDOW = PHYS["nbins"], PHYS["light_speed_mps"], PHYS["sample_rate_hz"], \
    PHYS["sample_window_s"]
REHEARSAL = WORKLOAD["cpu_rehearsal"]
RAYS = REHEARSAL["config"]["rays"]
TX, CARRIER = tuple(TRAFFIC["tx"]), TRAFFIC["carrier_hz"]
RADIUS = REHEARSAL["traffic"]["rx_radius"]


#: Half the CPU rehearsal's rays, on a terrain of 3,042 triangles (above
#: the brute backend's 2,048): the plain closest hit on the CPU tests every
#: face against every ray.
RAYS_HERE = RAYS // 2


@pytest.fixture(scope="module")
def terrain():
    """A terrain of the cell's extent from the benchmark's frozen builder."""
    return ref_geometry.build_scene({**CONFIG["scene"], "grid": 40})


def _dirs(seed: int) -> torch.Tensor:
    return sphere_directions(RAYS_HERE, generator=torch.Generator().manual_seed(seed),
                             device=torch.device("cpu"))


def test_the_bvh_environment_trace_matches_the_plain_reference(terrain):
    """Three bounces of seeded rays from the cell's transmitter: each
    bounce's live rays, each live ray's hit or escape, its t where it hits
    and its amplitude, at tests/test_fused.py's tolerances."""
    verts, faces = terrain
    dirs = _dirs(2**31 + 27)
    env = make_kernel_env_hit(TriangleMesh(verts, faces), device="cpu")
    got = trace_env(Scene.from_mesh(TriangleMesh(verts, faces), "cpu"), TX, dirs,
                    max_bounces=3, n1=PHYS["n1"], n2=PHYS["n2"], env_hit=env)
    want = ref.env_trace(ref.RefScene(verts, faces, device="cpu"), TX, dirs, bounces=3,
                         n1=PHYS["n1"], n2=PHYS["n2"])
    assert len(want) == 3 and want[1]["ray"].numel() > 100 and want[2]["ray"].numel() > 0
    for b, seg in enumerate(want):
        ray = seg["ray"]
        assert torch.equal(torch.nonzero(got.alive[b]).flatten(), ray), b
        hit = seg["face"] >= 0
        assert torch.equal(is_hit(got.t_env[b, ray]), hit), b
        np.testing.assert_allclose(got.t_env[b, ray[hit]].double().numpy(),
                                   seg["t_env"][hit].numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got.amplitude[b, ray].double().numpy(), seg["amp"].numpy(),
                                   rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_the_facade_s_exact_coverage_agrees_with_the_plain_reference(terrain, backend):
    """The CPU rehearsal's receivers and radius through the facade
    (`auto` takes the plain walk on the CPU, `fused` the branch the card
    takes, whose environment trace runs `make_kernel_env_hit`), then the
    dBm, and the environment trace the facade runs; every gap that decides
    `correct` within the cell's limit."""
    verts, faces = terrain
    dirs = _dirs(2**31 + 28)
    grid = receivers(REHEARSAL["traffic"]["receivers"])
    t = Tracer(TriangleMesh(verts, faces), C, RATE, WINDOW, PHYS["max_bounces"], RAYS_HERE,
               n1=PHYS["n1"], n2=PHYS["n2"], backend=backend, device="cpu")
    assert t.backend == ("bvh" if backend == "auto" else "fused")
    irs = t.compute_coverage(TX, 1.0, grid, RADIUS, directions=dirs)
    dbm = t.rx_power_dbm(irs, CARRIER)
    segs = ref.env_trace(ref.RefScene(verts, faces, device="cpu"), TX, dirs,
                         bounces=PHYS["max_bounces"], n1=PHYS["n1"], n2=PHYS["n2"])
    want, _ = ref.receiver_irs(segs, grid, RADIUS, rx_mode="analytic", scale=1.0 / RAYS_HERE,
                               nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE)
    want_dbm = ref.rx_power_dbm(want, WINDOW, CARRIER).numpy()
    own = ref.rx_power_dbm(torch.as_tensor(irs).double(), WINDOW, CARRIER).numpy()
    want = want.numpy()
    assert irs.shape == (grid.shape[0], NBINS) and np.isfinite(want_dbm).sum() >= 24
    width = int(WORKLOAD["check"]["pool_bins"])
    gaps = {"dbm_gap_db": compare.dbm_gap(dbm, want_dbm),
            "dbm_gap_db_mean": compare.dbm_gap_mean(dbm, want_dbm),
            "kp_gap_db": compare.dbm_gap(dbm, own),
            "ir_pooled_l1": compare.pooled_l1(irs, want, width),
            "ir_sum_gap": compare.sum_gap(irs, want),
            "ir_sum_gap_mean": compare.sum_gap_mean(irs, want),
            "ir_support_gap_mean": compare.support_gap_mean(irs, want, width),
            **env_gaps(port_env(t, TX, dirs, bounces=PHYS["max_bounces"], n1=PHYS["n1"],
                                n2=PHYS["n2"]), ref_env(segs), RAYS_HERE, PHYS["max_bounces"])}
    limits = WORKLOAD["check"]["limits"]
    assert set(gaps) == set(limits)
    for name, gap in gaps.items():
        assert gap <= limits[name], (name, gap, limits[name])


@pytest.mark.parametrize("brk,correct", [((), True), (("--fault", "half_batch"), False),
                                         (("--fault", "alter"), False),
                                         (("--fault", "env_miss"), False)],
                         ids=["sound", "half_batch", "alter", "env_miss"])
def test_the_cell_s_cpu_rehearsal(brk, correct, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc, res, err = run_cell("--workload", CELL, "--seed", "4242424243", "--seconds", "1",
                            "--device", "cpu", *brk)
    assert rc == 0, err[-3000:]
    assert res["correct"] is correct, res["checks"]
    assert res["checks"]["compared"]["value"] > 0


def _segs(n_live, hit, face, t, ray=None):
    ray = torch.arange(n_live) if ray is None else torch.as_tensor(ray)
    return dict(ray=ray, hit=torch.as_tensor(hit), face=torch.as_tensor(face),
                t=torch.as_tensor(t, dtype=torch.float64))


#: Four rays, two bounces: rays 0-2 hit faces 7, 8, 9 at t 2, 4, 8; ray 3
#: escapes; at the second bounce ray 0 hits face 1 at t 3, rays 1 and 2
#: escape.
REF = [_segs(4, [True, True, True, False], [7, 8, 9, -1], [2.0, 4.0, 8.0, math.inf]),
       _segs(3, [True, False, False], [1, -1, -1], [3.0, math.inf, math.inf])]


@pytest.mark.parametrize("port,gaps", [
    (REF, {}),
    ([_segs(4, [True, True, True, False], [7, 8, 9, -1], [2.0, 4.4, 8.0, 1e30]), REF[1]],
     {"env_t_gap_mean": 0.1 / 4}),
    ([_segs(4, [True, True, True, False], [7, 5, 9, -1], [2.0, 4.0, 8.0, 1e30]), REF[1]],
     {"env_face_gap": 1 / 4}),
    ([_segs(4, [True, True, False, False], [7, 8, -1, -1], [2.0, 4.0, 1e30, 1e30]),
      _segs(2, [True, False], [1, -1], [3.0, 1e30])],
     {"env_live_gap": 1 / 7, "env_hit_gap": 1 / 6}),
    ([_segs(4, [False] * 4, [-1] * 4, [math.inf] * 4),
      _segs(0, [], [], [], ray=torch.zeros(0, dtype=torch.long))],
     {"env_live_gap": 3 / 7, "env_hit_gap": 3 / 4}),
], ids=["same", "far_t", "wrong_face", "one_escape", "all_miss"])
def test_the_environment_gaps_see_each_fault_of_the_closest_hit(port, gaps):
    """Each fault of the environment trace moves its own number, and the
    reference against itself reads 0."""
    want = {"env_live_gap": 0.0, "env_hit_gap": 0.0, "env_face_gap": 0.0,
            "env_t_gap_mean": 0.0, **gaps}
    assert env_gaps(port, REF, 4, 2) == pytest.approx(want)


def test_k2_roofline_reads_the_closest_hit_kernel_alone():
    """The bound of the reference's live queries over the device time a
    sweep of `closest_hit_kernel`; K1, K-B, K3 and its reduction are not
    counted; a trace without the counts, or without a K2 record, reads
    None."""
    k2 = ("void (anonymous namespace)::closest_hit_kernel<rfx::NoCount, "
          "(anonymous namespace)::NoCounts>(float const*, float const*, int)")
    others = ["void (anonymous namespace)::fused_trace_kernel<AnalyticSphere>(float const*)",
              "(anonymous namespace)::brute_hit_kernel(float const*)",
              "(anonymous namespace)::coverage_hist_kernel(float const*, float*)",
              "(anonymous namespace)::coverage_reduce_kernel(float const*, float*)"]
    device = []
    for u in (0.0, 10.0):
        device += [(u + 0.1, u + 0.14, k2), (u + 0.2, u + 0.26, k2)]
        device += [(u + 1.0 + i, u + 1.5 + i, n) for i, n in enumerate(others)]
    shapes = {"rays": 1 << 20, "bounces": 2, "receivers": 2048, "faces": 32258}
    trace = Trace(units=[(0.0, 5.0), (10.0, 15.0)], device=device,
                  counts={"live_segments": 1.5e6}, shapes=shapes)
    want = 100.0 * bound_s(*k2_work(live_queries=1.5e6, faces=32258)) / 0.1
    assert load_metric("k2_roofline_pct").read(trace, None) == pytest.approx(want)
    assert k2_work(live_queries=1.5e6, faces=32258) == (1.5e6 * 44 + 32258 * 36, 1.5e6 * 51)
    trace.counts = {}
    assert load_metric("k2_roofline_pct").read(trace, None) is None
    trace.counts = {"live_segments": 1.5e6}
    trace.device = [r for r in device if r[2] != k2]
    assert load_metric("k2_roofline_pct").read(trace, None) is None
