"""The fast coverage configuration on the CPU, as the benchmark's
`coverage.room.fast` drives it: the plain reference of the phasor metric
(`gpubench/reference/phasor.py`) against the port's
`rfx_torch.cir.rx_power_dbm_phasor` on hand-made captures; the facade's
`compute_coverage_dbm_fast` against the reference under the cell's own
limits; the cell's CPU rehearsal ends correct and refuses its `alter` fault;
the fast and hybrid facade calls record their spans and named waits, which
the benchmark's readers read; and the cell's two new readers on synthetic
records. No JAX."""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gpubench.harness import compare
from gpubench.harness.profile import UNIT, Trace, collect
from gpubench.harness.spec import load_metric
from gpubench.reference import geometry as ref_geometry
from gpubench.reference import phasor as ref_phasor
from gpubench.reference import trace as ref
from gpubench.reference.counts_phasor import kf_work
from gpubench.reference.peaks import bound_s
from gpubench.reference.sampler import sphere_directions
from gpubench.tests.conftest import ROOT, run_cell
from rfx_torch import cir
from rfx_torch.api import Tracer
from rfx_torch.geometry import TriangleMesh
from rfx_torch.utils import profiling

torch.set_num_threads(1)

CELL = "coverage.room.fast"
WORKLOAD = json.loads((ROOT / "gpubench" / "workloads" / f"{CELL}.json").read_text())
CONFIG = json.loads((ROOT / "gpubench" / "configs" / "rfx_coverage_room_fast.json").read_text())
PHYS = CONFIG["physics"]
NBINS, C, RATE, WINDOW = PHYS["nbins"], PHYS["light_speed_mps"], PHYS["sample_rate_hz"], \
    PHYS["sample_window_s"]
CARRIER, TX, RADIUS = 2.4e9, (3.0, 2.0, 2.0), 0.5
RAYS = WORKLOAD["cpu_rehearsal"]["config"]["rays"]


def _length(b: float) -> float:
    """A path length whose delay lies in the middle of bin b."""
    return (b + 0.5) * C / RATE


def test_the_reference_s_phasor_identity_is_the_port_s():
    """Four receivers: captures in the window's first and last bins beside
    one past its end (dropped), a pair whose phases differ by ~3.17 rad
    (cancelling to ~27 dB below one path alone), no capture, and only a
    capture past the window (-inf, as no capture)."""
    rows = [[(0.7, 0), (0.4, NBINS - 1), (0.9, NBINS)],
            [(1.0, 6000), (0.96, 6021)],
            [],
            [(0.5, NBINS + 5)]]
    k = max(len(r) for r in rows)
    amp = torch.zeros((len(rows), k), dtype=torch.float32)
    dist = torch.zeros((len(rows), k), dtype=torch.float32)
    captured = torch.zeros((len(rows), k), dtype=torch.bool)
    flat = []
    for i, paths in enumerate(rows):
        for j, (a, b) in enumerate(paths):
            amp[i, j], dist[i, j], captured[i, j] = a, _length(b), True
            flat.append((i, a, _length(b)))
    port = cir.rx_power_dbm_phasor(amp, dist, captured, sample_window_s=WINDOW, nbins=NBINS,
                                   light_speed_mps=C, sample_rate_hz=RATE,
                                   carrier_hz=CARRIER).double().numpy()
    row, a, d = (torch.tensor(x, dtype=dt) for x, dt in
                 zip(zip(*flat), (torch.int64, torch.float64, torch.float64)))
    want = ref_phasor.phasor_dbm(row, a, d, rows=len(rows), scale=1.0, nbins=NBINS,
                                 light_speed_mps=C, sample_rate_hz=RATE,
                                 sample_window_s=WINDOW, carrier_hz=CARRIER).numpy()
    assert np.isneginf(want[2:]).all() and np.isneginf(port[2:]).all()
    assert np.isfinite(want[:2]).all()
    np.testing.assert_allclose(port[:2], want[:2], atol=0.02, rtol=0)
    # The pair cancels: far below either path alone.
    alone = ref_phasor.phasor_dbm(row[3:4], a[3:4], d[3:4], rows=2, scale=1.0, nbins=NBINS,
                                  light_speed_mps=C, sample_rate_hz=RATE,
                                  sample_window_s=WINDOW, carrier_hz=CARRIER).numpy()
    assert want[1] < alone[1] - 20.0
    # Bins 0 and nbins - 1: |A|^2 / (2 max s_k) by hand, s_0 = hi + 1, s_last = nbins.
    hi = NBINS - 1 - (NBINS - 1) // 2
    w = 2.0 * math.pi * CARRIER * WINDOW
    s0, s1 = hi + 1, NBINS
    re = 0.7 * math.sqrt(s0) + 0.4 * math.sqrt(s1) * math.cos(w)
    im = -0.4 * math.sqrt(s1) * math.sin(w)
    assert want[0] == pytest.approx(10.0 * math.log10((re * re + im * im) / (2.0 * s1) / 1e-3),
                                    abs=1e-9)


@pytest.fixture(scope="module")
def room():
    return ref_geometry.build_scene(CONFIG["scene"])


def _grid():
    from gpubench.harness.inputs import receivers

    return receivers(WORKLOAD["cpu_rehearsal"]["traffic"]["receivers"])


def test_the_facade_s_fast_dbm_agrees_with_the_plain_reference(room):
    """Seeded directions, the CPU rehearsal's rays and its 4 x 4 x 3 grid
    of 48 receivers, the cell's limits on the gaps that decide `correct`."""
    verts, faces = room
    dirs = sphere_directions(RAYS, generator=torch.Generator().manual_seed(2**31 + 25),
                             device=torch.device("cpu"))
    grid = _grid()
    t = Tracer(TriangleMesh(verts, faces), C, RATE, WINDOW, PHYS["max_bounces"], RAYS,
               n1=PHYS["n1"], n2=PHYS["n2"], device="cpu")
    got = t.compute_coverage_dbm_fast(TX, 1.0, grid, RADIUS, carrier_hz=CARRIER, directions=dirs)
    segs = ref.env_trace(ref.RefScene(verts, faces, device="cpu"), TX, dirs,
                         bounces=PHYS["max_bounces"], n1=PHYS["n1"], n2=PHYS["n2"])
    want = ref_phasor.receiver_phasor_dbm(segs, grid, RADIUS, scale=1.0 / RAYS, nbins=NBINS,
                                          light_speed_mps=C, sample_rate_hz=RATE,
                                          sample_window_s=WINDOW, carrier_hz=CARRIER).numpy()
    assert got.shape == (48,) and np.isfinite(want).sum() >= 24
    limits = WORKLOAD["check"]["limits"]
    gaps = {"dbm_gap_db": compare.dbm_gap(got, want),
            "dbm_gap_db_mean": compare.dbm_gap_mean(got, want)}
    assert set(gaps) == set(limits)
    for name, gap in gaps.items():
        assert gap <= limits[name], (name, gap, limits[name])


@pytest.mark.parametrize("brk,correct", [((), True), (("--fault", "alter"), False)],
                         ids=["sound", "alter"])
def test_the_cell_s_cpu_rehearsal(brk, correct, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc, res, err = run_cell("--workload", CELL, "--seed", "4242424242", "--seconds", "1",
                            "--device", "cpu", *brk)
    assert rc == 0, err[-3000:]
    assert res["correct"] is correct, res["checks"]
    assert res["checks"]["compared"]["value"] > 0


FAST_WAITS = ["rfx.wait.env_tx_to_device", "rfx.wait.centers_to_device",
              "rfx.wait.scale_to_device", "rfx.wait.dbm_to_host"]


@pytest.mark.parametrize("metric", ["fast", "hybrid"])
def test_the_fast_and_hybrid_calls_record_their_spans_and_named_waits(metric, monkeypatch):
    """One call under the profiler, inside the benchmark's unit span: the
    facade's span holds every other `rfx.*` span, the centers and the dBm
    cross under named waits, and the span readers and `host_mb` read them:
    the fast call's four waits carry the tx, the centers, the amplitude
    scale and the dBm."""
    monkeypatch.setattr(profiling, "_COUNTERS", dict.fromkeys(profiling._COUNTERS, 0))
    t = Tracer(TriangleMesh(*ref_geometry.build_scene(CONFIG["scene"])), C, RATE, WINDOW,
               PHYS["max_bounces"], 1024, device="cpu")
    grid = _grid()
    call = getattr(t, f"compute_coverage_dbm_{metric}")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(UNIT):
            call(TX, 1.0, grid, RADIUS, carrier_hz=CARRIER)
    trace = collect(prof)
    spans = [h for h in trace.host if h[2].startswith("rfx.")]
    facade = [h for h in spans if h[2].startswith("rfx.api.")]
    assert [h[2] for h in facade] == [f"rfx.api.compute_coverage_dbm_{metric}"]
    a, b = facade[0][:2]
    assert all(a <= s and e <= b for s, e, _ in spans)
    waits = [h[2] for h in spans if h[2].startswith("rfx.wait.")]
    assert {"rfx.wait.centers_to_device", "rfx.wait.dbm_to_host"} <= set(waits)
    assert waits[-1] == "rfx.wait.dbm_to_host"
    assert load_metric("waits.sweep").read(trace, None) == len(waits)
    assert load_metric("wait_ms.sweep").read(trace, None) > 0
    host_bytes = load_metric("host_mb.sweep").read(trace, None) * 1e6
    m = grid.shape[0]
    if metric == "fast":
        assert waits == FAST_WAITS
        assert host_bytes == pytest.approx(4 * 3 + 4 * 3 * m + 4 + 4 * m)
    else:
        assert host_bytes >= 4 * 3 * m + 4 * m


@pytest.mark.parametrize("program,expected", [
    ("every_receiver", 100.0), ("half_the_receivers", 50.0), ("no_tally", 0.0),
    ("no_counters", None), ("no_units", None)])
def test_the_phasor_share_reads_the_receivers_the_kernel_walked(program, expected,
                                                                monkeypatch):
    """100 x rx_phasor / (receivers x traced units); 0 where the program has
    no such tally (the parent), None without counters or traced units."""
    trace = Trace(units=[(0.0, 1.0), (2.0, 3.0)], device=[], shapes={"receivers": 2048})
    counters = {"bytes_to_host": 0, "bytes_to_device": 0}
    if program == "every_receiver":
        counters["rx_phasor"] = 4096
    elif program == "half_the_receivers":
        counters["rx_phasor"] = 2048
    elif program == "no_units":
        trace.units = []
    monkeypatch.setattr(profiling, "_COUNTERS", counters)
    if program == "no_counters":
        monkeypatch.delattr(profiling, "counters")
    assert load_metric("phasor_pct.sweep").read(trace, None) == expected


def test_kf_roofline_reads_the_forward_phasor_kernels_alone():
    """The bound of the reference's live segments over the device time a
    sweep of the five forward kernels; the backward's kernels and another
    kernel are not counted, and a trace without the counts reads None."""
    names = ["(anonymous namespace)::phasor_table_kernel(int, float, float, float4*)",
             "(anonymous namespace)::coverage_phasor_kernel(float const*)",
             "(anonymous namespace)::phasor_reduce_kernel(float const*)",
             "(anonymous namespace)::coverage_phasor_rewalk_kernel(float const*)",
             "(anonymous namespace)::phasor_spread_kernel(int, int)"]
    others = ["void (anonymous namespace)::coverage_phasor_backward_kernel<2>(float const*)",
              "(anonymous namespace)::phasor_live_count(bool const*)",
              "(anonymous namespace)::brute_hit_kernel(float const*)"]
    device = []
    for u in (0.0, 10.0):
        device += [(u + 0.1 * i, u + 0.1 * i + 0.05, n) for i, n in enumerate(names)]
        device += [(u + 1.0 + i, u + 1.5 + i, n) for i, n in enumerate(others)]
    shapes = {"rays": 1 << 20, "bounces": 2, "receivers": 2048}
    trace = Trace(units=[(0.0, 5.0), (10.0, 15.0)], device=device,
                  counts={"live_segments": 1.5e6}, shapes=shapes)
    want = 100.0 * bound_s(*kf_work(live_segments=1.5e6, segments=2 << 20,
                                    receivers=2048)) / (5 * 0.05)
    assert load_metric("kf_roofline_pct").read(trace, None) == pytest.approx(want)
    assert kf_work(live_segments=1.5e6, segments=2 << 20, receivers=2048) == (
        (2 << 20) * 37 + 2048 * 24, 1.5e6 * 2048 * 17)
    trace.counts = {}
    assert load_metric("kf_roofline_pct").read(trace, None) is None
