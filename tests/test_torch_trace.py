"""The port's spans and counters (rfx_torch.utils.profiling) on the CPU: the
facade's calls open exactly the documented spans, each under its facade
span; the benchmark's trace reader keeps them as host operators; the
counters count a wait's payload while a profiler records and nothing
otherwise; the benchmark's readers of the spans give hand-computed values on
a synthetic trace; and every kernel name a reader matches is a kernel of the
port's CUDA sources."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gpubench.harness.profile import UNIT, Trace, collect
from gpubench.harness.spec import load_metric
from rfx_torch.api import Tracer
from rfx_torch.geometry import make_room, make_terrain
from rfx_torch.ops.coverage_hist import coverage_hist
from rfx_torch.tracer import Scene, trace_env
from rfx_torch.utils import profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

TX, RX = (0.0, 0.0, 12.0), (3.0, 2.0, 5.0)

RX_POWER = {"rfx.api.rx_power_dbm", "rfx.wait.ir_to_device", "rfx.cir.rx_power",
            "rfx.wait.carrier_window_to_device", "rfx.wait.carrier_steps_to_device",
            "rfx.wait.dbm_to_host"}
CIR = {"rfx.api.compute_cir", "rfx.tracer.scan", "rfx.wait.rx_to_device",
       "rfx.wait.tx_to_device", "rfx.wait.scale_to_device", "rfx.cir.histogram",
       "rfx.wait.ir_to_host"}
SPANS = {
    "analytic": CIR | RX_POWER,
    "icosphere": CIR | RX_POWER | {"rfx.wait.ico_to_device", "rfx.wait.ico_radius_to_device",
                                   "rfx.wait.cull_radius_to_device", "rfx.ops.rx_hit"},
    "sweep": RX_POWER | {"rfx.api.compute_coverage", "rfx.tracer.env",
                         "rfx.wait.env_tx_to_device", "rfx.ops.env_hit",
                         "rfx.wait.centers_to_device", "rfx.wait.irs_to_host"},
}


def _request(unit):
    """One unit of a benchmark cell at a CPU size: a CIR request on the
    terrain (the `bvh` backend) or a sweep of the room, then its dBm."""
    if unit == "sweep":
        t = Tracer(make_room(), 2.998e8, 100e9, 50e-9, 2, 1024, device="cpu")
        centers = np.array([[0.0, 0.0, 2.0], [1.0, 1.0, 3.0]], np.float32)
        return lambda: t.rx_power_dbm(t.compute_coverage((3.0, 2.0, 2.0), 1.0, centers, 0.5))
    t = Tracer(make_terrain(grid=12, extent=30.0, seed=1), 2.998e8, 100e9, 20e-9, 3, 1024,
               rx_mode=unit, backend="bvh", device="cpu")
    return lambda: t.rx_power_dbm(t.compute_cir(TX, 1.0, RX, 1.0, record_paths=False)[1])


def _rfx_events(prof):
    return [e for e in prof.events() if e.name.startswith("rfx.")]


@pytest.mark.parametrize("unit", ["analytic", "icosphere", "sweep"])
def test_a_unit_opens_the_documented_spans_under_its_facade_span(unit):
    request = _request(unit)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        request()
    events = _rfx_events(prof)
    assert {e.name for e in events} == SPANS[unit]
    for e in events:
        chain, p = [], e.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        if e.name.startswith("rfx.api."):
            assert not any(n.startswith("rfx.") for n in chain), (e.name, chain)
        else:
            assert any(n.startswith("rfx.api.") for n in chain), (e.name, chain)
        assert not e.is_user_annotation


def test_the_coverage_kernel_s_wrapper_opens_its_span():
    """The batched engine runs only on a card; its wrapper's span opens on
    the plain version too."""
    scene = Scene.from_mesh(make_room(), "cpu")
    dirs = torch.nn.functional.normalize(torch.randn(256, 3, generator=torch.Generator()
                                                     .manual_seed(3)), dim=1)
    segs = trace_env(scene, (3.0, 2.0, 2.0), dirs, max_bounces=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        coverage_hist(segs, np.array([[0.0, 0.0, 2.0]], np.float32), 0.5, nbins=64,
                      light_speed_mps=2.998e8, sample_rate_hz=10e9)
    assert [e.name for e in _rfx_events(prof)] == ["rfx.coverage.hist"]


def test_the_benchmark_reader_keeps_the_spans_on_the_host():
    request = _request("icosphere")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(UNIT):
            request()
    trace = collect(prof)
    assert len(trace.units) == 1
    names = {h[2] for h in trace.host if h[2].startswith("rfx.")}
    assert names == SPANS["icosphere"]
    a, b = trace.units[0]
    assert all(a <= h[0] and h[1] <= b for h in trace.host if h[2].startswith("rfx."))
    assert not [d for d in trace.device if d[2].startswith("rfx.")]


def test_counters_count_a_wait_s_payload_only_while_a_profiler_records():
    t = Tracer(make_terrain(grid=12, extent=30.0, seed=1), 2.998e8, 100e9, 20e-9, 3, 1024,
               backend="bvh", device="cpu")
    before = profiling.counters()
    _, ir = t.compute_cir(TX, 1.0, RX, 1.0, record_paths=False)
    assert profiling.counters() == before
    with profile(activities=[ProfilerActivity.CPU]):
        _, ir = t.compute_cir(TX, 1.0, RX, 1.0, record_paths=False)
    after = profiling.counters()
    assert ir.nbytes == 2000 * 4
    # ir_to_host is the request's one copy to the host; to the card go rx,
    # tx (3 floats each) and the amplitude scale.
    assert after["bytes_to_host"] - before["bytes_to_host"] == ir.nbytes
    assert after["bytes_to_device"] - before["bytes_to_device"] == 4 * (3 + 3 + 1)
    x = torch.ones(5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.to_host("probe", x)
    assert profiling.counters()["bytes_to_host"] - after["bytes_to_host"] == x.nbytes
    assert [e.name for e in _rfx_events(prof)] == ["rfx.wait.probe"]


@pytest.mark.parametrize("numel", [5, (1 << 18) + 3])
def test_to_host_of_a_cpu_tensor_is_counted_and_never_page_locked(numel):
    """Under and over `PINNED_MIN_BYTES`: a CPU tensor stays where it is."""
    x = torch.arange(numel, dtype=torch.float32)
    assert (x.nbytes >= profiling.PINNED_MIN_BYTES) == (numel > 5)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = profiling.to_host("probe", x)
    moved = {k: v - before[k] for k, v in profiling.counters().items() if k.startswith("bytes_")}
    assert torch.equal(out, x)
    assert moved == {"bytes_to_host": x.nbytes, "bytes_to_device": 0,
                     "bytes_pinned_to_host": 0, "bytes_pinned_to_device": 0}


@pytest.mark.parametrize("numel", [6, (1 << 18) + 3])
def test_to_device_on_a_cpu_device_never_asks_whether_memory_is_page_locked(numel,
                                                                             monkeypatch):
    def refuse(self, *args, **kwargs):
        raise AssertionError("is_pinned asked for a CPU device")

    monkeypatch.setattr(torch.Tensor, "is_pinned", refuse)
    a = np.arange(numel, dtype=np.float32)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = profiling.to_device("probe", a, torch.device("cpu"))
    moved = {k: v - before[k] for k, v in profiling.counters().items() if k.startswith("bytes_")}
    assert np.array_equal(out.numpy(), a)
    assert moved == {"bytes_to_host": 0, "bytes_to_device": a.nbytes,
                     "bytes_pinned_to_host": 0, "bytes_pinned_to_device": 0}


def test_span_takes_the_fast_record_function_where_torch_has_it():
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        pytest.skip("this torch has no _RecordFunctionFast")
    assert isinstance(profiling.span("rfx.x"), fast)


def _synthetic_trace():
    """Two units of 10 s. Unit 1: a scan tracer span of 1-6 s holding an
    rx_hit of 2-3 s and a wait of 3.5-4 s, then a wait of 6.5-8 s outside the
    tracer and one of 7-9 s that overlaps it; unit 2: a fused tracer span of
    21-22 s. A wait between the units and an operator are not read."""
    host = [(0.5, 9.5, "rfx.api.compute_cir"), (1.0, 6.0, "rfx.tracer.scan"),
            (2.0, 3.0, "rfx.ops.rx_hit"), (2.1, 2.9, "aten::mul"),
            (3.5, 4.0, "rfx.wait.tx_to_device"), (6.5, 8.0, "rfx.wait.ir_to_host"),
            (7.0, 9.0, "rfx.wait.ir_to_device"), (12.0, 13.0, "rfx.wait.outside"),
            (21.0, 22.0, "rfx.tracer.fused")]
    return Trace(units=[(0.0, 10.0), (20.0, 30.0)], device=[(1.0, 2.0, "k")], host=host)


@pytest.mark.parametrize("kind", ["cir", "sweep"])
def test_span_readers_on_a_synthetic_trace(kind, monkeypatch):
    trace = _synthetic_trace()
    read = lambda q: load_metric(f"{q}.{kind}").read(trace, None)  # noqa: E731
    assert read("waits") == pytest.approx(3 / 2)
    # The union of the waits: 0.5 + (6.5..9) = 3.0 s over two units.
    assert read("wait_ms") == pytest.approx(3.0 / 2 * 1e3)
    # Tracers 5 + 1 s, less the rx_hit (1 s) and the wait (0.5 s) inside.
    assert read("tracer_self_ms") == pytest.approx(4.5 / 2 * 1e3)
    monkeypatch.setattr(profiling, "_COUNTERS", {"bytes_to_host": 3_000_000,
                                                 "bytes_to_device": 1_000_000,
                                                 "bytes_pinned_to_host": 2_000_000,
                                                 "bytes_pinned_to_device": 0})
    assert read("host_mb") == pytest.approx(2.0)


def test_pinned_share_reads_the_page_locked_bytes_of_all_through_the_host(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTERS", {"bytes_to_host": 3_000_000,
                                                 "bytes_to_device": 1_000_000,
                                                 "bytes_pinned_to_host": 2_000_000,
                                                 "bytes_pinned_to_device": 0})
    assert load_metric("pinned_pct.sweep").read(_synthetic_trace(), None) == pytest.approx(50.0)


@pytest.mark.parametrize("program", ["counters_without_pinned_keys", "no_counters", "no_units"])
def test_pinned_share_reads_nothing_where_the_program_or_trace_has_nothing(program,
                                                                            monkeypatch):
    trace = _synthetic_trace()
    if program == "counters_without_pinned_keys":
        monkeypatch.setattr(profiling, "_COUNTERS", {"bytes_to_host": 3_000_000,
                                                     "bytes_to_device": 1_000_000})
    elif program == "no_counters":
        monkeypatch.delattr(profiling, "counters")
    else:
        trace.units = []
    assert load_metric("pinned_pct.sweep").read(trace, None) is None


def test_span_readers_read_nothing_without_the_program_s_spans(monkeypatch):
    trace = _synthetic_trace()
    trace.host = [h for h in trace.host if not h[2].startswith("rfx.")]
    for q in ("waits", "wait_ms", "tracer_self_ms"):
        assert load_metric(f"{q}.cir").read(trace, None) is None
    monkeypatch.delattr(profiling, "counters")
    assert load_metric("host_mb.cir").read(trace, None) is None


def test_every_kernel_a_reader_matches_is_a_kernel_of_the_port():
    """A kernel renamed in the CUDA sources would leave its roofline's reader
    with nothing to read: the names the readers match are pinned here."""
    matched = set()
    for path in (ROOT / "gpubench" / "metrics").glob("*.py"):
        matched |= set(re.findall(r"[\"'](\w+_kernel)[\"']", path.read_text()))
    assert {"fused_trace_kernel", "coverage_hist_kernel", "coverage_reduce_kernel"} <= matched
    sources = "\n".join(p.read_text() for p in (ROOT / "rfx_torch" / "csrc").glob("*.cu*"))
    for name in sorted(matched):
        assert re.search(r"__global__\s+void\s+(__launch_bounds__\([^)]*\)\s*)?" + name
                         + r"\s*\(", sources), name
