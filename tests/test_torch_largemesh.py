"""The large-mesh configuration on the CPU: a 100,352-triangle terrain, just
above `NATIVE_MIN_FACES`, through the facade as the benchmark's
`cir.largemesh.analytic` drives it. The facade takes the native BVH builder,
and its CIR and dBm agree with the benchmark's plain float64 reference
(`gpubench/reference/trace.py`) under the cell's own limits; the cell's CPU
rehearsal ends correct and refuses its `alter` fault; the BVH set-up's spans
and gauges are recorded and read back by the benchmark's readers. No JAX."""

import json
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpubench.harness import compare
from gpubench.harness.spec import load_metric
from gpubench.reference import geometry as ref_geometry
from gpubench.reference import trace as ref
from gpubench.reference.sampler import sphere_directions
from gpubench.tests.conftest import ROOT, run_cell
from rfx_torch import bvh
from rfx_torch.api import Tracer
from rfx_torch.geometry import TriangleMesh, make_terrain
from rfx_torch.ops import native_lib
from rfx_torch.utils import profiling

torch.set_num_threads(1)

CELL = "cir.largemesh.analytic"
WORKLOAD = json.loads((ROOT / "gpubench" / "workloads" / f"{CELL}.json").read_text())
CONFIG = json.loads((ROOT / "gpubench" / "configs" / "ref_main_largemesh.json").read_text())
SCENE = WORKLOAD["cpu_rehearsal"]["config"]["scene"]  # grid 225: 100,352 faces
PHYS = CONFIG["physics"]
RAYS, RADIUS, TX = 4096, 3.0, (10.0, 0.0, 25.0)
RX = np.array([[-20.0, -20.0, 8.0], [0.0, 5.0, 8.0], [12.0, -8.0, 8.0], [20.0, 20.0, 8.0]],
              np.float32)
GAUGES = ("bvh_build_s", "bvh_native", "bvh_table_bytes")


@pytest.fixture(scope="module")
def scene():
    verts, faces = ref_geometry.build_scene(SCENE)
    assert faces.shape[0] == 100_352 > bvh.NATIVE_MIN_FACES
    return verts, faces


@pytest.fixture
def native():
    if not native_lib.native_available():
        pytest.skip(f"no native BVH builder here: {native_lib.unavailable_reason()}")


def _tracer(verts, faces, **kw):
    return Tracer(TriangleMesh(verts, faces), PHYS["light_speed_mps"], PHYS["sample_rate_hz"],
                  PHYS["sample_window_s"], PHYS["max_bounces"], RAYS, n1=PHYS["n1"],
                  n2=PHYS["n2"], device="cpu", **kw)


def test_the_facade_builds_the_large_terrain_s_tree_natively(scene, native, monkeypatch):
    monkeypatch.setattr(profiling, "_GAUGES", {})
    _tracer(*scene)
    c = profiling.counters()
    assert c["bvh_native"] == 1
    assert c["bvh_build_s"] > 0 and c["bvh_table_bytes"] > 0


def test_the_facade_s_cir_and_dbm_agree_with_the_plain_reference(scene, native):
    """Seeded directions, four receivers on the cell's grid, the cell's
    limits on the gaps that decide `correct`."""
    verts, faces = scene
    gen = torch.Generator().manual_seed(2**31 + 11)
    dirs = sphere_directions(RAYS, generator=gen, device=torch.device("cpu"))
    t = _tracer(verts, faces)
    got = [t.compute_cir(TX, 1.0, tuple(rx), RADIUS, directions=dirs, record_paths=False)[1]
           for rx in RX]
    got_dbm = np.array([t.rx_power_dbm(ir, 2.4e9) for ir in got])
    rscene = ref.RefScene(verts, faces, device="cpu", columns=CONFIG["reference_columns"])
    segs = ref.env_trace(rscene, TX, dirs, bounces=PHYS["max_bounces"], n1=PHYS["n1"],
                         n2=PHYS["n2"])
    irs, _ = ref.receiver_irs(segs, RX, RADIUS, rx_mode="analytic", scale=1.0 / RAYS,
                              nbins=PHYS["nbins"], light_speed_mps=PHYS["light_speed_mps"],
                              sample_rate_hz=PHYS["sample_rate_hz"])
    want_dbm = ref.rx_power_dbm(irs, PHYS["sample_window_s"], 2.4e9).numpy()
    irs = irs.numpy()
    assert (irs != 0).any(axis=1).sum() >= 3  # the receivers catch paths
    limits, width = WORKLOAD["check"]["limits"], WORKLOAD["check"]["pool_bins"]
    gaps = {
        "dbm_gap_db": compare.dbm_gap(got_dbm, want_dbm),
        "dbm_gap_db_mean": compare.dbm_gap_mean(got_dbm, want_dbm),
        "ir_pooled_l1": compare.pooled_l1(np.stack(got), irs, width),
        "ir_sum_gap": compare.sum_gap(np.stack(got), irs),
        "ir_sum_gap_mean": compare.sum_gap_mean(np.stack(got), irs),
        "ir_support_gap_mean": compare.support_gap_mean(np.stack(got), irs, width),
    }
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


def test_a_tracer_s_set_up_records_the_bvh_spans_and_sets_the_gauges(monkeypatch):
    mesh = make_terrain(grid=24, extent=30.0, seed=2)
    monkeypatch.setattr(profiling, "_GAUGES", {})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = Tracer(mesh, 2.998e8, 100e9, 20e-9, 2, 1024, backend="fused", device="cpu")
    names = [e.name for e in prof.events() if e.name.startswith("rfx.bvh.")]
    assert names == ["rfx.bvh.build", "rfx.bvh.pack"]
    packed = t._fused.bvh
    c = profiling.counters()
    assert c["bvh_table_bytes"] == (packed.nodes.nbytes + packed.tri.nbytes
                                    + packed.tri_face.nbytes)
    assert c["bvh_native"] == 0 and c["bvh_build_s"] > 0


@pytest.mark.parametrize("backend", ["fused", "bvh"])
def test_the_gauges_are_set_with_no_profiler_recording(backend, monkeypatch):
    monkeypatch.setattr(profiling, "_GAUGES", {})
    before = {k: v for k, v in profiling.counters().items() if k.startswith("bytes_")}
    Tracer(make_terrain(grid=24, extent=30.0, seed=2), 2.998e8, 100e9, 20e-9, 2, 1024,
           backend=backend, device="cpu")
    c = profiling.counters()
    assert set(GAUGES) <= set(c)
    assert c["bvh_native"] == 0 and c["bvh_build_s"] > 0 and c["bvh_table_bytes"] > 0
    # The tallies count only while a profiler records: set-up moves none.
    assert {k: v for k, v in c.items() if k.startswith("bytes_")} == before


def test_a_brute_tracer_builds_no_bvh(monkeypatch):
    monkeypatch.setattr(profiling, "_GAUGES", {})
    Tracer(make_terrain(grid=8, extent=30.0, seed=2), 2.998e8, 100e9, 20e-9, 2, 1024,
           device="cpu")
    assert not set(GAUGES) & set(profiling.counters())


def test_the_readers_return_the_gauges(monkeypatch):
    monkeypatch.setattr(profiling, "_GAUGES", {"bvh_build_s": 0.875, "bvh_native": 1,
                                               "bvh_table_bytes": 81_737_728})
    assert load_metric("bvh_table_mb").read(None, None) == pytest.approx(81.737728)
    assert load_metric("bvh_build_s").read(None, None) == 0.875


@pytest.mark.parametrize("metric", ["bvh_table_mb", "bvh_build_s"])
def test_a_reader_returns_none_where_the_counters_lack_its_gauge(metric, monkeypatch):
    monkeypatch.setattr(profiling, "_GAUGES", {})
    assert load_metric(metric).read(None, None) is None
    monkeypatch.delattr(profiling, "counters")
    assert load_metric(metric).read(None, None) is None


def test_auto_s_numpy_fallback_warns_with_the_face_count(monkeypatch):
    """Where the native builder is missing, `auto` builds with numpy and
    says how many faces and that it is slow; the tree is the numpy one."""
    mesh = make_terrain(grid=12, extent=30.0, seed=2)
    monkeypatch.setattr(bvh, "NATIVE_MIN_FACES", 100)
    monkeypatch.setattr(native_lib, "native_available", lambda: False)
    monkeypatch.setattr(native_lib, "unavailable_reason", lambda: "g++ not found")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("rfx_torch.bvh")
    logger.addHandler(handler)
    try:
        flat = bvh.build_bvh(mesh, leaf_size=8)
    finally:
        logger.removeHandler(handler)
    msg = " ".join(r.getMessage() for r in records if r.levelno == logging.WARNING)
    assert f"{mesh.num_faces} faces" in msg and "slow" in msg and "g++ not found" in msg
    want = bvh.build_bvh(mesh, leaf_size=8, method="numpy")
    assert np.array_equal(flat.skip, want.skip) and np.array_equal(flat.tri_face, want.tri_face)
    assert profiling.counters()["bvh_native"] == 0


def test_the_configuration_is_the_terrain_s_request_at_full_size():
    """The large mesh keeps `ref_main_terrain`'s physics word for word and
    cuts nothing; its reference columns hold as many triangles as there."""
    small = json.loads((ROOT / "gpubench" / "configs" / "ref_main_terrain.json").read_text())
    assert CONFIG["physics"] == small["physics"] and CONFIG["reduced"] == []
    for key in ("deployment", "guarantees", "precision"):
        assert CONFIG[key] == small[key]
    # The request is main.py's, as there; the configuration's own source is
    # the scene it is sized to, so the two configurations name distinct sources.
    assert CONFIG["request_source"] == small["source"] != CONFIG["source"]
    assert CONFIG["source"].endswith("/models/apollo_17_landing_site.stl")
    sizes = {}
    for cfg in (small, CONFIG):
        verts, faces = ref_geometry.build_scene(cfg["scene"])
        sizes[cfg["name"]] = faces.shape[0], ref.RefScene(
            verts, faces, device="cpu", columns=cfg["reference_columns"]).table.shape[1]
    assert sizes["ref_main_largemesh"] == (1_045_458, sizes["ref_main_terrain"][1])
