"""The port's command line (rfx_torch.cli) with --device cpu, mirroring
tests/test_aux.py:84-172 for rfx.cli: the cir smoke, the chunked resume with
an identical dBm and the profile report; the coverage sweep with each metric
against the facade; and the profiling helpers."""

import json
import os
import time

import numpy as np
import pytest
import torch

from rfx_torch.config import CoverageConfig, resolve_scene
from rfx_torch.api import Tracer
from rfx_torch.cli import main
from rfx_torch.utils.profiling import PhaseTimer, block_until_ready

torch.set_num_threads(1)

CIR_ARGS = ["cir", "--scene", "room", "--bounces", "2", "--tx", "5", "5", "2",
            "--rx", "-5", "-5", "2", "--rx-radius", "1.5", "--device", "cpu"]


def _dbm_lines(text):
    return [line.split("RX power:")[1] for line in text.splitlines() if "RX power" in line]


def test_cli_cir_smoke(tmp_path, capsys):
    out = str(tmp_path / "scene.html")
    assert main(CIR_ARGS + ["--rays", "2000", "--out", out]) == 0
    assert os.path.exists(out)
    text = capsys.readouterr().out
    assert "RX power" in text and "dBm" in text


def test_cli_cir_chunked_resume(tmp_path, capsys):
    """--chunks N accumulates partial IRs with checkpointed resume: a second
    run re-reads the chunk state and recomputes nothing; a run without the
    state redraws each chunk's directions from (seed, chunk) and gets the
    same dBm."""
    out = str(tmp_path / "scene.html")
    resume = str(tmp_path / "chunks")
    argv = CIR_ARGS + ["--rays", "2048", "--out", out, "--chunks", "2", "--resume-dir", resume,
                       "--no-viz"]
    assert main(argv) == 0
    meta = json.load(open(os.path.join(resume, "meta.json")))
    assert meta["done"] == [0, 1]
    first = _dbm_lines(capsys.readouterr().out)
    assert main(argv) == 0
    second = _dbm_lines(capsys.readouterr().out)
    assert main(argv[:-2] + [str(tmp_path / "fresh"), "--no-viz"]) == 0
    fresh = _dbm_lines(capsys.readouterr().out)
    assert len(first) == 1 and first == second == fresh


def test_cli_cir_profile_report(tmp_path, capsys):
    out = str(tmp_path / "scene.html")
    prof = str(tmp_path / "prof")
    assert main(CIR_ARGS + ["--rays", "1024", "--out", out, "--profile", prof]) == 0
    text = capsys.readouterr().out
    assert "profiler trace written" in text
    assert "trace:" in text and "viz-trace:" in text  # PhaseTimer report
    trace = os.path.join(prof, "trace.json")
    assert os.path.isfile(trace) and json.load(open(trace))["traceEvents"]


def test_cli_bvh_backend_gives_the_brute_backend_dbm(capsys):
    """--backend bvh runs the plain stackless walk under the scan tracer: the
    same dBm line as --backend brute on the same seed's directions."""
    lines = []
    for backend in ("bvh", "brute"):
        assert main(CIR_ARGS + ["--rays", "2048", "--backend", backend, "--no-viz"]) == 0
        lines += _dbm_lines(capsys.readouterr().out)
    assert len(lines) == 2
    dbm = [float(line.split()[0]) for line in lines]
    assert np.isfinite(dbm).all() and abs(dbm[0] - dbm[1]) < 1e-3, lines
    with pytest.raises(SystemExit):
        main(CIR_ARGS + ["--rays", "64", "--backend", "pallas", "--no-viz"])


@pytest.mark.parametrize("metric", ["exact", "fast", "hybrid"])
def test_cli_coverage_metric_saves_dbm(tmp_path, capsys, metric):
    """A 50-receiver room sweep from a config file; the saved dBm equals the
    facade's for the same seed."""
    cfg = CoverageConfig(scene="room", num_rays=4096, rx_radius=1.0, sample_rate_hz=10e9,
                         tx_pos=(3.0, 2.0, 2.0), grid_x=(-12.0, 12.0, 6.0),
                         grid_y=(-12.0, 12.0, 6.0), grid_z=(2.0, 8.0, 6.0), seed=4)
    path = tmp_path / "cov.json"
    path.write_text(cfg.to_json())
    save = str(tmp_path / "dbm.npy")
    argv = ["coverage", "--config", str(path), "--metric", metric, "--no-viz", "--save-dbm",
            save, "--device", "cpu"]
    assert main(argv) == 0
    text = capsys.readouterr().out
    assert "coverage: 50 receivers" in text and f"wrote {save}" in text
    rows = np.load(save)
    grid = cfg.grid_points()
    assert rows.shape == (50, 4)
    np.testing.assert_array_equal(rows[:, :3], grid)
    assert np.isfinite(rows[:, 3]).sum() > 25

    t = Tracer(resolve_scene("room"), cfg.light_speed_mps, cfg.sample_rate_hz,
               cfg.sample_window_s, cfg.max_bounces, cfg.num_rays, seed=cfg.seed, device="cpu")
    request = (cfg.tx_pos, cfg.tx_power, grid, cfg.rx_radius)
    if metric == "exact":
        want = t.rx_power_dbm(t.compute_coverage(*request))
    elif metric == "fast":
        want = t.compute_coverage_dbm_fast(*request)
    else:
        want, n_flagged = t.compute_coverage_dbm_hybrid(*request)
        assert f"hybrid: {n_flagged} cancellation-flagged" in text
    np.testing.assert_array_equal(rows[:, 3], want.astype(np.float32))


def test_phase_timer_and_throughput():
    t = PhaseTimer()
    x = torch.ones(16)
    with t.phase("a", block_on={"y": [x * 2, (x, 3)]}):
        time.sleep(0.01)
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert t.totals["a"] >= 0.01
    rep = t.report()
    assert "a:" in rep and "x2" in rep
    assert block_until_ready(x) is x
