"""The harness finds its files by name, rehearses every cell on the CPU to
the contract's last line, and loads nothing of JAX or of `rfx`."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from gpubench.tests.conftest import ROOT, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_every_name_has_its_file():
    from gpubench.harness.spec import load_cell, load_driver, load_metric

    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for name in CELLS:
        spec = load_cell(name)
        assert spec.config["name"] == spec.entry["config"]
        assert hasattr(load_driver(spec), "Cell")
        assert spec.end_to_end() and spec.per_layer()
    for m in BENCH["per_layer"]:
        assert callable(load_metric(m["name"]).read)


def test_a_new_cell_and_metric_are_files_and_entries_only(tmp_path):
    """A throwaway workload and metric added to a copy are found by name."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    first = bench["workloads"][0]
    bench["workloads"].append({**first, "name": "throwaway.cell", "traffic": "throwaway.mix"})
    bench["per_layer"].append({"name": "throwaway_metric", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "api",
                               "moves": "setup_s", "workloads": ["throwaway.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    g = tmp_path / "gpubench"
    (g / "traffic" / "throwaway.mix.json").write_text(
        (g / "traffic" / f"{first['traffic']}.json").read_text())
    (g / "workloads" / "throwaway.cell.json").write_text(
        (g / "workloads" / f"{first['name']}.json").read_text())
    (g / "metrics" / "throwaway_metric.py").write_text("def read(trace, spec):\n    return 42.0\n")
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from gpubench.harness.spec import load_cell, load_metric;"
            "s = load_cell('throwaway.cell');"
            "print([m['name'] for m in s.per_layer()], load_metric('throwaway_metric').read(None, s))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, check=True, cwd=tmp_path).stdout
    assert "throwaway_metric" in out and "42.0" in out


def test_a_kind_of_a_quantity_is_read_by_the_quantity_s_own_reader():
    """`idle_pct.<kind>` without a file of its own is read by `idle_pct.py`;
    a name with a file of its own keeps it."""
    from pathlib import Path

    from gpubench.harness.spec import load_metric

    assert Path(load_metric("idle_pct.some_later_kind").__file__).name == "idle_pct.py"
    assert Path(load_metric("k1_roofline_pct").__file__).name == "k1_roofline_pct.py"


def test_the_schedule_takes_every_pair_of_a_set_and_a_receiver():
    """Every S x M units take each (direction set, receiver) pair once, so the
    check's sets meet every receiver."""
    from gpubench.harness.inputs import Schedule

    sch = Schedule({"direction_sets": 8, "rx_order": "seeded_permutation"}, 2**33 + 5, 64)
    pairs = [(sch.set_of(k), sch.rx_of(k)) for k in range(8 * 64)]
    assert len(set(pairs)) == 8 * 64


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_rehearsal_prints_the_result_line(cell, trace):
    rc, res, err = run_cell("--workload", cell, "--seed", str(2**31 + 7), "--seconds", "1",
                            "--trace", str(trace), "--device", "cpu")
    assert rc == 0, err[-3000:]
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["compared"]["value"] > 0
    spec_names = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    if not trace:
        assert set(res["metrics"]) == spec_names
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert err.strip().splitlines()[-1].startswith("check compared")


def test_nothing_the_benchmark_imports_is_jax_or_rfx():
    """Every module of gpubench and the port imported in one process: no
    top-level name is jax, jaxlib, flax or rfx (whole names: rfx_torch
    starts with rfx)."""
    mods = [p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
            for p in (ROOT / "gpubench").rglob("*.py")
            if "tests" not in p.parts and p.name != "__init__.py" and p.parent.name != "metrics"]
    code = ("import sys, importlib, json; sys.path.insert(0, sys.argv[1]);"
            "[importlib.import_module(m) for m in json.loads(sys.argv[2])];"
            "from gpubench.harness.spec import load_metric, metric_names;"
            "[load_metric(n) for n in metric_names()];"
            "import rfx_torch.api, rfx_torch.solver, rfx_torch.coverage;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), json.dumps(mods)],
                         capture_output=True, text=True, check=True, cwd=ROOT).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert "rfx_torch" in top and "gpubench" in top
    assert not top & {"jax", "jaxlib", "flax", "rfx"}, top & {"jax", "jaxlib", "flax", "rfx"}


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("rfx_torch", "rfx", "jax", "jaxlib", "flax"), \
                    f"{path.name} imports {n}"
    code = ("import sys, importlib; sys.path.insert(0, sys.argv[1]);"
            "[importlib.import_module('gpubench.reference.' + m) for m in"
            " ('geometry', 'sampler', 'trace', 'counts', 'peaks')];"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('rfx_torch', 'rfx', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"


def test_the_driver_refuses_to_run_without_a_card_or_the_program(tmp_path):
    """Without a card, or in a directory that holds only BENCHMARK.json and the
    benchmark, a run exits non-zero and prints no result."""
    import torch

    if not torch.cuda.is_available():
        rc, res, _ = run_cell("--workload", CELLS[0], "--seed", "1", "--seconds", "1")
        assert rc != 0 and res is None
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    rc, res, _ = run_cell("--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--device",
                          "cpu", root=tmp_path)
    assert rc != 0 and res is None
