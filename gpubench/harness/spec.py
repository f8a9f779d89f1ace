"""Find a cell's files by the names in `BENCHMARK.json`.

- `configs/<config>.json`: the scene, the physics, `source`, `assumed`,
  `reduced`;
- `traffic/<traffic>.json`: the parameters the general generator
  (`harness.inputs`) reads;
- `workloads/<cell>.json`: the driver (`drivers/<driver>.py`), the traced
  units, the output check's sample and its limits, and the CPU rehearsal's
  sizes;
- `metrics/<metric>.py`: the reader of one per-layer metric; a metric
  `<quantity>.<kind>` without a file of its own is read by
  `metrics/<quantity>.py`.

A later cell, configuration or metric is new files and new entries; nothing
here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BENCH_DIR", "ROOT", "CellSpec", "load_cell", "load_metric", "metric_names"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class CellSpec:
    name: str
    entry: dict  # the cell's entry of BENCHMARK.json
    config: dict
    traffic: dict
    workload: dict
    benchmark: dict

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def end_to_end(self) -> list[dict]:
        return [m for m in self.benchmark["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.benchmark["per_layer"]:
            if (self.name in m["workloads"]) if "workloads" in m else (m["moves"] in mine):
                out.append(m)
        return out


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> CellSpec:
    benchmark = _json(bench_dir.parent / "BENCHMARK.json")
    entries = [w for w in benchmark["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = _json(bench_dir / "workloads" / f"{name}.json")
    config = _json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return CellSpec(name, entry, config, traffic, workload, benchmark)


def load_driver(spec: CellSpec):
    return importlib.import_module(f"gpubench.drivers.{spec.workload['driver']}")


def metric_names(bench_dir: Path = BENCH_DIR) -> list[str]:
    return sorted(p.name[:-3] for p in (bench_dir / "metrics").glob("*.py"))


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    """The module of `metrics/<name>.py`, or of `metrics/<quantity>.py` for a
    name `<quantity>.<kind>` that has no file of its own (its
    `read(trace, cell)` returns the value, or None where the run has nothing
    to read)."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        path = bench_dir / "metrics" / f"{name.split('.')[0]}.py"
    mod_name = "gpubench.metrics." + name.replace(".", "_")
    loader = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod
