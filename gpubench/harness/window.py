"""One run of one cell: set-up, the measured window, the output check and
the result line.

The run's steps, in order:

1. look for the cards the cell asks for (not with `--device cpu`, the CPU
   rehearsal), load its driver and let it build its inputs and the program
   and warm up every shape the traffic uses: `setup_s` runs from process start
   to here;
2. the window: units (requests, sweeps, steps) back to back from one caller
   for `--seconds` seconds, each timed on the host's clock from its call to
   its answer on the host; a unit that raises counts as failed; with
   `--trace 1` the first `trace_units` units run under `torch.profiler`;
3. the device's peak memory, then the program's state is freed and the
   driver compares what the window answered with the plain reference;
4. the check's numbers, each beside its limit, as the last lines of standard
   error, and one JSON line as the last line of standard output, with the
   numbers again under `checks`, its last key.

No JAX may be loaded: a run whose process holds `jax`, `jaxlib`, `flax` or
`rfx` (compared by whole top-level name) after the window prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import traceback

from gpubench.harness import profile as prof_mod
from gpubench.harness.spec import load_cell, load_driver, load_metric

__all__ = ["run", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "rfx")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    power = ""
    try:
        power = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        power = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": power.splitlines()[0] if power else "unknown"}


def _fail(msg: str) -> int:
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)
    return 2


def run(args, t_start: float) -> int:
    spec = load_cell(args.workload)
    import torch

    if args.device == "cuda":
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
            return _fail(f"needs {spec.chips} CUDA card(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    try:
        import rfx_torch  # noqa: F401  (the program under test)
    except ImportError as exc:
        return _fail(f"the program rfx_torch is not importable here: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    driver = load_driver(spec)
    cell = driver.Cell(spec, seed=args.seed, device=device, program=args.program,
                       fault=args.fault)
    cell.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    trace_units = int(spec.workload["trace_units"]) if args.trace else 0
    profiler = None
    if trace_units:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profiler = profile(activities=acts)
    latencies, failed, k = [], 0, 0
    if profiler is not None:
        profiler.start()
    t0 = time.perf_counter()
    t_end = t0
    while True:
        s = time.perf_counter()
        if k and s - t0 >= args.seconds:
            break
        try:
            if profiler is not None and k < trace_units:
                with record_function(prof_mod.UNIT):
                    cell.unit(k)
            else:
                cell.unit(k)
        except Exception:  # a unit that fails counts; the run goes on
            failed += 1
            if failed == 1:
                traceback.print_exc()
        t_end = time.perf_counter()
        latencies.append(t_end - s)
        k += 1
        if profiler is not None and k == trace_units:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.stop()
    if profiler is not None and k < trace_units:
        profiler.stop()
    attempted = k
    card = _card(torch, device)

    e2e = dict(cell.end_to_end(latencies=latencies, done=attempted - failed,
                               seconds=t_end - t0))
    e2e["setup_s"] = setup_s
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = cell.check()
    lat = sorted(latencies)
    q = [lat[min(len(lat) - 1, int(f * len(lat)))] * 1e3 for f in (0.05, 0.5, 0.95)] + [lat[-1] * 1e3]
    half = len(latencies) // 2
    halves = [sum(latencies[:half]) / max(half, 1) * 1e3,
              sum(latencies[half:]) / max(len(latencies) - half, 1) * 1e3]
    print(f"gpubench: {spec.name}: set-up {setup_s:.3f} s, window {t_end - t0:.3f} s, "
          f"{attempted} units (ms p5/p50/p95/max {[round(x, 3) for x in q]}, mean of each half "
          f"{[round(x, 3) for x in halves]}), check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)

    result = {"correct": bool(checks.ok() and failed == 0), "attempted": attempted,
              "failed": failed}
    if args.trace:
        metrics = {}
        trace = prof_mod.collect(profiler) if profiler is not None else None
        if trace is not None and trace.units:
            trace.counts, trace.shapes = cell.counts(), cell.shapes()
            a, b = trace.window
            card["busy_s"] = prof_mod.covered(trace.device, a, b)
            card["window_s"] = b - a
            for m in spec.per_layer():
                value = load_metric(m["name"]).read(trace, spec)
                if value is not None and math.isfinite(value):
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["breakdown"] = {"device_ops": prof_mod.device_ops(trace),
                                   "idle_gaps": prof_mod.idle_gaps(trace)}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end()}
    result["metrics"] = metrics
    result["device"] = card
    # JSON has no infinity: a number that is infinite (one side without a
    # capture, or no answer) is written as 1e300.
    result["checks"] = {k: {n: (v if math.isfinite(v) else 1e300) for n, v in rec.items()}
                        for k, rec in checks.report().items()}

    found = forbidden_modules()
    if found:
        return _fail(f"the process holds {found}: nothing the benchmark runs may load JAX or rfx")
    for name, rec in result["checks"].items():
        print(f"check {name}: {rec['value']!r} (limit {rec['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
