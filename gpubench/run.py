"""The benchmark of the PyTorch / CUDA port `rfx_torch` on one NVIDIA H100.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. `--trace 0` prints the cell's end-to-end metrics,
`--trace 1` its per-layer metrics read from a profile of its first units;
both check the window's answers against the plain reference
(`gpubench/reference/`). The last line of standard output is the result's
JSON object. Options for the CPU rehearsal and the output check's own tests:
`--device cpu` runs the cell at its rehearsal sizes on the port's CPU path;
`--program control` puts the reference, computed in bfloat16, in the port's
place; `--fault NAME` breaks the timed path as the driver names it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="rfx_torch benchmark: one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--program", choices=("port", "control"), default="port")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    # Every cache of the program and of PyTorch's compilers lives at a fixed
    # path inside the checkout, so only a checkout's first run builds.
    cache = ROOT / "build" / "gpubench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    # The port logs every request at INFO by default; a serving user keeps
    # it quiet, and the check's lines must end standard error.
    os.environ["RFX_LOG_LEVEL"] = "WARNING"
    if args.device == "cuda":
        # One process with one host thread of compute: PyTorch's and the
        # math libraries' thread pools would only contend with the thread
        # that feeds the card for the host's cores.
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            os.environ[var] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from gpubench.harness.window import run

    return run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
