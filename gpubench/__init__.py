"""gpubench: the benchmark of the PyTorch / CUDA port `rfx_torch` on an NVIDIA
H100. Run `python gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout; `BENCHMARK.json` names the cells."""
