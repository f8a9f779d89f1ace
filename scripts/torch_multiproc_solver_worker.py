#!/usr/bin/env python3
"""One rank of one sharded inverse-solve step (the port's
scripts/multiproc_solver_worker.py): the ranks form a {'rays': num_procs / 2,
'rx': 2} mesh, and one full step (trace -> soft-binned coverage IRs -> loss
-> gradients -> Adam update) all-reduces the partial IRs over 'rays', the
squared error over 'rx' and the gradients over every rank.

    python3 scripts/torch_multiproc_solver_worker.py <coordinator> <num_procs> <proc_id> <out.npz>
        [--device cuda|cpu] [--workload test|chip] [--inputs in.npz]

It is scripts/torch_multiproc_worker.py with `--cases solver`; that script's
docstring has the workloads and the output.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_multiproc_worker import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(default_cases=("solver",)))
