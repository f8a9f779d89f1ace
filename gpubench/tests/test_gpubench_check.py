"""The output check rejects its control and every fault the cells can have.

On the CPU at the rehearsal's sizes: the reference computed in bfloat16 put
in the port's place (`--program control`), half of each unit's rays left out
with the mean taken over the rest (`--fault half_batch`) and each answer
altered where it is produced (`--fault alter`) each come out not correct.
On a card (marker `cuda`), a short run of each cell at its full size comes
out correct.
"""

import json

import pytest

from gpubench.tests.conftest import ROOT, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
BREAKS = [("--program", "control"), ("--fault", "half_batch"), ("--fault", "alter")]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("brk", BREAKS, ids=lambda b: b[1])
def test_a_broken_timed_path_is_not_correct(cell, brk):
    rc, res, err = run_cell("--workload", cell, "--seed", "4242424242", "--seconds", "1",
                            "--device", "cpu", *brk)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    rc, res, err = run_cell("--workload", cell, "--seed", "5151515151", "--seconds", "2")
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
