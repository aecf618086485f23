"""A whole run of each cell, past the harness's look for a chip, on the CPU at
a tiny size, with the timed path broken underneath (`portbench/faults.py`):
`correct` has to come out false under the cell's own limits, once for each
fault the cell can have. The cells run on one chip, so there is no exchange
between chips to leave out. A sound run of each comes out correct."""
import time

import pytest
import torch

from portbench import faults, harness
from portbench.tests.tiny import tiny_cell

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CASES = [(w["name"], f) for w in SPEC["workloads"]
         for f in faults.of(harness.load_json(harness.HERE / "mixes" / f"{w['traffic']}.json"))]


@pytest.mark.parametrize("workload,fault", CASES, ids=lambda v: v)
def test_a_fault_makes_the_run_incorrect(workload, fault):
    torch.set_num_threads(4)
    cell = tiny_cell(workload)
    mend = faults.plant(cell, fault)
    try:
        line = harness.run_cell(cell, time.perf_counter())
    finally:
        mend()
    assert line["correct"] is False, line["checks"]
    assert line["attempted"] >= 1


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_sound_run_is_correct(workload):
    torch.set_num_threads(4)
    line = harness.run_cell(tiny_cell(workload), time.perf_counter())
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
