"""The control of each cell, on the card at the cell's own size: the
reference put in the program's place and computed in the next precision
below the cell's must come out not correct, while the program on the same
seeds comes out correct. Three seeds a cell; the program's window is a few
units (none in training, whose numbers come from set-up).

    python -m pytest portbench/tests/test_portbench_control.py -q   (on a machine with the card)
"""
import gc

import pytest
import torch

from portbench import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_and_program_passes(cuda_device, workload):
    for seed in SEEDS:
        cell = harness.make_cell(SPEC, workload, seed, 0.0, False, cuda_device)
        run = harness.job_module(cell.mix).Run(cell)
        # a window of a few units where the window's own outputs are checked
        # (training's numbers come from set-up)
        if "kept_units" in cell.mix:
            for _ in range(cell.mix["kept_units"] + 1):
                run.unit()
        harness.sync(cuda_device)
        run.release()
        gc.collect()
        torch.cuda.empty_cache()
        program = harness.judge(run.check(), cell.limits)
        control = harness.judge(run.check_control(), cell.limits)
        assert harness.correct(program), (seed, program)
        assert not harness.correct(control), (seed, control)
        del run
        gc.collect()
        torch.cuda.empty_cache()
