"""Cells of BENCHMARK.json cut to sizes a CPU test can hold.

The sizes of a configuration are data beside this file,
`<configuration name>.json`: {"config": {...}, "mix": {...}}, laid over the
configuration file and over the mix of each of its cells. A configuration
without such a file has no tiny cell: it would run at its published widths.
"""
from pathlib import Path

import torch

from portbench import harness

HERE = Path(__file__).resolve().parent


def sizes(config_name: str) -> dict:
    """The tiny sizes of configuration `config_name`."""
    path = HERE / f"{config_name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config_name!r} has no tiny sizes: "
                                f"portbench/tests/tiny/{path.name} does not exist")
    return harness.load_json(path)


def tiny_cell(name, seed=2 ** 31 + 12345, seconds=0.2):
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.make_cell(spec, name, seed, seconds, False, torch.device("cpu"))
    tiny = sizes(cell.workload["config"])
    cell.config.update(tiny["config"])
    cell.mix.update(tiny["mix"])
    return cell
