"""Cells of BENCHMARK.json cut to sizes a CPU test can hold."""
import torch

from portbench import harness

TINY_FUSION = dict(dims=[16, 32], depths=[1, 2], depths_decoder=[2, 1], d_state=4, image_size=32)
TINY_LM = dict(d_model=32, n_layer=2, vocab_size=61, dt_rank=None)


def tiny_cell(name, seed=2 ** 31 + 12345, seconds=0.2):
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.make_cell(spec, name, seed, seconds, False, torch.device("cpu"))
    if cell.config["model"] == "fusion":
        cell.config.update(TINY_FUSION)
        cell.mix.update(batch=4, ring=4, reference_rows=2, kept_units=2, trace_units=2)
    else:
        cell.config.update(TINY_LM)
        cell.mix.update(batch=2, seq_len=40, ring=3, kept_units=2, trace_units=2)
    return cell
