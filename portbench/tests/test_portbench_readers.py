"""The readers of the program's spans and counts (`source` `program_span` and
`program_counter`) on a made-up traced summary: each reads its number, and
none where the program recorded no such span or count."""
import types

import pytest

from portbench import harness
from portbench import spans as sp
from portbench import trace as tr


def _row(host=0.0, device=0.0, self_idle=0.0):
    return {"host_ms": host, "device_ms": device, "self_device_ms": 0.0, "idle_ms": self_idle,
            "self_idle_ms": self_idle}


SPANS = {"train.step": _row(700.0, 732.3, 3.1), "fusion.forward": _row(119.4, 242.9, 4.1),
         "train.backward": _row(20.0, 479.8, 11.2), "train.optimizer": _row(20.5, 4.9, 0.0),
         sp.OUTSIDE: _row(self_idle=1.5)}
COUNTS = {"fm_selective_scan_fwd": 50.0, "copies:ss2d.dt_b_c": 102.0,
          "copy_bytes:ss2d.dt_b_c": 400e6, "copy_bytes:lm.scan_inputs": 71.6e6}
WANT = {"forward_device_ms.train": 242.9, "backward_device_ms.train": 479.8,
        "optimizer_device_ms.train": 4.9, "program_idle_ms.train": 3.1 + 4.1 + 11.2,
        "program_idle_ms.serve": 3.1 + 4.1 + 11.2, "host_ms.serve": 119.4,
        "copy_mb.train": 471.6, "copy_mb.lm": 471.6}


def _win(spans, counts):
    return types.SimpleNamespace(trace=tr.Summary(3, 2.2, 2.1, {}, {}, 0, {}, spans, counts))


def _read(name, win):
    return harness.load_module(harness.metric_file(name)).read(win)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_span_or_count(name):
    assert _read(name, _win(SPANS, COUNTS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_none_without_the_span_or_count(name):
    assert _read(name, _win({sp.OUTSIDE: _row(self_idle=1.5)}, {"fm_selective_scan_fwd": 50.0})) \
        is None
