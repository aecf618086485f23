"""The reduction of a span capture (`portbench/spans.py`) on synthetic
events, the capture itself on the CPU, and the device-side reduction of
`trace.py` unchanged by span events."""
import types

import pytest
import torch

from portbench import spans as sp
from portbench import trace as tr


def _span(name, start, end, thread=1, corr=0):
    return sp.Event(name, start, end, thread, False, True, corr)


def _launch(corr, t, thread=1):
    return sp.Event("cudaLaunchKernel", t, t + 5, thread, False, False, corr)


def _kernel(corr, start, end, linked=0):
    return sp.Event(f"kernel{corr}", start, end, 0, True, False, corr, linked)


def _step():
    """A unit of 1000 ns: train.step on the main thread, train.backward in
    it; kernel 1 launched in the step, kernel 2 from autograd's thread while
    the main thread waits in train.backward, kernel 3 known only by the span
    open at its launch (its linked id)."""
    return [_span(sp.WINDOW, 0, 1000), _span("train.step", 10, 900, corr=11),
            _span("train.backward", 400, 800, corr=12),
            _launch(1, 50), _launch(2, 500, thread=2),
            _kernel(1, 100, 200), _kernel(2, 600, 700), _kernel(3, 650, 750, linked=12)]


def test_launches_map_to_the_innermost_span_on_any_thread():
    got = sp.reduce(_step(), units=1)
    rows = got["spans"]
    assert rows["train.step"]["device_ms"] == pytest.approx((100 + 150) * 1e-6)
    assert rows["train.backward"]["device_ms"] == pytest.approx(150 * 1e-6)
    assert rows["train.step"]["self_device_ms"] == pytest.approx(100 * 1e-6)
    assert rows["train.backward"]["self_device_ms"] == pytest.approx(150 * 1e-6)
    assert rows["train.step"]["host_ms"] == pytest.approx(890 * 1e-6)
    assert got["busy_ms"] == pytest.approx(250 * 1e-6) and got["unmatched"] == 0


def test_idle_gaps_go_to_the_innermost_span_on_the_main_thread_or_outside():
    events = _step() + [_span("elsewhere", 0, 1000, thread=2), _kernel(4, 950, 990, linked=0),
                        _launch(4, 920)]
    got = sp.reduce(events, units=2)
    rows = got["spans"]
    # gaps: [0,100] mid 50 and [750,950] mid 850 in the step; [200,600] mid
    # 400 in the backward; [990,1000] outside; none to the span of thread 2
    assert rows["train.step"]["self_idle_ms"] == pytest.approx((100 + 200) * 1e-6 / 2)
    assert rows["train.backward"]["self_idle_ms"] == pytest.approx(400 * 1e-6 / 2)
    assert rows["train.step"]["idle_ms"] == pytest.approx(700 * 1e-6 / 2)
    assert rows[sp.OUTSIDE]["self_idle_ms"] == pytest.approx(10 * 1e-6 / 2)
    assert rows["elsewhere"]["idle_ms"] == 0
    assert got["program_idle_ms"] == pytest.approx(700 * 1e-6 / 2)
    assert got["idle_ms"] == pytest.approx((1000 - 290) * 1e-6 / 2)
    assert rows[sp.OUTSIDE]["self_device_ms"] == 0
    assert rows["elsewhere"]["device_ms"] == pytest.approx(290 * 1e-6 / 2)


def test_device_copies_of_spans_and_unknown_launches_are_left_out():
    events = _step() + [sp.Event("train.step", 100, 900, 0, True, True, 0),
                        sp.Event("train.backward", 90, 95, 0, True, False, 0),
                        _kernel(9, 960, 970)]
    got = sp.reduce(events, units=1)
    assert got["unmatched"] == 1
    assert got["spans"]["train.step"]["device_ms"] == pytest.approx(250 * 1e-6)


def test_capture_on_the_cpu_records_the_program_spans_and_no_operator():
    from fusionmamba_torch import config as tcfg
    from fusionmamba_torch.models import VSSMFusion

    net = VSSMFusion(tcfg.test_config()).eval()
    x = torch.rand(1, 16, 16, 1)

    def unit():
        with torch.no_grad():
            net(x, x)

    got = sp.capture(unit, 2, torch.device("cpu"))
    assert got["kinds"]["operators"] == 0 and got["kinds"]["device"] == 0
    assert got["kinds"]["spans"] == 2 * 6 + 1
    rows = got["spans"]
    assert {"fusion.forward", "fusion.encoder", "fusion.head"} <= set(rows)
    assert rows["fusion.forward"]["host_ms"] >= rows["fusion.encoder"]["host_ms"] > 0
    assert got["counts"]["copies:ss2d.dt_b_c"] > 0


def test_trace_device_reduction_leaves_out_device_copies_of_spans():
    """`trace.capture`'s device events, and so its busy time, device time
    by name and copy count, read the same with span annotations on the
    device's timeline as without."""
    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, annotation=False):
        return types.SimpleNamespace(name=name, device_type=cuda, is_user_annotation=annotation)

    kernels = [ev("copy_kernel"), ev("ln_fwd")]
    spans = [ev(n, annotation=True) for n in ("fusion.forward", "train.backward")]
    assert tr._device_events(kernels + spans) == kernels
