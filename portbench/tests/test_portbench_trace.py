"""The reduction of a trace: the busy union, the naming of idle gaps, and the
program's spans and counts beside them."""
import types

import torch

from portbench import harness
from portbench import trace as tr


def test_busy_is_the_union_of_spans():
    busy, merged = tr._busy([(0, 10), (5, 12), (20, 30), (29, 31), (40, 41)])
    assert busy == 12 + 11 + 1
    assert merged == [[0, 12], [20, 31], [40, 41]]


def test_gaps_are_named_by_the_shortest_covering_host_op():
    merged = [[0, 10], [100, 110], [112, 120]]
    host = [(0, 200, "portbench.unit"), (50, 90, "aten::item"), (0, 115, "aten::copy_")]
    gaps = tr._gap_names(merged, host)
    assert gaps["aten::item"] == 90e-6
    assert gaps[f"(idle gaps under {tr.NAMED_GAP_US:g} us)"] == 2e-6


def test_breakdown_keeps_ten_of_each():
    s = tr.Summary(1, 1.0, 0.5, {}, {f"k{i}": i * 1e-3 for i in range(30)}, 0,
                   {f"h{i}": i * 1e-4 for i in range(30)}, {}, {})
    b = s.breakdown()
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k29", 29e-3]
    assert len(b["idle_gaps"]) == 10 and b["idle_gaps"][0][0] == "h29"


def test_capture_fills_the_program_spans_and_counts_on_the_cpu(monkeypatch):
    """The two profiles' device events made up (a CPU has none), the span
    capture run for real: the device-alone readings come from the first
    profile alone, and the spans and counts from the model's own record."""
    from fusionmamba_torch import config as tcfg
    from fusionmamba_torch.models import VSSMFusion

    net = VSSMFusion(tcfg.test_config()).eval()
    x = torch.rand(1, 16, 16, 1)

    def unit():
        with torch.no_grad():
            net(x, x)

    def ev(name, start, end, device=torch.autograd.DeviceType.CUDA):
        return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=False,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    profiled = []

    def profile(unit_, n, device, activities):
        profiled.append(n)
        for _ in range(n):
            unit_()
        return [ev("ln_fwd", 0, 10), ev("copy_kernel", 40, 50),
                ev("aten::copy_", 12, 45, torch.autograd.DeviceType.CPU)], 1e-3

    monkeypatch.setattr(tr, "_profile", profile)
    s = tr.capture(unit, 2, torch.device("cpu"))
    assert profiled == [2, 1]
    assert (s.units, s.busy_s, s.copy_events) == (2, 20e-6, 1)
    assert s.by_function["layer_norm"] == 10e-6 and s.gaps == {"aten::copy_": 30e-6}
    assert {"fusion.forward", "fusion.encoder", "fusion.head"} <= set(s.spans)
    assert s.spans["fusion.forward"]["host_ms"] >= s.spans["fusion.encoder"]["host_ms"] > 0
    assert s.counts["copies:ss2d.dt_b_c"] > 0 and s.counts["copy_bytes:ss2d.dt_b_c"] > 0
    copy_mb = harness.load_module(harness.metric_file("copy_mb.train")).read(
        types.SimpleNamespace(trace=s))
    assert copy_mb == sum(v for k, v in s.counts.items() if k.startswith("copy_bytes:")) / 1e6
