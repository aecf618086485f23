"""The reduction of a trace: the busy union and the naming of idle gaps."""
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
                   {f"h{i}": i * 1e-4 for i in range(30)})
    b = s.breakdown()
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k29", 29e-3]
    assert len(b["idle_gaps"]) == 10 and b["idle_gaps"][0][0] == "h29"
