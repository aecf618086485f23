"""BENCHMARK.json against the benchmark's contract: names, units, keys, and
every name resolved to a file of its own."""
import json
import math
import re

import pytest

from portbench import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_size():
    assert set(SPEC) == TOP_KEYS
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_uniqueness():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs_resolve():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        body = harness.load_json(harness.ROOT / c["file"])
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads_resolve():
    assert 1 <= len(SPEC["workloads"]) <= 24
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        mix = harness.load_json(harness.HERE / "mixes" / f"{w['traffic']}.json")
        assert (harness.HERE / "jobs" / f"{mix['job']}.py").is_file()
        limits = harness.load_json(harness.HERE / "limits" / f"{w['name']}.json")["limits"]
        assert limits and all(isinstance(v, float) and v > 0 for v in limits.values())


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in SPEC["workloads"]])


def test_end_to_end_metrics():
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert harness.metric_file(m["name"]).is_file()
    for w in SPEC["workloads"]:
        reported = [m["name"] for m in SPEC["end_to_end"] if w["name"] in _cells(m)]
        assert "setup_s" in reported and len(reported) >= 2, w["name"]


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _line(metric["layer"])
    assert harness.metric_file(metric["name"]).is_file()
    moves = {m["name"]: m for m in SPEC["end_to_end"]}[metric["moves"]]
    for cell in _cells(metric):
        assert cell in {w["name"] for w in SPEC["workloads"]}
        assert cell in _cells(moves), (metric["name"], cell)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_every_cell_reports_a_per_layer_metric():
    for w in SPEC["workloads"]:
        assert any(w["name"] in _cells(m) for m in SPEC["per_layer"]), w["name"]


def test_peaks_table():
    peaks = harness.load_json(harness.HERE / "peaks.json")
    for key in ("hbm_bytes_per_s", "fp32", "tf32", "tf32x3", "bf16", "sfu_calls_per_s"):
        assert math.isfinite(peaks[key]) and peaks[key] > 0
    assert peaks["tf32x3"] == pytest.approx(peaks["tf32"] / 3, rel=1e-3)
