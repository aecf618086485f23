"""How a configuration enters the benchmark by new files alone: its maker
(`makers/<model>.py`, found by the configuration's `model`) and its tiny
sizes for the CPU tests (`tests/tiny/<configuration>.json`), and no module
of the harness that knows a model by its kind."""
import ast

import pytest

from portbench import build, harness
from portbench.tests import tiny

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_every_configuration_has_a_maker_and_tiny_sizes(entry):
    config = harness.load_json(harness.ROOT / entry["file"])
    assert callable(build.maker(config).make)
    sizes = tiny.sizes(entry["name"])
    assert set(sizes) == {"config", "mix"}
    # tiny sizes replace the configuration's own keys and its cells' mix
    # keys; a misspelt key would leave a published width in place
    assert set(sizes["config"]) <= set(config), entry["name"]
    mixes = [harness.load_json(harness.HERE / "mixes" / f"{w['traffic']}.json")
             for w in SPEC["workloads"] if w["config"] == entry["name"]]
    assert set(sizes["mix"]) <= set().union(*mixes), entry["name"]


def test_a_configuration_without_tiny_sizes_has_no_tiny_cell(monkeypatch, tmp_path):
    monkeypatch.setattr(tiny, "HERE", tmp_path)
    with pytest.raises(FileNotFoundError, match="'fusion_full'"):
        tiny.tiny_cell("fusion_serve_fp32_b32")


def test_a_model_without_a_maker_is_refused():
    with pytest.raises(FileNotFoundError, match="'no_such_model'"):
        build.maker({"model": "no_such_model"})


def test_only_build_reads_a_configuration_s_model_and_no_job_names_a_maker():
    here = harness.HERE
    for path in sorted(here.rglob("*.py")):
        rel = path.relative_to(here)
        if rel.parts[0] in ("makers", "reference", "tests") or str(rel) == "build.py":
            continue
        text = path.read_text()
        assert '["model"]' not in text and "['model']" not in text, rel
    for path in sorted((here / "jobs").glob("*.py")):
        names = {t.id for node in ast.walk(ast.parse(path.read_text()))
                 if isinstance(node, ast.Assign) for t in node.targets
                 if isinstance(t, ast.Name)}
        assert "MODEL" not in names, path.name
