"""What the benchmark's processes load: never JAX nor the JAX package, and the
reference nothing of the program."""
import ast
import json
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "fusionmamba_tpu"}


def _loaded(code: str) -> set:
    """Top-level names of every module a fresh interpreter holds after `code`."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from pathlib import Path\n"
            "from portbench import harness, trace, readers, flops, calibrate\n"
            "for d in ('jobs', 'makers', 'metrics', 'kernels'):\n"
            "    for p in sorted((harness.HERE / d).glob('*.py')):\n"
            "        harness.load_module(p)\n")
    loaded = _loaded(code)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "fusionmamba_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import sys; sys.path.insert(0, '.')\n"
                     "from portbench.reference import fusion, mamba_lm, scan, weights, products")
    assert not loaded & (FORBIDDEN | {"fusionmamba_torch", "chip_smoke"})


def test_reference_sources_import_only_torch_numpy_and_themselves():
    for path in sorted((harness.HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in {"torch", "numpy", "math", "contextlib",
                                              "__future__"}, (path.name, name)


def test_forbidden_names_compare_whole_top_level_names():
    sys.modules.setdefault("fusionmamba_tpu_lookalike_for_test", sys)
    try:
        assert "fusionmamba_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["fusionmamba_tpu_lookalike_for_test"]
