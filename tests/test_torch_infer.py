"""The port's inference CLI on the CPU, and the port's import boundary."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from fusionmamba_torch import infer

REPO = Path(__file__).resolve().parent.parent


def _write_pairs(root: Path, n: int):
    rng = np.random.default_rng(0)
    dirs = {}
    for name in ("ir", "vis"):
        d = root / name
        d.mkdir()
        for i in range(n):
            arr = rng.integers(0, 256, (37, 50), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"pair{i}.png")
        dirs[name] = str(d)
    return dirs


def test_cli_runs_on_cpu(tmp_path):
    """Three odd-sized pairs at batch 2: one full batch and one padded tail."""
    dirs = _write_pairs(tmp_path, 3)
    out = tmp_path / "out"
    stats = infer.main(["--ir_dir", dirs["ir"], "--vis_dir", dirs["vis"],
                        "--out_dir", str(out), "--model", "tiny", "--size", "64",
                        "--batch", "2", "--device", "cpu"])
    assert stats["pairs"] == 3 and len(stats["batch_seconds"]) == 2
    names = sorted(os.listdir(out))
    assert names == ["pair0.png", "pair1.png", "pair2.png"]
    for name in names:
        img = np.asarray(Image.open(out / name))
        assert img.shape == (64, 64) and img.dtype == np.uint8
        assert img.min() == 0 and img.max() == 255


def test_cli_without_a_card_fails_clearly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    dirs = _write_pairs(tmp_path, 1)
    with pytest.raises(SystemExit) as exc:
        infer.main(["--ir_dir", dirs["ir"], "--vis_dir", dirs["vis"],
                    "--out_dir", str(tmp_path / "out")])
    assert exc.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_port_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fusionmamba_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'fusionmamba_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'fusionmamba_tpu')]\n"
        "assert len(mods) >= 20, mods\n"
        "new = ['fusionmamba_torch.' + m for m in ('train_segmentation', "
        "'train_pst900_improved', 'evaluate_segmentation', 'losses.segmentation', "
        "'eval.metrics_seg', 'eval.metrics_sod', 'models.mamba_lm', 'checkpoints.hf_import', "
        "'visualize_segmentation', 'tools.color_convert', 'tools.check_dataset', "
        "'utils.logger', 'utils.profiling', 'utils.flops', 'parallel.mesh', "
        "'parallel.collectives', 'parallel.sharding', 'parallel.tensor_parallel', "
        "'parallel.data', 'parallel.seq_scan')]\n"
        "assert set(new) <= set(mods), new\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
