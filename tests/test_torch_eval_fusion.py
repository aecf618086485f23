"""The port's fusion metrics (`fusionmamba_torch/eval/metrics_fusion.py`) and
its evaluation CLI (`python -m fusionmamba_torch.evaluate_fusion`), on the
CPU, against the JAX package's metrics and the root `evaluate_fusion.py`.

Both sides are the same float64 numpy arithmetic, so each metric is held to
1e-9 (relative and absolute), and the CLI's table to equality.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import evaluate_fusion as root_evaluate_fusion
from fusionmamba_torch.eval import metrics_fusion as tm
from fusionmamba_tpu.eval import metrics_fusion as jm

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-9, atol=1e-9)


def _images(seed, h=40, w=52):
    """Three smooth-plus-noise images in [0, 1] and one uint8."""
    rng = np.random.default_rng(seed)
    coarse = np.kron(rng.uniform(0, 1, (3, h // 4, w // 4)), np.ones((1, 4, 4)))
    imgs = np.clip(0.8 * coarse + 0.2 * rng.uniform(0, 1, (3, h, w)), 0, 1)
    return imgs[0], imgs[1], imgs[2], (255 * imgs[2]).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    a, b, f, f8 = _images(seed)
    for name in ("ssim",):
        np.testing.assert_allclose(getattr(tm, name)(f, a), getattr(jm, name)(f, a), **TOL)
        np.testing.assert_allclose(getattr(tm, name)(f8, b), getattr(jm, name)(f8, b), **TOL)
    for name in ("qabf", "mutual_information"):
        np.testing.assert_allclose(getattr(tm, name)(a, b, f), getattr(jm, name)(a, b, f), **TOL)
        np.testing.assert_allclose(getattr(tm, name)(a, b, f8), getattr(jm, name)(a, b, f8),
                                   **TOL)
    for name in ("entropy", "std_dev"):
        np.testing.assert_allclose(getattr(tm, name)(f), getattr(jm, name)(f), **TOL)
        np.testing.assert_allclose(getattr(tm, name)(f8), getattr(jm, name)(f8), **TOL)
    for ref in (None, b):
        got, want = tm.fusion_report(a, b, f, ref), jm.fusion_report(a, b, f, ref)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL)
    assert tm.ssim(f, f) == pytest.approx(1.0, abs=1e-12)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """IR, VIS, fused and reference folders: three pairs at two sizes (the
    sources larger than the fused output, so both CLIs resize them), one
    extra IR image without a match, one pair without a reference."""
    root = tmp_path_factory.mktemp("evaluate")
    rng = np.random.default_rng(7)
    dirs = {d: root / d for d in ("ir", "vis", "fused", "ref")}
    for d in dirs.values():
        d.mkdir()
    for i in range(3):
        for d, size in (("ir", (50, 61)), ("vis", (50, 61)), ("fused", (32, 40)),
                        ("ref", (32, 40))):
            if d == "ref" and i == 2:
                continue
            img = rng.integers(0, 256, size, dtype=np.uint8)
            ext = ".jpg" if d == "vis" else ".png"
            Image.fromarray(img).save(dirs[d] / f"p{i}{ext}")
    Image.fromarray(rng.integers(0, 256, (8, 8), dtype=np.uint8)).save(dirs["ir"] / "lone.png")
    return {k: str(v) for k, v in dirs.items()}


@pytest.mark.parametrize("with_ref", [False, True])
def test_cli_table_matches_root_script(folders, tmp_path, monkeypatch, with_ref):
    args = ["--ir_dir", folders["ir"], "--vis_dir", folders["vis"],
            "--fused_dir", folders["fused"]] + (["--ref_dir", folders["ref"]] if with_ref else [])
    want_out, got_out = tmp_path / "root.txt", tmp_path / "port.txt"
    monkeypatch.setattr(sys, "argv", ["evaluate_fusion.py", *args, "--out", str(want_out)])
    root_evaluate_fusion.main()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "fusionmamba_torch.evaluate_fusion", *args,
                          "--out", str(got_out)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert got_out.read_text() == want_out.read_text()
    lines = got_out.read_text().splitlines()
    assert len(lines) == 5 and lines[-1].startswith("MEAN")
    assert ("ssim_vs_reference" in lines[0]) == with_ref
    assert ("parity SSIM vs reference" in res.stdout) == with_ref


def test_cli_reference_equal_to_fused_gives_parity_one(folders):
    from fusionmamba_torch import evaluate_fusion

    got = evaluate_fusion.main(["--ir_dir", folders["ir"], "--vis_dir", folders["vis"],
                                "--fused_dir", folders["fused"], "--ref_dir", folders["fused"]])
    assert got["means"]["ssim_vs_reference"] == pytest.approx(1.0, abs=1e-12)
    assert all(np.isfinite(v) for v in got["means"].values())
