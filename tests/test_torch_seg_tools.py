"""The port's last three CLIs of the segmentation slice on the CPU, against
the JAX package's: `visualize_segmentation` (its palette and panels equal the
root script's; end to end at the test config on a PST900-layout folder),
`tools.color_convert` (the files it writes equal, byte for byte, those of
the JAX package's `data/color.py` on its PIL path) and `tools.check_dataset`
(its class counts equal the JAX `audit_classes`'s on the same folder; its
mAcc check equal). Exact throughout: the same integer and PIL work on both
sides, and the grid's model panels are the port's own forward.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import visualize_segmentation as jax_visualize
from fusionmamba_torch import config as tcfg
from fusionmamba_torch import visualize_segmentation
from fusionmamba_torch.data import FusionDataset
from fusionmamba_torch.models import VSSMFusionSeg
from fusionmamba_torch.nn import init_weights
from fusionmamba_torch.tools import check_dataset, color_convert
from fusionmamba_tpu.data import color as jcolor
from fusionmamba_tpu.data import datasets as jdatasets
from fusionmamba_tpu.data import native as jnative
from tools import check_dataset as jax_check_dataset

SIZE = 32


def _write(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture
def pst900_root(tmp_path, monkeypatch):
    """A PST900-layout folder: 4 training and 3 test pairs at 48x40, labels
    of 8x8 blocks of the 5 classes; the JAX package on its PIL path."""
    rng = np.random.default_rng(9)
    for split, n in (("train", 4), ("test", 3)):
        base = tmp_path / "PST900_RGBT_Dataset" / split
        for i in range(n):
            name = f"{i:03d}.png"
            _write(base / "rgb" / name, rng.integers(0, 256, (40, 48, 3), np.uint8))
            _write(base / "thermal" / name, rng.integers(0, 256, (40, 48), np.uint8))
            ids = rng.integers(0, 5, (5, 6)).astype(np.uint8)
            _write(base / "labels" / name, np.kron(ids, np.ones((8, 8), np.uint8)))
    monkeypatch.setenv("FUSIONMAMBA_DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(jdatasets, "_HAS_CV2", False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(jcolor, "_HAS_CV2", False)
    return tmp_path


@pytest.mark.parametrize("classes", [2, 5, 9])
def test_colorize_and_to_rgb_equal_the_root_script(classes):
    rng = np.random.default_rng(classes)
    labels = rng.integers(-2, 12, (7, 9)).astype(np.int32)
    np.testing.assert_array_equal(visualize_segmentation.colorize(labels, classes),
                                  jax_visualize.colorize(labels, classes))
    np.testing.assert_array_equal(visualize_segmentation.PALETTE, jax_visualize.PALETTE)
    gray = rng.uniform(-0.5, 1.5, (7, 9, 1)).astype(np.float32)
    np.testing.assert_array_equal(visualize_segmentation.to_rgb(gray), jax_visualize.to_rgb(gray))


def test_visualize_segmentation_end_to_end(pst900_root):
    """Two grids of [vis | ir | fused | GT | prediction] from a saved
    checkpoint, each panel equal to the model's own batch-1 forward on the
    same item."""
    net = init_weights(VSSMFusionSeg(tcfg.test_config(num_seg_classes=5)), seed=2).eval()
    ckpt, out_dir = pst900_root / "seg.pth", pst900_root / "vis"
    torch.save(net.state_dict(), ckpt)
    got = visualize_segmentation.main(["--dataset", "pst900", "--ckpt", str(ckpt),
                                       "--out_dir", str(out_dir), "--num_samples", "2",
                                       "--model", "test", "--image_size", str(SIZE),
                                       "--device", "cpu"])
    assert got["written"] == 2 and len(got["sample_seconds"]) == 2
    assert sorted(os.listdir(out_dir)) == ["pst900_sample0.png", "pst900_sample1.png"]
    ds = FusionDataset(split="test", dataset_name="pst900", size=(SIZE, SIZE))
    for i in range(2):
        grid = np.asarray(Image.open(out_dir / f"pst900_sample{i}.png"))
        assert grid.shape == (SIZE, 5 * SIZE, 3) and grid.dtype == np.uint8
        vis_y, ir, lbl = ds[i]
        with torch.no_grad():
            out = net(torch.from_numpy(vis_y[None]), torch.from_numpy(ir[None]))
        want = [jax_visualize.to_rgb(vis_y), jax_visualize.to_rgb(ir),
                jax_visualize.to_rgb(out["fusion"][0].clamp(0, 1).numpy()),
                jax_visualize.colorize(lbl, 5),
                jax_visualize.colorize(out["segmentation"][0].argmax(-1).numpy(), 5)]
        np.testing.assert_array_equal(grid, np.concatenate(want, axis=1))


def test_visualize_segmentation_without_a_card_fails_clearly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    with pytest.raises(SystemExit) as exc:
        visualize_segmentation.main(["--dataset", "pst900", "--ckpt", str(tmp_path / "m.pth")])
    assert exc.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def _files(folder):
    return {name: (folder / name).read_bytes() for name in sorted(os.listdir(folder))}


def test_color_convert_writes_the_jax_package_bytes(pst900_root):
    """rgb2y on the training RGB folder, then y2rgb of those Y images back
    into it: the port's CLI and the JAX package's functions write the same
    files."""
    rgb = pst900_root / "PST900_RGBT_Dataset" / "train" / "rgb"
    t, j = pst900_root / "t", pst900_root / "j"
    assert color_convert.main(["rgb2y", "--input", str(rgb), "--output", str(t / "y")]) == 4
    assert jcolor.extract_y_dir(str(rgb), str(j / "y")) == 4
    assert _files(t / "y") == _files(j / "y") and len(_files(t / "y")) == 4
    assert color_convert.main(["y2rgb", "--fused", str(t / "y"), "--rgb", str(rgb),
                               "--output", str(t / "rgb")]) == 4
    assert jcolor.reinject_y_dir(str(j / "y"), str(rgb), str(j / "rgb")) == 4
    assert _files(t / "rgb") == _files(j / "rgb")


@pytest.mark.parametrize("split,limit", [("test", 0), ("train", 0), ("train", 2)])
def test_check_dataset_classes_equal_jax(pst900_root, split, limit, capsys):
    got = check_dataset.main(["classes", "--dataset", "pst900", "--split", split,
                              "--num_classes", "5", "--limit", str(limit)])[split]
    printed = capsys.readouterr().out
    want = jax_check_dataset.audit_classes("pst900", split, 5, limit)
    np.testing.assert_array_equal(got, want)
    assert printed == capsys.readouterr().out
    assert got.sum() == (limit or {"test": 3, "train": 4}[split]) * 256 * 256


def test_check_dataset_dist_and_macc_equal_jax(pst900_root, capsys):
    got = check_dataset.main(["dist", "--dataset", "pst900", "--num_classes", "5"])
    printed = capsys.readouterr().out
    for split in ("train", "test"):
        np.testing.assert_array_equal(got[split],
                                      jax_check_dataset.audit_classes("pst900", split, 5, 0))
    assert "class | train% | test% | ratio" in printed
    macc = check_dataset.main(["macc"])
    capsys.readouterr()
    jax_check_dataset.macc_ab_check()
    jax_lines = capsys.readouterr().out.splitlines()
    assert jax_lines[0].endswith(f"{macc['present']:.4f}")
    assert jax_lines[1].endswith(f"{macc['all']:.4f}")
