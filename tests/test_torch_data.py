"""The port's on-disk data (`fusionmamba_torch/data`) and the training CLI on
image folders, on the CPU, against the JAX package.

The tests write small acod, mfnet and pst900 folders themselves. The port
reads images with PIL only and resizes the pairs with its native library, as
the JAX package does by default (it reads with cv2 where it is present; the
decoded bytes are the same), so the two packages must give the same items
bit for bit. With the JAX package's cv2 and native library switched off it
takes PIL throughout, and then it must equal the port's dataset with the
port's PIL version (`preprocess_pair_plain`) in place of the library.
"""
import os
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import fusionmamba_torch
from fusionmamba_torch import train as ttrain
from fusionmamba_torch.data import DatasetRoots, FusionDataset, SyntheticFusionDataset
from fusionmamba_torch.data import batch_iterator as tbatch_iterator
from fusionmamba_torch.data import color as tcolor
from fusionmamba_torch.data import native as tnative
from fusionmamba_torch.data import preprocess_pair_plain
from fusionmamba_torch.data.prefetch import device_prefetch, threaded_batches
from fusionmamba_tpu.data import DatasetRoots as JDatasetRoots
from fusionmamba_tpu.data import FusionDataset as JFusionDataset
from fusionmamba_tpu.data import SyntheticFusionDataset as JSyntheticFusionDataset
from fusionmamba_tpu.data import color as jcolor
from fusionmamba_tpu.data import datasets as jdatasets
from fusionmamba_tpu.data import native as jnative
from fusionmamba_tpu.data.prefetch import threaded_batches as jthreaded_batches

SIZE = (48, 40)


def _write(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _rgb(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), np.uint8)


def _gray(rng, h, w):
    return rng.integers(0, 256, (h, w), np.uint8)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Folders of the three layouts at odd sizes; one pst900 pair with an
    unreadable thermal file (left out by discovery)."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        base = root / "PST900_RGBT_Dataset" / split
        for i in range(5):
            _write(base / "rgb" / f"{i:02d}.png", _rgb(rng, 37, 53))
            _write(base / "thermal" / f"{i:02d}.png", _gray(rng, 37, 53))
            _write(base / "labels" / f"{i:02d}.png", rng.integers(0, 12, (37, 53)).astype(np.uint8))
        _write(base / "rgb" / "09.png", _rgb(rng, 37, 53))
        (base / "thermal" / "09.png").write_bytes(b"not an image")
        _write(base / "labels" / "09.png", _gray(rng, 37, 53))
    acod = root / "ACOD-12K" / "Train"
    for i in range(3):
        _write(acod / "Imgs" / f"c{i}_left_0.png", _rgb(rng, 29, 31))
        _write(acod / "Depth" / f"c{i}_depth_0.png", _gray(rng, 29, 31))
        _write(acod / "GT" / f"c{i}_left_0.png", _gray(rng, 29, 31))
    mfnet = root / "MFNet" / "ir_seg_dataset"
    for i in range(3):
        _write(mfnet / "images" / f"{i:05d}.png", _rgb(rng, 30, 41))
        _write(mfnet / "visual" / f"{i:05d}.jpg", _gray(rng, 30, 41))
        _write(mfnet / "labels" / f"{i:05d}.png", rng.integers(0, 9, (30, 41)).astype(np.uint8))
    (mfnet / "test.txt").write_text("00000\n00002\n")
    return str(root)


def _pair(roots, name, split):
    base = {"acod": "ACOD-12K", "mfnet": os.path.join("MFNet", "ir_seg_dataset"),
            "pst900": "PST900_RGBT_Dataset"}
    kw = {name: os.path.join(roots, base[name])}
    return (FusionDataset(split=split, dataset_name=name, roots=DatasetRoots(**kw), size=SIZE),
            JFusionDataset(split=split, dataset_name=name, roots=JDatasetRoots(**kw), size=SIZE))


_CASES = [("pst900", "train"), ("pst900", "test"), ("acod", "train"), ("mfnet", "train"),
          ("mfnet", "test")]


@pytest.mark.parametrize("name,split", _CASES)
def test_dataset_matches_jax_pil_path(roots, name, split, monkeypatch):
    monkeypatch.setattr(jdatasets, "_HAS_CV2", False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "preprocess_pair", preprocess_pair_plain)
    port, ref = _pair(roots, name, split)
    assert len(port) == len(ref) > 0
    assert port.filepath_vis == ref.filepath_vis and port.filepath_ir == ref.filepath_ir
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    vis_y, ir, lbl = port[0]
    assert vis_y.shape == ir.shape == (*SIZE, 1) and vis_y.dtype == np.float32
    assert lbl.shape == SIZE and lbl.dtype == np.int32
    assert set(np.unique(lbl)) <= ({0, 1} if name == "acod" else set(range(9)))


@pytest.mark.parametrize("name,split", _CASES)
def test_dataset_near_jax_defaults(roots, name, split):
    """The JAX defaults (its native library) and the port's: the same bits."""
    assert jnative.available()
    port, ref = _pair(roots, name, split)
    assert len(port) == len(ref) > 0
    before = tnative.pairs
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert tnative.pairs == before + len(port)


def test_unreadable_pair_is_skipped(roots, tmp_path):
    """Discovery leaves out the pair whose thermal file does not decode; an
    item whose file turns unreadable later is replaced by the next pair."""
    port, _ = _pair(roots, "pst900", "train")
    assert len(port) == 5 and not any("09" in p for p in port.filepath_ir)
    port.filepath_ir[1] = str(tmp_path / "gone.png")
    np.testing.assert_array_equal(port[1][0], port[2][0])


def test_generic_folders(roots):
    base = os.path.join(roots, "PST900_RGBT_Dataset", "test")
    ds = FusionDataset(split="test", dataset_name="other", vi_path=os.path.join(base, "rgb"),
                       ir_path=os.path.join(base, "thermal"), size=SIZE)
    ref = JFusionDataset(split="test", dataset_name="other", vi_path=os.path.join(base, "rgb"),
                         ir_path=os.path.join(base, "thermal"), size=SIZE)
    assert ds.filepath_vis == ref.filepath_vis and len(ds) == 6 and not ds.has_labels


def test_roots_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("FUSIONMAMBA_DATA_ROOT", str(tmp_path))
    assert DatasetRoots.from_env() == DatasetRoots(**vars(JDatasetRoots.from_env()))
    assert DatasetRoots.from_env().pst900 == str(tmp_path / "PST900_RGBT_Dataset")


@pytest.mark.parametrize("seed", [1, 2])
def test_threaded_batches_match_jax(seed):
    """The same batches in the same order as the JAX loader and as the port's
    batch_iterator, over two epochs, with a last partial batch dropped."""
    port, ref = SyntheticFusionDataset(length=11, size=(16, 16)), \
        JSyntheticFusionDataset(length=11, size=(16, 16))
    got = list(threaded_batches(port, 3, seed=seed, num_workers=3, prefetch=2, epochs=2))
    want = list(jthreaded_batches(ref, 3, seed=seed, num_workers=3, prefetch=2, epochs=2))
    plain = list(tbatch_iterator(port, 3, seed=seed, epochs=2))
    assert len(got) == len(want) == len(plain) == 6
    for g, w, p in zip(got, want, plain):
        for a, b, c in zip(g, w, p):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_device_prefetch_yields_every_batch_and_stops():
    """On the CPU: the batches as tensors in order; an exception in the source
    reaches the consumer; a consumer that stops early ends the producer."""
    batches = [tuple(np.full((2, 3), i + k, np.float32) for k in range(3)) for i in range(7)]
    got = list(device_prefetch(iter(batches), torch.device("cpu")))
    assert len(got) == 7
    for g, w in zip(got, batches):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), b)

    def broken():
        yield batches[0]
        raise OSError("unreadable")

    it = device_prefetch(broken(), torch.device("cpu"))
    next(it)
    with pytest.raises(OSError, match="unreadable"):
        next(it)

    before = threading.active_count()
    it = device_prefetch(iter(batches * 50), torch.device("cpu"), depth=2)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_color_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jcolor, "_HAS_CV2", False)
    rng = np.random.default_rng(3)
    rgb = _rgb(rng, 19, 23)
    np.testing.assert_array_equal(tcolor.rgb_to_y(rgb), jcolor.rgb_to_y(rgb))
    f = rgb.astype(np.float32)
    np.testing.assert_array_equal(tcolor.rgb_to_ycrcb(f), jcolor.rgb_to_ycrcb(f))
    ycc = jcolor.rgb_to_ycrcb(f)
    np.testing.assert_array_equal(tcolor.ycrcb_to_rgb(ycc), jcolor.ycrcb_to_rgb(ycc))
    small = _gray(rng, 10, 12)
    np.testing.assert_array_equal(tcolor.reinject_y(small, rgb), jcolor.reinject_y(small, rgb))
    for name in ("a.png", "b.jpg"):
        _write(tmp_path / "rgb" / name, _rgb(rng, 19, 23))
        _write(tmp_path / "fused" / name, _gray(rng, 19, 23))
    for mod, tag in ((tcolor, "t"), (jcolor, "j")):
        assert mod.extract_y_dir(str(tmp_path / "rgb"), str(tmp_path / f"y_{tag}")) == 2
        assert mod.reinject_y_dir(str(tmp_path / "fused"), str(tmp_path / "rgb"),
                                  str(tmp_path / f"out_{tag}")) == 2
    for sub, names in (("y", ("a.png", "b.png")), ("out", ("a.png", "b.jpg"))):
        for name in names:
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"{sub}_t" / name)),
                                          np.asarray(Image.open(tmp_path / f"{sub}_j" / name)))


def test_cli_trains_on_a_pst900_folder(tmp_path, monkeypatch):
    """Two steps of the test config on 4 pairs at 256^2 (the on-disk size),
    items loaded in the loop and by two threads with the device prefetch:
    the same losses."""
    rng = np.random.default_rng(5)
    base = tmp_path / "PST900_RGBT_Dataset" / "train"
    for i in range(4):
        _write(base / "rgb" / f"{i}.png", _rgb(rng, 45, 60))
        _write(base / "thermal" / f"{i}.png", _gray(rng, 45, 60))
        _write(base / "labels" / f"{i}.png", rng.integers(0, 5, (45, 60)).astype(np.uint8))
    monkeypatch.setenv("FUSIONMAMBA_DATA_ROOT", str(tmp_path))
    runs = {}
    for j in ("0", "2"):
        stats = ttrain.main(["--dataset", "pst900", "-B", "2", "-E", "1", "-j", j,
                             "--model", "test", "--device", "cpu",
                             "--ckpt_dir", str(tmp_path / f"ck{j}")])
        assert stats["steps"] == 2 and len(stats["loader_wait_seconds"]) == 2
        assert all(np.isfinite(stats["losses"]))
        runs[j] = stats["losses"]
    assert runs["0"] == runs["2"]


def test_port_names_no_cv2():
    """No module of the port names cv2 (the card's machine has none)."""
    pkg = Path(fusionmamba_torch.__file__).resolve().parent
    named = [str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
             if re.search(r"\bcv2\b", p.read_text())]
    assert not named, named
