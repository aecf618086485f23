"""The port's segmentation CLIs on the CPU: `train_segmentation` in each mode
on synthetic pairs, its PST900 special case on a PST900-layout folder (batch
2, the poly lr, class weights from the label counts, as the JAX package's
CLI counts them), the `train_pst900_improved` alias, and
`evaluate_segmentation` on an mfnet-style and an acod-style folder, its
metrics recomputed from the model's logits with the JAX package's metric
functions (1e-12). All at the test config and 32x32.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import train_segmentation as jax_train_segmentation
from fusionmamba_torch import config as tcfg
from fusionmamba_torch import evaluate_segmentation, train_pst900_improved
from fusionmamba_torch import train_segmentation as tseg
from fusionmamba_torch.checkpoints import load_reference_checkpoint
from fusionmamba_torch.data import FusionDataset, batch_iterator
from fusionmamba_torch.models import VSSMFusionSeg
from fusionmamba_torch.nn import init_weights
from fusionmamba_torch.train import poly_lr
from fusionmamba_tpu import eval as jeval
from fusionmamba_tpu import losses as jlosses
from fusionmamba_tpu.data import FusionDataset as JFusionDataset
from fusionmamba_tpu.data import datasets as jdatasets
from fusionmamba_tpu.data import native as jnative

SIZE = 32


def _write(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _blocks(rng, classes, h=40, w=48):
    """A label image of 8x8 blocks of class ids."""
    ids = rng.integers(0, classes, (h // 8, w // 8)).astype(np.uint8)
    return np.kron(ids, np.ones((8, 8), np.uint8))


def _pair_images(rng, base, name, vis_dir, ir_dir, ir_name=None, h=40, w=48):
    _write(base / vis_dir / name, rng.integers(0, 256, (h, w, 3), np.uint8))
    _write(base / ir_dir / (ir_name or name), rng.integers(0, 256, (h, w), np.uint8))


@pytest.mark.parametrize("mode", ["segmentation", "fusion", "both"])
def test_train_segmentation_in_each_mode(mode, tmp_path):
    """4 steps on 8 synthetic mfnet-class pairs and one evaluation; the
    checkpoints load strictly. A head the mode leaves out gets no gradient,
    so AdamW only decays it (lr 1e-4, weight decay 0.01), and its BatchNorm
    statistics stay at their start."""
    stats = tseg.main(["--model", "test", "--synthetic", "8", "--image_size", str(SIZE),
                       "-E", "1", "-B", "2", "-j", "0", "--mode", mode, "--device", "cpu",
                       "--ckpt_dir", str(tmp_path)])
    assert stats["steps"] == 4 and len(stats["step_seconds"]) == 4
    assert len(stats["losses"]) == 4 and all(np.isfinite(stats["losses"]))
    assert len(stats["evals"]) == 1 and np.isfinite(stats["evals"][0]["mean_iou"])
    assert stats["best_miou"] == stats["evals"][0]["mean_iou"]
    start = init_weights(VSSMFusionSeg(tcfg.test_config(num_seg_classes=9)), seed=0).state_dict()
    for name in ("segmentation_model_mfnet.pth", "segmentation_model_mfnet_best.pth"):
        net = VSSMFusionSeg(tcfg.test_config(num_seg_classes=9))
        load_reference_checkpoint(net, str(tmp_path / name))
    sd = net.state_dict()
    decay = (1 - 1e-4 * 0.01) ** 4
    left_out = {"fusion": "segmentation_head.conv1.weight",
                "segmentation": "fusion_model.final_conv.weight"}.get(mode)
    if left_out:
        np.testing.assert_allclose(sd[left_out].numpy(), start[left_out].numpy() * decay,
                                   rtol=1e-6)
    ran_head = mode != "fusion"
    assert torch.equal(sd["segmentation_head.bn1.running_var"],
                       start["segmentation_head.bn1.running_var"]) != ran_head
    assert int(sd["segmentation_head.bn1.num_batches_tracked"]) == (4 if ran_head else 0)


@pytest.fixture
def pst900_root(tmp_path, monkeypatch):
    """A PST900-layout folder: 6 training and 3 test pairs at 48x40 with
    block labels of the 5 classes."""
    rng = np.random.default_rng(3)
    for split, n in (("train", 6), ("test", 3)):
        base = tmp_path / "PST900_RGBT_Dataset" / split
        for i in range(n):
            _pair_images(rng, base, f"{i:03d}.png", "rgb", "thermal")
            _write(base / "labels" / f"{i:03d}.png", _blocks(rng, 5))
    monkeypatch.setenv("FUSIONMAMBA_DATA_ROOT", str(tmp_path))
    return tmp_path


def test_pst900_special_case_on_a_folder(pst900_root, monkeypatch):
    """Batch 2 whatever -B says, the poly lr from 5e-5 set before every step,
    the improved loss's class weights from the training split's label counts
    (held to 1e-6 of the JAX package's CLI counting its own dataset), an
    evaluation on the test split after each epoch."""
    lrs = []
    real = tseg.set_learning_rate

    def record(opt, lr):
        lrs.append(lr)
        real(opt, lr)
        assert all(g["lr"] == lr for g in opt.param_groups)

    monkeypatch.setattr(tseg, "set_learning_rate", record)
    stats = tseg.main(["--dataset", "pst900", "-B", "4", "-E", "2", "-j", "0", "--model", "test",
                       "--image_size", str(SIZE), "--device", "cpu",
                       "--ckpt_dir", str(pst900_root / "ck")])
    assert stats["steps"] == 6 and all(np.isfinite(stats["losses"]))
    assert lrs == [poly_lr(5e-5, s, 6) for s in range(6)]
    assert len(stats["evals"]) == 2 and all(np.isfinite(e["mean_iou"]) for e in stats["evals"])
    monkeypatch.setattr(jdatasets, "_HAS_CV2", False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    counts = jax_train_segmentation.compute_dataset_class_counts(
        JFusionDataset(split="train", dataset_name="pst900", size=(SIZE, SIZE)), 5)
    assert counts.min() > 0
    np.testing.assert_allclose(stats["class_weights"],
                               np.asarray(jlosses.compute_class_weights(counts)), rtol=1e-6)


def test_pst900_improved_alias_adds_the_dataset(monkeypatch):
    seen = []
    monkeypatch.setattr(train_pst900_improved.train_segmentation, "main", seen.append)
    train_pst900_improved.main(["-E", "1"])
    train_pst900_improved.main(["--dataset", "mfnet"])
    assert seen == [["-E", "1", "--dataset", "pst900"], ["--dataset", "mfnet"]]


def _mfnet(root, rng):
    base = root / "MFNet" / "ir_seg_dataset"
    for i in range(4):
        _pair_images(rng, base, f"{i:05d}.png", "images", "visual", f"{i:05d}.jpg")
        _write(base / "labels" / f"{i:05d}.png", _blocks(rng, 9))
    (base / "test.txt").write_text("00000\n00001\n00003\n")


def _acod(root, rng):
    base = root / "ACOD-12K" / "Train"
    for i in range(3):
        _pair_images(rng, base, f"c{i}_left_0.png", "Imgs", "Depth", f"c{i}_depth_0.png")
        _write(base / "GT" / f"c{i}_left_0.png", 255 * (_blocks(rng, 2)))


@pytest.mark.parametrize("dataset,classes,split", [("mfnet", 9, "test"), ("acod", 2, "train")])
def test_evaluate_segmentation_on_a_folder(dataset, classes, split, tmp_path, monkeypatch):
    """The report, printed and written to --out, in the root script's
    format; its numbers equal the JAX package's metrics on the logits of the
    same model over the same split (3 pairs at batch 2: a partial batch)."""
    rng = np.random.default_rng(7)
    {"mfnet": _mfnet, "acod": _acod}[dataset](tmp_path, rng)
    monkeypatch.setenv("FUSIONMAMBA_DATA_ROOT", str(tmp_path))
    net = init_weights(VSSMFusionSeg(tcfg.test_config(num_seg_classes=classes)), seed=1)
    ckpt, out = tmp_path / "seg.pth", tmp_path / "report.txt"
    torch.save(net.state_dict(), ckpt)
    got = evaluate_segmentation.main(["--dataset", dataset, "--ckpt", str(ckpt), "--model", "test",
                                      "--batch", "2", "--image_size", str(SIZE),
                                      "--device", "cpu", "--out", str(out)])
    assert out.read_text() == got["report"] + "\n"
    assert got["samples"] == 3
    lines = got["report"].splitlines()
    assert lines[:2] == [f"{dataset} segmentation evaluation", "=" * 40]

    ds = FusionDataset(split=split, dataset_name=dataset, size=(SIZE, SIZE))
    net.eval()
    labels, logits = [], []
    for vis_y, ir, lbl in batch_iterator(ds, 3, shuffle=False, drop_last=False):
        with torch.no_grad():
            logits.append(net(torch.from_numpy(vis_y), torch.from_numpy(ir),
                              return_fusion=False)["segmentation"].numpy())
        labels.append(lbl)
    lbl, lg = np.concatenate(labels), np.concatenate(logits)
    m = got["metrics"]
    if dataset == "acod":
        prob = np.exp(lg[..., 1]) / np.exp(lg).sum(-1)
        for key, fn in (("s_measure", jeval.s_measure), ("f_measure", jeval.f_measure_sod),
                        ("e_measure", jeval.e_measure), ("mae", jeval.mae)):
            assert abs(m[key] - np.mean([fn(p, t) for p, t in zip(prob, lbl)])) <= 1e-12, key
        assert [ln.split(":")[0] for ln in lines[2:]] == [
            "S-measure", "F-measure", "E-measure", "MAE", "samples"]
    else:
        pred = lg.argmax(-1)
        rs = jeval.RunningScore(classes)
        rs.update(lbl, pred)
        s = rs.get_scores()
        present = [jeval.present_classes_metrics(p, t, classes) for p, t in zip(pred, lbl)]
        for key, want in (("mean_acc", s["mean_acc"]), ("mean_iou", s["mean_iou"]),
                          ("pixel_acc", s["pixel_acc"]),
                          ("present_mean_acc", np.mean([p["mAcc"] for p in present])),
                          ("present_mean_iou", np.mean([p["mIoU"] for p in present]))):
            assert abs(m[key] - want) <= 1e-12, key
        np.testing.assert_allclose(m["iou"], s["iou"], rtol=0, atol=1e-12)
        assert lines[-1].startswith("per-class IoU: ") and len(lines[-1].split()) == 2 + classes


@pytest.mark.parametrize("cli", ["train_segmentation", "evaluate_segmentation"])
def test_cli_without_a_card_fails_clearly(cli, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    argv = {"train_segmentation": ["--synthetic", "4", "--ckpt_dir", str(tmp_path)],
            "evaluate_segmentation": ["--dataset", "mfnet", "--ckpt", str(tmp_path / "m.pth")]}
    module = tseg if cli == "train_segmentation" else evaluate_segmentation
    with pytest.raises(SystemExit) as exc:
        module.main(argv[cli])
    assert exc.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_train_segmentation_without_data_fails_clearly(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("FUSIONMAMBA_DATA_ROOT", str(tmp_path))
    with pytest.raises(SystemExit):
        tseg.main(["--device", "cpu", "--ckpt_dir", str(tmp_path)])
    err = capsys.readouterr().err
    assert "no dataset on disk" in err and "--synthetic" in err
