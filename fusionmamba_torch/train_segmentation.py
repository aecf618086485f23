"""Segmentation and combined training CLI of the port (the counterpart of
`train_segmentation.py`, reference `train_segmentation.py:102-547`).

    python -m fusionmamba_torch.train_segmentation [--dataset mfnet|pst900|acod]
        [--mode segmentation|fusion|both] [--epochs/-E 10] [--batch_size/-B 4]
        [--lr 1e-4] [--fusion_weight 1] [--seg_weight 1] [--eval_interval 1]
        [--ckpt_dir model_last/segmentation] [--model full|tiny|test]
        [--num_workers/-j 8] [--synthetic N] [--image_size 256]
        [--device cuda|cpu] [--precision auto|bf16|fp32]

Trains `VSSMFusionSeg` (weights from seed 0) with `seg_train_step`: the
class count of the dataset (acod 2, mfnet 9, pst900 5), AdamW with the
gradients clipped to a global norm of 1.0, the losses of `--mode` with their
weights. PST900 is special-cased as in the reference: batch 2, lr 5e-5 with
`poly_lr` every step, class weights from the training split's label counts
and `improved_pst900_loss`. Batches come from the dataset's training split on
disk (`data.FusionDataset` under `FUSIONMAMBA_DATA_ROOT`) or, with
`--synthetic N`, from N deterministic labelled pairs; `-j N > 0` loads them
in N threads and copies each batch to the card ahead of its step. After
every epoch the state dict is saved to
`<ckpt_dir>/segmentation_model_<dataset>.pth` (the reference layout); every
`--eval_interval` epochs `RunningScore` scores the test split (mfnet and
pst900 on disk; a second synthetic set with `--synthetic`), and a new best
mIoU is also saved to `..._best.pth`. `--image_size` is the size the pairs
are resized to or made at. It runs on the card unless `--device cpu` is
given. `--precision bf16` trains in mixed precision as the fusion CLI does
(fp32 master weights, AdamW state and BatchNorm running statistics; `auto`,
the default, is fp32); the saved state dicts are fp32 either way. Not
ported: `--scan_impl`/`--scan_guard`/`--auto_exact` (the port's scan is
exact at any dt).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .data import FusionDataset, SyntheticFusionDataset, batch_iterator
from .device import select_device
from .eval import RunningScore
from .losses import compute_class_weights
from .models import VSSMFusionSeg
from .nn import init_weights
from .train.cli import CONFIGS, StepClock, epoch_batches, logger
from .train.loop import (PRECISIONS, SEG_MODES, make_seg_optimizer, poly_lr,
                         resolve_compute_dtype, seg_train_step, set_learning_rate)

NUM_CLASSES = {"acod": 2, "mfnet": 9, "pst900": 5}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="mfnet", choices=list(NUM_CLASSES))
    ap.add_argument("--epochs", "-E", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4, help="not read for pst900 (5e-5, poly)")
    ap.add_argument("--batch_size", "-B", type=int, default=4,
                    help="not read for pst900 (2)")
    ap.add_argument("--fusion_weight", type=float, default=1.0)
    ap.add_argument("--seg_weight", type=float, default=1.0)
    ap.add_argument("--mode", default="segmentation", choices=list(SEG_MODES))
    ap.add_argument("--eval_interval", type=int, default=1)
    ap.add_argument("--ckpt_dir", default="model_last/segmentation")
    ap.add_argument("--model", choices=list(CONFIGS), default="full",
                    help="full/tiny are the reference variants; test is a miniature")
    ap.add_argument("--num_workers", "-j", type=int, default=8,
                    help="loader threads; 0 = load in the training loop")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="train and evaluate on deterministic synthetic labelled pairs "
                         "(N for training, N // 4, at least 2, for evaluation)")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--precision", default="auto", choices=PRECISIONS,
                    help="compute dtype: bf16 = mixed precision (fp32 master weights); "
                         "auto = fp32")
    return ap, ap.parse_args(argv)


def compute_dataset_class_counts(ds, num_classes: int) -> np.ndarray:
    """The label histogram of the whole dataset (`train_segmentation.py:43-55`)."""
    counts = np.zeros(num_classes, np.float64)
    for i in range(len(ds)):
        item = ds[i]
        if len(item) == 3:
            counts += np.bincount(np.clip(item[2].ravel(), 0, num_classes - 1),
                                  minlength=num_classes)
    return counts


def predict_logits(net, ds, batch_size: int, device: torch.device):
    """(labels, logits) numpy batches of `ds` in order, the last one partial,
    from the model in eval mode."""
    net.eval()
    for vis_y, ir, lbl in batch_iterator(ds, batch_size, shuffle=False, drop_last=False):
        with torch.inference_mode():
            out = net(torch.from_numpy(vis_y).to(device), torch.from_numpy(ir).to(device),
                      return_fusion=False)
        yield lbl, out["segmentation"].float().cpu().numpy()


def evaluate(net, ds, num_classes: int, batch_size: int, device: torch.device, log) -> dict:
    """`RunningScore` of the argmax predictions over `ds`."""
    score = RunningScore(num_classes)
    for lbl, logits in predict_logits(net, ds, batch_size, device):
        score.update(lbl, logits.argmax(-1))
    s = score.get_scores()
    log.info(f"eval: pixel_acc={s['pixel_acc']:.4f} mAcc={s['mean_acc']:.4f} "
             f"mIoU={s['mean_iou']:.4f} fwIoU={s['fw_iou']:.4f}")
    return {k: v.tolist() if isinstance(v, np.ndarray) else float(v) for k, v in s.items()}


def _datasets(args, ap, num_classes: int):
    size = (args.image_size, args.image_size)
    if args.synthetic > 0:
        return (SyntheticFusionDataset(args.synthetic, size, num_classes=num_classes),
                SyntheticFusionDataset(max(2, args.synthetic // 4), size,
                                       num_classes=num_classes, seed=1))
    try:
        train_ds = FusionDataset(split="train", dataset_name=args.dataset, size=size)
        test_ds = (FusionDataset(split="test", dataset_name=args.dataset, size=size)
                   if args.dataset in ("mfnet", "pst900") else None)
    except FileNotFoundError as e:
        ap.error(f"{args.dataset}: no dataset on disk ({e}); set FUSIONMAMBA_DATA_ROOT, "
                 "or pass --synthetic N")
    return train_ds, test_ds


def main(argv=None) -> dict:
    """Run the CLI; returns {"steps", "step_seconds", "loader_wait_seconds",
    "losses" (each step's total), "evals" (the scores of each evaluation),
    "best_miou", "class_weights", "seconds"}. Step seconds are as
    `train.cli.StepClock` takes them, per epoch (saving and evaluation
    fall outside them)."""
    ap, args = parse_args(argv)
    try:
        device = select_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    log = logger("fusionmamba_torch.train_segmentation")
    compute_dtype = resolve_compute_dtype(args.precision)
    tic = time.time()
    num_classes = NUM_CLASSES[args.dataset]
    is_pst900 = args.dataset == "pst900"
    batch_size = 2 if is_pst900 else args.batch_size
    lr = 5e-5 if is_pst900 else args.lr
    train_ds, test_ds = _datasets(args, ap, num_classes)
    if len(train_ds) < batch_size:
        ap.error(f"{args.dataset}: {len(train_ds)} training pairs, fewer than the batch size "
                 f"{batch_size}")

    class_weights = None
    if is_pst900:
        counts = compute_dataset_class_counts(train_ds, num_classes)
        class_weights = compute_class_weights(counts).to(device)
        log.info(f"PST900 class weights: {class_weights.tolist()}")

    cfg = CONFIGS[args.model](num_seg_classes=num_classes)
    net = init_weights(VSSMFusionSeg(cfg), seed=0).to(device)
    opt = make_seg_optimizer(net.parameters(), lr=lr)
    gen = torch.Generator(device=device).manual_seed(0)
    steps_per_epoch = len(train_ds) // batch_size
    max_iter = steps_per_epoch * args.epochs
    log.info(f"{args.dataset}: {len(train_ds)} pairs, {steps_per_epoch} steps/epoch, "
             f"mode {args.mode}, on {device}")

    os.makedirs(args.ckpt_dir, exist_ok=True)
    ckpt = os.path.join(args.ckpt_dir, f"segmentation_model_{args.dataset}")
    clock, losses, waits, evals = StepClock(device), [], [], []
    best_miou, step = -1.0, 0
    for epoch in range(1, args.epochs + 1):
        t_epoch = time.time()
        batches = iter(epoch_batches(train_ds, batch_size, args.num_workers, epoch, device))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            waits.append(time.perf_counter() - t0)
            clock.mark()
            vis_y, ir, lbl = batch
            if is_pst900:
                set_learning_rate(opt, poly_lr(lr, step, max_iter))
            metrics = seg_train_step(
                net, opt, vis_y, ir, lbl, num_classes=num_classes, mode=args.mode,
                fusion_weight=args.fusion_weight, seg_weight=args.seg_weight,
                class_weights=class_weights, improved=is_pst900, generator=gen,
                compute_dtype=compute_dtype)
            losses.append(metrics["total"])
            step += 1
            if step % 10 == 0:
                log.info(f"epoch:{epoch} step:{step}/{max_iter} "
                         + " ".join(f"{k}:{float(v):.4f}" for k, v in metrics.items()))
        clock.end()
        log.info(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
        torch.save(net.state_dict(), ckpt + ".pth")
        if test_ds is not None and epoch % args.eval_interval == 0:
            scores = evaluate(net, test_ds, num_classes, batch_size, device, log)
            evals.append(scores)
            if scores["mean_iou"] > best_miou:
                best_miou = scores["mean_iou"]
                torch.save(net.state_dict(), ckpt + "_best.pth")
                log.info(f"new best mIoU {best_miou:.4f}")
    return {"steps": step, "step_seconds": clock.seconds(), "loader_wait_seconds": waits,
            "losses": torch.stack(losses).tolist() if losses else [], "evals": evals,
            "best_miou": best_miou,
            "class_weights": None if class_weights is None else class_weights.tolist(),
            "seconds": time.time() - tic}


if __name__ == "__main__":
    main()
