"""Fusion training CLI of the port (the counterpart of `train.py`).

    python -m fusionmamba_torch.train [--dataset pst900|acod|mfnet|all]
        [--epochs/-E 2] [--batch_size/-B 6] [--model full|tiny|test]
        [--ckpt_dir model_last/my_cross] [--num_workers/-j 8]
        [--synthetic N] [--image_size 256] [--device cuda|cpu]

Per dataset: warm start from `<ckpt_dir>/fusion_model_<dataset>.pth` (the
reference layout) when it exists, else weights from seed 0; per epoch the
reference lr; batches of the dataset's training split on disk
(`data.FusionDataset`, under `FUSIONMAMBA_DATA_ROOT`, 256x256) or, with
`--synthetic N`, of N deterministic pairs of `--image_size`, shuffled per
epoch; a log line every 10 steps in the reference's format; the state dict
saved to the same path at the end. With `-j N > 0` the items load in N
threads and each batch is copied to the card ahead of its step
(`data.prefetch`); with `-j 0` they load in the loop. `--dataset all` trains
acod, mfnet and pst900 in turn. It runs on the card unless `--device cpu` is
given.
"""
from __future__ import annotations

import argparse
import datetime
import logging
import os
import sys
import time

import torch

from ..checkpoints import load_reference_checkpoint
from ..config import full_config, test_config, tiny_config
from ..data import FusionDataset, SyntheticFusionDataset, batch_iterator
from ..data.prefetch import device_prefetch, threaded_batches
from ..device import select_device
from ..models import VSSMFusion
from ..nn import init_weights
from .loop import fusion_train_step, make_fusion_optimizer, reference_fusion_lr, set_learning_rate

DATASETS = ("acod", "mfnet", "pst900")
_CONFIGS = {"full": full_config, "tiny": tiny_config, "test": test_config}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="pst900", choices=[*DATASETS, "all"])
    ap.add_argument("--epochs", "-E", type=int, default=2)
    ap.add_argument("--batch_size", "-B", type=int, default=6)
    ap.add_argument("--model", choices=list(_CONFIGS), default="full",
                    help="full/tiny are the reference variants; test is a miniature")
    ap.add_argument("--ckpt_dir", default="model_last/my_cross")
    ap.add_argument("--num_workers", "-j", type=int, default=8,
                    help="loader threads; 0 = load in the training loop")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="train on N deterministic synthetic pairs instead of the on-disk "
                         "dataset")
    ap.add_argument("--image_size", type=int, default=256,
                    help="size of the synthetic pairs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap, ap.parse_args(argv)


def _logger() -> logging.Logger:
    log = logging.getLogger("fusionmamba_torch.train")
    if not log.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
    return log


def _batches(args, ds, epoch: int, device: torch.device):
    """One epoch's batches as tensors on `device`."""
    if args.num_workers > 0:
        return device_prefetch(threaded_batches(ds, args.batch_size, shuffle=True, seed=epoch,
                                                num_workers=args.num_workers), device)
    return (tuple(torch.from_numpy(b).to(device, non_blocking=True) for b in batch)
            for batch in batch_iterator(ds, args.batch_size, shuffle=True, seed=epoch))


def train_fusion(args, ds, dataset: str, device: torch.device, log: logging.Logger) -> dict:
    net = init_weights(VSSMFusion(_CONFIGS[args.model]()), seed=0)
    ckpt = os.path.join(args.ckpt_dir, f"fusion_model_{dataset}.pth")
    if os.path.exists(ckpt):
        log.info(f"warm start from {ckpt}")
        load_reference_checkpoint(net, ckpt)
    net.to(device)
    opt = make_fusion_optimizer(net.parameters())
    gen = torch.Generator(device=device).manual_seed(0)
    steps_per_epoch = len(ds) // args.batch_size
    total = steps_per_epoch * args.epochs
    log.info(f"{dataset}: {len(ds)} pairs, {steps_per_epoch} steps/epoch, on {device}")

    timed = device.type == "cuda"

    def stamp():
        """A mark of the device's progress (a recorded CUDA event) or, on the
        CPU, of the host clock."""
        if not timed:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    marks, losses = [], []   # a mark at the start of each step and at the end
    waits = []               # host seconds each step waited for its batch
    step = 0
    st = glob_st = time.time()
    for epoch in range(1, args.epochs + 1):
        set_learning_rate(opt, reference_fusion_lr(epoch))
        batches = iter(_batches(args, ds, epoch, device))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            waits.append(time.perf_counter() - t0)
            marks.append(stamp())
            # the on-disk datasets' items also carry a label, which fusion
            # training does not read
            metrics = fusion_train_step(net, opt, batch[0], batch[1], gen)
            losses.append(metrics["loss_total"])
            step += 1
            if step % 10 == 0:
                ed = time.time()
                eta = int((total - step) * (ed - glob_st) / step)
                log.info(
                    "epoch:{epoch} step:{step}/{total} loss_total:{lt:.4f} loss_in:{li:.4f} "
                    "loss_ssim:{ls:.4f} loss_grad:{lg:.4f} time:{t:.4f} eta:{eta}".format(
                        epoch=epoch, step=step, total=total,
                        lt=float(metrics["loss_total"]), li=float(metrics["loss_in"]),
                        ls=float(metrics["loss_ssim"]), lg=float(metrics["loss_grad"]),
                        t=ed - st, eta=datetime.timedelta(seconds=eta)))
                st = ed
    marks.append(stamp())
    if timed:
        torch.cuda.synchronize(device)
        step_seconds = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    else:
        step_seconds = [b - a for a, b in zip(marks, marks[1:])]
    os.makedirs(args.ckpt_dir, exist_ok=True)
    torch.save(net.state_dict(), ckpt)
    log.info(f"saved {ckpt}")
    return {"steps": step, "step_seconds": step_seconds, "loader_wait_seconds": waits,
            "losses": torch.stack(losses).tolist()}


def _dataset(args, ap, dataset: str):
    if args.synthetic > 0:
        size = args.image_size
        return SyntheticFusionDataset(length=args.synthetic, size=(size, size))
    try:
        ds = FusionDataset(split="train", dataset_name=dataset)
    except FileNotFoundError as e:
        ap.error(f"{dataset}: no dataset on disk ({e}); set FUSIONMAMBA_DATA_ROOT, "
                 "or pass --synthetic N")
    if len(ds) < args.batch_size:
        ap.error(f"{dataset}: {len(ds)} pairs on disk, fewer than the batch size")
    return ds


def main(argv=None) -> dict:
    """Run the CLI; returns {"steps", "step_seconds", "loader_wait_seconds",
    "losses", "seconds"} over all datasets trained. On the card a step's
    seconds run from the device reaching its start to reaching the next one
    (CUDA events), so they include any time the device waited for the host;
    a step's loader wait is the host's time in fetching its batch."""
    ap, args = parse_args(argv)
    if 0 < args.synthetic < args.batch_size:
        ap.error("--synthetic must be at least the batch size")
    try:
        device = select_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    log = _logger()
    tic = time.time()
    stats = {"steps": 0, "step_seconds": [], "loader_wait_seconds": [], "losses": []}
    for dataset in (DATASETS if args.dataset == "all" else (args.dataset,)):
        log.info(f"=== training fusion on {dataset} ===")
        run = train_fusion(args, _dataset(args, ap, dataset), dataset, device, log)
        stats = {k: stats[k] + run[k] for k in stats}
    stats["seconds"] = time.time() - tic
    return stats
