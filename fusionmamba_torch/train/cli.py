"""Fusion training CLI of the port (the counterpart of `train.py`).

    python -m fusionmamba_torch.train [--dataset pst900|acod|mfnet|all]
        [--epochs/-E 2] [--batch_size/-B 6] [--model full|tiny|test]
        [--ckpt_dir model_last/my_cross] [--num_workers/-j 8]
        [--synthetic N] [--image_size 256] [--device cuda|cpu]
        [--mesh NDATA,NMODEL] [--scan_impl adaptive|...|sp]
        [--precision auto|bf16|fp32]

    torchrun --nproc_per_node N -m fusionmamba_torch.train --mesh NDATA,NMODEL ...

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
given. `--precision bf16` trains in mixed precision (`loop.cast_compute`:
fp32 master weights and Adam state, bf16 compute through the kernels' bf16
variants); `auto`, the default, is fp32 (the JAX package's auto picks bf16
on a TPU only). The saved state dict is fp32 either way.

Under torchrun (or in a process group already made) the ranks form the mesh
`--mesh NDATA,NMODEL` (default: every rank data-parallel), as the JAX
package's `train.py --mesh` lays its devices out: each data rank takes
`-B / NDATA` rows of every global batch, the wide projections are sharded
over NMODEL (`parallel.apply_tensor_parallel`), and with `--scan_impl sp`
the scan's sequence axis too. Every rank loads the whole warm-start
checkpoint and takes its shards; rank 0 logs and saves the gathered whole
state dict, which loads into a single-process model. The backend is NCCL
when every rank has a card of its own, else gloo (`parallel.init_distributed`).
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
from ..config import SCAN_IMPLS, full_config, test_config, tiny_config
from ..data import FusionDataset, SyntheticFusionDataset, batch_iterator
from ..data.prefetch import device_prefetch, threaded_batches
from ..device import select_device
from ..models import VSSMFusion
from ..nn import init_weights
from ..parallel import (apply_tensor_parallel, gather_state_dict, init_distributed, make_mesh,
                        rank_rows, set_mesh)
from ..utils import rank_log_level
from .loop import (PRECISIONS, fusion_train_step, make_fusion_optimizer, reference_fusion_lr,
                   resolve_compute_dtype, set_learning_rate)

DATASETS = ("acod", "mfnet", "pst900")
CONFIGS = {"full": full_config, "tiny": tiny_config, "test": test_config}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="pst900", choices=[*DATASETS, "all"])
    ap.add_argument("--epochs", "-E", type=int, default=2)
    ap.add_argument("--batch_size", "-B", type=int, default=6)
    ap.add_argument("--model", choices=list(CONFIGS), default="full",
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
    ap.add_argument("--mesh", default="", metavar="NDATA,NMODEL",
                    help="rank mesh: the batch split over NDATA, the wide projections over "
                         "NMODEL (default: every rank data-parallel)")
    ap.add_argument("--scan_impl", default="adaptive", choices=SCAN_IMPLS,
                    help="sp also splits the scan's sequence over NMODEL; every other name "
                         "runs the port's one scan")
    ap.add_argument("--precision", default="auto", choices=PRECISIONS,
                    help="compute dtype: bf16 = mixed precision (fp32 master weights); "
                         "auto = fp32")
    return ap, ap.parse_args(argv)


def logger(name: str = "fusionmamba_torch.train") -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        log.addHandler(handler)
    log.setLevel(rank_log_level())
    return log


def epoch_batches(ds, batch_size: int, num_workers: int, epoch: int, device: torch.device,
                  rows: slice | None = None):
    """One epoch's shuffled batches as tensors on `device` (only `rows` of
    each, where given): loaded by `num_workers` threads and copied ahead of
    the step (`data.prefetch`), or with 0 workers loaded in the loop."""
    if num_workers > 0:
        return device_prefetch(threaded_batches(ds, batch_size, shuffle=True, seed=epoch,
                                                num_workers=num_workers, rows=rows), device)
    return (tuple(torch.from_numpy(b).to(device, non_blocking=True) for b in batch)
            for batch in batch_iterator(ds, batch_size, shuffle=True, seed=epoch, rows=rows))


class StepClock:
    """Step times: a mark of the device's progress (a recorded CUDA event)
    or, on the CPU, of the host clock, at the start of each step and at the
    end of each run of steps (`end`). A step's seconds run from its mark to
    the next, so on the card they include any time the device waited for
    the host."""

    def __init__(self, device: torch.device):
        self.device = device
        self.runs = [[]]

    def _stamp(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def mark(self) -> None:
        self.runs[-1].append(self._stamp())

    def end(self) -> None:
        if self.runs[-1]:
            self.runs[-1].append(self._stamp())
            self.runs.append([])

    def seconds(self) -> list:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        return [a.elapsed_time(b) / 1e3 if cuda else b - a
                for run in self.runs for a, b in zip(run, run[1:])]


def train_fusion(args, ds, dataset: str, device: torch.device, log: logging.Logger,
                 mesh) -> dict:
    net = init_weights(VSSMFusion(CONFIGS[args.model](scan_impl=args.scan_impl)), seed=0)
    ckpt = os.path.join(args.ckpt_dir, f"fusion_model_{dataset}.pth")
    if os.path.exists(ckpt):
        log.info(f"warm start from {ckpt}")
        load_reference_checkpoint(net, ckpt)
    sharded = apply_tensor_parallel(net, mesh)
    net.to(device)
    opt = make_fusion_optimizer(net.parameters())
    gen = torch.Generator(device=device).manual_seed(0)
    steps_per_epoch = len(ds) // args.batch_size
    total = steps_per_epoch * args.epochs
    rows = rank_rows(args.batch_size, mesh) if mesh.data.size > 1 else None
    log.info(f"{dataset}: {len(ds)} pairs, {steps_per_epoch} steps/epoch, on {device}, mesh "
             f"{mesh.n_data},{mesh.n_model}, {sharded} parameters sharded")

    clock, losses = StepClock(device), []
    waits = []               # host seconds each step waited for its batch
    step = 0
    st = glob_st = time.time()
    for epoch in range(1, args.epochs + 1):
        set_learning_rate(opt, reference_fusion_lr(epoch))
        batches = iter(epoch_batches(ds, args.batch_size, args.num_workers, epoch, device, rows))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            waits.append(time.perf_counter() - t0)
            clock.mark()
            # the on-disk datasets' items also carry a label, which fusion
            # training does not read
            metrics = fusion_train_step(net, opt, batch[0], batch[1], gen, mesh,
                                        compute_dtype=resolve_compute_dtype(args.precision))
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
    clock.end()
    step_seconds = clock.seconds()
    state = gather_state_dict(net, mesh)
    if mesh.rank == 0:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        torch.save(state, ckpt)
        log.info(f"saved {ckpt}")
    if mesh.world > 1:
        torch.distributed.barrier()
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


def _mesh_shape(ap, spec: str, world: int):
    if not spec:
        return world, 1
    try:
        n_data, n_model = (int(v) for v in spec.split(","))
    except ValueError:
        ap.error(f"--mesh takes NDATA,NMODEL, got {spec!r}")
    return n_data, n_model


def main(argv=None) -> dict:
    """Run the CLI; returns {"steps", "step_seconds", "loader_wait_seconds",
    "losses", "seconds", "world", "mesh", "backend", "peak_memory_bytes"}
    over all datasets trained (on every rank; the losses are the global
    batch's, the same on every rank). On the card a step's seconds run from
    the device reaching its start to reaching the next one (CUDA events), so
    they include any time the device waited for the host; a step's loader
    wait is the host's time in fetching its batch. `peak_memory_bytes` holds
    each rank's `torch.cuda.max_memory_allocated` (None on the CPU), in rank
    order."""
    ap, args = parse_args(argv)
    if 0 < args.synthetic < args.batch_size:
        ap.error("--synthetic must be at least the batch size")
    try:
        device = select_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    info = init_distributed(device)
    device = info.device
    try:
        n_data, n_model = _mesh_shape(ap, args.mesh, info.world)
        mesh = make_mesh(n_data, n_model)
        log = logger()
        if info.world > 1:
            log.info(f"{info.world} ranks, backend {info.backend}"
                     + (" (CUDA tensors staged through host memory for its collectives)"
                        if info.backend == "gloo" and device.type == "cuda" else ""))
        tic = time.time()
        stats = {"steps": 0, "step_seconds": [], "loader_wait_seconds": [], "losses": []}
        with set_mesh(mesh):
            for dataset in (DATASETS if args.dataset == "all" else (args.dataset,)):
                log.info(f"=== training fusion on {dataset} ===")
                run = train_fusion(args, _dataset(args, ap, dataset), dataset, device, log, mesh)
                stats = {k: stats[k] + run[k] for k in stats}
        stats["seconds"] = time.time() - tic
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        peaks = [peak]
        if info.world > 1:
            peaks = [None] * info.world
            torch.distributed.all_gather_object(peaks, peak)
        stats.update(world=info.world, mesh=[mesh.n_data, mesh.n_model], backend=info.backend,
                     peak_memory_bytes=peaks)
        return stats
    finally:
        if info.created:
            torch.distributed.destroy_process_group()
