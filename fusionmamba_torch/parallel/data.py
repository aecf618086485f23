"""Data parallelism over the mesh's "data" axis.

Each data rank takes its rows of one global batch (the same shuffle on every
rank: `rank_rows`), and its columns of the step's one DropPath table, drawn
whole at the global batch from a generator seeded alike on every rank
(`local_dp_table`), so that a step over the ranks is the single-process step
on the global batch. The fusion loss is a function of the global batch (the
MS-SSIM's level means and its dynamic range span it), so its means are
all-reduced inside the loss (`losses.fusion_loss(..., axis=)`); each rank's
backward then yields its rows' share of the gradient, which
`sync_gradients` sums.

The gradients are summed explicitly, not by DistributedDataParallel: the
sum must run on the data axis only (tensor-parallel shards differ along the
model axis), go through host memory under gloo as every collective of the
port does (`parallel.collectives`), and leave the parameters that no loss
reaches (the finest VSSBlockCross) without a gradient, as the
single-process step leaves them, so that Adam skips them there too.
"""
from __future__ import annotations

import torch

from .collectives import reduce_sum
from .mesh import Mesh

# floats all-reduced at a time
BUCKET_ELEMS = 1 << 24


def rank_rows(batch_size: int, mesh: Mesh) -> slice:
    """The rows of a global batch of `batch_size` that this data rank takes."""
    n = mesh.data.size
    if batch_size % n:
        raise ValueError(f"batch size {batch_size} does not divide over {n} data ranks")
    per = batch_size // n
    return slice(mesh.data.index * per, (mesh.data.index + 1) * per)


def local_dp_table(net, generator, global_batch: int, mesh: Mesh, device) -> torch.Tensor:
    """This data rank's columns of the step's DropPath table: the table of
    the global batch (rows, 2 * global_batch) drawn from `generator`, of
    which the encoder's 2B columns are [modality 1's samples, modality 2's];
    the rank keeps both halves' columns of its own samples."""
    table = torch.rand(net.dp_table_shape(global_batch), generator=generator, device=device)
    rows = rank_rows(global_batch, mesh)
    return torch.cat([table[:, rows], table[:, global_batch:][:, rows]], dim=1)


def sync_gradients(params, mesh: Mesh) -> None:
    """Sum the parameters' gradients over the data axis, in buckets, in
    place; a parameter without a gradient keeps none (on every rank alike:
    every rank runs the same graph)."""
    ax = mesh.data
    if ax.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    start = 0
    while start < len(grads):
        end, n = start, 0
        while end < len(grads) and (end == start or n + grads[end].numel() <= BUCKET_ELEMS):
            n += grads[end].numel()
            end += 1
        flat = reduce_sum(torch.cat([g.reshape(-1) for g in grads[start:end]]), ax)
        for g, part in zip(grads[start:end], flat.split([g.numel() for g in grads[start:end]])):
            g.copy_(part.view_as(g))
        start = end
