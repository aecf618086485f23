"""Collectives over one mesh axis, as autograd Functions whose backward is
written out.

Every rank runs the same program on its part of the work and keeps its own
copy of whatever is replicated. The loss is such a copy: each rank
backpropagates it once, with a cotangent of 1. Which backward a collective
needs depends on who reads its output:

  * `all_reduce(x, backward="identity")`: the sum of the ranks' partial x,
    read the same way by every rank (a loss term's sum over the batch, a
    row-parallel product). The cotangent of the sum is the cotangent of each
    partial, so the backward passes it through; the gradient a rank then
    forms for a shared parameter covers its own partial only, and the
    gradients are summed over the ranks afterwards (`data.sync_gradients`)
    or are complete because the ranks' partials differ by parameter shard.
  * `all_reduce(x, backward="sum")`: the sum, read differently by each rank
    (x_proj's product feeding each rank's channel shard of the scan): each
    rank's cotangent covers its own use, so the backward sums them.
  * `all_gather(x, dim, backward="slice")`: the ranks' pieces joined, read
    the same way by every rank: the backward keeps this rank's slice of the
    cotangent. With backward="sum" (read differently by each rank, the
    sequence-parallel scan's carries) it sums the cotangents first.
  * `scatter(x, dim)`: this rank's slice of a replicated x: the backward
    gathers the ranks' slices, so every rank holds x's whole gradient.
  * `replicate(x)`: the identity on a replicated x that each rank reads
    differently (the input of a column-parallel product): the backward sums
    the ranks' cotangents.
  * `first_rank_only(x)`: x on the axis' first rank and zeros elsewhere (a
    bias added once before a row-parallel sum). The cotangent reaching it
    is the same on every rank, so each rank passes it through as x's whole
    gradient.

On an axis of one rank every helper is the identity. Under gloo (see
`mesh.Axis.stage_on_host`) a CUDA tensor is copied to host memory for the
collective and the result copied back. bf16 sums and maxima are taken in
fp32.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Axis


def _host(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    return t.cpu() if axis.stage_on_host and t.is_cuda else t


def _reduce(t: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    """A bf16 t is reduced in fp32 and rounded back once (gloo has no bf16
    sum; for two ranks this rounds as a bf16 sum does)."""
    if axis.size == 1:
        return t.detach().clone()
    buf = _host(t.detach(), axis).contiguous().clone()
    if buf.dtype == torch.bfloat16:
        buf = buf.float()
    dist.all_reduce(buf, op=op, group=axis.group)
    return buf.to(t.device, t.dtype)


def reduce_sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum of t over `axis`, outside autograd; a new tensor."""
    return _reduce(t, axis, dist.ReduceOp.SUM)


def reduce_max(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise largest t over `axis`, outside autograd; a new tensor."""
    return _reduce(t, axis, dist.ReduceOp.MAX)


def gather_list(t: torch.Tensor, axis: Axis) -> list:
    """Every rank's t along `axis`, in rank order, outside autograd."""
    if axis.size == 1:
        return [t]
    src = _host(t.detach(), axis).contiguous()
    out = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(out, src, group=axis.group)
    return [o.to(t.device) for o in out]


def _slice(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    if t.shape[dim] % axis.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{axis.size} ranks of {axis.name!r}")
    return t.chunk(axis.size, dim)[axis.index].contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, sum_grad):
        ctx.axis, ctx.sum_grad = axis, sum_grad
        return reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, dy):
        return (reduce_sum(dy, ctx.axis) if ctx.sum_grad else dy), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, sum_grad):
        ctx.dim, ctx.axis, ctx.sum_grad = dim, axis, sum_grad
        return torch.cat(gather_list(x, axis), dim)

    @staticmethod
    def backward(ctx, dy):
        if ctx.sum_grad:
            dy = reduce_sum(dy, ctx.axis)
        return _slice(dy, ctx.dim, ctx.axis), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _slice(x, dim, axis)

    @staticmethod
    def backward(ctx, dy):
        return torch.cat(gather_list(dy.contiguous(), ctx.axis), ctx.dim), None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return reduce_sum(dy, ctx.axis), None


class _FirstRankOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return x.clone() if axis.index == 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def _sums_grad(backward: str, other: str) -> bool:
    if backward not in (other, "sum"):
        raise ValueError(f"backward must be {other!r} or 'sum', got {backward!r}")
    return backward == "sum"


def all_reduce(x: torch.Tensor, axis: Axis, backward: str = "identity") -> torch.Tensor:
    """Sum of x over `axis`; `backward` "identity" or "sum" (module doc)."""
    sum_grad = _sums_grad(backward, "identity")
    return x if axis.size == 1 else _AllReduce.apply(x, axis, sum_grad)


def all_gather(x: torch.Tensor, dim: int, axis: Axis, backward: str = "slice") -> torch.Tensor:
    """The ranks' x joined along `dim` in rank order; `backward` "slice" or
    "sum" (module doc)."""
    sum_grad = _sums_grad(backward, "slice")
    return x if axis.size == 1 else _AllGather.apply(x, dim % x.dim(), axis, sum_grad)


def scatter(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's contiguous slice of x along `dim` (module doc)."""
    return x if axis.size == 1 else _Scatter.apply(x, dim % x.dim(), axis)


def replicate(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x, with the ranks' cotangents summed in the backward (module doc)."""
    return x if axis.size == 1 else _Replicate.apply(x, axis)


def first_rank_only(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x on the axis' first rank, zeros elsewhere (module doc)."""
    return x if axis.size == 1 else _FirstRankOnly.apply(x, axis)
