"""Selective scan: the public op, its plain PyTorch version, and the dispatch
to the CUDA kernels (`scan_cuda.py`).

Channels-last layout, as in `fusionmamba_tpu/ops/selective_scan.py`:
    u, delta : (B, K, L, D)   A: (K, D, N)   Bmat, Cmat: (B, K, L, N)
    D, delta_bias: (K, D)
K is the direction axis of the four-direction 2-D scan. The recurrence is
    h_l = exp(dt_l * A) * h_{l-1} + dt_l * B_l * u_l,   y_l = <C_l, h_l> + D * u_l
in fp32, with dt = softplus(delta + delta_bias) when `delta_softplus`.
"""
from __future__ import annotations

import torch

from . import cuda_lib, scan_cuda


def softplus(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + log1p(exp(-|x|)): the reference's form, exact for every x
    (torch's F.softplus switches to the identity above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def materialize_dt(delta, dt_lowrank_weight):
    """(B, K, L, R) @ (K, D, R) -> (B, K, L, D) full dt."""
    if dt_lowrank_weight is None:
        return delta
    return torch.einsum("bklr,kdr->bkld", delta, dt_lowrank_weight.to(delta.dtype))


def selective_scan_plain(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                         delta_softplus=False, dt_lowrank_weight=None):
    """Sequential scan over L, exact at any dt. Shapes as the module doc."""
    in_dtype = u.dtype
    u = u.float()
    delta = materialize_dt(delta.float(), dt_lowrank_weight)
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None, :]
    if delta_softplus:
        delta = softplus(delta)
    A = A.float()
    dA = torch.exp(delta[..., None] * A[None, :, None])                # (B,K,L,D,N)
    dBu = (delta * u)[..., None] * Bmat.float()[:, :, :, None, :]       # (B,K,L,D,N)
    h = torch.zeros_like(dA[:, :, 0])
    ys = []
    # unbind, not indexing: autograd then gathers the steps' gradients in one
    # stack, where each index's backward would write a zero-filled copy of
    # the whole tensor (quadratic in L)
    for dA_l, dBu_l, C_l in zip(dA.unbind(2), dBu.unbind(2), Cmat.float().unbind(2)):
        h = dA_l * h + dBu_l
        ys.append(torch.einsum("bkdn,bkn->bkd", h, C_l))
    out = torch.stack(ys, dim=2)
    if D is not None:
        out = out + u * D.float()[None, :, None, :]
    return out.to(in_dtype)


class _ScanFn(torch.autograd.Function):
    """The scan on the card with its backward kernel; the forward saves the
    chunk states that the backward restarts from."""

    @staticmethod
    def forward(ctx, u, delta, A, Bmat, Cmat, D, delta_bias, dt_lowrank_weight,
                delta_softplus):
        out, hsave = scan_cuda.selective_scan_fwd(
            u, delta, A, Bmat, Cmat, D, delta_bias, delta_softplus, dt_lowrank_weight,
            save_states=True)
        ctx.save_for_backward(u, delta, A, Bmat, Cmat, D, delta_bias, dt_lowrank_weight,
                              hsave)
        ctx.delta_softplus = delta_softplus
        return out

    @staticmethod
    def backward(ctx, dy):
        *inputs, hsave = ctx.saved_tensors
        grads = scan_cuda.selective_scan_bwd(*inputs, hsave, dy.contiguous(),
                                             ctx.delta_softplus)
        return (*grads, None)


def selective_scan(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                   delta_softplus=False, dt_lowrank_weight=None):
    """The scan. With `dt_lowrank_weight` (K, D, R) given, `delta` is the
    low-rank (B, K, L, R) dt, expanded inside the kernel on the card.

    CPU tensors take the plain version, differentiated by autograd. CUDA
    tensors take the forward kernel and, when a gradient is needed, the
    backward kernel; both raise on what they do not take."""
    if u.device.type == "cpu":
        return selective_scan_plain(u, delta, A, Bmat, Cmat, D, delta_bias,
                                    delta_softplus, dt_lowrank_weight)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan: no implementation for {u.device}")
    args = (u, delta, A, Bmat, Cmat, D, delta_bias, dt_lowrank_weight)
    if cuda_lib.needs_grad(*args):
        return _ScanFn.apply(*args, delta_softplus)
    return scan_cuda.selective_scan_fwd(u, delta, A, Bmat, Cmat, D, delta_bias,
                                        delta_softplus, dt_lowrank_weight)
