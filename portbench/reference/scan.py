"""The selective scan in plain PyTorch: the benchmark's own, for its reference.

    h_l = exp(dt_l * A) * h_{l-1} + dt_l * B_l * u_l,   y_l = <C_l, h_l> + D * u_l,
    dt = softplus(delta + delta_bias)

(Gu & Dao, arXiv:2312.00752, Algorithm 2), in float32. The recurrence runs in
chunks: a sequential pass inside every chunk at once, then one across the
chunks' ends, so a sequence of length L takes about 2 sqrt(L) steps of whole
tensors. Its gradient is the same recurrence run backwards (`_Recurrence`),
so autograd keeps one tensor of states, not one per step.
"""
from __future__ import annotations

import math

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), written to be exact for every x."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 of (N, L, ...) tensors, h_{-1} = 0;
    returns every h_t, shape of b. No autograd of its own."""
    n, length = b.shape[:2]
    rest = b.shape[2:]
    t_len = max(1, int(math.ceil(math.sqrt(length))))
    chunks = -(-length // t_len)
    pad = chunks * t_len - length
    if pad:
        a = torch.cat([a, a.new_ones((n, pad) + rest)], 1)
        b = torch.cat([b, b.new_zeros((n, pad) + rest)], 1)
    a = a.reshape((n, chunks, t_len) + rest)
    b = b.reshape((n, chunks, t_len) + rest)
    # inside each chunk from a zero state: the states, and the products of a
    local, prod = torch.empty_like(b), torch.empty_like(a)
    h, p = torch.zeros_like(b[:, :, 0]), torch.ones_like(a[:, :, 0])
    for t in range(t_len):
        h = torch.addcmul(b[:, :, t], a[:, :, t], h, out=local[:, :, t])
        p = torch.mul(a[:, :, t], p, out=prod[:, :, t])
    # across the chunks: each takes the state its predecessor ended on
    for c in range(1, chunks):
        local[:, c].addcmul_(prod[:, c], local[:, c - 1, -1].unsqueeze(1))
    return local.reshape((n, chunks * t_len) + rest)[:, :length]


class _Recurrence(torch.autograd.Function):
    """`recurrence` with its adjoint: g_t = dh_t + a_{t+1} g_{t+1}, then
    db_t = g_t and da_t = g_t h_{t-1}."""

    @staticmethod
    def forward(ctx, a, b):
        h = recurrence(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
        g = recurrence(a_next.flip(1), dh.flip(1)).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        return g * h_prev, g


def linear_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`recurrence`, differentiable."""
    return _Recurrence.apply(a, b)


def selective_scan(u, delta, A, Bm, Cm, D, delta_bias):
    """u, delta (B, K, L, D); A (K, D, N); Bm, Cm (B, K, L, N); D, delta_bias
    (K, D) -> y (B, K, L, D), all float32."""
    b, k, length, d = u.shape
    n = A.shape[-1]
    dt = softplus(delta + delta_bias[None, :, None, :])
    da = torch.exp(dt[..., None] * A[None, :, None])                 # (B, K, L, D, N)
    dbu = (dt * u)[..., None] * Bm[:, :, :, None, :]
    h = linear_recurrence(da.reshape(b * k, length, d, n), dbu.reshape(b * k, length, d, n))
    del da, dbu
    y = torch.einsum("bkldn,bkln->bkld", h.reshape(b, k, length, d, n), Cm)
    return y + u * D[None, :, None, :]
