"""Sequence-parallel selective scan over a mesh axis (the counterpart of
`fusionmamba_tpu/parallel/seq_scan.py`).

Each rank of the axis scans its own contiguous shard of L from a zero state
through `ops.selective_scan` (kernels #1 and #2 on the card, the plain scan
on the CPU). The shards are then joined as the scan kernel joins its chunks:
each rank forms its shard's last state and its decay product over the shard
(plain torch, as the JAX package forms them in jnp, because the kernel
returns no last state), the ranks exchange them, every rank combines those
of the shards before it into its incoming state h_in, and corrects its
outputs exactly:

    y_l += C_l . (exp(A * T_l) * h_in),   T_l = cumsum(dt)_l over the shard,
    last = sum_l exp(A * (T_end - T_l)) * dt_l * B_l * u_l,   prod = exp(A * T_end).

Every exponent is <= 0 for the model's negative A, so nothing overflows.
The (B, K, l, D, N) terms of `last` and of the correction are formed a
chunk of positions at a time under `torch.utils.checkpoint`, so that no more
than `TERM_ELEMS` floats of them are live at once, in the forward or the
backward; chunking changes no arithmetic but the order of `last`'s sum.

Layouts as `ops/selective_scan.py`: u, delta (B, K, L, D) (delta the
low-rank (B, K, L, R) with `dt_lowrank_weight` (K, D, R)), A (K, D, N),
Bmat, Cmat (B, K, L, N), D, delta_bias (K, D). The inputs are replicated
over the axis and so is the output; every input's gradient is whole on
every rank (`parallel.collectives`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.selective_scan import materialize_dt, selective_scan, softplus
from .collectives import all_gather, replicate, scatter
from .mesh import Mesh, get_mesh

# floats of one chunk's (B, K, c, D, N) terms
TERM_ELEMS = 1 << 24


def _last_chunk(du, tcum, Bm, t_end, A):
    """sum_l exp(A (T_end - T_l)) * (dt u)_l * B_l over one chunk -> (B, K, D, N)."""
    w = torch.exp(A[None, :, None] * (t_end[:, :, None] - tcum)[..., None])
    return torch.einsum("bkldn,bkld,bkln->bkdn", w, du, Bm)


def _corr_chunk(Cm, tcum, A, h_in):
    """C_l . (exp(A T_l) * h_in) over one chunk -> (B, K, c, D)."""
    w = torch.exp(A[None, :, None] * tcum[..., None])
    return torch.einsum("bkln,bkldn,bkdn->bkld", Cm, w, h_in)


def _chunks(fn, chunked, shared, length: int, per_step: int):
    """fn over chunks of positions (dim 2 of each `chunked` tensor), each
    under checkpoint when autograd records; a list of the chunk results."""
    step = max(1, TERM_ELEMS // max(per_step, 1))
    out = []
    for s in range(0, length, step):
        args = [t[:, :, s:s + step] for t in chunked] + list(shared)
        if torch.is_grad_enabled():
            out.append(checkpoint(fn, *args, use_reentrant=False))
        else:
            out.append(fn(*args))
    return out


def selective_scan_seq_parallel(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                                delta_softplus=False, *, dt_lowrank_weight=None,
                                mesh: Mesh | None = None, axis: str = "model"):
    """The scan with L split over `mesh`'s `axis`; y (B, K, L, D), whole on
    every rank. mesh=None reads the ambient mesh (`parallel.set_mesh`), which
    is how `scan_impl="sp"` reaches this path. L must divide by the axis'
    size."""
    if mesh is None:
        mesh = get_mesh()
        if mesh is None:
            raise ValueError("impl='sp' needs a mesh: pass mesh=... or set the ambient mesh "
                             "with fusionmamba_torch.parallel.set_mesh(make_mesh(...))")
    ax = mesh.axis(axis)
    L = u.shape[2]
    if L % ax.size:
        raise ValueError(f"selective_scan_seq_parallel: L = {L} does not divide over the "
                         f"{ax.size} ranks of {axis!r}")
    if ax.size == 1:
        return selective_scan(u, delta, A, Bmat, Cmat, D, delta_bias, delta_softplus,
                              dt_lowrank_weight)
    u_s, dt_s, B_s, C_s = (scatter(t, 2, ax) for t in (u, delta, Bmat, Cmat))
    A_r, D_r, bias_r, W_r = (None if t is None else replicate(t, ax)
                             for t in (A, D, delta_bias, dt_lowrank_weight))
    y_loc = selective_scan(u_s, dt_s, A_r, B_s, C_s, D_r, bias_r, delta_softplus, W_r)

    Bsz, K, l, Dm = u_s.shape
    N = A.shape[-1]
    Af = A_r.float()
    deff = materialize_dt(dt_s.float(), W_r)
    if bias_r is not None:
        deff = deff + bias_r.float()[None, :, None, :]
    if delta_softplus:
        deff = softplus(deff)
    tcum = torch.cumsum(deff, dim=2)                       # (B, K, l, D)
    t_end = tcum[:, :, -1]
    per_step = Bsz * K * Dm * N
    last = sum(_chunks(_last_chunk, (deff * u_s.float(), tcum, B_s.float()), (t_end, Af),
                       l, per_step))
    prod = torch.exp(Af[None] * t_end[..., None])          # (B, K, D, N)
    # every shard's carry on every rank; each rank reads those before it
    all_last = all_gather(last[None], 0, ax, backward="sum")
    all_prod = all_gather(prod[None], 0, ax, backward="sum")
    h_in = torch.zeros_like(last)
    for t in range(ax.size):
        # arithmetic masks, not a loop that stops at this rank: every rank
        # must read every gathered carry, so that every rank's backward runs
        # the gathers' collectives
        m = 1.0 if t < ax.index else 0.0
        h_in = m * (all_prod[t] * h_in + all_last[t]) + (1.0 - m) * h_in
    corr = torch.cat(_chunks(_corr_chunk, (C_s.float(), tcum), (Af, h_in), l, per_step), dim=2)
    y = (y_loc.float() + corr).to(u.dtype)
    return all_gather(y, 2, ax, backward="slice")
