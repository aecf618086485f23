"""Launch wrappers of the selective-scan kernels: the forward
(`csrc/selective_scan_fwd.cu`; replaces
`fusionmamba_tpu/ops/scan_pallas.py::_fwd_kernel`) and the backward
(`csrc/selective_scan_bwd.cu`; replaces `::_bwd_kernel`).

Both run one thread per (b, k, d) channel with its 16 states in registers
and stage dt, B and C of a chunk of steps in shared memory. The forward is
bound by the bytes of u and y and, at the deep stages, by how few channels
there are to run in parallel; the backward by that latency too, as it walks
every channel's steps twice. For training the forward saves the states at
the start of every `SAVE_EVERY` steps, from which the backward recomputes
each chunk of states. See the sources for the designs.
"""
from __future__ import annotations

import torch

from . import cuda_lib

MAX_STATE = 16      # kMaxN in the sources
SAVE_EVERY = 16     # steps between saved states: the backward's chunk
_SMEM_LIMIT = 48 * 1024
_BWD_SMEM_LIMIT = 227 * 1024
_BWD_THREADS = 64   # kThreads of the backward: channels per block

launches = 0
bwd_launches = 0


def _check(u, delta, A, Bmat, Cmat, D, delta_bias, dt_lowrank_weight):
    """Raise on what the kernels do not take; returns (batch, K, L, dim, N, R)."""
    batch, K, L, dim = u.shape
    N = A.shape[-1]
    R = 0 if dt_lowrank_weight is None else dt_lowrank_weight.shape[-1]
    if N > MAX_STATE:
        raise ValueError(f"selective_scan: d_state {N} > {MAX_STATE}")
    if batch * K > 65535:   # the grid's y dimension
        raise ValueError(f"selective_scan: batch * K = {batch * K} > 65535")
    if 4 * (64 * R + 32 * (R + 2 * N)) > _SMEM_LIMIT:
        raise ValueError(f"selective_scan: dt rank {R} too large for the kernel")
    want_dt = (batch, K, L, R) if R else (batch, K, L, dim)
    if (tuple(delta.shape) != want_dt or tuple(A.shape) != (K, dim, N)
            or tuple(Bmat.shape) != (batch, K, L, N) or Cmat.shape != Bmat.shape):
        raise ValueError("selective_scan: inconsistent shapes")
    tensors = [u, delta, A, Bmat, Cmat]
    for opt, shape in ((dt_lowrank_weight, (K, dim, R)), (D, (K, dim)),
                       (delta_bias, (K, dim))):
        if opt is not None:
            if tuple(opt.shape) != shape:
                raise ValueError("selective_scan: inconsistent shapes")
            tensors.append(opt)
    cuda_lib.check_cuda_float32("selective_scan", *tensors)
    return batch, K, L, dim, N, R


def _ptr(t):
    return None if t is None else t.data_ptr()


def selective_scan_fwd(u, delta, A, Bmat, Cmat, D, delta_bias, delta_softplus,
                       dt_lowrank_weight, save_states=False):
    """fp32 scan on the card. Shapes as `selective_scan`; `delta` is the
    low-rank (B, K, L, R) dt when `dt_lowrank_weight` (K, D, R) is given.
    Returns y, or (y, hsave) with `save_states`, hsave being the states at
    the start of every SAVE_EVERY steps, (B*K, ceil(L/SAVE_EVERY), N, D)."""
    global launches
    batch, K, L, dim, N, R = _check(u, delta, A, Bmat, Cmat, D, delta_bias,
                                    dt_lowrank_weight)
    out = torch.empty_like(u)
    hsave = None
    if save_states:
        n_save = -(-L // SAVE_EVERY)
        hsave = torch.empty((batch * K, n_save, N, dim), device=u.device, dtype=torch.float32)
    cuda_lib.launch(
        "fm_selective_scan_fwd", u.data_ptr(), delta.data_ptr(),
        _ptr(dt_lowrank_weight), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
        _ptr(D), _ptr(delta_bias), out.data_ptr(), _ptr(hsave), batch, K, L, dim, N, R,
        int(delta_softplus), SAVE_EVERY, device=u.device)
    launches += 1
    return (out, hsave) if save_states else out


def selective_scan_bwd(u, delta, A, Bmat, Cmat, D, delta_bias, dt_lowrank_weight,
                       hsave, dy, delta_softplus):
    """Gradients of `selective_scan_fwd` for the cotangent dy (B, K, L, D),
    given the states it saved: (du, ddelta, dA, dB, dC, dD, dbias, dW), each
    in the shape of its input (None for an input that was None). The
    kernel's per-d-block and per-batch partials are summed here."""
    global bwd_launches
    batch, K, L, dim, N, R = _check(u, delta, A, Bmat, Cmat, D, delta_bias,
                                    dt_lowrank_weight)
    n_chunk = -(-L // SAVE_EVERY)
    if tuple(hsave.shape) != (batch * K, n_chunk, N, dim) or dy.shape != u.shape:
        raise ValueError("selective_scan backward: inconsistent shapes")
    cuda_lib.check_cuda_float32("selective_scan backward", u, hsave, dy)
    smem = 4 * (2 * R * _BWD_THREADS + SAVE_EVERY * (R + 2 * N)
                + 2 * SAVE_EVERY * _BWD_THREADS + (SAVE_EVERY + 1) * N * _BWD_THREADS
                + 2 * SAVE_EVERY * (2 * N + R))
    if smem > _BWD_SMEM_LIMIT:
        raise ValueError(f"selective_scan backward: dt rank {R} too large for the kernel")
    n_dblk = -(-dim // _BWD_THREADS)
    BK, dev = batch * K, u.device

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    du = torch.empty_like(u)
    ddt = empty(BK, n_dblk, L, R) if R else torch.empty_like(delta)
    dW_p = empty(BK, dim, R) if R else None
    dA_p, dB_p, dC_p = empty(BK, dim, N), empty(BK, n_dblk, L, N), empty(BK, n_dblk, L, N)
    dD_p = None if D is None else empty(BK, dim)
    dbias_p = None if delta_bias is None else empty(BK, dim)
    cuda_lib.launch(
        "fm_selective_scan_bwd", u.data_ptr(), delta.data_ptr(), _ptr(dt_lowrank_weight),
        A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), _ptr(D), _ptr(delta_bias),
        hsave.data_ptr(), dy.data_ptr(), du.data_ptr(), ddt.data_ptr(), _ptr(dW_p),
        dA_p.data_ptr(), dB_p.data_ptr(), dC_p.data_ptr(), _ptr(dD_p), _ptr(dbias_p),
        batch, K, L, dim, N, R, SAVE_EVERY, int(delta_softplus), device=dev)
    bwd_launches += 1

    def over_batch(p, *tail):
        return None if p is None else p.view(batch, K, *tail).sum(0)

    def over_dblk(p, width):
        return p.view(batch, K, n_dblk, L, width).sum(2)

    return (du, over_dblk(ddt, R) if R else ddt, over_batch(dA_p, dim, N),
            over_dblk(dB_p, N), over_dblk(dC_p, N), over_batch(dD_p, dim),
            over_batch(dbias_p, dim), over_batch(dW_p, dim, R))
