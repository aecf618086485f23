"""Launch wrappers of the selective-scan kernels: the forward
(`csrc/selective_scan_fwd.cu`; replaces
`fusionmamba_tpu/ops/scan_pallas.py::_fwd_kernel`) and the backward
(`csrc/selective_scan_bwd.cu`; replaces `::_bwd_kernel`).

Both spread a (b, k, d) channel's 16 states over 4 lanes, stage every input
of the serial loop in shared memory one tile ahead (cp.async), and cut L into
chunks that run in parallel and are joined by carries where the channels
alone cannot fill the card (`chunk_len` picks the cut;
`tests/test_torch_scan_chunked.py` holds the algebra in plain PyTorch against
the sequential scan). For training the forward saves the
states at the start of every `SAVE_EVERY` steps, from which the backward
recomputes each tile of states. See the sources for the designs.

Both take fp32 or bf16 I/O (`cuda_lib.entry`): u, dt, its low-rank weight,
B, C, y and their gradients in the I/O dtype, A, D, the dt bias, the saved
states and their gradients fp32, as the JAX package's kernels take them;
the math inside is fp32 either way. The bf16 variants form the low-rank
products on the bf16 tensor cores (exact products, fp32 sums), take the
softplus in MUFU form, and have shared-memory layouts of their own
(`fwd_smem_bytes`, `bwd_smem_bytes` take the I/O dtype).
"""
from __future__ import annotations


import torch
import torch.nn.functional as F

from ..utils import tracing
from . import cuda_lib

MAX_STATE = 16      # kMaxN in the sources
SAVE_EVERY = 8      # steps between saved states: the backward's tile
TILE = 16           # the kernels stage 16 steps at a time: chunks are multiples
MIN_CHUNK = 64      # no chunk shorter than this: each costs a carry
_SMEM_LIMIT = 227 * 1024
_FWD_BLOCK, _BWD_BLOCK = 32, 64   # channels per block (kDB in the sources)
_LANES = 4          # lanes per channel
# (enough, target) warps an SM for `chunk_len`: L is cut where the unchunked
# call would keep fewer than `enough` warps on an SM, into the largest power
# of two of chunks that does not pass `target`. A chunked forward repeats
# every exp in its local pass, so it is cut only on a mostly empty card; the
# backward's local pass is a small part of it, so it is cut earlier and finer
# (tools/scan_tune.py times both)
FWD_WARPS_PER_SM = (8, 40)
BWD_WARPS_PER_SM = (16, 72)


def chunk_len(L: int, threads: int, enough_threads: int, target_threads: int) -> int:
    """Steps per chunk, a multiple of TILE. One chunk (a length >= L, no
    carry pass) where the unchunked call's `threads` already reach
    `enough_threads`: cutting L repeats every exp in a local pass, which pays
    only on a card that is mostly empty. Else the largest power of two of
    chunks (two or more) that passes neither `target_threads` nor
    L / MIN_CHUNK."""
    n = 1
    if threads < enough_threads:
        most = min(L // MIN_CHUNK, target_threads // max(threads, 1))
        if most >= 2:
            n = 1 << (most.bit_length() - 1)
    return max(TILE, -(-(-(-L // n)) // TILE) * TILE)


def _check(u, delta, A, Bmat, Cmat, D, delta_bias, dt_lowrank_weight):
    """Raise on what the kernels do not take; returns (batch, K, L, dim, N,
    R, the I/O dtype)."""
    batch, K, L, dim = u.shape
    N = A.shape[-1]
    R = 0 if dt_lowrank_weight is None else dt_lowrank_weight.shape[-1]
    if N > MAX_STATE:
        raise ValueError(f"selective_scan: d_state {N} > {MAX_STATE}")
    if batch * K > 65535:   # the grid's z dimension
        raise ValueError(f"selective_scan: batch * K = {batch * K} > 65535")
    want_dt = (batch, K, L, R) if R else (batch, K, L, dim)
    if (tuple(delta.shape) != want_dt or tuple(A.shape) != (K, dim, N)
            or tuple(Bmat.shape) != (batch, K, L, N) or Cmat.shape != Bmat.shape):
        raise ValueError("selective_scan: inconsistent shapes")
    for opt, shape in ((dt_lowrank_weight, (K, dim, R)), (D, (K, dim)),
                       (delta_bias, (K, dim))):
        if opt is not None and tuple(opt.shape) != shape:
            raise ValueError("selective_scan: inconsistent shapes")
    io = cuda_lib.io_dtype("selective_scan", u)
    cuda_lib.check_cuda("selective_scan", io,
                        *(t for t in (u, delta, Bmat, Cmat, dt_lowrank_weight) if t is not None),
                        fp32=[t for t in (A, D, delta_bias) if t is not None])
    return batch, K, L, dim, N, R, io


def _round4(x):
    return (x + 3) & ~3


def _round(x, m):
    return -(-x // m) * m


def w16_ld(R):
    """Row stride of the bf16 variants' W tile [channel][r] (`w16_ld` in
    `csrc/scan_common.cuh`): R rounded up to 16, plus 8."""
    return _round(R, 16) + 8


def fwd_smem_bytes(N, R, io=torch.float32):
    """Dynamic shared memory of a forward block (`smem_bytes` in the
    source): W (fp32 [R][33], or bf16 [32][w16_ld(R)] in the bf16 variant),
    the bias, delta, the lanes' parts of y and two ring stages of I/O tiles."""
    stage = TILE * _FWD_BLOCK + (TILE * R if R else TILE * _FWD_BLOCK) + 2 * TILE * N
    rest = 4 * (_FWD_BLOCK + TILE * _FWD_BLOCK * (1 + _LANES))
    if io == torch.bfloat16:
        return (2 * _FWD_BLOCK * w16_ld(R) if R else 0) + rest + 2 * 2 * stage
    return 4 * _round4(R * (_FWD_BLOCK + 1)) + rest + 4 * 2 * stage


def bwd_smem_bytes(N, R, io=torch.float32):
    """Dynamic shared memory of a block of the backward's main pass (fp32:
    `smem_bytes` in the source; bf16: `Bf16Layout`)."""
    DB, T = _BWD_BLOCK, SAVE_EVERY
    h = 4 * (T + 1) * (DB * MAX_STATE + 16)
    if io == torch.bfloat16:
        stage = (2 * (2 * T * DB + (_round(T * R, 8) if R else T * DB) + 2 * T * MAX_STATE)
                 + 4 * DB * MAX_STATE)   # B and C with room for 16 states
        w16 = 2 * DB * w16_ld(R) if R else 0
        wt, dw = 2 * _round(R, 8) * (DB + 8), 16 * -(-R // 16) * _LANES * DB
        return w16 + wt + dw + 4 * DB + 2 * 4 * T * DB + h + 2 * stage
    stage = (2 * T * DB + (_round4(T * R) if R else T * DB) + 2 * _round4(T * N)
             + DB * MAX_STATE)
    return 4 * (2 * _round4(R * (DB + 1)) + DB + 2 * T * DB + 2 * stage) + h


def _pick_chunk(chunk, batch, K, L, dim, device, warps_per_sm):
    """The chunk length in steps: the caller's, or what fills the card."""
    if chunk is None:
        per_warp_an_sm = cuda_lib.sm_count(device) * 32
        return chunk_len(L, batch * K * dim * _LANES, warps_per_sm[0] * per_warp_an_sm,
                         warps_per_sm[1] * per_warp_an_sm)
    if chunk < TILE or chunk % TILE:
        raise ValueError(f"selective_scan: chunk {chunk} is not a multiple of {TILE}")
    return chunk


def _ptr(t):
    return None if t is None else t.data_ptr()


def selective_scan_fwd(u, delta, A, Bmat, Cmat, D, delta_bias, delta_softplus,
                       dt_lowrank_weight, save_states=False, chunk=None):
    """The scan on the card, in u's I/O dtype (module doc). Shapes as
    `selective_scan`; `delta` is the
    low-rank (B, K, L, R) dt when `dt_lowrank_weight` (K, D, R) is given.
    Returns y, or (y, hsave) with `save_states`, hsave being the states at
    the start of every SAVE_EVERY steps, (B*K, ceil(L/SAVE_EVERY), D, N).
    `chunk` overrides the chunk length (a multiple of 16 steps)."""
    batch, K, L, dim, N, R, io = _check(u, delta, A, Bmat, Cmat, D, delta_bias,
                                        dt_lowrank_weight)
    if fwd_smem_bytes(N, R, io) > _SMEM_LIMIT:
        raise ValueError(f"selective_scan: dt rank {R} too large for the kernel")
    dev = u.device
    out = torch.empty_like(u)
    hsave = None
    if save_states:
        hsave = torch.empty((batch * K, -(-L // SAVE_EVERY), dim, N), device=dev,
                            dtype=torch.float32)
    chunk = _pick_chunk(chunk, batch, K, L, dim, dev, FWD_WARPS_PER_SM)
    n_chunk = -(-L // chunk)
    carry = sdel = None
    if n_chunk > 1:   # scratch of the carry pass
        carry = torch.empty((batch * K, n_chunk, dim, N), device=dev, dtype=torch.float32)
        sdel = torch.empty((batch * K, n_chunk, dim), device=dev, dtype=torch.float32)
    cuda_lib.launch(
        cuda_lib.entry("fm_selective_scan_fwd", io), u.data_ptr(), delta.data_ptr(),
        _ptr(dt_lowrank_weight), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
        _ptr(D), _ptr(delta_bias), out.data_ptr(), _ptr(hsave), _ptr(carry), _ptr(sdel),
        batch, K, L, dim, N, R, int(delta_softplus), SAVE_EVERY, chunk, device=dev)
    return (out, hsave) if save_states else out


def bwd_scratch_floats(batch, K, L, dim, N, R, n_chunk):
    """Floats of the backward's scratch: its partials and carries, each
    segment rounded up to 4 floats (the layout is in the source)."""
    BK, n_dblk = batch * K, -(-dim // _BWD_BLOCK)
    per_chunk = BK * n_chunk * dim
    segments = (BK * n_dblk * L * R, BK * n_dblk * L * N, BK * n_dblk * L * N, per_chunk * N,
                per_chunk, per_chunk, per_chunk * R, per_chunk * N, per_chunk)
    return sum(_round4(n) for n in segments)


def selective_scan_bwd(u, delta, A, Bmat, Cmat, D, delta_bias, dt_lowrank_weight,
                       hsave, dy, delta_softplus, chunk=None):
    """Gradients of `selective_scan_fwd` for the cotangent dy (B, K, L, D),
    given the states it saved: (du, ddelta, dA, dB, dC, dD, dbias, dW), each
    in the shape of its input (None for an input that was None). `chunk`
    overrides the chunk length (a multiple of 16 steps; it need not be the
    forward's)."""
    batch, K, L, dim, N, R, io = _check(u, delta, A, Bmat, Cmat, D, delta_bias,
                                        dt_lowrank_weight)
    dev = u.device
    cuda_lib.check_cuda("selective_scan backward", io, dy, fp32=[hsave])
    if (tuple(hsave.shape) != (batch * K, -(-L // SAVE_EVERY), dim, N)
            or dy.shape != u.shape):
        raise ValueError("selective_scan backward: inconsistent shapes")
    if io == torch.bfloat16 and N < MAX_STATE:
        # the bf16 kernel runs 16 states a channel: A, B, C and the saved
        # states padded with zeros keep the states past N at zero
        pad = (0, MAX_STATE - N)
        du, ddt, dA, dB, dC, dD, dbias, dW = selective_scan_bwd(
            u, delta, F.pad(A, pad), F.pad(Bmat, pad), F.pad(Cmat, pad), D, delta_bias,
            dt_lowrank_weight, F.pad(hsave, pad), dy, delta_softplus, chunk)
        dA, dB, dC = (tracing.contiguous(g[..., :N], "scan_bwd.unpad") for g in (dA, dB, dC))
        return du, ddt, dA, dB, dC, dD, dbias, dW
    if bwd_smem_bytes(N, R, io) > _SMEM_LIMIT:
        raise ValueError(f"selective_scan backward: dt rank {R} too large for the kernel")
    chunk = _pick_chunk(chunk, batch, K, L, dim, dev, BWD_WARPS_PER_SM)
    n_chunk = -(-L // chunk)

    def like(t):
        return None if t is None else torch.empty_like(t)

    du, ddt, dA, dB, dC = like(u), like(delta), like(A), like(Bmat), like(Cmat)
    dD, dbias, dW = like(D), like(delta_bias), like(dt_lowrank_weight)
    scratch = torch.empty(bwd_scratch_floats(batch, K, L, dim, N, R, n_chunk), device=dev,
                          dtype=torch.float32)
    cuda_lib.launch(
        cuda_lib.entry("fm_selective_scan_bwd", io), u.data_ptr(), delta.data_ptr(), _ptr(dt_lowrank_weight),
        A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), _ptr(D), _ptr(delta_bias),
        hsave.data_ptr(), dy.data_ptr(), du.data_ptr(), ddt.data_ptr(), _ptr(dW),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), _ptr(dD), _ptr(dbias), scratch.data_ptr(),
        batch, K, L, dim, N, R, SAVE_EVERY, int(delta_softplus), chunk, device=dev)
    return du, ddt, dA, dB, dC, dD, dbias, dW
