"""y = x Wᵀ in fp32 (`nn.Linear`'s product, no bias): the op of the Mamba
mixer's four projections and the LM's tied head, and the wrapper of its
kernel (`csrc/linear_tf32x3.cu`). The plain version is `F.linear`.

The kernel forms every product as three TF32 products on the tensor cores
(`wgmma`, fed by TMA: `csrc/wgmma_tf32x3.cuh`), which keeps fp32-class
accuracy; one persistent block an SM walks the 128 x 128 output tiles in
the fixed order of `tile_of`, each over its whole depth, with no atomics,
so two launches are bit-identical. x is read as it lies where its rows are
16-byte aligned (a view of every row's first columns takes no copy); an
operand the kernel cannot read so is copied once (`rows`), counted under
`copies:linear`.

The op takes the kernel on the card where the algorithm the kernel runs
fits what it can see (`engages`): fp32 operands, at least one output tile
of rows, and no gradient recorded (the kernel has no backward). Every other
call takes `F.linear` and counts 1 under `linear:library` in
`tracing.counts`; the kernel's launches count under their entry point,
`fm_linear`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import cuda_lib

TILE = 128        # rows and columns of an output tile (the engine's kTile)
BAND = 8          # row tiles a band of the walk (the kernel's kBand)
LIBRARY = "linear:library"
COPY_SITE = "linear"


def grid(M: int, N: int, sms: int) -> int:
    """The persistent grid at (M, N): a block an SM, or one a 128 x 128
    output tile where there are fewer. A fixed rule of the shape: nothing is
    tuned at run time."""
    return min(sms, -(-M // TILE) * -(-N // TILE))


def tile_of(t: int, tiles_m: int, tiles_n: int) -> tuple[int, int]:
    """Output tile t of the walk -> (row tile, column tile): bands of BAND
    row tiles (the last may hold fewer), each band's row tiles fastest, then
    its column tiles. The kernel's `Walk::tile` does the same arithmetic."""
    per = BAND * tiles_n
    b, r = divmod(t, per)
    rows = min(BAND, tiles_m - b * BAND)
    return b * BAND + r % rows, r // rows


def rows(t: torch.Tensor) -> torch.Tensor:
    """t (..., K) as (rows, K) rows the kernel reads: a view where one has
    unit steps along K, rows apart by at least K and by a multiple of 16
    bytes, and a 16-byte-aligned start; else one copy into rows padded to 16
    bytes, counted under `copies:linear`."""
    K = t.shape[-1]
    try:
        t2 = t.view(-1, K)
    except RuntimeError:
        t2 = None
    if (t2 is None or t2.stride(1) != 1 or t2.stride(0) < K or t2.stride(0) % 4
            or t2.data_ptr() % 16):
        t2 = torch.empty(t.numel() // K, -(-K // 4) * 4, device=t.device, dtype=t.dtype)[:, :K]
        tracing.copied(COPY_SITE, t2.view(t.shape).copy_(t))
    return t2


def engages(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether the kernel's algorithm fits `linear(x, weight)`: fp32
    operands, at least one output tile of rows, no gradient recorded."""
    return (x.dtype == torch.float32 and weight.dtype == torch.float32
            and x.numel() // max(x.shape[-1], 1) >= TILE
            and not cuda_lib.needs_grad(x, weight))


def linear_cuda(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The kernel's y = x Wᵀ for fp32 x (..., K) and weight (N, K) on one
    card."""
    x2, w = rows(x), rows(weight)
    M, K = x2.shape
    N = w.shape[0]
    if w.shape[1] != K:
        raise ValueError(f"linear: x has {K} columns, the weight {w.shape[1]}")
    y = torch.empty(M, N, device=x.device, dtype=torch.float32)
    cuda_lib.launch("fm_linear", x2.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K,
                    x2.stride(0), w.stride(0), grid(M, N, cuda_lib.sm_count(x.device)),
                    device=x.device)
    return y.view(*x.shape[:-1], N)


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ weight (N, K)ᵀ -> (..., N): the kernel on the card where
    it `engages`, else `F.linear`, counted under LIBRARY."""
    if x.is_cuda and weight.device == x.device and engages(x, weight):
        return linear_cuda(x, weight)
    tracing.counts[LIBRARY] += 1
    return F.linear(x, weight)
