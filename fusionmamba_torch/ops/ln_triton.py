"""Triton kernel of the fused LayerNorm (+ gate) forward. (The LN-mean
forward and both backwards are CUDA kernels, `csrc/ln_mean_fwd.cu` and
`csrc/layer_norm_bwd.cu`.)

Replaces `fusionmamba_tpu/ops/ln_pallas.py::_ln_fwd_kernel` (built by
`_fwd_pallas`). It is a row normalisation that does a handful of flops per
byte, so it is bound by the bytes it moves: it reads x (and the gate) once
and writes y once. One program owns whole rows, `BLOCK_C` being C rounded up
to a power of two and masked, and the statistics are the fast variance
E[x^2] - E[x]^2 in fp32, as on the TPU. x, the gate and y are fp32 or bf16
(the pointers' element type picks the compiled variant), every value is
taken to fp32 on load, and scale and bias are fp32.

`triton` is imported inside the launching functions: the module imports (and
the CPU path runs) where Triton is absent.
"""
from __future__ import annotations

import functools

import torch

from . import cuda_lib

# the gate kinds of the LN forward and backward kernels when a gate is given
# (0: no gate): "none" multiplies by the raw gate
GATE_CODES = {"silu": 1, "silu_sum": 2, "none": 3}
_ROW_BLOCK_ELEMS = 4096

layer_norm_launches = 0        # every launch, of either I/O dtype
bf16_layer_norm_launches = 0   # the launches of the bf16-I/O variant


# triton.language, bound by `_kernels()`. Triton resolves the names a kernel
# uses among its module's globals, so the import binds a global here.
tl = None


@functools.cache
def _kernels():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd(X, G, S, Bi, Y, rows, C, eps, GATE: tl.constexpr,
               BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
        c = tl.arange(0, BLOCK_C)[None, :]
        mask = (r < rows) & (c < C)
        offs = r.to(tl.int64) * C + c
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        s = tl.load(S + c, mask=c < C, other=0.0)
        b = tl.load(Bi + c, mask=c < C, other=0.0)
        mu = tl.sum(x, axis=1) / C
        rs = tl.rsqrt(tl.sum(x * x, axis=1) / C - mu * mu + eps)
        y = (x - mu[:, None]) * rs[:, None] * s + b
        if GATE != 0:
            g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
            if GATE != 3:
                g = g * tl.sigmoid(g)
                if GATE == 2:
                    g = g + g * tl.sigmoid(g)
            y = y * g
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)

    return triton, ln_fwd


def _blocks(C: int):
    block_c = 1 << max(C - 1, 0).bit_length()
    block_r = max(1, min(128, _ROW_BLOCK_ELEMS // block_c))
    return block_r, block_c, (8 if block_r * block_c >= 8192 else 4)


def layer_norm_fwd(x, scale, bias, gate, eps, gate_act):
    """LN(x) * act(gate) over the last axis, in x's dtype, on the card."""
    global layer_norm_launches, bf16_layer_norm_launches
    C = x.shape[-1]
    io = cuda_lib.io_dtype("layer_norm_fused", x)
    cuda_lib.check_cuda("layer_norm_fused", io, x, *([] if gate is None else [gate]),
                        fp32=[scale, bias])
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError("layer_norm_fused: scale and bias must be (C,)")
    if gate is not None and gate.shape != x.shape:
        raise ValueError("layer_norm_fused: gate must have x's shape")
    triton, ln_fwd = _kernels()
    rows = x.numel() // C
    y = torch.empty_like(x)
    block_r, block_c, warps = _blocks(C)
    code = 0 if gate is None else GATE_CODES[gate_act]
    with torch.cuda.device(x.device):
        ln_fwd[(triton.cdiv(rows, block_r),)](
            x, x if gate is None else gate, scale, bias, y, rows, C, eps,
            GATE=code, BLOCK_R=block_r, BLOCK_C=block_c, num_warps=warps)
    layer_norm_launches += 1
    bf16_layer_norm_launches += io == torch.bfloat16
    return y
