"""Fused two-layer GELU MLP: the public op, its plain PyTorch version, and
the wrappers of the CUDA kernels: the forward (`csrc/fused_mlp_fwd.cu`;
replaces `fusionmamba_tpu/ops/mlp_pallas.py::_fwd_kernel`) and the backward
(`csrc/fused_mlp_bwd.cu`; replaces `::_bwd_kernel`).

Both are bound by operations (fp32 FMAs on the CUDA cores). The forward walks
the hidden layer in chunks held in shared memory, so the 4C-wide hidden never
reaches device memory. The backward recomputes the hidden in tiles, writes
gelu(h) and dL/dh as scratch, and forms dx, dW1, db1, dW2 and db2 from them
in tiled products; the weight and bias gradients come out as partials over
slices of the rows, summed here. See the sources for the designs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

MAX_OUT = 1024      # kMaxOut * kThreads in the source
_SMEM_LIMIT = 227 * 1024

launches = 0
bwd_launches = 0


def fused_mlp_plain(x, w1, b1, w2, b2):
    return F.gelu(x @ w1 + b1, approximate="none") @ w2 + b2


def _check_shapes(x, w1, b1, w2, b2):
    C = x.shape[-1]
    Hd, C_out = w1.shape[1], w2.shape[1]
    if (w1.shape != (C, Hd) or b1.shape != (Hd,) or w2.shape != (Hd, C_out)
            or b2.shape != (C_out,)):
        raise ValueError("fused_mlp: inconsistent shapes")
    return C, Hd, C_out


def _mlp_cuda(x, w1, b1, w2, b2):
    global launches
    C, Hd, C_out = _check_shapes(x, w1, b1, w2, b2)
    if C_out > MAX_OUT:
        raise ValueError(f"fused_mlp: output width {C_out} > {MAX_OUT}")
    if 4 * (16 * C + 16 * 128 + max(128 * 33, C_out * 17)) > _SMEM_LIMIT:
        raise ValueError(f"fused_mlp: input width {C} too large for the kernel")
    x2 = x.reshape(-1, C)
    # the kernel reads torch's nn.Linear layout (out, in): views, not copies,
    # when the weights came in as `linear.weight.t()`
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    cuda_lib.check_cuda_float32("fused_mlp", x2, w1t, b1, w2t, b2)
    y = torch.empty((x2.shape[0], C_out), device=x.device, dtype=x.dtype)
    cuda_lib.launch("fm_fused_mlp_fwd", x2.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                    w2t.data_ptr(), b2.data_ptr(), y.data_ptr(), x2.shape[0], C,
                    Hd, C_out, device=x.device)
    launches += 1
    return y.reshape(*x.shape[:-1], C_out)


def mlp_bwd(x, w1, b1, w2, b2, dy):
    """Gradients of `fused_mlp` for the cotangent dy: (dx, dw1, db1, dw2, db2),
    each in the shape of its input (w1 (C, H) and w2 (H, C_out) as given)."""
    global bwd_launches
    C, Hd, C_out = _check_shapes(x, w1, b1, w2, b2)
    x2, dy2 = x.reshape(-1, C), dy.reshape(-1, C_out)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()   # nn.Linear (out, in)
    cuda_lib.check_cuda_float32("fused_mlp backward", x2, dy2, w1t, b1, w2t)
    M = x2.shape[0]
    # slices of the rows for the weight gradients: enough blocks to fill the
    # card's SMs twice over, given (Hd/64) * (C/64) output tiles
    tiles = -(-Hd // 64) * -(-max(C, C_out) // 64)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_slice = max(1, min(-(-M // 256), -(-2 * sms // tiles)))
    rows = -(-M // n_slice)
    S = -(-M // rows)

    def empty(*shape):
        return torch.empty(shape, device=x.device, dtype=torch.float32)

    a_buf, g_buf, dx = empty(M, Hd), empty(M, Hd), empty(M, C)
    dw1_p, db1_p, dw2_p, db2_p = empty(S, Hd, C), empty(S, Hd), empty(S, C_out, Hd), empty(S, C_out)
    cuda_lib.launch("fm_fused_mlp_bwd", x2.data_ptr(), dy2.data_ptr(), w1t.data_ptr(),
                    b1.data_ptr(), w2t.data_ptr(), a_buf.data_ptr(), g_buf.data_ptr(),
                    dx.data_ptr(), dw1_p.data_ptr(), db1_p.data_ptr(), dw2_p.data_ptr(),
                    db2_p.data_ptr(), M, C, Hd, C_out, rows, device=x.device)
    bwd_launches += 1
    return (dx.view(x.shape), dw1_p.sum(0).t(), db1_p.sum(0), dw2_p.sum(0).t(),
            db2_p.sum(0))


class _MlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _mlp_cuda(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        return mlp_bwd(*ctx.saved_tensors, dy.contiguous())


def fused_mlp(x, w1, b1, w2, b2):
    """y = gelu_exact(x @ w1 + b1) @ w2 + b2 with x (..., C), w1 (C, H),
    b1 (H,), w2 (H, C_out), b2 (C_out,). CPU tensors take the plain version,
    differentiated by autograd; CUDA tensors the kernel, which keeps the
    hidden on chip, and, when a gradient is needed, the backward kernel."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no implementation for {x.device}")
    if cuda_lib.needs_grad(x, w1, b1, w2, b2):
        return _MlpFn.apply(x, w1, b1, w2, b2)
    return _mlp_cuda(x, w1, b1, w2, b2)
