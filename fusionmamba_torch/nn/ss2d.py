"""SS2D modules: the VMamba 2-D selective-scan core (NHWC).

`SS2D` reproduces the reference `models/cross.py:417-742` (the "efficient"
core with the stride-2 four-direction scan, or with `scan_variant="fullres"`
the full-resolution four-direction scan of the reference's forward_corev0,
`models/vmamba_Fusion_efficross.py:391-429`); `SS2DCross` reproduces
`SS2D_cross_new` (`models/cross.py:890-1230`) with its quirks: one depthwise
conv shared by both inputs, the pre-scan fusion x1*x2 + x1 + x2, and a gate
read only from z1 as silu(z1) + silu(silu(z1)).

The scan pipeline: efficient_scan (cross_scan) -> per-direction x_proj ->
low-rank dt, B, C -> selective scan with fp32 math (A = -exp(A_logs), softplus
dt, low-rank dt expanded inside the kernel) -> efficient_merge (cross_merge)
-> LayerNorm x gate. Under mixed precision the activations, B, C, the
low-rank dt and its weight are bf16 while A, D and the dt bias enter the
scan as fp32, as in the JAX package's `nn/ss2d.py`, and the output keeps
the input's dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cross_merge, cross_scan, depthwise_conv3x3, efficient_merge, efficient_scan
from ..ops.selective_scan import selective_scan
from .layers import FusedLayerNorm

K_DIRS = 4
SCAN_VARIANTS = ("efficient", "fullres")


class DepthwiseConv2d(nn.Conv2d):
    """Depthwise 3x3 SAME conv + bias + SiLU on NHWC input through the
    depthwise kernel (`ops/dwconv.py`); parameters are those of the
    reference's grouped nn.Conv2d."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, padding=1, groups=channels, bias=True)

    def forward(self, x):  # NHWC
        return depthwise_conv3x3(x, self.weight[:, 0].permute(1, 2, 0), self.bias,
                                 act="silu")


class SSMCore(nn.Module):
    """The SSM parameters shared by SS2D and SS2DCross, and the scan pipeline.
    A_logs and Ds keep the reference's flattened (K*D, N) and (K*D,) shapes.
    `scan_variant` "efficient" scans the stride-2 decimated sequences of
    length ceil(H/2)*ceil(W/2); "fullres" scans all H*W positions. The
    parameters are the same for both. `scan_impl` "sp" splits the scan's
    sequence axis over the ambient mesh's "model" axis
    (`parallel/seq_scan.py`); every other name runs the one scan.

    `scan_params`, `sum_channels` and `norm_gated` are where a
    tensor-parallel subclass (`parallel/tensor_parallel.py`) takes its
    channel shard of d_inner."""

    def __init__(self, d_model: int, d_state: int, ssm_ratio: float,
                 scan_variant: str = "efficient", scan_impl: str = "adaptive"):
        super().__init__()
        if scan_variant not in SCAN_VARIANTS:
            raise ValueError(f"scan_variant must be one of {SCAN_VARIANTS}, "
                             f"got {scan_variant!r}")
        self.scan_variant = scan_variant
        self.scan_impl = scan_impl
        self.d_inner = int(ssm_ratio * d_model)
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16)
        D, N, R = self.d_inner, d_state, self.dt_rank
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, R + 2 * N, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, D))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS * D, N))
        self.Ds = nn.Parameter(torch.ones(K_DIRS * D))
        self.out_norm = FusedLayerNorm(D, eps=1e-5)

    def scan_params(self):
        """(x_proj_weight (K, R+2N, D), dt_projs_weight (K, D, R),
        dt_projs_bias (K, D), A (K, D, N), Ds (K, D)) over the channels that
        the scan runs on: here all of d_inner."""
        return (self.x_proj_weight, self.dt_projs_weight, self.dt_projs_bias.float(),
                -torch.exp(self.A_logs.float()).view(K_DIRS, -1, self.d_state),
                self.Ds.float().view(K_DIRS, -1))

    def sum_channels(self, x_dbl):
        """x_proj's product, summed over every channel of d_inner."""
        return x_dbl

    def norm_gated(self, y, gate, gate_act: str):
        """out_norm(y) * act(gate) over the whole of d_inner."""
        return self.out_norm(y, gate=gate, gate_act=gate_act)

    def scan(self, x, gate, gate_act: str):
        """x (B, H, W, d_inner) -> out_norm(scan(x)) * act(gate); gate raw."""
        B, H, W, D = x.shape
        N, R = self.d_state, self.dt_rank
        fullres = self.scan_variant == "fullres"
        xw, dtw, dtb, As, Ds = self.scan_params()
        xs = cross_scan(x) if fullres else efficient_scan(x)      # (B, 4, L, D)
        x_dbl = self.sum_channels(torch.einsum("bkld,kcd->bklc", xs, xw))
        dts, Bs, Cs = (t.contiguous() for t in x_dbl.split([R, N, N], dim=-1))
        ys = selective_scan(xs, dts, As, Bs, Cs, Ds, dtb, delta_softplus=True,
                            dt_lowrank_weight=dtw, impl=self.scan_impl)
        y = cross_merge(ys, H, W) if fullres else efficient_merge(ys, H, W)
        return self.norm_gated(y, gate, gate_act)


class SS2D(SSMCore):
    """Single-input SS2D (reference `models/cross.py:417-742`)."""

    def __init__(self, d_model: int, d_state: int = 16, ssm_ratio: float = 2.0,
                 scan_variant: str = "efficient", scan_impl: str = "adaptive"):
        super().__init__(d_model, d_state, ssm_ratio, scan_variant, scan_impl)
        self.in_proj = nn.Linear(d_model, 2 * self.d_inner, bias=False)
        self.conv2d = DepthwiseConv2d(self.d_inner)
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=False)

    def forward(self, x):  # (B, H, W, d_model)
        d = self.d_inner
        # the two halves of in_proj as two products: both come out contiguous
        xpart = F.linear(x, self.in_proj.weight[:d])
        z = F.linear(x, self.in_proj.weight[d:])
        y = self.scan(self.conv2d(xpart), gate=z, gate_act="silu")
        return self.out_proj(y)


class SS2DCross(SSMCore):
    """Cross-modal SS2D (reference `models/cross.py:890-1230`)."""

    def __init__(self, d_model: int, d_state: int = 16, ssm_ratio: float = 2.0,
                 scan_variant: str = "efficient", scan_impl: str = "adaptive"):
        super().__init__(d_model, d_state, ssm_ratio, scan_variant, scan_impl)
        self.in_proj1 = nn.Linear(d_model, 2 * self.d_inner, bias=False)
        self.in_proj2 = nn.Linear(d_model, 2 * self.d_inner, bias=False)
        self.conv2d = DepthwiseConv2d(self.d_inner)
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=False)

    def forward(self, x1, x2):
        d = self.d_inner
        x1p = self.conv2d(F.linear(x1, self.in_proj1.weight[:d]))
        z1 = F.linear(x1, self.in_proj1.weight[d:])
        # the second half of in_proj2 (z2) is never read: the reference's z2
        # is silu of the already-activated z1, folded into "silu_sum"
        x2p = self.conv2d(F.linear(x2, self.in_proj2.weight[:d]))
        fused = x1p * x2p + x1p + x2p
        y = self.scan(fused, gate=z1, gate_act="silu_sum")
        return self.out_proj(y)
