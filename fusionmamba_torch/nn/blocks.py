"""Encoder/decoder block and cross-modal fusion block (NHWC).

`VSSBlock` reproduces the reference `VSSBlock_new` (`models/cross.py:1297-1383`):
the LDC branch reads x_ssm + eca(x_ssm), not the block input, and one BiAttn
(`se`) gates both the SSM and the conv branch. `VSSBlockCross` reproduces
`VSSBlock_Cross_new` (`models/cross.py:1262-1295`): its output is
x1 + x2 + y + eca(y), and the reference never applies its DropPath.

With `remat_light`, a VSSBlock recomputes its cheap wide branches (ECA,
BiAttn, Mlp) in the backward (`torch.utils.checkpoint`, as the JAX package's
`nn.remat` of those classes): the Mlp and LN-mean forward kernels run again
there, the scan and the dwconv do not. The port's fused kernels keep none of
those branches' intermediates in the first place, so it saves little memory
here (PERF.md, the remat peak memory).
"""
from __future__ import annotations

from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import LDC, BiAttn, CrossLayer, DropPath, ECALayer, FusedLayerNorm, Mlp
from .ss2d import SS2D, SS2DCross


class VSSBlock(nn.Module):
    def __init__(self, dim: int, d_state: int = 16, ssm_ratio: float = 2.0,
                 mlp_ratio: float = 4.0, norm_eps: float = 1e-6, drop_path: float = 0.0,
                 scan_impl: str = "adaptive", remat_light: bool = False):
        super().__init__()
        self.remat_light = remat_light
        self.norm = FusedLayerNorm(dim, norm_eps)
        self.op = SS2D(dim, d_state, ssm_ratio, scan_impl=scan_impl)
        self.self_attention_cross_channel = ECALayer()
        self.conv_branch = LDC(dim, dim)
        self.se = BiAttn(dim)
        self.drop_path = DropPath(drop_path)
        self.mlp = None
        if mlp_ratio > 0:
            self.norm2 = FusedLayerNorm(dim, norm_eps)
            self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def _branch(self, module, x):
        if self.remat_light and self.training and x.requires_grad:
            return checkpoint(module, x, use_reentrant=False)
        return module(x)

    def forward(self, x, dp_uni=None):  # x (B, H, W, C); dp_uni (2, >= B) uniforms
        uni = (None, None) if dp_uni is None else dp_uni
        x_ssm = self.op(self.norm(x))
        x_conv = self.conv_branch(x_ssm + self._branch(self.self_attention_cross_channel, x_ssm))
        x = x + self.drop_path(self._branch(self.se, x_ssm) + self._branch(self.se, x_conv),
                               uni[0])
        if self.mlp is not None:
            x = x + self.drop_path(self._branch(self.mlp, self.norm2(x)), uni[1])
        return x


class VSSBlockCross(nn.Module):
    def __init__(self, dim: int, d_state: int = 16, ssm_ratio: float = 2.0,
                 norm_eps: float = 1e-6, scan_impl: str = "adaptive"):
        super().__init__()
        self.Cross_layer = CrossLayer(dim)
        self.ln_1 = FusedLayerNorm(dim, norm_eps)
        self.ln_2 = FusedLayerNorm(dim, norm_eps)
        self.self_attention_cross = SS2DCross(dim, d_state, ssm_ratio, scan_impl=scan_impl)
        self.self_attention_cross_spatial = ECALayer()

    def forward(self, x1, x2):
        f1, f2 = self.Cross_layer(x1 + x2, x1, x2)
        y = self.self_attention_cross(self.ln_1(f1), self.ln_2(f2))
        return x1 + x2 + y + self.self_attention_cross_spatial(y)
