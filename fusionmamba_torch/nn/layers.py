"""Primitive layers of the fusion network (NHWC).

Attribute names follow the reference model's state-dict keys, so a reference
checkpoint loads with `load_state_dict`. Each class names the reference
component it reproduces.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_mlp, layer_norm_fused, ln_spatial_mean


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 fast-variance statistics, times
    an optional activated gate (`ops/layer_norm.py`). Parameters are torch
    LayerNorm's `weight` and `bias`."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, gate=None, gate_act: str = "none"):
        return layer_norm_fused(x, self.weight, self.bias, gate, self.eps, gate_act)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath at reference
    `models/cross.py:1353,1374-1376`): the identity at inference or at rate 0.
    In training, sample i is kept, scaled by 1 / (1 - rate), where
    uni[i] < 1 - rate, and zeroed otherwise. `uni` is this DropPath's row of
    the model's one uniform table per step (`VSSMFusion.dp_tables`), at least
    batch wide, as in the JAX package's `nn/layers.py::DropPath`."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, uni=None):
        if not self.training or self.rate == 0.0:
            return x
        if uni is None:
            raise ValueError("DropPath: training needs the step's uniform row")
        keep = 1.0 - self.rate
        mask = (uni[: x.shape[0]] < keep).view(-1, *([1] * (x.dim() - 1)))
        return torch.where(mask, x / keep, torch.zeros_like(x))


class LDC(nn.Module):
    """Learnable central-difference 3x3 conv, no bias (reference
    `models/cross.py:790-814`). Effective weight
    W * (base_mask - theta * M * center * sum_hw W), with M the learnable
    (out, in) mask and theta a learnable scalar. The masks (buffers) take
    the weight's dtype, as the JAX package builds its center mask in it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.conv = nn.Conv2d(in_channels, out_channels, k, padding=k // 2, bias=False)
        self.register_buffer("base_mask", torch.ones(out_channels, in_channels, k, k))
        center = torch.zeros(k, k)
        center[k // 2, k // 2] = 1.0
        self.register_buffer("center_mask", center, persistent=False)
        self.learnable_mask = nn.Parameter(torch.ones(out_channels, in_channels))
        self.learnable_theta = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x):  # NHWC
        w = self.conv.weight
        wsum = w.sum(dim=(2, 3), keepdim=True)
        eff = w * (self.base_mask.to(w.dtype) - self.learnable_theta
                   * self.learnable_mask[:, :, None, None] * self.center_mask.to(w.dtype) * wsum)
        y = F.conv2d(x.permute(0, 3, 1, 2), eff, padding=self.conv.padding)
        return y.permute(0, 2, 3, 1).contiguous()


class ECALayer(nn.Module):
    """Efficient channel attention (reference `models/cross.py:1233-1259`):
    spatial mean -> zero-padded 3-tap conv across channels -> sigmoid gate."""

    def __init__(self, k_size: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, k_size, padding=k_size // 2, bias=False)

    def forward(self, x):  # NHWC
        y = self.conv(x.mean(dim=(1, 2))[:, None, :])[:, 0]
        return x * torch.sigmoid(y)[:, None, None, :]


class BiAttn(nn.Module):
    """Global channel attention (reference `models/cross.py:744-768`):
    LN -> spatial mean -> reduce (1/8) -> GELU -> expand -> sigmoid -> scale.
    The LN feeds only the mean, so the two run as one op (`ln_spatial_mean`)
    and LN(x) is never written."""

    def __init__(self, in_channels: int, act_ratio: float = 0.125):
        super().__init__()
        reduce_channels = int(in_channels * act_ratio)
        self.norm = FusedLayerNorm(in_channels, eps=1e-5)
        self.global_reduce = nn.Linear(in_channels, reduce_channels)
        self.channel_select = nn.Linear(reduce_channels, in_channels)

    def forward(self, x):  # NHWC
        g = ln_spatial_mean(x, self.norm.weight, self.norm.bias, self.norm.eps)
        g = F.gelu(self.global_reduce(g.to(x.dtype)))
        attn = torch.sigmoid(self.channel_select(g))
        return x * attn[:, None, None, :]


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (reference `models/cross.py:770-788`), as one
    fused op whose hidden stays on chip (`ops/mlp.py`)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x):
        return fused_mlp(x, self.fc1.weight.t(), self.fc1.bias,
                         self.fc2.weight.t(), self.fc2.bias)


class DifferentialEnhance(nn.Module):
    """Cross-modal difference gating (reference `models/cross.py:843-864`):
    F1 = sigmoid(mean(x1 - x2)) * fuse + x1, and symmetrically F2. The
    reference also builds a `lastconv` that its forward never uses; it is
    not built here."""

    def forward(self, fuse, x1, x2):
        w12 = torch.sigmoid((x1 - x2).mean(dim=(1, 2), keepdim=True))
        w21 = torch.sigmoid((x2 - x1).mean(dim=(1, 2), keepdim=True))
        return w12 * fuse + x1, w21 * fuse + x2


class CrossLayer(nn.Module):
    """Texture + differential enhancement (reference `models/cross.py:866-888`):
    F_i = LDC_i(x_i) + DifferentialEnhance(fuse, x1, x2)_i."""

    def __init__(self, dim: int):
        super().__init__()
        self.texture_enhance1 = LDC(dim, dim)
        self.texture_enhance2 = LDC(dim, dim)
        self.Diff_enhance = DifferentialEnhance()

    def forward(self, fuse, x1, x2):
        d1, d2 = self.Diff_enhance(fuse, x1, x2)
        return self.texture_enhance1(x1) + d1, self.texture_enhance2(x2) + d2


class SegmentationHead(nn.Module):
    """Segmentation head (reference `vmamba_Fusion_efficross.py:932-992`):
    conv3x3 -> BN -> ReLU -> conv3x3 -> BN -> ReLU -> x * sigmoid(conv1x1(x))
    -> dropout -> conv1x1 to the classes. NHWC in, NHWC logits out; the
    convolutions run on the NCHW view of the NHWC memory (channels-last), so
    nothing is copied on either side.

    The BatchNorms follow the JAX package's flax `nn.BatchNorm` (momentum
    0.99 there, so 0.01 here; eps 1e-5). torch updates `running_var` with
    the unbiased batch variance, flax with the biased one: the running
    variances differ by n / (n - 1), n = B*H*W. On a bf16 input the
    normalization runs in fp32 on fp32 casts of the input and of the
    affine parameters, and its output is cast back, as flax's BatchNorm
    reduces its statistics and normalizes in fp32; the running statistics
    stay fp32.

    In training, dropout keeps each activation where `drop_mask` (a bool
    (B, H, W, 2C) keep-mask, as flax draws it) is true, scaled by
    1 / (1 - rate); without a mask it draws one from `generator` on the
    input's device."""

    def __init__(self, in_channels: int, num_classes: int, dropout_rate: float = 0.3):
        super().__init__()
        c2 = 2 * in_channels
        self.dropout_rate = dropout_rate
        self.conv1 = nn.Conv2d(in_channels, c2, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(c2, eps=1e-5, momentum=0.01)
        self.conv2 = nn.Conv2d(c2, c2, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(c2, eps=1e-5, momentum=0.01)
        self.attention = nn.Sequential(nn.Conv2d(c2, c2, 1), nn.Sigmoid())
        self.final_conv = nn.Conv2d(c2, num_classes, 1)

    @staticmethod
    def _bn(bn: nn.BatchNorm2d, x):
        """bn(x), its statistics and normalization in fp32 whatever x's
        dtype (the casts are the identity at fp32)."""
        if bn.training:
            bn.num_batches_tracked.add_(1)
        return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight.float(),
                            bn.bias.float(), bn.training, bn.momentum, bn.eps).to(x.dtype)

    def forward(self, x, generator=None, drop_mask=None):  # (B, H, W, C)
        x = x.permute(0, 3, 1, 2)                         # channels-last NCHW view
        x = F.relu(self._bn(self.bn1, self.conv1(x)))
        x = F.relu(self._bn(self.bn2, self.conv2(x)))
        x = x * self.attention(x)
        if self.training and self.dropout_rate > 0.0:
            keep = 1.0 - self.dropout_rate
            B, C2, H, W = x.shape
            if drop_mask is None:
                drop_mask = torch.rand((B, H, W, C2), generator=generator,
                                       device=x.device) < keep
            elif tuple(drop_mask.shape) != (B, H, W, C2):
                raise ValueError(f"drop_mask must be {(B, H, W, C2)}, "
                                 f"got {tuple(drop_mask.shape)}")
            x = torch.where(drop_mask.permute(0, 3, 1, 2), x / keep, torch.zeros_like(x))
        return self.final_conv(x).permute(0, 2, 3, 1)
