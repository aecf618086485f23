"""VSSMFusion: U-shaped dual-encoder VMamba fusion network (NHWC).

Reproduces the reference `VSSM_Fusion` (`models/vmamba_Fusion_efficross.py:753-929`):
  * one encoder trunk shared by both modalities, run once on the two inputs
    stacked into a 2B batch (the reference runs it twice with the same
    weights; per sample the math is the same), two patch embeddings;
  * per-scale fusion of the skips through four `VSSBlockCross`;
  * the decoder adds the fused skips before each up stage but the first;
  * head: FinalPatchExpand + 1x1 conv to one channel, then the reference's
    residual `out + 2*x1 + 2*x2`.

I/O is NHWC: x1, x2 are (B, H, W, in_chans); the output is (B, H, W, 1).
Module names are the reference's state-dict keys.

`VSSMFusionSeg` reproduces the reference `VSSM_Fusion_Segmentation`
(`models/vmamba_Fusion_efficross.py:995-1078`): the fusion network's
features (everything up to and including final_up) feed both its fusion
head and a `SegmentationHead`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import FusionModelConfig
from ..nn.blocks import VSSBlock, VSSBlockCross
from ..nn.layers import SegmentationHead
from ..nn.patch import FinalPatchExpand, PatchEmbed, PatchExpand, PatchMerging
from ..utils import tracing


def _blocks(dim: int, drop_paths: Sequence[float], cfg: FusionModelConfig) -> nn.ModuleList:
    return nn.ModuleList(
        VSSBlock(dim, cfg.d_state, cfg.ssm_ratio, cfg.mlp_ratio, cfg.norm_eps, dp,
                 cfg.scan_impl, cfg.remat_light)
        for dp in drop_paths)


def _run_blocks(blocks, x, dp_uni, remat: bool):
    """The blocks in turn, each reading its (2, width) rows of the stage's
    DropPath slice. With `remat` (in training) each block is a
    `torch.utils.checkpoint` region: its activations are recomputed in the
    backward, every forward kernel of the block launching again. The rows
    are drawn before the blocks run and passed in, so the recomputation
    replays no random draw."""
    for i, blk in enumerate(blocks):
        rows = None if dp_uni is None else dp_uni[i]
        if remat and blk.training and torch.is_grad_enabled():
            x = checkpoint(blk, x, rows, use_reentrant=False)
        else:
            x = blk(x, rows)
    return x


class VSSStage(nn.Module):
    """Encoder stage: depth x VSSBlock, then PatchMerging unless last."""

    def __init__(self, dim: int, drop_paths: Sequence[float], downsample: bool,
                 cfg: FusionModelConfig):
        super().__init__()
        self.remat = cfg.remat
        self.blocks = _blocks(dim, drop_paths, cfg)
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, dp_uni=None):  # dp_uni (depth, 2, width) or None
        x = _run_blocks(self.blocks, x, dp_uni, self.remat)
        return x if self.downsample is None else self.downsample(x)


class VSSStageUp(nn.Module):
    """Decoder stage: PatchExpand unless first, then depth x VSSBlock."""

    def __init__(self, dim: int, drop_paths: Sequence[float], upsample: bool,
                 cfg: FusionModelConfig):
        super().__init__()
        self.upsample = PatchExpand(dim) if upsample else None
        self.remat = cfg.remat
        self.blocks = _blocks(dim, drop_paths, cfg)

    def forward(self, x, dp_uni=None):  # dp_uni (depth, 2, width) or None
        if self.upsample is not None:
            x = self.upsample(x)
        return _run_blocks(self.blocks, x, dp_uni, self.remat)


class FinalConv(nn.Conv2d):
    """1x1 conv C -> 1 on NHWC input, with nn.Conv2d's parameters. The
    product runs in fp32 and returns in x's dtype, as the JAX package's
    `_FinalConv` takes its block product in fp32."""

    def __init__(self, in_channels: int):
        super().__init__(in_channels, 1, 1)

    def forward(self, x):  # (B, H, W, C) -> (B, H, W, 1)
        return F.linear(x.float(), self.weight.float().view(1, -1),
                        self.bias.float()).to(x.dtype)


def _split(values, depths):
    out, idx = [], 0
    for d in depths:
        out.append(tuple(values[idx:idx + d]))
        idx += d
    return out


class VSSMFusion(nn.Module):
    def __init__(self, cfg: FusionModelConfig):
        super().__init__()
        self.cfg = cfg
        nl = len(cfg.depths)
        dims, dims_dec = cfg.dims, cfg.dims_decoder
        rate = cfg.drop_path_rate
        dpr = _split(np.linspace(0.0, rate, sum(cfg.depths)).tolist(), cfg.depths)
        dpr_dec = _split(np.linspace(0.0, rate, sum(cfg.depths_decoder)).tolist()[::-1],
                         cfg.depths_decoder)
        self.patch_embed1 = PatchEmbed(cfg.in_chans, dims[0], cfg.patch_size, cfg.patch_norm)
        self.patch_embed2 = PatchEmbed(cfg.in_chans, dims[0], cfg.patch_size, cfg.patch_norm)
        self.layers = nn.ModuleList(
            VSSStage(dims[i], dpr[i], i < nl - 1, cfg) for i in range(nl))
        self.layers_up = nn.ModuleList(
            VSSStageUp(dims_dec[i], dpr_dec[i], i != 0, cfg) for i in range(nl))
        self.Cross_block = nn.ModuleList(
            VSSBlockCross(dims[i], cfg.d_state, cfg.ssm_ratio, cfg.norm_eps, cfg.scan_impl)
            for i in range(nl))
        self.final_up = FinalPatchExpand(dims_dec[-1], scale=4)
        self.final_conv = FinalConv(dims_dec[-1] // 4)

    def dp_table_shape(self, batch: int):
        """(rows, width) of the uniform table of one training step: two rows
        per VSSBlock (VSSBlockCross applies no DropPath), as wide as the
        encoder's 2B batch."""
        c = self.cfg
        return 2 * (sum(c.depths) + sum(c.depths_decoder)), 2 * batch

    def dp_tables(self, table):
        """The step's table (rows, 2B) sliced per stage as (depth, 2, 2B):
        (encoder stages, decoder stages), as the JAX package's
        `models/fusion.py::_dp_tables` slices its table. The decoder, at
        batch B, reads the first B entries of each row."""
        out, off = [], 0
        for d in list(self.cfg.depths) + list(self.cfg.depths_decoder):
            out.append(table[off:off + 2 * d].view(d, 2, table.shape[1]))
            off += 2 * d
        k = len(self.cfg.depths)
        return out[:k], out[k:]

    def features(self, x1, x2, generator=None, dp_uni=None):
        """x1, x2 (B, H, W, in_chans) -> the (B, H, W, dims[0] // 4) map that
        the fusion and segmentation heads share: the network up to and
        including final_up. In training with drop_path_rate > 0, DropPath
        reads one uniform table per call: `dp_uni` (rows, 2B) when given,
        else drawn from `generator` (the default generator when None) on the
        inputs' device. Spans `fusion.embed`, `fusion.encoder`, `fusion.cross`
        and `fusion.decoder` (final_up included)."""
        nl = len(self.layers)
        enc_dp = dec_dp = [None] * nl
        if self.training and self.cfg.drop_path_rate > 0.0:
            shape = self.dp_table_shape(x1.shape[0])
            if dp_uni is None:
                dp_uni = torch.rand(shape, generator=generator, device=x1.device)
            elif tuple(dp_uni.shape) != shape:
                raise ValueError(f"dp_uni must be {shape}, got {tuple(dp_uni.shape)}")
            enc_dp, dec_dp = self.dp_tables(dp_uni)
        with tracing.span("fusion.embed"):
            x = torch.cat([self.patch_embed1(x1), self.patch_embed2(x2)], dim=0)
        skips = []
        with tracing.span("fusion.encoder"):
            for layer, dp in zip(self.layers, enc_dp):
                skips.append(x)
                x = layer(x, dp)
            e1, e2 = x.chunk(2, dim=0)
            x = e1 + e2
        with tracing.span("fusion.cross"):
            fused = [cross(*s.chunk(2, dim=0)) for cross, s in zip(self.Cross_block, skips)]
        with tracing.span("fusion.decoder"):
            for i, (layer_up, dp) in enumerate(zip(self.layers_up, dec_dp)):
                if i > 0:
                    x = x + fused[-i]
                x = layer_up(x, dp)
            return self.final_up(x)

    def fusion_head(self, feats, x1, x2):
        """final_conv plus the reference's residual `x + x_1 + x_2 + x_1 + x_2`
        (span `fusion.head`)."""
        with tracing.span("fusion.head"):
            return self.final_conv(feats) + 2.0 * x1 + 2.0 * x2

    def forward(self, x1, x2, generator=None, dp_uni=None):
        """x1, x2 (B, H, W, in_chans) -> (B, H, W, 1); `generator` and
        `dp_uni` as in `features`. Span `fusion.forward`."""
        with tracing.span("fusion.forward"):
            return self.fusion_head(self.features(x1, x2, generator, dp_uni), x1, x2)


class VSSMFusionSeg(nn.Module):
    """The fusion network and a segmentation head on its shared features."""

    def __init__(self, cfg: FusionModelConfig):
        super().__init__()
        self.cfg = cfg
        self.fusion_model = VSSMFusion(cfg)
        self.segmentation_head = SegmentationHead(cfg.dims_decoder[-1] // 4,
                                                  cfg.num_seg_classes, dropout_rate=0.3)

    def forward(self, x1, x2, generator=None, dp_uni=None, drop_mask=None,
                return_fusion: bool = True, return_segmentation: bool = True) -> dict:
        """x1, x2 (B, H, W, in_chans) -> {"segmentation": (B, H, W, classes)
        logits, "fusion": (B, H, W, 1)}, each where asked for. In training,
        DropPath's table (`dp_uni`) and the head's dropout keep-mask
        (`drop_mask`) are drawn from `generator` where not given."""
        feats = self.fusion_model.features(x1, x2, generator, dp_uni)
        out = {}
        if return_segmentation:
            out["segmentation"] = self.segmentation_head(feats, generator, drop_mask)
        if return_fusion:
            out["fusion"] = self.fusion_model.fusion_head(feats, x1, x2)
        return out
