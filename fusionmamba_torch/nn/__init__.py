"""Layers, SS2D modules, blocks and patch ops of the fusion network (NHWC)."""
from .blocks import VSSBlock, VSSBlockCross
from .initializers import init_weights
from .layers import (LDC, BiAttn, CrossLayer, DropPath, ECALayer, FusedLayerNorm, Mlp,
                     SegmentationHead)
from .patch import FinalPatchExpand, PatchEmbed, PatchExpand, PatchMerging
from .ss2d import SS2D, DepthwiseConv2d, SS2DCross

__all__ = [
    "BiAttn", "CrossLayer", "DepthwiseConv2d", "DropPath", "ECALayer",
    "FinalPatchExpand", "FusedLayerNorm", "LDC", "Mlp", "PatchEmbed",
    "PatchExpand", "PatchMerging", "SS2D", "SS2DCross", "SegmentationHead",
    "VSSBlock", "VSSBlockCross", "init_weights",
]
