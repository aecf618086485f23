"""Ops of the port. Each op with a kernel takes its plain PyTorch version for
CPU tensors and launches its kernel for CUDA tensors. The scan is imported
from its module, `fusionmamba_torch.ops.selective_scan`."""
from .dwconv import depthwise_conv3x3
from .layer_norm import layer_norm_fused, ln_spatial_mean
from .mlp import fused_mlp
from .scan2d import cross_merge, cross_scan, efficient_merge, efficient_scan

__all__ = [
    "cross_merge",
    "cross_scan",
    "depthwise_conv3x3",
    "efficient_merge",
    "efficient_scan",
    "fused_mlp",
    "layer_norm_fused",
    "ln_spatial_mean",
]
