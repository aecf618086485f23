"""Weights in the reference layout: JAX params -> state dict, and reference
`.pth` checkpoints."""
from __future__ import annotations

import torch
from torch import nn

from .from_jax import fusion_key_map, seg_key_map, seg_state_dict_from_jax, state_dict_from_jax

# keys of the reference checkpoint that the port does not build: the
# DifferentialEnhance `lastconv`, which the reference forward never uses
_UNUSED_KEY = ".Diff_enhance.lastconv."


def load_reference_checkpoint(model: nn.Module, path: str) -> None:
    """Load a reference `.pth` (state dict, or {"state_dict": ...}) strictly,
    apart from the unused `lastconv` keys: a `VSSM_Fusion` checkpoint into
    VSSMFusion, a `VSSM_Fusion_Segmentation` one (its fusion keys under
    `fusion_model.`) into VSSMFusionSeg."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model.load_state_dict({k: v for k, v in sd.items() if _UNUSED_KEY not in k})


__all__ = ["fusion_key_map", "load_reference_checkpoint", "seg_key_map",
           "seg_state_dict_from_jax", "state_dict_from_jax"]
