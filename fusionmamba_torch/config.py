"""Model configurations of the fusion network.

The hyperparameters are those of the reference `VSSM_Fusion.__init__`
(`models/vmamba_Fusion_efficross.py:754-757`); the tiny config is the CT-MRI
variant from the reference README, and the test config is a miniature for
unit tests.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FusionModelConfig:
    in_chans: int = 1
    patch_size: int = 4
    depths: Tuple[int, ...] = (2, 2, 9, 2)
    depths_decoder: Tuple[int, ...] = (2, 9, 2, 2)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    d_state: int = 16
    ssm_ratio: float = 2.0
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1
    # eps of the VSSBlock/VSSBlockCross pre-norms (the reference builds them
    # with partial(nn.LayerNorm, eps=1e-6)); SS2D out_norm, BiAttn and the
    # patch norms use torch's default 1e-5, fixed at their call sites
    norm_eps: float = 1e-6
    patch_norm: bool = True
    # classes of VSSMFusionSeg's segmentation head (MFNet's 9)
    num_seg_classes: int = 9

    @property
    def dims_decoder(self) -> Tuple[int, ...]:
        return tuple(reversed(self.dims))


def full_config(**overrides) -> FusionModelConfig:
    return FusionModelConfig(**overrides)


def tiny_config(**overrides) -> FusionModelConfig:
    """CT-MRI tiny config (reference `README.md:54`)."""
    overrides.setdefault("depths", (2, 2, 1, 2))
    overrides.setdefault("depths_decoder", (2, 1, 2, 2))
    return FusionModelConfig(**overrides)


def test_config(**overrides) -> FusionModelConfig:
    """Miniature config for unit tests (not a reference variant)."""
    overrides.setdefault("depths", (1, 1))
    overrides.setdefault("depths_decoder", (1, 1))
    overrides.setdefault("dims", (16, 32))
    overrides.setdefault("d_state", 4)
    overrides.setdefault("drop_path_rate", 0.0)
    return FusionModelConfig(**overrides)
