"""The maker of a configuration whose `model` is "fusion":
`fusionmamba_torch.models.VSSMFusion`."""
from __future__ import annotations

import torch

FIELDS = ("in_chans", "patch_size", "depths", "depths_decoder", "dims", "d_state",
          "ssm_ratio", "mlp_ratio", "drop_path_rate", "norm_eps")


def make(config: dict, device):
    """`VSSMFusion` of `config`, made on `device` (its parameters are then
    overwritten by the benchmark's weights)."""
    from fusionmamba_torch.config import FusionModelConfig
    from fusionmamba_torch.models import VSSMFusion
    cfg = FusionModelConfig(**{k: tuple(config[k]) if isinstance(config[k], list) else config[k]
                               for k in FIELDS})
    with torch.device(device):
        return VSSMFusion(cfg)
