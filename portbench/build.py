"""The program's objects built from a configuration file's dict: the
system under test, which the benchmark drives through its own entries."""
from __future__ import annotations

import torch

FUSION_FIELDS = ("in_chans", "patch_size", "depths", "depths_decoder", "dims", "d_state",
                 "ssm_ratio", "mlp_ratio", "drop_path_rate", "norm_eps")


def fusion_model(config: dict, device):
    """`fusionmamba_torch.models.VSSMFusion` of `config`, made on `device`
    (its parameters are then overwritten by the benchmark's weights)."""
    from fusionmamba_torch.config import FusionModelConfig
    from fusionmamba_torch.models import VSSMFusion
    cfg = FusionModelConfig(**{k: tuple(config[k]) if isinstance(config[k], list) else config[k]
                               for k in FUSION_FIELDS})
    with torch.device(device):
        return VSSMFusion(cfg)


def padded_vocab(config: dict) -> int:
    m = config["pad_vocab_size_multiple"]
    return -(-config["vocab_size"] // m) * m


def lm_model(config: dict, device):
    """`fusionmamba_torch.models.mamba_lm.MambaLMHeadModel` of `config`."""
    from fusionmamba_torch.models.mamba_lm import MambaLMHeadModel
    with torch.device(device):
        return MambaLMHeadModel(padded_vocab(config), config["d_model"], config["n_layer"],
                                config["d_state"], config["d_conv"], config["expand"],
                                config.get("dt_rank"), config["norm_eps"], config["rms_norm"])
