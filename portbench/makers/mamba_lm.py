"""The maker of a configuration whose `model` is "mamba_lm":
`fusionmamba_torch.models.mamba_lm.MambaLMHeadModel`."""
from __future__ import annotations

import torch


def padded_vocab(config: dict) -> int:
    """The vocabulary padded to `pad_vocab_size_multiple`, as mamba_ssm
    builds its embedding and tied head."""
    m = config["pad_vocab_size_multiple"]
    return -(-config["vocab_size"] // m) * m


def make(config: dict, device):
    """`MambaLMHeadModel` of `config`, made on `device`."""
    from fusionmamba_torch.models.mamba_lm import MambaLMHeadModel
    with torch.device(device):
        return MambaLMHeadModel(padded_vocab(config), config["d_model"], config["n_layer"],
                                config["d_state"], config["d_conv"], config["expand"],
                                config.get("dt_rank"), config["norm_eps"], config["rms_norm"])
