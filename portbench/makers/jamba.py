"""The maker of a configuration whose `model` is "jamba":
`fusionmamba_torch.models.jamba.JambaForCausalLM`, built through
`checkpoints/hf_import.py::model_from_config` and holding the configuration's
share of the experts (`reference/jamba.py::model_config`, `experts_held`)."""
from __future__ import annotations

import torch

from portbench.reference import jamba as ref_jamba


def padded_vocab(config: dict) -> int:
    """Jamba's vocabulary, which is not padded."""
    return config["vocab_size"]


def make(config: dict, device):
    """`JambaForCausalLM` of `config`, made on `device`."""
    from fusionmamba_torch.checkpoints.hf_import import model_from_config
    with torch.device(device):
        return model_from_config(ref_jamba.model_config(config), ref_jamba.experts_held(config))
