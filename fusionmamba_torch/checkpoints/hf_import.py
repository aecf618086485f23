"""Released Mamba LM checkpoints for `models.mamba_lm.MambaLMHeadModel`: the
port of `fusionmamba_tpu/checkpoints/hf_import.py` (itself the counterpart of
`mamba_ssm/utils/hf.py`). `model_from_config` also builds
`models.jamba.JambaForCausalLM` from a Jamba config.json, whose parameters
keep transformers' names.

The released `state-spaces/mamba-*` checkpoints ship a `config.json` and a
`pytorch_model.bin` whose keys follow `mamba_ssm/models/mixer_seq_simple.py`
(`backbone.embedding`, `backbone.layers.{i}.{norm, mixer.*}`,
`backbone.norm_f`, the tied `lm_head`). The port's LM keeps those names and
layouts, so converting only checks the keys and drops the tied head. Only
local files are read: a directory holding both files, or a `.bin` beside its
`config.json`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..models.jamba import JambaForCausalLM
from ..models.mamba_lm import MambaLMHeadModel

#: the ssm_cfg keys MambaBlock honours; any other (e.g. `layer` choosing a
#: Mamba-2 mixer) would build a model that does not match the checkpoint
_SSM_CFG_KEYS = ("d_state", "d_conv", "expand", "dt_rank")
_HEAD = "lm_head.weight"
_WEIGHT_NAMES = ("pytorch_model.bin", "model.bin", "weights.bin")


def model_from_config(cfg: Dict[str, Any], experts_held=None) -> nn.Module:
    """The LM of a `config.json` dict. A `model_type` "jamba" config builds
    `JambaForCausalLM` (transformers' `JambaConfig` fields), holding
    `experts_held` of each expert layer's experts (all by default). Any
    other is mamba_ssm's (`mamba_ssm/models/config_mamba.py` fields): its
    vocabulary padded to `pad_vocab_size_multiple`
    (`mixer_seq_simple.py:181-184`); ssm_cfg's d_state, d_conv, expand and
    dt_rank honoured, and any other ssm_cfg key raises."""
    if cfg.get("model_type") == "jamba":
        return JambaForCausalLM(cfg, experts_held)
    if experts_held is not None:
        raise ValueError("experts_held applies to a Jamba config only")
    vocab = int(cfg["vocab_size"])
    mult = int(cfg.get("pad_vocab_size_multiple", 8))
    if vocab % mult:
        vocab += mult - vocab % mult
    ssm_cfg = cfg.get("ssm_cfg") or {}
    unknown = sorted(set(ssm_cfg) - set(_SSM_CFG_KEYS))
    if unknown:
        raise ValueError(
            f"unsupported ssm_cfg keys {unknown}: this importer builds the "
            f"Mamba-1 MambaBlock, which honors only {_SSM_CFG_KEYS}")
    dt_rank = ssm_cfg.get("dt_rank", "auto")
    return MambaLMHeadModel(
        vocab_size=vocab, d_model=int(cfg["d_model"]), n_layer=int(cfg["n_layer"]),
        d_state=int(ssm_cfg.get("d_state", 16)), d_conv=int(ssm_cfg.get("d_conv", 4)),
        expand=int(ssm_cfg.get("expand", 2)),
        dt_rank=None if dt_rank in ("auto", None) else int(dt_rank),
        rms_norm=bool(cfg.get("rms_norm", True)))


def _expected_keys(n_layer: int, norm_bias: bool):
    keys = {"backbone.embedding.weight", "backbone.norm_f.weight"}
    mixer = ("in_proj.weight", "conv1d.weight", "conv1d.bias", "x_proj.weight",
             "dt_proj.weight", "dt_proj.bias", "A_log", "D", "out_proj.weight")
    for i in range(n_layer):
        p = f"backbone.layers.{i}."
        keys.add(p + "norm.weight")
        keys.update(p + "mixer." + k for k in mixer)
        if norm_bias:
            keys.add(p + "norm.bias")
    if norm_bias:
        keys.add("backbone.norm_f.bias")
    return keys


def convert_mamba_state_dict(sd: Dict[str, Any], n_layer: int) -> Dict[str, torch.Tensor]:
    """A mamba_ssm state dict -> the port's: the same keys and layouts, fp32,
    without the tied `lm_head.weight` (`mixer_seq_simple.py:235-238`).
    Raises on a missing or unknown key."""
    norm_bias = "backbone.norm_f.bias" in sd
    got = set(sd) - {_HEAD}
    want = _expected_keys(n_layer, norm_bias)
    if got != want:
        raise KeyError(f"not a {n_layer}-layer mamba_ssm state dict: missing "
                       f"{sorted(want - got)}, unexpected {sorted(got - want)}")
    return {k: torch.as_tensor(sd[k]).detach().float().cpu() for k in sorted(got)}


def export_mamba_state_dict(model: MambaLMHeadModel) -> Dict[str, torch.Tensor]:
    """The inverse of `convert_mamba_state_dict`: the model's state dict on
    the CPU with the tied `lm_head.weight` added, as mamba_ssm saves it."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    sd[_HEAD] = sd["backbone.embedding.weight"]
    return sd


def _resolve(path: str) -> Tuple[str, str]:
    """(config path, weights path) of a local directory or `.bin` file."""
    if os.path.isdir(path):
        for name in _WEIGHT_NAMES:
            weights = os.path.join(path, name)
            if os.path.exists(weights):
                return os.path.join(path, "config.json"), weights
        raise FileNotFoundError(f"no pytorch_model.bin under {path!r}")
    if os.path.isfile(path):
        return os.path.join(os.path.dirname(path), "config.json"), path
    raise FileNotFoundError(
        f"{path!r} is neither a directory nor a file: load_mamba_hf needs a local path "
        f"(a directory with config.json and pytorch_model.bin, or the .bin beside its "
        f"config.json); model names are not resolved through a hub cache")


def load_mamba_hf(path: str) -> MambaLMHeadModel:
    """A released Mamba LM checkpoint from a local directory or `.bin`
    file, as a model on the CPU with its weights loaded strictly."""
    cfg_path, weights_path = _resolve(path)
    with open(cfg_path) as f:
        cfg = json.load(f)
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    model = model_from_config(cfg)
    model.load_state_dict(convert_mamba_state_dict(sd, model.n_layer))
    return model
