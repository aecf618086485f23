"""JAX params tree (numpy) -> the port's state dict, which is the reference
`VSSM_Fusion` (and `VSSM_Fusion_Segmentation`) state-dict layout.

`fusion_key_map(depths, depths_decoder)` enumerates every
(torch_key, flax_path, transform) triple of the fusion model and
`seg_key_map` those of the segmentation model's parameters; this is the
port's own copy of the tables in `fusionmamba_tpu/checkpoints/torch_import.py`
(`convert_seg_state_dict`'s layout for the segmentation head), so the port
needs nothing from the JAX package to read such weights. Transforms from the
flax layout:
  * linear : Dense kernel (in, out)      -> Linear weight (out, in)
  * conv   : HWIO (kh, kw, I, O)         -> Conv2d weight (O, I, kh, kw)
  * eca    : (k,)                        -> Conv1d weight (1, 1, k)
  * mask_t : LDC learnable_mask (in, out) -> (out, in)
  * a_logs : (K, D, N)                   -> (K*D, N)
  * ds     : (K, D)                      -> (K*D,)
  * conv1d : (d_conv, 1, C)              -> Conv1d weight (C, 1, d_conv)
  * none   : identity
The LDC modules' constant `base_mask` buffers (ones) are synthesised; the
head's BatchNorm statistics come from the flax `batch_stats` collection.
`lm_state_dict_from_jax` maps the JAX Mamba LM's parameters onto the port's
LM, whose names are mamba_ssm's.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_TO_TORCH = {
    "none": lambda x: x,
    "linear": lambda x: x.T,
    "conv": lambda x: x.transpose(3, 2, 0, 1),
    "eca": lambda x: x.reshape(1, 1, -1),
    "mask_t": lambda x: x.T,
    "a_logs": lambda x: x.reshape(-1, x.shape[-1]),
    "ds": lambda x: x.reshape(-1),
    "conv1d": lambda x: x.transpose(2, 1, 0),
}

MapEntry = Tuple[str, Tuple[str, ...], str]


def _layernorm(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield tk + ".weight", fp + ("scale",), "none"
    yield tk + ".bias", fp + ("bias",), "none"


def _linear(tk: str, fp: Tuple[str, ...], bias: bool) -> Iterator[MapEntry]:
    yield tk + ".weight", fp + ("kernel",), "linear"
    if bias:
        yield tk + ".bias", fp + ("bias",), "none"


def _conv(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield tk + ".weight", fp + ("kernel",), "conv"
    yield tk + ".bias", fp + ("bias",), "none"


def _ldc(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield tk + ".conv.weight", fp + ("kernel",), "conv"
    yield tk + ".learnable_mask", fp + ("learnable_mask",), "mask_t"
    yield tk + ".learnable_theta", fp + ("learnable_theta",), "none"


def _eca(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield tk + ".conv.weight", fp + ("conv_kernel",), "eca"


def _ssm_core(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield tk + ".x_proj_weight", fp + ("x_proj_weight",), "none"
    yield tk + ".dt_projs_weight", fp + ("dt_projs_weight",), "none"
    yield tk + ".dt_projs_bias", fp + ("dt_projs_bias",), "none"
    yield tk + ".A_logs", fp + ("A_logs",), "a_logs"
    yield tk + ".Ds", fp + ("Ds",), "ds"
    yield from _layernorm(tk + ".out_norm", fp + ("out_norm",))


def _ss2d(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield from _linear(tk + ".in_proj", fp + ("in_proj",), bias=False)
    yield from _conv(tk + ".conv2d", fp + ("conv2d",))
    yield from _ssm_core(tk, fp)
    yield from _linear(tk + ".out_proj", fp + ("out_proj",), bias=False)


def _ss2d_cross(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield from _linear(tk + ".in_proj1", fp + ("in_proj1",), bias=False)
    yield from _linear(tk + ".in_proj2", fp + ("in_proj2",), bias=False)
    yield from _conv(tk + ".conv2d", fp + ("conv2d",))
    yield from _ssm_core(tk, fp)
    yield from _linear(tk + ".out_proj", fp + ("out_proj",), bias=False)


def _biattn(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield from _layernorm(tk + ".norm", fp + ("norm",))
    yield from _linear(tk + ".global_reduce", fp + ("global_reduce",), True)
    yield from _linear(tk + ".channel_select", fp + ("channel_select",), True)


def _vss_block(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield from _layernorm(tk + ".norm", fp + ("norm",))
    yield from _ss2d(tk + ".op", fp + ("op",))
    yield from _ldc(tk + ".conv_branch", fp + ("conv_branch",))
    yield from _eca(tk + ".self_attention_cross_channel", fp + ("eca",))
    yield from _biattn(tk + ".se", fp + ("se",))
    yield from _layernorm(tk + ".norm2", fp + ("norm2",))
    yield from _linear(tk + ".mlp.fc1", fp + ("mlp", "fc1"), True)
    yield from _linear(tk + ".mlp.fc2", fp + ("mlp", "fc2"), True)


def _cross_block(tk: str, fp: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield from _layernorm(tk + ".ln_1", fp + ("ln_1",))
    yield from _layernorm(tk + ".ln_2", fp + ("ln_2",))
    yield from _ldc(tk + ".Cross_layer.texture_enhance1",
                    fp + ("cross_layer", "texture_enhance1"))
    yield from _ldc(tk + ".Cross_layer.texture_enhance2",
                    fp + ("cross_layer", "texture_enhance2"))
    yield from _ss2d_cross(tk + ".self_attention_cross", fp + ("self_attention_cross",))
    yield from _eca(tk + ".self_attention_cross_spatial",
                    fp + ("self_attention_cross_spatial",))


def fusion_key_map(depths, depths_decoder) -> Iterator[MapEntry]:
    """Every (torch_key, flax_path, transform) of VSSMFusion."""
    for which in ("1", "2"):
        yield from _conv(f"patch_embed{which}.proj", (f"patch_embed{which}", "proj"))
        yield from _layernorm(f"patch_embed{which}.norm", (f"patch_embed{which}", "norm"))
    nl = len(depths)
    for i in range(nl):
        for j in range(depths[i]):
            yield from _vss_block(f"layers.{i}.blocks.{j}", (f"layers_{i}", f"block{j}"))
        if i < nl - 1:
            yield from _layernorm(f"layers.{i}.downsample.norm",
                                  (f"layers_{i}", "downsample", "norm"))
            yield from _linear(f"layers.{i}.downsample.reduction",
                               (f"layers_{i}", "downsample", "reduction"), bias=False)
    for i in range(nl):
        if i != 0:
            yield from _linear(f"layers_up.{i}.upsample.expand",
                               (f"layers_up_{i}", "upsample", "expand"), bias=False)
            yield from _layernorm(f"layers_up.{i}.upsample.norm",
                                  (f"layers_up_{i}", "upsample", "norm"))
        for j in range(depths_decoder[i]):
            yield from _vss_block(f"layers_up.{i}.blocks.{j}",
                                  (f"layers_up_{i}", f"block{j}"))
    for i in range(nl):
        yield from _cross_block(f"Cross_block.{i}", (f"cross_blocks_{i}",))
    yield from _linear("final_up.expand", ("final_up", "expand"), bias=False)
    yield from _layernorm("final_up.norm", ("final_up", "norm"))
    yield from _conv("final_conv", ("final_conv",))


_HEAD = "segmentation_head"


def seg_key_map(depths, depths_decoder) -> Iterator[MapEntry]:
    """Every (torch_key, flax_path, transform) of VSSMFusionSeg's parameters:
    the fusion model's under `fusion_model`, then the head's (the attention
    conv is the reference's `nn.Sequential`, hence `attention.0`)."""
    for tk, fp, tr in fusion_key_map(depths, depths_decoder):
        yield "fusion_model." + tk, ("fusion_model",) + fp, tr
    for conv in ("conv1", "conv2"):
        yield from _conv(f"{_HEAD}.{conv}", (_HEAD, conv))
    yield from _conv(f"{_HEAD}.attention.0", (_HEAD, "attention"))
    yield from _conv(f"{_HEAD}.final_conv", (_HEAD, "final_conv"))
    for bn in ("bn1", "bn2"):
        yield from _layernorm(f"{_HEAD}.{bn}", (_HEAD, bn))


def _get(tree: Dict[str, Any], path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _from_map(params: Dict[str, Any], key_map) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for tk, fp, tr in key_map:
        arr = _TO_TORCH[tr](np.array(_get(params, fp), dtype=np.float32))
        sd[tk] = torch.from_numpy(np.ascontiguousarray(arr))
    for tk in list(sd):
        if tk.endswith(".conv.weight") and ("texture_enhance" in tk or "conv_branch" in tk):
            sd[tk[: -len(".conv.weight")] + ".base_mask"] = torch.ones_like(sd[tk])
    return sd


def state_dict_from_jax(params: Dict[str, Any], depths,
                        depths_decoder) -> Dict[str, torch.Tensor]:
    """The flax params tree of VSSMFusion (nested dicts of numpy arrays) as
    the port's state dict, `base_mask` buffers included."""
    return _from_map(params, fusion_key_map(depths, depths_decoder))


def seg_state_dict_from_jax(variables: Dict[str, Any], depths,
                            depths_decoder) -> Dict[str, torch.Tensor]:
    """The flax variables of VSSMFusionSeg, {"params": {"fusion_model",
    "segmentation_head"}, "batch_stats": {"segmentation_head": {"bn1",
    "bn2": {"mean", "var"}}}}, as the port's state dict: `base_mask`
    buffers, the BatchNorms' running statistics and `num_batches_tracked`
    (0: flax keeps no count) included."""
    sd = _from_map(variables["params"], seg_key_map(depths, depths_decoder))
    stats = variables["batch_stats"][_HEAD]
    for bn in ("bn1", "bn2"):
        for tk, fk in (("running_mean", "mean"), ("running_var", "var")):
            sd[f"{_HEAD}.{bn}.{tk}"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(stats[bn][fk], dtype=np.float32)))
        sd[f"{_HEAD}.{bn}.num_batches_tracked"] = torch.tensor(0)
    return sd



def _lm_key_map(params: Dict[str, Any], n_layer: int) -> Iterator[MapEntry]:
    """Every (torch_key, flax_path, transform) of the Mamba LM; a norm's bias
    only where the flax tree has one (the LayerNorm flavour)."""
    def norm(tk, fp):
        yield tk + ".weight", fp + ("scale",), "none"
        if "bias" in _get(params, fp):
            yield tk + ".bias", fp + ("bias",), "none"

    yield "backbone.embedding.weight", ("embedding", "embedding"), "none"
    for i in range(n_layer):
        tk, fp = f"backbone.layers.{i}.", (f"blocks_{i}",)
        yield from norm(tk + "norm", fp + ("norm",))
        m, mp = tk + "mixer.", fp + ("mixer",)
        for name in ("in_proj", "x_proj", "out_proj"):
            yield m + name + ".weight", mp + (name, "kernel"), "linear"
        yield m + "conv1d.weight", mp + ("conv1d_kernel",), "conv1d"
        for tname, fname in (("conv1d.bias", "conv1d_bias"), ("dt_proj.weight", "dt_proj_weight"),
                             ("dt_proj.bias", "dt_proj_bias"), ("A_log", "A_log"), ("D", "D")):
            yield m + tname, mp + (fname,), "none"
    yield from norm("backbone.norm_f", ("norm_f",))


def lm_state_dict_from_jax(variables: Dict[str, Any], n_layer: int) -> Dict[str, torch.Tensor]:
    """The flax variables of the JAX `MambaLMHeadModel` ({"params": ...} of
    numpy arrays) as the state dict of the port's LM (mamba_ssm's names):
    Dense kernels transposed, `conv1d_kernel` (d_conv, 1, d_inner) ->
    conv1d.weight (d_inner, 1, d_conv), `dt_proj_weight`, `A_log` and `D` as
    they are, a norm's `bias` only where it has one."""
    params = variables["params"]
    return _from_map(params, _lm_key_map(params, n_layer))
