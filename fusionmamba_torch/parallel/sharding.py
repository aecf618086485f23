"""Tensor-parallel sharding rules and state dicts (the counterpart of
`fusionmamba_tpu/parallel/sharding.py`).

The rules are the JAX package's: the SS2D in-projections, fc1 and the patch
expansions are column-parallel, the SS2D out-projections and fc2
row-parallel, where the sharded dimension is at least 128. JAX's Dense
kernels are (in, out) and torch's Linear weights (out, in), so a column
shard (JAX `P(None, "model")`) is `("model", None)` here and a row shard
`(None, "model")`.

The optimizer state follows the shards by construction, the counterpart of
`opt_state_shardings`: `apply_tensor_parallel` runs before the optimizer is
made, so Adam's moments are made for, and only ever see, this rank's shard
of each sharded parameter (and a whole copy of each replicated one), and
the update is local.
"""
from __future__ import annotations

import re

import torch
from torch import nn

from ..nn.layers import Mlp
from ..nn.patch import FinalPatchExpand, PatchExpand
from ..nn.ss2d import SS2D, SS2DCross
from .collectives import gather_list
from .mesh import Mesh
from .tensor_parallel import SHARDED

_COL_PARALLEL = re.compile(r"(in_proj\d?|fc1|expand)\.weight$")
_ROW_PARALLEL = re.compile(r"(out_proj|fc2)\.weight$")
# least size of the sharded dim (smaller matrices stay whole)
MIN_SHARD_DIM = 128
COL, ROW = ("model", None), (None, "model")


def spec_for(name: str, weight: torch.Tensor) -> tuple:
    """The sharding of parameter `name` over the mesh axes, per torch dim:
    COL, ROW, or () for a whole (replicated) parameter."""
    if weight.dim() == 2:
        if _COL_PARALLEL.search(name) and weight.shape[0] >= MIN_SHARD_DIM:
            return COL
        if _ROW_PARALLEL.search(name) and weight.shape[1] >= MIN_SHARD_DIM:
            return ROW
    return ()


def param_specs(model: nn.Module) -> dict:
    """name -> spec_for(name, parameter) for every parameter of a whole model."""
    return {n: spec_for(n, p) for n, p in model.named_parameters()}


def shard_tensor(t: torch.Tensor, dim: int, blocks: int, index: int, n: int) -> torch.Tensor:
    """Rank `index` of `n`'s shard of t: t cut into `blocks` equal blocks
    along `dim`, each block cut into n, this rank's piece of each joined."""
    if t.shape[dim] % (blocks * n):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {blocks} x {n}")
    return torch.cat([b.chunk(n, dim)[index] for b in t.chunk(blocks, dim)], dim).contiguous()


def unshard_tensor(shards, dim: int, blocks: int) -> torch.Tensor:
    """The whole tensor from every rank's shard (`shard_tensor` inverted)."""
    pieces = [s.chunk(blocks, dim) for s in shards]
    return torch.cat([p[b] for b in range(blocks) for p in pieces], dim)


def _shard_param(module: nn.Module, name: str, dim: int, blocks: int, mesh: Mesh) -> None:
    ax = mesh.model
    owner, leaf = module.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
    whole = getattr(owner, leaf)
    setattr(owner, leaf, nn.Parameter(shard_tensor(whole.detach(), dim, blocks, ax.index,
                                                   ax.size)))


def _make_sharded(module: nn.Module, kind: type, shards: dict, mesh: Mesh) -> None:
    module.__class__ = SHARDED[kind]
    module.axis, module.shards = mesh.model, shards
    for name, (dim, blocks) in shards.items():
        _shard_param(module, name, dim, blocks, mesh)


def apply_tensor_parallel(model: nn.Module, mesh: Mesh) -> int:
    """Shard `model`'s wide modules over the mesh's "model" axis in place, by
    `spec_for` (a no-op on an axis of one rank). Call it on the whole model,
    its weights loaded, before the optimizer is made. Returns the number of
    parameters sharded."""
    if mesh.model.size == 1:
        return 0
    specs, count = param_specs(model), 0
    for prefix, mod in list(model.named_modules()):
        def spec(name):
            return specs[f"{prefix}.{name}" if prefix else name]

        if type(mod) in (SS2D, SS2DCross):
            ins = ["in_proj.weight"] if type(mod) is SS2D else ["in_proj1.weight",
                                                              "in_proj2.weight"]
            if spec(ins[0]) != COL:
                if spec("out_proj.weight") == ROW:
                    raise ValueError(f"{prefix}: out_proj row-parallel without in_proj")
                continue
            shards = {n: (0, 2) for n in ins}
            if spec("out_proj.weight") == ROW:
                shards["out_proj.weight"] = (1, 1)
            _make_sharded(mod, type(mod), shards, mesh)
        elif type(mod) is Mlp:
            col, row = spec("fc1.weight") == COL, spec("fc2.weight") == ROW
            if col != row:
                raise ValueError(f"{prefix}: fc1 and fc2 must shard together")
            if not col:
                continue
            shards = {"fc1.weight": (0, 1), "fc1.bias": (0, 1), "fc2.weight": (1, 1)}
            _make_sharded(mod, Mlp, shards, mesh)
        elif type(mod) in (PatchExpand, FinalPatchExpand) and spec("expand.weight") == COL:
            shards = {"weight": (0, 1)}
            if mod.expand.bias is not None:
                shards["bias"] = (0, 1)
            _make_sharded(mod.expand, nn.Linear, shards, mesh)
        else:
            continue
        count += len(shards)
    return count


def shard_layouts(model: nn.Module) -> dict:
    """state-dict key -> (dim, blocks) of every sharded parameter of `model`."""
    return {f"{prefix}.{name}" if prefix else name: layout
            for prefix, mod in model.named_modules()
            for name, layout in getattr(mod, "shards", {}).items()}


def shard_state_dict(state: dict, model: nn.Module, mesh: Mesh) -> dict:
    """This rank's state dict for the tensor-parallel `model`, from a whole
    one (a checkpoint, or `gather_state_dict`'s)."""
    layouts, ax = shard_layouts(model), mesh.model
    return {k: shard_tensor(state[k], *layouts[k], ax.index, ax.size) if k in layouts
            else state[k] for k in model.state_dict()}


def gather_state_dict(model: nn.Module, mesh: Mesh, state: dict | None = None) -> dict:
    """The whole state dict of the tensor-parallel `model` (or of `state`,
    keyed as its state dict, such as its gradients), its shards gathered
    over the "model" axis: keys and shapes as the single-process model's.
    Every rank of the axis must call it; every rank gets the result."""
    layouts = shard_layouts(model)
    state = model.state_dict() if state is None else state
    out = {}
    for k, t in state.items():
        if t is not None and k in layouts:
            dim, blocks = layouts[k]
            out[k] = unshard_tensor(gather_list(t, mesh.model), dim, blocks)
        else:
            out[k] = t if t is None else t.detach()
    return out
