"""The training steps and their optimizers (the counterpart of
`fusionmamba_tpu/train/loop.py`).

Fusion (`train.py:74-205`): Adam at lr 1e-4 with the per-epoch decay of
`train.py:125-131`, the output clamped to [0, 1] before the loss
(`train.py:149-152`), then Fusionloss, backward and the Adam step.
Segmentation (`train_segmentation.py:288-465`): AdamW with a global-norm
clip at 1.0, the poly lr for PST900, and the segmentation, fusion or both
losses.

Mixed precision (`--precision`, `resolve_compute_dtype` and `cast_compute`):
the master weights and the optimizer state are fp32; with a bf16 compute
dtype the forward and backward run on bf16 casts of the floating parameters
and of the inputs, the kernels take bf16 I/O with fp32 math inside, and the
outputs return to fp32 before the clamp and the losses. The default is fp32.
"""
from __future__ import annotations

import contextlib

import torch

from ..losses import fusion_loss, improved_pst900_loss, segmentation_loss
from ..parallel import local_dp_table, sync_gradients
from ..utils import tracing


def reference_fusion_lr(epoch: int) -> float:
    """lr of 1-based `epoch`: `train.py:125-131` computes 1e-4 * 0.75 ** (epo - 1)
    with a 0-based epo, so the first epoch runs at 1e-4 / 0.75. That quirk is
    what every released model trained with, so it is kept."""
    return 1e-4 * (0.75 ** (epoch - 2))


def poly_lr(base_lr: float, step: int, max_iter: int, power: float = 0.9) -> float:
    """`train_segmentation.py:94-100`."""
    return base_lr * (1.0 - step / max_iter) ** power


def make_fusion_optimizer(params, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam as the reference builds it (`train.py:108`); its betas and eps are
    optax.adam's defaults too."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_seg_optimizer(params, lr: float = 5e-5,
                       weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW with optax.adamw's betas, eps and decoupled weight decay (over
    every parameter, scaled by the lr, as optax does). The global-norm clip
    of `make_seg_optimizer`'s optax chain runs in `seg_train_step`."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set the lr of every parameter group (the per-epoch decay)."""
    for group in opt.param_groups:
        group["lr"] = lr


PRECISIONS = ("auto", "bf16", "fp32")


def resolve_compute_dtype(precision: str) -> torch.dtype:
    """The compute dtype of a `--precision` choice: "bf16" and "fp32" as
    named, "auto" fp32 (the JAX package's auto picks bf16 on a TPU only, and
    the port runs on none), anything else raises."""
    if precision == "bf16":
        return torch.bfloat16
    if precision in ("fp32", "auto"):
        return torch.float32
    raise ValueError(f"unknown precision {precision!r}: use one of {PRECISIONS}")


@contextlib.contextmanager
def cast_compute(net: torch.nn.Module, dtype: torch.dtype):
    """Within the block, every floating parameter of `net` reads as its cast
    to `dtype` (the JAX package's `cast_compute` of the params tree; a
    parameter shared by several modules is cast once). The casts are
    differentiable, so each master parameter's gradient comes back in fp32;
    buffers (BatchNorm's running statistics) are not cast, as flax leaves
    `batch_stats` alone. The block must hold the backward too: remat
    recomputes forwards there, and they must read the same casts. At fp32
    it is a no-op. The casts are span `train.cast` and copy site
    `train.cast` (`tracing`)."""
    if dtype == torch.float32:
        yield
        return
    casts, swapped = {}, []
    with tracing.span("train.cast"):
        for mod in net.modules():
            for name, p in mod._parameters.items():
                if p is not None and p.is_floating_point() and p.dtype != dtype:
                    if id(p) not in casts:
                        casts[id(p)] = tracing.cast(p, dtype, "train.cast")
                    swapped.append((mod, name, p))
    try:
        for mod, name, p in swapped:
            mod._parameters[name] = casts[id(p)]
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def fusion_train_step(net, opt, vis_y, ir, generator=None, mesh=None,
                      compute_dtype: torch.dtype = torch.float32) -> dict:
    """One step: forward in training mode, clamp to [0, 1], fusion loss,
    backward, Adam. vis_y and ir are (B, H, W, 1) on the model's device;
    DropPath draws its table from `generator` (see `VSSMFusion.forward`).
    Returns the loss terms as device tensors: the step itself never waits
    for the device.

    With a `mesh` whose data axis has several ranks, vis_y and ir are this
    rank's rows of the global batch (`parallel.rank_rows`), the DropPath
    table is drawn at the global batch and sliced (`parallel.local_dp_table`,
    the generator seeded alike on every rank), the loss is the global
    batch's, and the gradients are summed over the data axis before Adam:
    the step is the single-process step on the global batch. The model may
    be tensor-parallel over the model axis (`parallel.apply_tensor_parallel`).

    With `compute_dtype` bf16 the forward and backward run on bf16 casts of
    the parameters (`cast_compute`) and of vis_y and ir; the output returns
    to fp32 before the clamp, and the loss reads the fp32 vis_y and ir.

    Spans (`tracing`): `train.step`, and in it `train.cast` (bf16), the
    model's `fusion.forward`, `train.loss` (the clamp and the loss),
    `train.backward` and `train.optimizer`."""
    with tracing.span("train.step"):
        net.train()
        axis = None if mesh is None or mesh.data.size == 1 else mesh.data
        dp_uni = None
        if axis is not None and net.cfg.drop_path_rate > 0.0:
            dp_uni = local_dp_table(net, generator, vis_y.shape[0] * axis.size, mesh,
                                    vis_y.device)
        opt.zero_grad(set_to_none=True)
        with cast_compute(net, compute_dtype):
            x1, x2 = (tracing.cast(t, compute_dtype, "train.cast") for t in (vis_y, ir))
            gen = net(x1, x2, generator=generator, dp_uni=dp_uni)
            with tracing.span("train.loss"):
                out = fusion_loss(vis_y, ir, gen.float().clamp(0.0, 1.0), axis=axis)
            with tracing.span("train.backward"):
                out.total.backward()
        if axis is not None:
            sync_gradients(net.parameters(), mesh)
        with tracing.span("train.optimizer"):
            opt.step()
    return {"loss_total": out.total.detach(), "loss_in": out.loss_in.detach(),
            "loss_ssim": out.ssim_value.detach(), "loss_grad": out.loss_grad.detach()}


SEG_MODES = ("fusion", "segmentation", "both")
GRAD_CLIP = 1.0


def seg_train_step(net, opt, vis_y, ir, labels, *, num_classes: int,
                   mode: str = "segmentation", fusion_weight: float = 1.0,
                   seg_weight: float = 1.0, class_weights=None, improved: bool = False,
                   generator=None, dp_uni=None, drop_mask=None,
                   compute_dtype: torch.dtype = torch.float32) -> dict:
    """One step of VSSMFusionSeg (the counterpart of `make_seg_train_step`):
    forward in training mode (BatchNorm on the batch's statistics, its
    running statistics updated; DropPath and dropout drawn from `generator`
    unless `dp_uni` and `drop_mask` are given), in modes fusion and both the
    fusion output clamped to [0, 1] and its loss, in modes segmentation and
    both the segmentation loss (`improved_pst900_loss` with `class_weights`
    when `improved`, else `segmentation_loss`), the backward, the gradients
    clipped to a global norm of 1.0, and the optimizer's step. A parameter
    the losses do not reach (the head a mode leaves out, the finest
    VSSBlockCross) gets a zero gradient, so that AdamW decays it as optax
    does; torch would skip it. vis_y and ir
    are (B, H, W, 1), labels (B, H, W) integer, on the model's device.
    Returns the loss terms as device tensors: the step never waits for the
    device. `compute_dtype` as in `fusion_train_step`; the segmentation
    logits return to fp32 before their loss, and BatchNorm's running
    statistics stay fp32."""
    if mode not in SEG_MODES:
        raise ValueError(f"mode must be one of {SEG_MODES}, got {mode!r}")
    net.train()
    opt.zero_grad(set_to_none=True)
    with cast_compute(net, compute_dtype):
        outs = net(vis_y.to(compute_dtype), ir.to(compute_dtype), generator=generator,
                   dp_uni=dp_uni, drop_mask=drop_mask, return_fusion=mode != "segmentation",
                   return_segmentation=mode != "fusion")
        total, metrics = 0.0, {}
        if "fusion" in outs:
            f = fusion_loss(vis_y, ir, outs["fusion"].float().clamp(0.0, 1.0))
            total = total + fusion_weight * f.total
            metrics["fusion_total"] = f.total.detach()
        if "segmentation" in outs:
            logits = outs["segmentation"].float()
            if improved:
                s = improved_pst900_loss(logits, labels, num_classes, class_weights)
            else:
                s = segmentation_loss(logits, labels, num_classes, weight=class_weights)
            total = total + seg_weight * s.total
            metrics["seg_total"] = s.total.detach()
        total.backward()
    params = list(net.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    torch.nn.utils.clip_grad_norm_(params, GRAD_CLIP)
    opt.step()
    metrics["total"] = total.detach()
    return metrics
