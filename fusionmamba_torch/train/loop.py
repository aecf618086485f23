"""The training steps and their optimizers (the counterpart of
`fusionmamba_tpu/train/loop.py`).

Fusion (`train.py:74-205`): Adam at lr 1e-4 with the per-epoch decay of
`train.py:125-131`, the output clamped to [0, 1] before the loss
(`train.py:149-152`), then Fusionloss, backward and the Adam step.
Segmentation (`train_segmentation.py:288-465`): AdamW with a global-norm
clip at 1.0, the poly lr for PST900, and the segmentation, fusion or both
losses. fp32 throughout.
"""
from __future__ import annotations

import torch

from ..losses import fusion_loss, improved_pst900_loss, segmentation_loss
from ..parallel import local_dp_table, sync_gradients


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


def fusion_train_step(net, opt, vis_y, ir, generator=None, mesh=None) -> dict:
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
    be tensor-parallel over the model axis (`parallel.apply_tensor_parallel`)."""
    net.train()
    axis = None if mesh is None or mesh.data.size == 1 else mesh.data
    dp_uni = None
    if axis is not None and net.cfg.drop_path_rate > 0.0:
        dp_uni = local_dp_table(net, generator, vis_y.shape[0] * axis.size, mesh, vis_y.device)
    gen = net(vis_y, ir, generator=generator, dp_uni=dp_uni).float().clamp(0.0, 1.0)
    out = fusion_loss(vis_y, ir, gen, axis=axis)
    opt.zero_grad(set_to_none=True)
    out.total.backward()
    if axis is not None:
        sync_gradients(net.parameters(), mesh)
    opt.step()
    return {"loss_total": out.total.detach(), "loss_in": out.loss_in.detach(),
            "loss_ssim": out.ssim_value.detach(), "loss_grad": out.loss_grad.detach()}


SEG_MODES = ("fusion", "segmentation", "both")
GRAD_CLIP = 1.0


def seg_train_step(net, opt, vis_y, ir, labels, *, num_classes: int,
                   mode: str = "segmentation", fusion_weight: float = 1.0,
                   seg_weight: float = 1.0, class_weights=None, improved: bool = False,
                   generator=None, dp_uni=None, drop_mask=None) -> dict:
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
    device."""
    if mode not in SEG_MODES:
        raise ValueError(f"mode must be one of {SEG_MODES}, got {mode!r}")
    net.train()
    outs = net(vis_y, ir, generator=generator, dp_uni=dp_uni, drop_mask=drop_mask,
               return_fusion=mode != "segmentation", return_segmentation=mode != "fusion")
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
    opt.zero_grad(set_to_none=True)
    total.backward()
    params = list(net.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    torch.nn.utils.clip_grad_norm_(params, GRAD_CLIP)
    opt.step()
    metrics["total"] = total.detach()
    return metrics
