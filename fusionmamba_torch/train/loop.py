"""The fusion training step and its optimizer (the counterpart of
`fusionmamba_tpu/train/loop.py`'s fusion half).

Reference semantics (`train.py:74-205`): Adam at lr 1e-4 with the per-epoch
decay of `train.py:125-131`, the output clamped to [0, 1] before the loss
(`train.py:149-152`), then Fusionloss, backward and the Adam step. fp32
throughout.
"""
from __future__ import annotations

import torch

from ..losses import fusion_loss


def reference_fusion_lr(epoch: int) -> float:
    """lr of 1-based `epoch`: `train.py:125-131` computes 1e-4 * 0.75 ** (epo - 1)
    with a 0-based epo, so the first epoch runs at 1e-4 / 0.75. That quirk is
    what every released model trained with, so it is kept."""
    return 1e-4 * (0.75 ** (epoch - 2))


def make_fusion_optimizer(params, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam as the reference builds it (`train.py:108`); its betas and eps are
    optax.adam's defaults too."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set the lr of every parameter group (the per-epoch decay)."""
    for group in opt.param_groups:
        group["lr"] = lr


def fusion_train_step(net, opt, vis_y, ir, generator=None) -> dict:
    """One step: forward in training mode, clamp to [0, 1], fusion loss,
    backward, Adam. vis_y and ir are (B, H, W, 1) on the model's device;
    DropPath draws its table from `generator` (see `VSSMFusion.forward`).
    Returns the loss terms as device tensors: the step itself never waits
    for the device."""
    net.train()
    gen = net(vis_y, ir, generator=generator).float().clamp(0.0, 1.0)
    out = fusion_loss(vis_y, ir, gen)
    opt.zero_grad(set_to_none=True)
    out.total.backward()
    opt.step()
    return {"loss_total": out.total.detach(), "loss_in": out.loss_in.detach(),
            "loss_ssim": out.ssim_value.detach(), "loss_grad": out.loss_grad.detach()}
