"""Model FLOPs of a forward, counted by torch's FlopCounterMode on the plain
reference on the meta device (products, einsums and convolutions, two FLOPs
a multiply-add; no data is touched): the arithmetic of
`fusionmamba_torch/utils/flops.py::model_cost_report`, run on the
benchmark's own reference. The configuration files hold the results."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import fusion as ref_fusion
from .reference import mamba_lm as ref_lm


def _count(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def fusion_forward_flops(config: dict) -> int:
    """FLOPs of one pair's forward at the configuration's image size."""
    net = ref_fusion.FusionNet(config, device="meta").eval()
    s = config["image_size"]
    x = torch.empty(1, s, s, config["in_chans"], device="meta")
    return _count(lambda: net(x, x))


def lm_forward_flops(config: dict, seq_len: int) -> int:
    """FLOPs of one sequence of `seq_len` tokens' forward to the logits."""
    net = ref_lm.MambaLM(config, device="meta")
    tokens = torch.zeros(1, seq_len, dtype=torch.long, device="meta")
    return _count(lambda: net(tokens))


def parameters(module_cls, config: dict) -> int:
    return sum(p.numel() for p in module_cls(config, device="meta").parameters())
