"""FLOP and parameter accounting (the counterpart of the JAX package's
`utils/flops.py`; reference `flops_selective_scan_ref`,
`models/vmamba_Fusion_efficross.py:33-148`, and `cal_params_flops`,
`utils.py:449-458`)."""
from __future__ import annotations

import copy

import torch
from torch import nn


def flops_selective_scan(B: int, L: int, D: int, N: int, with_D: bool = True,
                         with_z: bool = False) -> int:
    """Analytic FLOPs of one selective scan, in the reference's einsum-path
    accounting: deltaA (B L D N), deltaB_u (B L D N), the L-step recurrence
    (2 madds per element), and the C contraction."""
    flops = 2 * B * L * D * N       # deltaA = exp(delta * A) (mul only)
    flops += 3 * B * L * D * N      # deltaB_u = delta * B * u
    flops += 2 * B * L * D * N      # h = a*h + b
    flops += 2 * B * L * D * N      # y = <C, h>
    if with_D:
        flops += 2 * B * D * L
    if with_z:
        flops += 2 * B * D * L
    return flops


def count_params(model: nn.Module) -> int:
    """Number of parameter elements (buffers not counted)."""
    return sum(p.numel() for p in model.parameters())


def model_cost_report(model: nn.Module, *inputs) -> dict:
    """Parameters and forward FLOPs of `model` on `inputs`.

    The FLOPs are counted by `torch.utils.flop_counter.FlopCounterMode` on a
    CPU copy of the model, through the plain PyTorch versions of the ops: the
    counter sees only dispatched torch operators, not the kernels' ctypes
    launches, so counting on the card would miss the scan, the MLP and the
    convolutions that the kernels do. On the plain path the count is the
    same whatever runs the model. It counts the matrix products, einsums and
    convolutions (the bulk of the work), not elementwise ops; the JAX
    package's count is XLA's `cost_analysis`, which also counts those.
    `bytes_accessed` is NaN: no torch counter reckons the bytes a forward
    moves, and the plain path's bytes would not be the kernels'."""
    from torch.utils.flop_counter import FlopCounterMode

    cpu = copy.deepcopy(model).cpu().eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        cpu(*(x.cpu() for x in inputs))
    return {"params": count_params(model), "flops": counter.get_total_flops(),
            "bytes_accessed": float("nan")}
