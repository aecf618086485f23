"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def select_device(name: str) -> torch.device:
    """The device an entry point runs on: "cuda" (a card, the default of the
    entry points) or "cpu". Asking for a card where there is none raises;
    nothing falls back to the CPU.

    On the card this pins fp32 numerics for the whole process: matmuls and
    convolutions run in full fp32, not TF32 (cuDNN runs fp32 convolutions in
    TF32 by default), bf16 matmuls (mixed-precision training) accumulate in
    fp32 as the JAX kernels' dots do, and cuDNN picks deterministic
    algorithms, so that the card's output matches the CPU path and repeats
    from run to run."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu "
                               "to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    return dev
