"""Training of the fusion network: the step and optimizer (`loop.py`) and
the CLI (`cli.py`, run as `python -m fusionmamba_torch.train`)."""
from .cli import main
from .loop import (fusion_train_step, make_fusion_optimizer, reference_fusion_lr,
                   set_learning_rate)

__all__ = ["fusion_train_step", "main", "make_fusion_optimizer", "reference_fusion_lr",
           "set_learning_rate"]
