"""The numbers that decide `correct`, each a gap between what the program
produced and what the reference computes from the same inputs."""
from __future__ import annotations

import torch


def rel_gap(got: list, want: list) -> float:
    """The largest |got - want| / |want| over paired scalars (the losses)."""
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def leaf_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each leaf's |norm_got - norm_want|, against the larger of that leaf's
    reference norm and the median leaf's (some leaves' norms are all but
    zero). `got` and `want` hold one norm a leaf."""
    got, want = got.double().cpu(), want.double().cpu()
    return (got - want).abs() / torch.maximum(want, want[want > 0].median())



def out_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference of two outputs; infinite where their
    shapes differ (an output with rows missing)."""
    if got.shape != want.shape:
        return float("inf")
    return (got.double().cpu() - want.double().cpu()).abs().max().item()
