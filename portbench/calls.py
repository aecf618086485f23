"""How often each hand-written kernel runs in one forward or one training
step of the fusion network, by shape: a frozen copy of
`chip_smoke.py::main_path_calls` and `train_calls` for one process without
remat (the cells' setting). `cfg` is a configuration file's dict.

Shapes: scan (B, K, L, D, R), K = 4; layer_norm (rows, C, gate); ln_mean
(B, rows, C); dwconv (B, H, W, C); mlp (M, C, hidden). The backward runs
the same calls but those of the finest cross block, whose output the
decoder never reads.
"""
from __future__ import annotations

import collections
import math

OPS = ("scan", "layer_norm", "ln_mean", "dwconv", "mlp")


def main_path_calls(cfg: dict, pairs: int, size: int, part: str = "forward") -> dict:
    """op -> Counter(shape -> calls) for one forward ("forward") or its
    backward ("backward") on `pairs` pairs of size x size."""
    calls = {k: collections.Counter() for k in OPS}
    dims, depths, dec = cfg["dims"], cfg["depths"], cfg["depths_decoder"]
    g0, nl = size // cfg["patch_size"], len(dims)

    def ln(rows, c, gate="none"):
        calls["layer_norm"][(rows, c, gate)] += 1

    def ssm(b, g, c, convs, gate):
        d = int(cfg["ssm_ratio"] * c)
        length, r = ((g + 1) // 2) ** 2, math.ceil(c / 16)
        calls["dwconv"][(b, g, g, d)] += convs
        calls["scan"][(b, 4, length, d, r)] += 1
        ln(b * g * g, d, gate)

    def vss_block(b, g, c):
        ln(b * g * g, c)
        ssm(b, g, c, 1, "silu")
        calls["ln_mean"][(b, g * g, c)] += 2
        ln(b * g * g, c)
        calls["mlp"][(b * g * g, c, int(c * cfg["mlp_ratio"]))] += 1

    for _ in range(2):                                   # patch embeds
        ln(pairs * g0 * g0, dims[0])
    for i, c in enumerate(dims):                         # shared encoder, 2B
        g = g0 >> i
        for _ in range(depths[i]):
            vss_block(2 * pairs, g, c)
        if i < nl - 1:
            ln(2 * pairs * (g // 2) ** 2, 4 * c)
    for i, c in enumerate(dims):                         # cross blocks
        if part == "backward" and i == 0:
            continue
        g = g0 >> i
        ln(pairs * g * g, c)
        ln(pairs * g * g, c)
        ssm(pairs, g, c, 2, "silu_sum")
    for i, c in enumerate(dims[::-1]):                   # decoder
        g = g0 >> (nl - 1 - i)
        if i > 0:
            ln(pairs * g * g, c)
        for _ in range(dec[i]):
            vss_block(pairs, g, c)
    ln(pairs * (4 * g0) ** 2, dims[0] // 4)              # final_up
    return calls


def train_calls(cfg: dict, pairs: int, size: int) -> dict:
    """kernel -> Counter(shape -> calls) for one training step, all ten
    kernels: the forward's and, as `<op>_bwd`, the backward's."""
    fwd = main_path_calls(cfg, pairs, size, "forward")
    bwd = main_path_calls(cfg, pairs, size, "backward")
    return {**fwd, **{k + "_bwd": c for k, c in bwd.items()}}


def lm_calls(cfg: dict, batch: int, seq_len: int) -> dict:
    """The Mamba LM's one kernel per layer: the scan at K = 1 with a full-rank dt."""
    shape = (batch, 1, seq_len, cfg["expand"] * cfg["d_model"], 0)
    return {"scan": collections.Counter({shape: cfg["n_layer"]})}
