"""Time the depthwise-conv backward (`csrc/dwconv3x3_bwd.cu`) in several
checkouts of the port on one NVIDIA GPU, alternating them, at every shape of
a training step of the full config: the fusion step's 6 pairs and the
segmentation steps' batches.

    python3 -m fusionmamba_torch.tools.dwconv_bwd_ab [--dtype bf16] [--rounds 2] TREE [TREE ...]

Run from the root of a checkout (it reads the shapes from `chip_smoke.py`).
Each TREE is a directory that holds a `fusionmamba_torch` package (another
commit unpacked with `git archive`, or a copy with another plan); each round
runs every tree in a process of its own, in the given order in even rounds
and the reverse order in odd ones, so that each tree is timed before and
after the others (`_ab.compare`). A process builds its tree's kernels, makes the same seeded
inputs (x and dy in the I/O dtype; w and the bias rounded to it and passed as
fp32, as the op's autograd Function passes them) and takes the device time
of `dwconv_bwd` a call (`_ab.device_ms`: the median of 3 captures of 20
calls, both of its kernels).

Prints one JSON line a tree, round and shape, then the card's name and power
limit, and last one JSON object: for each tree and batch the device ms a
step in each round, and the largest difference of its dx, dw and dbias from
the first tree's, over the largest entry.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPS = 20


def child(spec: dict, ab) -> None:
    """In a tree's process: time its `dwconv_bwd` at each shape and save
    its outputs."""
    import torch

    from fusionmamba_torch.ops import cuda_lib, dwconv

    io = {"bf16": torch.bfloat16, "fp32": torch.float32}[spec["dtype"]]
    dev = torch.device("cuda")
    cuda_lib.build()
    outs = {}
    for i, shape in enumerate(spec["shapes"]):
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        B, H, W, C = shape
        x, dy = (torch.randn(*shape, device=dev, generator=gen).to(io) for _ in range(2))
        w = (torch.randn(3, 3, C, device=dev, generator=gen) / 3).to(io).float()
        b = (torch.randn(C, device=dev, generator=gen) / 3).to(io).float()

        def run():
            return dwconv.dwconv_bwd(x, w, b, dy, "silu")

        outs[str(shape)] = [t.cpu() for t in run()]
        print(json.dumps({"shape": shape, "device_ms": ab.device_ms(run, REPS)}), flush=True)
    if spec.get("save"):
        torch.save(outs, spec["save"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not args.trees:
        ap.error("name at least one tree")
    from fusionmamba_torch.tools import _ab

    _ab.needs_card("dwconv_bwd_ab")
    sys.path.insert(0, os.getcwd())
    from chip_smoke import SEG_PAIRS, SIZE, train_calls

    from fusionmamba_torch.config import full_config

    calls = {f"batch {p}": {"device_ms": train_calls(full_config(), p, SIZE)["dwconv_bwd"]}
             for p in (6, *SEG_PAIRS)}
    shapes = sorted({s for c in calls.values() for s in c["device_ms"]})
    result = _ab.compare("dwconv_bwd_ab", args.trees, shapes, calls, args.rounds,
                         {"dtype": args.dtype})
    print(_ab.smi())
    print(json.dumps({"dtype": args.dtype, **result}))


if __name__ == "__main__":
    main()
