"""Time the fused MLP's backward (#10, `csrc/fused_mlp_bwd.cu`) in several
checkouts of the port on one NVIDIA GPU, alternating them, at the shapes of
a training step of the full config at 256²: by default the benchmark's
batch of 64 pairs (eight shapes), with --batch any other.

    python3 -m fusionmamba_torch.tools.mlp_bwd_ab [--batch 64] [--rounds 2] [--bf16] TREE [TREE ...]

Run from the root of a checkout (it reads the shapes from `chip_smoke.py`).
Each TREE is a directory that holds a `fusionmamba_torch` package (another
commit unpacked with `git archive`); each round runs every tree in a process
of its own, in the given order in even rounds and the reverse order in odd
ones (`_ab.compare`), each building only its tree's `fused_mlp_bwd.cu`. A
process makes the same seeded inputs (x and dy N(0, 1), the weights as
nn.Linear's (out, in) tensors passed as `.t()` views, as `Mlp` passes them)
and takes at each shape the device time of a call of `mlp.mlp_bwd` in fp32
(`_ab.device_ms`: the median of 3 captures of 10 calls, every kernel and
memset of the call), each kernel's share of it by name (`fp32_kernels`) and
the TFLOP/s of fp32 work it reaches (10 M C H + 30 M H operations, as
`portbench/kernels/mlp_bwd.py` counts them); with --bf16 the same in bf16.

Prints one JSON line a tree, round and shape, then the card's name and power
limit, and last one JSON object: for each tree the device ms of a step's
backward MLP calls in each round, the largest absolute difference of its
fp32 gradients from the first tree's, the largest difference of its bf16
gradients over the largest entry (0: bit for bit the first tree's), and at
each shape and dtype the largest difference of its gradients from the first
tree's over the largest entry (`rel_diff_by_output_vs_first`).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPS = 10


def _inputs(i, shape, dev, dtype):
    import torch

    gen = torch.Generator(device=dev).manual_seed(3000 + i)
    M, C, H = shape
    x = torch.randn(M, C, device=dev, generator=gen)
    dy = torch.randn(M, C, device=dev, generator=gen)
    w1 = torch.randn(H, C, device=dev, generator=gen) * C ** -0.5
    w2 = torch.randn(C, H, device=dev, generator=gen) * H ** -0.5
    b1 = torch.randn(H, device=dev, generator=gen) * 0.1
    b2 = torch.randn(C, device=dev, generator=gen) * 0.1
    return [t.to(dtype) for t in (x, w1, b1, w2, b2, dy)]


def child(spec: dict, ab) -> None:
    """In a tree's process: time its MLP backward at each shape, save its
    gradients."""
    import torch

    from fusionmamba_torch.ops import cuda_lib, mlp

    dev = torch.device("cuda")
    cuda_lib.build()
    dtypes = {"fp32": torch.float32, **({"bf16": torch.bfloat16} if spec["bf16"] else {})}
    outs = {}
    for i, shape in enumerate(map(tuple, spec["shapes"])):
        M, C, H = shape
        line = {"shape": list(shape)}
        for kind, dtype in dtypes.items():
            x, w1, b1, w2, b2, dy = _inputs(i, shape, dev, dtype)

            def call():
                return mlp.mlp_bwd(x, w1.t(), b1, w2.t(), b2, dy)

            got = call()
            torch.cuda.synchronize()
            outs[("fp32 " if kind == "fp32" else "") + str(list(shape))] = [t.cpu() for t in got]
            del got
            kernels = {}
            ms = ab.device_ms(call, REPS, kernels)
            line[kind] = ms
            line[kind + "_kernels"] = kernels
            line[kind + "_tflops"] = M * (10 * C * H + 30 * H) / (ms * 1e9) if ms else None
            del x, w1, b1, w2, b2, dy
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    if spec.get("save"):
        torch.save(outs, spec["save"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args(argv)
    if not args.trees:
        ap.error("name at least one tree")
    from fusionmamba_torch.tools import _ab

    _ab.needs_card("mlp_bwd_ab")
    sys.path.insert(0, os.getcwd())
    from chip_smoke import SIZE, train_calls

    from fusionmamba_torch.config import full_config

    step = train_calls(full_config(), args.batch, SIZE)["mlp_bwd"]
    calls = {f"train {args.batch}": {"fp32": step, **({"bf16": step} if args.bf16 else {})}}
    shapes = sorted(step)
    result = _ab.compare("mlp_bwd_ab", args.trees, shapes, calls, args.rounds,
                         {"bf16": args.bf16}, sources=["fused_mlp_bwd.cu"])
    print(_ab.smi())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
