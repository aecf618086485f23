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
after the others. A process builds its tree's kernels, makes the same seeded
inputs (x and dy in the I/O dtype; w and the bias rounded to it and passed as
fp32, as the op's autograd Function passes them) and takes the device time
of `dwconv_bwd` a call (torch.profiler: the median of 3 captures of 20 calls,
both of its kernels).

Prints one JSON line a tree, round and shape, then the card's name and power
limit, and last one JSON object: for each tree the device ms a step of each
batch in each round, and the largest difference of its dx, dw and dbias from
the first tree's, over the largest entry.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

CAPTURES, REPS = 3, 20


def _child(spec: dict) -> None:
    """In a tree's process: time its `dwconv_bwd` at each shape and save
    its outputs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        times = []
        for _ in range(CAPTURES):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    run()
                torch.cuda.synchronize()
            spans = [e.time_range.end - e.time_range.start for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if spans:
                times.append(sum(spans) / 1e3 / REPS)
        times.sort()
        print(json.dumps({"shape": shape, "device_ms": times[len(times) // 2] if times else None,
                          "captures_ms": times}), flush=True)
    if spec.get("save"):
        torch.save(outs, spec["save"])


def _run_tree(tree: str, spec: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", json.dumps(spec)],
                          cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return {str(ln["shape"]): ln for ln in lines}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(json.loads(args.child))
        return
    if not args.trees:
        ap.error("name at least one tree")
    import torch

    if not torch.cuda.is_available():
        sys.exit("dwconv_bwd_ab: no CUDA device")
    sys.path.insert(0, os.getcwd())
    from chip_smoke import SEG_PAIRS, SIZE, train_calls

    from fusionmamba_torch.config import full_config

    calls = {pairs: train_calls(full_config(), pairs, SIZE)["dwconv_bwd"]
             for pairs in (6, *SEG_PAIRS)}
    shapes = sorted({s for c in calls.values() for s in c})
    step_ms = {t: {f"batch {p}": [] for p in calls} for t in args.trees}
    with tempfile.TemporaryDirectory() as tmp:
        saved = {t: os.path.join(tmp, f"{i}.pt") for i, t in enumerate(args.trees)}
        for r in range(args.rounds):
            for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
                spec = {"shapes": [list(s) for s in shapes], "dtype": args.dtype,
                        "save": saved[tree] if r == 0 else None}
                got = _run_tree(tree, spec)
                for s in shapes:
                    print(json.dumps({"tree": tree, "round": r, **got[str(list(s))]}), flush=True)
                for p, c in calls.items():
                    step_ms[tree][f"batch {p}"].append(
                        sum(n * got[str(list(s))]["device_ms"] for s, n in c.items()))
        ref = torch.load(saved[args.trees[0]])
        diff = {}
        for tree in args.trees:
            outs = torch.load(saved[tree])
            diff[tree] = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                             for k in ref for a, b in zip(outs[k], ref[k]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"dtype": args.dtype, "step_device_ms": step_ms,
                      "max_rel_diff_vs_first": diff}))


if __name__ == "__main__":
    main()
