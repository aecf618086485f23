"""Time the depthwise conv (`csrc/dwconv3x3_bwd.cu`, with --forward also
`csrc/dwconv3x3_fwd.cu`) and, with --ln, the fused LN (`ops/ln_triton.py`,
`csrc/layer_norm_bwd.cu`) in several checkouts of the port on one NVIDIA
GPU, alternating them, at every shape of a training step of the full config:
the fusion step's 6 pairs and the segmentation steps' batches.

    python3 -m fusionmamba_torch.tools.dwconv_bwd_ab [--dtype bf16] [--rounds 2]
        [--forward | --ln] [--sweep] TREE [TREE ...]

Run from the root of a checkout (it reads the shapes from `chip_smoke.py`).
Each TREE is a directory that holds a `fusionmamba_torch` package (another
commit unpacked with `git archive`, or a copy with another plan); each round
runs every tree in a process of its own, in the given order in even rounds
and the reverse order in odd ones, so that each tree is timed before and
after the others (`_ab.compare`). A process builds its tree's kernels, makes
the same seeded inputs and takes device times a call (`_ab.device_ms`: the
median of 3 captures of 20 calls, every kernel of the call):

- by default, of `dwconv_bwd` (both of its kernels) on x and dy in the I/O
  dtype and w and the bias rounded to it and passed as fp32;
- with --forward, of both passes of the public `depthwise_conv3x3` as a
  training step calls them (`fwd`: the op, which in a tree that casts the
  parameters times the casts; `bwd`: autograd's backward through it, the
  casts of the parameters' gradients included), x, dy and the parameters in
  the I/O dtype, as a step at that precision hands them; `fwd_kernel`: the
  op on the parameters' fp32 casts, made before the timed call (in a tree
  that casts them, its kernel alone); beside each pass its kernel launches a
  call (`fwd_launches`, `bwd_launches`, by the profiler) and each kernel's
  device ms a call (`kernels`);
- with --ln, the same of `layer_norm_fused` at the LN's shapes (rows, C and
  the gate), its gate in the I/O dtype.

With --forward or --ln every output and gradient is also computed in fp32
(x, dy and the parameters as their fp32 values) and saved beside the bf16
ones, so that the trees' fp32 results are compared too. With --sweep (and
--forward), the last tree alone (the change, where the parent goes first),
once more: its bf16 dwconv forward at every combination of the bf16 plan's
figures (`BF16_FWD_MAX_ROWS`, `BF16_FWD_ROWS_PER_BLOCK`), each shape's plan
and device time a call, each output checked equal to the default plan's bit
for bit.

Prints one JSON line a tree, round and shape, then the card's name and power
limit, and last one JSON object: for each tree and batch the device ms (and
launches) a step in each round, the largest difference of its outputs from
the first tree's over the largest entry (and of its fp32 outputs,
absolute), and whether every output equals the first tree's bit for bit;
with --sweep the sweep's step sums.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

REPS = 20
SWEEP = {"BF16_FWD_MAX_ROWS": (8, 16, 32), "BF16_FWD_ROWS_PER_BLOCK": (2, 4, 8, 16)}


def _launches(fn, captures=3) -> int:
    """The kernels one call of `fn` launches, by the profiler: the most that
    any of `captures` captures of one call recorded (a capture sometimes
    misses a kernel, never adds one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    most = 0
    for _ in range(captures):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.device_type == torch.autograd.DeviceType.CUDA
                             for e in prof.events()))
    return most


def _inputs(kind, i, shape, io, dev):
    """Seeded (x, parameters..., gate or None, dy) in the I/O dtype."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1000 + i)

    def rnd(*s, scale=1.0, shift=0.0):
        return (torch.randn(*s, device=dev, generator=gen) * scale + shift).to(io)

    if kind == "ln":
        rows, C, gate = shape
        return (rnd(rows, C, scale=2.0, shift=0.5), rnd(C, scale=0.2, shift=1.0),
                rnd(C, scale=0.2), None if gate == "none" else rnd(rows, C), rnd(rows, C))
    # w as SS2D passes its Conv2d weight: a (3, 3, C) view of (C, 3, 3)
    B, H, W, C = shape
    return (rnd(*shape), rnd(C, 3, 3, scale=1 / 3).permute(1, 2, 0), rnd(C, scale=1 / 3), None,
            rnd(*shape))


def _passes(kind, shape, x, p1, p2, gate, dy):
    """(forward, backward, forward on the parameters' fp32 casts) of the op
    as a training step calls it."""
    import torch

    from fusionmamba_torch.ops import dwconv, layer_norm

    if kind == "ln":
        def op(*a):
            return layer_norm.layer_norm_fused(*a, eps=1e-6, gate_act=shape[2])
        args = [x, p1, p2] + ([] if gate is None else [gate])
    else:
        def op(*a):
            return dwconv.depthwise_conv3x3(*a, act="silu")
        args = [x, p1, p2]
    live = [a.detach().requires_grad_(True) for a in args]
    out = op(*live)

    cast = [a.float() if i in (1, 2) else a for i, a in enumerate(args)]

    def fwd():
        with torch.no_grad():
            return op(*args)

    def bwd():
        return torch.autograd.grad(out, live, dy, retain_graph=True)

    def fwd_kernel():
        with torch.no_grad():
            return op(*cast)

    return fwd, bwd, fwd_kernel


def child(spec: dict, ab) -> None:
    """In a tree's process: time its kernels at each shape (and sweep the
    forward's plans), save its outputs."""
    import torch

    from fusionmamba_torch.ops import cuda_lib, dwconv

    io = {"bf16": torch.bfloat16, "fp32": torch.float32}[spec["dtype"]]
    kind = spec["kind"]
    dev = torch.device("cuda")
    cuda_lib.build()
    sms = cuda_lib.sm_count(dev)
    outs = {}
    for i, shape in enumerate(map(tuple, spec["shapes"])):
        x, p1, p2, gate, dy = _inputs(kind, i, shape, io, dev)
        key = str(list(shape))
        if kind == "bwd":
            def run():
                return dwconv.dwconv_bwd(x, p1.float(), p2.float(), dy, "silu")

            outs[key] = [t.cpu() for t in run()]
            print(json.dumps({"shape": list(shape), "device_ms": ab.device_ms(run, REPS)}),
                  flush=True)
            continue
        fwd, bwd, fwd_kernel = _passes(kind, shape, x, p1, p2, gate, dy)
        outs[key] = [fwd().cpu(), fwd_kernel().cpu(), *(g.cpu() for g in bwd())]
        f32 = [None if t is None else t.float() for t in (x, p1, p2, gate, dy)]
        f_fwd, f_bwd, _ = _passes(kind, shape, *f32)
        outs["fp32 " + key] = [f_fwd().cpu(), *(g.cpu() for g in f_bwd())]
        kernels = {"fwd": {}, "bwd": {}}
        line = {"shape": list(shape), "fwd": ab.device_ms(fwd, REPS, kernels["fwd"]),
                "bwd": ab.device_ms(bwd, REPS, kernels["bwd"]),
                "fwd_kernel": ab.device_ms(fwd_kernel, REPS), "fwd_launches": _launches(fwd),
                "bwd_launches": _launches(bwd), "kernels": kernels}
        if spec.get("sweep"):
            want = outs[key][0].to(dev)
            line["sweep"] = {}
            kept = {k: getattr(dwconv, k) for k in SWEEP}
            for figures in itertools.product(*SWEEP.values()):
                for k, v in zip(SWEEP, figures):
                    setattr(dwconv, k, v)
                plan = dwconv.fwd_plan(*shape, sms=sms, io=io)

                def run(plan=plan):
                    return dwconv.dwconv_fwd(x, p1, p2, "silu", plan)

                line["sweep"][str(figures)] = {
                    "cq": plan.cq, "tw": plan.tw, "th": plan.th,
                    "same_bits": bool(torch.equal(run(), want)), "ms": ab.device_ms(run, REPS)}
            for k, v in kept.items():
                setattr(dwconv, k, v)
        print(json.dumps(line), flush=True)
    if spec.get("save"):
        torch.save(outs, spec["save"])


def _sweep_sums(lines, calls):
    """Device ms a step of the forward (each batch) under each combination
    of the plan's figures, and whether every shape kept the default's bits."""
    out = {}
    for figures in itertools.product(*SWEEP.values()):
        f = str(figures)
        out[f] = {name: sum(n * lines[str(list(s))]["sweep"][f]["ms"]
                            for s, n in c["fwd"].items()) for name, c in calls.items()}
        out[f]["same_bits"] = all(ln["sweep"][f]["same_bits"] for ln in lines.values())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--rounds", type=int, default=2)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--forward", action="store_true")
    mode.add_argument("--ln", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not args.trees:
        ap.error("name at least one tree")
    if args.sweep and not args.forward:
        ap.error("--sweep goes with --forward")
    from fusionmamba_torch.tools import _ab

    _ab.needs_card("dwconv_bwd_ab")
    sys.path.insert(0, os.getcwd())
    from chip_smoke import SEG_PAIRS, SIZE, train_calls

    from fusionmamba_torch.config import full_config

    kind = "forward" if args.forward else "ln" if args.ln else "bwd"
    op = "layer_norm" if args.ln else "dwconv"
    calls = {}
    for p in (6, *SEG_PAIRS):
        t = train_calls(full_config(), p, SIZE)
        calls[f"batch {p}"] = ({"device_ms": t["dwconv_bwd"]} if kind == "bwd" else {
            "fwd": t[op], "bwd": t[op + "_bwd"], "fwd_kernel": t[op], "fwd_launches": t[op],
            "bwd_launches": t[op + "_bwd"]})
    shapes = sorted({s for c in calls.values() for k in c.values() for s in k})
    spec = {"dtype": args.dtype, "kind": kind}
    result = _ab.compare("dwconv_bwd_ab", args.trees, shapes, calls, args.rounds, spec)
    if args.sweep:
        last = args.trees[-1]
        got = _ab.by_shape(_ab.lines(last, _ab.spawn(
            "dwconv_bwd_ab", last, {**spec, "shapes": [list(s) for s in shapes],
                                    "sweep": True})))
        for s in shapes:
            print(json.dumps({"tree": last, "sweep": True, **got[str(list(s))]}), flush=True)
        result["sweep_step_device_ms"] = _sweep_sums(got, calls)
    print(_ab.smi())
    print(json.dumps({"dtype": args.dtype, "kind": kind, **result}))


if __name__ == "__main__":
    main()
