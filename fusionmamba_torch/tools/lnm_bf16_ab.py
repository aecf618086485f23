"""Time the bf16 LN-mean forward (#5, `csrc/ln_mean_fwd.cu`) and backward (#6,
`csrc/layer_norm_bwd.cu`) in several checkouts of the port on one NVIDIA GPU,
alternating them, at the LN-mean's shapes of the full config: the serving
batch of 8 pairs, the fusion step's 6 and the segmentation steps' batches.

    python3 -m fusionmamba_torch.tools.lnm_bf16_ab [--rounds 2] [--sweep] TREE [TREE ...]

Run from the root of a checkout (it reads the shapes from `chip_smoke.py`).
Each TREE is a directory that holds a `fusionmamba_torch` package (another
commit unpacked with `git archive`); each round runs every tree in a process
of its own, in the given order in even rounds and the reverse order in odd
ones (`_ab.compare`). A process builds its tree's kernels, makes the same
seeded inputs (x bf16; scale and bias bf16, as a bf16 step hands them to
BiAttn; dm fp32) and
takes at each shape the device time a call (`_ab.device_ms`: the median of 3
captures of 20 calls, every kernel and memset of the call) of
  fwd_op:     `ln_spatial_mean(x, scale, bias)` as BiAttn calls it without a
              gradient (a tree whose op casts the parameters times the casts);
  fwd_kernel: `ln_spatial_mean_fwd` on fp32 parameters (the kernel alone);
  bwd:        `ln_spatial_mean_bwd` on what the tree's op saves (the
              parameters in bf16 where its kernels take them, else their fp32
              casts; the forward's means of xhat where it keeps them);
and each kernel's share of bwd (`bwd_kernels`). With --sweep, the first tree
alone, once more: the bf16 forward and backward under several figures of
their plans' blocks an SM (`BF16_FWD_BLOCKS_PER_SM`,
`BF16_LNM_BWD_BLOCKS_PER_SM`), each shape's plan and device time a call.

Prints first the device time of a one-element fill (the least any launch
costs: one cast launch), then one JSON line a tree, round and shape, then the
card's name and power limit, and last one JSON object: for each tree and
step (a serving forward; a training step of each batch) the device ms of
each of the three, in each round, the largest difference of its bf16 outputs from
the first tree's over the largest entry, and the largest absolute difference
of its fp32 outputs (forward and backward on fp32 x and parameters) from the
first tree's; with --sweep the sweep's step sums.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPS = 20
FWD_PER_SM = (0.5, 1, 1.5, 2, 4)
BWD_PER_SM = (0.5, 1, 2, 3, 4)


def _inputs(i, shape, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(2000 + i)
    B, rows, C = shape
    x = (torch.randn(B, rows, C, device=dev, generator=gen) * 2.0 + 0.5).to(torch.bfloat16)
    s = (torch.randn(C, device=dev, generator=gen) * 0.2 + 1.0).to(torch.bfloat16)
    b = (torch.randn(C, device=dev, generator=gen) * 0.2).to(torch.bfloat16)
    return x, s, b, torch.randn(B, C, device=dev, generator=gen)


def child(spec: dict, ab) -> None:
    """In a tree's process: time its LN-mean pair at each shape (and sweep
    its plans), save its outputs."""
    import torch

    from fusionmamba_torch.ops import cuda_lib, layer_norm

    def ms(fn, by_kernel=None):
        return ab.device_ms(fn, REPS, by_kernel)

    dev = torch.device("cuda")
    cuda_lib.build()
    sms = cuda_lib.sm_count(dev)
    outs = {}
    for i, shape in enumerate(map(tuple, spec["shapes"])):
        x, s, b, dm = _inputs(i, shape, dev)
        s32, b32 = s.float(), b.float()
        try:        # what the tree's op saves for its backward
            _, xmean = layer_norm.ln_spatial_mean_fwd(x, s, b, 1e-5, with_mean=True)
            saved, kw = s, {"xmean": xmean}
        except TypeError:
            saved, kw = s32, {}
        with torch.no_grad():
            runs = {"fwd_op": lambda: layer_norm.ln_spatial_mean(x, s, b, 1e-5),
                    "fwd_kernel": lambda: layer_norm.ln_spatial_mean_fwd(x, s32, b32, 1e-5),
                    "bwd": lambda: layer_norm.ln_spatial_mean_bwd(x, saved, dm, 1e-5, **kw)}
            outs[str(list(shape))] = [runs["fwd_op"]().cpu(), *(t.cpu() for t in runs["bwd"]())]
            x32 = x.float()
            outs["fp32 " + str(list(shape))] = [
                layer_norm.ln_spatial_mean_fwd(x32, s32, b32, 1e-5).cpu(),
                *(t.cpu() for t in layer_norm.ln_spatial_mean_bwd(x32, s32, dm, 1e-5))]
            kernels = {}
            line = {"shape": list(shape), **{k: ms(f, kernels if k == "bwd" else None)
                                             for k, f in runs.items()}, "bwd_kernels": kernels}
            if spec.get("sweep"):
                line["fwd_per_sm"], line["bwd_per_sm"] = {}, {}
                kept = layer_norm.BF16_FWD_BLOCKS_PER_SM, layer_norm.BF16_LNM_BWD_BLOCKS_PER_SM
                for f in FWD_PER_SM:
                    layer_norm.BF16_FWD_BLOCKS_PER_SM = f
                    layer_norm.lnm_fwd_plan.cache_clear()
                    p = layer_norm.lnm_fwd_plan(*shape, sms, torch.bfloat16)
                    line["fwd_per_sm"][f] = {
                        "cluster": p.cluster, "unroll": p.unroll, "ms": ms(
                            lambda p=p: layer_norm.ln_spatial_mean_fwd(x, s, b, 1e-5, p))}
                for f in BWD_PER_SM:
                    layer_norm.BF16_LNM_BWD_BLOCKS_PER_SM = f
                    p = layer_norm.lnm_bwd_plan(*shape, sms, torch.bfloat16)
                    line["bwd_per_sm"][f] = {"blocks": p.blocks, "ms": ms(
                        lambda p=p: layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5, p, **kw))}
                layer_norm.BF16_FWD_BLOCKS_PER_SM, layer_norm.BF16_LNM_BWD_BLOCKS_PER_SM = kept
                layer_norm.lnm_fwd_plan.cache_clear()
        print(json.dumps(line), flush=True)
    if spec.get("save"):
        torch.save(outs, spec["save"])


def _sweep_sums(lines, calls):
    """Device ms a step (each batch's forwards and backwards) under each
    figure of the plans' blocks an SM, from the sweep's times."""
    out = {}
    for kind, key in (("fwd_op", "fwd_per_sm"), ("bwd", "bwd_per_sm")):
        figures = FWD_PER_SM if kind == "fwd_op" else BWD_PER_SM
        out[key] = {f: {name: sum(n * lines[str(list(s))][key][str(f)]["ms"]
                                  for s, n in c[kind].items())
                        for name, c in calls.items() if c[kind]} for f in figures}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not args.trees:
        ap.error("name at least one tree")
    from fusionmamba_torch.tools import _ab

    _ab.needs_card("lnm_bf16_ab")
    import torch

    sys.path.insert(0, os.getcwd())
    from chip_smoke import SEG_PAIRS, SIZE, device_ms, main_path_calls, train_calls

    from fusionmamba_torch.config import full_config

    one = torch.zeros(1, device="cuda")
    print(json.dumps({"one_element_fill_device_ms": device_ms(lambda: one.fill_(1.0), reps=10)}),
          flush=True)
    cfg = full_config()
    serve = main_path_calls(cfg, 8, SIZE)["ln_mean"]
    calls = {"serve 8": {"fwd_op": serve, "fwd_kernel": serve, "bwd": {}}}
    for p in (6, *SEG_PAIRS):
        t = train_calls(cfg, p, SIZE)
        calls[f"train {p}"] = {"fwd_op": t["ln_mean"], "fwd_kernel": t["ln_mean"],
                               "bwd": t["ln_mean_bwd"]}
    shapes = sorted({s for c in calls.values() for s in c["fwd_op"]})
    result = _ab.compare("lnm_bf16_ab", args.trees, shapes, calls, args.rounds, {})
    if args.sweep:
        first = args.trees[0]
        got = _ab.by_shape(_ab.lines(first, _ab.spawn(
            "lnm_bf16_ab", first, {"shapes": [list(s) for s in shapes], "sweep": True})))
        for s in shapes:
            print(json.dumps({"tree": first, "sweep": True, **got[str(list(s))]}), flush=True)
        result["sweep_step_device_ms"] = _sweep_sums(got, calls)
    print(_ab.smi())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
