"""Time the bf16 LN-mean forward (#5, `csrc/ln_mean_fwd.cu`) and backward (#6,
`csrc/layer_norm_bwd.cu`) in several checkouts of the port on one NVIDIA GPU,
alternating them, at the LN-mean's shapes of the full config: the serving
batch of 8 pairs, the fusion step's 6 and the segmentation steps' batches.

    python3 -m fusionmamba_torch.tools.lnm_bf16_ab [--rounds 2] [--sweep] TREE [TREE ...]

Run from the root of a checkout (it reads the shapes from `chip_smoke.py`).
Each TREE is a directory that holds a `fusionmamba_torch` package (another
commit unpacked with `git archive`); each round runs every tree in a process
of its own, in the given order in even rounds and the reverse order in odd
ones. A process builds its tree's kernels, makes the same seeded inputs (x
bf16; scale and bias bf16, as a bf16 step hands them to BiAttn; dm fp32) and
takes at each shape the device time a call (torch.profiler: the median of 3
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
card's name and power limit, and last one JSON object: for each tree the
device ms a step (a serving forward; a training step of each batch) of each
of the three, in each round, the largest difference of its bf16 outputs from
the first tree's over the largest entry, and the largest absolute difference
of its fp32 outputs (forward and backward on fp32 x and parameters) from the
first tree's; with --sweep the sweep's step sums.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

CAPTURES, REPS = 3, 20
FWD_PER_SM = (0.5, 1, 1.5, 2, 4)
BWD_PER_SM = (0.5, 1, 2, 3, 4)


def _device_ms(fn, by_kernel=None):
    """The median over CAPTURES of the device time a call of `fn`; with a
    dict `by_kernel`, each kernel's device time a call (the median
    capture's) goes into it by name."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    times = []
    for _ in range(CAPTURES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        names = collections.Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.name.split("(")[0].split("<")[0]] += e.time_range.end - e.time_range.start
        if names:
            times.append((sum(names.values()) / 1e3 / REPS, names))
    times.sort(key=lambda t: t[0])
    if not times:
        return None
    total, names = times[len(times) // 2]
    if by_kernel is not None:
        by_kernel.update({k: v / 1e3 / REPS for k, v in names.items()})
    return total


def _inputs(i, shape, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(2000 + i)
    B, rows, C = shape
    x = (torch.randn(B, rows, C, device=dev, generator=gen) * 2.0 + 0.5).to(torch.bfloat16)
    s = (torch.randn(C, device=dev, generator=gen) * 0.2 + 1.0).to(torch.bfloat16)
    b = (torch.randn(C, device=dev, generator=gen) * 0.2).to(torch.bfloat16)
    return x, s, b, torch.randn(B, C, device=dev, generator=gen)


def _child(spec: dict) -> None:
    """In a tree's process: time its LN-mean pair at each shape (and sweep
    its plans), save its outputs."""
    import torch

    from fusionmamba_torch.ops import cuda_lib, layer_norm

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
            line = {"shape": list(shape), **{k: _device_ms(f, kernels if k == "bwd" else None)
                                             for k, f in runs.items()}, "bwd_kernels": kernels}
            if spec.get("sweep"):
                line["fwd_per_sm"], line["bwd_per_sm"] = {}, {}
                kept = layer_norm.BF16_FWD_BLOCKS_PER_SM, layer_norm.BF16_LNM_BWD_BLOCKS_PER_SM
                for f in FWD_PER_SM:
                    layer_norm.BF16_FWD_BLOCKS_PER_SM = f
                    layer_norm.lnm_fwd_plan.cache_clear()
                    p = layer_norm.lnm_fwd_plan(*shape, sms, torch.bfloat16)
                    line["fwd_per_sm"][f] = {
                        "cluster": p.cluster, "unroll": p.unroll, "ms": _device_ms(
                            lambda p=p: layer_norm.ln_spatial_mean_fwd(x, s, b, 1e-5, p))}
                for f in BWD_PER_SM:
                    layer_norm.BF16_LNM_BWD_BLOCKS_PER_SM = f
                    p = layer_norm.lnm_bwd_plan(*shape, sms, torch.bfloat16)
                    line["bwd_per_sm"][f] = {"blocks": p.blocks, "ms": _device_ms(
                        lambda p=p: layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5, p, **kw))}
                layer_norm.BF16_FWD_BLOCKS_PER_SM, layer_norm.BF16_LNM_BWD_BLOCKS_PER_SM = kept
                layer_norm.lnm_fwd_plan.cache_clear()
        print(json.dumps(line), flush=True)
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


def _sweep_sums(lines, calls):
    """Device ms a step (each batch's forwards and backwards) under each
    figure of the plans' blocks an SM, from the sweep's times."""
    out = {}
    for kind, key in (("fwd", "fwd_per_sm"), ("bwd", "bwd_per_sm")):
        figures = FWD_PER_SM if kind == "fwd" else BWD_PER_SM
        out[key] = {f: {name: sum(n * lines[str(list(s))][key][str(f)]["ms"]
                                  for s, n in c[kind].items())
                        for name, c in calls.items() if c[kind]} for f in figures}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(json.loads(args.child))
        return
    if not args.trees:
        ap.error("name at least one tree")
    import torch

    if not torch.cuda.is_available():
        sys.exit("lnm_bf16_ab: no CUDA device")
    sys.path.insert(0, os.getcwd())
    from chip_smoke import SEG_PAIRS, SIZE, device_ms, main_path_calls, train_calls

    from fusionmamba_torch.config import full_config

    one = torch.zeros(1, device="cuda")
    print(json.dumps({"one_element_fill_device_ms": device_ms(lambda: one.fill_(1.0), reps=10)}),
          flush=True)
    cfg = full_config()
    calls = {"serve 8": {"fwd": main_path_calls(cfg, 8, SIZE)["ln_mean"], "bwd": {}}}
    for p in (6, *SEG_PAIRS):
        t = train_calls(cfg, p, SIZE)
        calls[f"train {p}"] = {"fwd": t["ln_mean"], "bwd": t["ln_mean_bwd"]}
    shapes = sorted({s for c in calls.values() for s in c["fwd"]})
    kinds = ("fwd_op", "fwd_kernel", "bwd")
    step_ms = {t: {k: {name: [] for name in calls} for k in kinds} for t in args.trees}
    sweep = None
    with tempfile.TemporaryDirectory() as tmp:
        saved = {t: os.path.join(tmp, f"{i}.pt") for i, t in enumerate(args.trees)}
        for r in range(args.rounds):
            for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
                spec = {"shapes": [list(s) for s in shapes], "save": saved[tree] if r == 0 else None}
                got = _run_tree(tree, spec)
                for s in shapes:
                    print(json.dumps({"tree": tree, "round": r, **got[str(list(s))]}), flush=True)
                for k in kinds:
                    for name, c in calls.items():
                        if k == "bwd" and not c["bwd"]:
                            continue
                        step_ms[tree][k][name].append(
                            sum(n * got[str(list(s))][k] for s, n in c[k[:3]].items()))
        if args.sweep:
            got = _run_tree(args.trees[0], {"shapes": [list(s) for s in shapes], "sweep": True})
            for s in shapes:
                print(json.dumps({"tree": args.trees[0], "sweep": True, **got[str(list(s))]}),
                      flush=True)
            sweep = _sweep_sums(got, calls)
        ref = torch.load(saved[args.trees[0]])
        diff, diff32 = {}, {}
        for tree in args.trees:
            outs = torch.load(saved[tree])
            diff[tree] = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                             for k in ref if not k.startswith("fp32")
                             for a, b in zip(outs[k], ref[k]))
            diff32[tree] = max(float((a - b).abs().max()) for k in ref if k.startswith("fp32")
                               for a, b in zip(outs[k], ref[k]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"step_device_ms": step_ms, "max_rel_diff_vs_first": diff,
                      "fp32_max_abs_diff_vs_first": diff32,
                      **({"sweep_step_device_ms": sweep} if sweep else {})}))


if __name__ == "__main__":
    main()
