"""Time the bf16 selective-scan forward (#1, `csrc/selective_scan_fwd.cu`) and
backward (#2, `csrc/selective_scan_bwd.cu`) in several checkouts of the port
on one NVIDIA GPU, alternating them, at the scan shapes of the full config's
training steps: the fusion step's batch of 6 pairs and the segmentation
steps' batches of 2 and 4.

    python3 -m fusionmamba_torch.tools.scan_bf16_ab [--rounds 2] [--train-only]
        [--more] [--fp32] [--sass] [--chunks] TREE [TREE ...]

Run from the root of a checkout (it reads the shapes from `chip_smoke.py`).
Each TREE is a directory that holds a `fusionmamba_torch` package (another
commit unpacked with `git archive`, or a copy with a kernel changed). Every
tree's scan kernels are built first, all trees at once (only the scan
sources, where the tree's `cuda_lib` reads FM_CUDA_SOURCES); then each round
runs every tree in a process of its own, in the given order in even rounds
and the reverse order in odd ones (`_ab.compare`). A process makes the same
seeded inputs at each shape (bf16 u, dt, W, B, C and dy; fp32 A, D and bias,
as a bf16 training step hands them to the scan) and takes the device time a
call (`_ab.device_ms`: the median of 3 captures of 10 calls, every kernel of
the call) of
  fwd: `selective_scan_fwd(..., save_states=True)`, as a training step calls it;
  bwd: `selective_scan_bwd` on the states that forward saved;
with each kernel's share of both (`fwd_kernels`, `bwd_kernels`).
--train-only keeps the fusion step's 8 shapes; --more adds a data-parallel
rank's batch of 3 (the fusion step under `--mesh 2,1`) and one call of each
full-resolution scan (SS2D(scan_variant="fullres") at batch 2, L up to 4096).

Prints one JSON line a tree, round and shape, then the card's name and power
limit, and last one JSON object: for each tree and step the device ms of
its forwards and of its backwards (calls a step times ms a call, summed over
the shapes), in each round, and the largest difference of
its bf16 outputs (y, the saved states and every gradient) from the first
tree's over the largest entry.
  --fp32   also runs every tree's fp32 kernels on the fp32 casts of the same
           inputs and compares all their outputs with the first tree's: the
           largest absolute difference of each tree, which must be 0.0 (exit
           status 1 otherwise).
  --sass   disassembles each tree's scan objects (`cuobjdump -sass`) and
           prints, for every kernel instance, its instruction count and its
           tensor-core (HMMA), special-function (MUFU), barrier (BAR) and
           shared-memory (LDS, STS) instructions.
  --chunks the last tree once more: the bf16 forward and backward at each
           shape with L = 1024 with L cut into 1, 2, 4, 8 and 16 chunks,
           beside the chunks the wrapper's rule picks (`picked`).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

CHUNK_CUTS = (1, 2, 4, 8, 16)
SCAN_SOURCES = ("selective_scan_fwd.cu", "selective_scan_bwd.cu")
SASS_GROUPS = ("HMMA", "MUFU", "BAR", "LDS", "STS", "SHFL")


def _inputs(i, shape, dev):
    """Seeded inputs at `shape` = (B, K, L, D, R), as `chip_smoke.make_case`
    scales them: bf16 u, dt, B, C, W and dy; fp32 A, D, bias."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3000 + i)
    B, K, L, D, R = shape
    N = 16

    def rnd(*s, scale=1.0, shift=0.0):
        return torch.randn(*s, device=dev, generator=gen) * scale + shift

    bf = torch.bfloat16
    u, dt = rnd(B, K, L, D).to(bf), rnd(B, K, L, R or D, scale=0.5).to(bf)
    A = -torch.arange(1.0, N + 1, device=dev).expand(K, D, N).contiguous()
    Bm, Cm = rnd(B, K, L, N).to(bf), rnd(B, K, L, N).to(bf)
    Dp, bias = rnd(K, D, scale=0.1, shift=1.0), rnd(K, D, scale=1.0, shift=-4.0)
    W = rnd(K, D, R, scale=R ** -0.5).to(bf) if R else None
    return [u, dt, A, Bm, Cm, Dp, bias, W], rnd(B, K, L, D).to(bf)


def _sass(cuda_lib):
    """{kernel instance: {"instructions": n, HMMA: n, ...}} of the tree's
    scan objects."""
    lib_path, _ = cuda_lib.build()
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    line = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)")
    out = {}
    for src in SCAN_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path.parent / (src + ".o"))],
                              capture_output=True, text=True, check=True).stdout
        for chunk in sass.split("Function : ")[1:]:
            name = chunk.split("\n", 1)[0].strip()
            ops = [op.split(".")[0] for op in line.findall(chunk)]
            counts = collections.Counter(ops)
            out[name] = {"instructions": len(ops), **{g: counts[g] for g in SASS_GROUPS}}
    return out


def child(spec: dict, ab) -> None:
    """In a tree's process: build its scan kernels; unless only building,
    time them at each shape and save the outputs."""
    from fusionmamba_torch.ops import cuda_lib

    _, log = cuda_lib.build()
    if spec.get("build_only"):
        print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                    if "spill" in ln or "registers" in ln
                                    or "Compiling entry" in ln]}))
        if spec.get("sass"):
            print(json.dumps({"sass": _sass(cuda_lib)}))
        return
    import torch

    from fusionmamba_torch.ops import scan_cuda

    dev = torch.device("cuda")
    outs = {}
    for i, shape in enumerate(map(tuple, spec["shapes"])):
        t, dy = _inputs(i, shape, dev)
        with torch.no_grad():
            _, hsave = scan_cuda.selective_scan_fwd(*t[:7], True, t[7], save_states=True)

            def fwd(t=t):
                return scan_cuda.selective_scan_fwd(*t[:7], True, t[7], save_states=True)

            def bwd(t=t, hsave=hsave, dy=dy):
                return scan_cuda.selective_scan_bwd(*t, hsave, dy, True)

            fk, bk = {}, {}
            line = {"shape": list(shape), "fwd": ab.device_ms(fwd, by_kernel=fk),
                    "fwd_kernels": fk, "bwd": ab.device_ms(bwd, by_kernel=bk), "bwd_kernels": bk}
            if spec.get("chunks"):
                B, K, L, D, R = shape
                line["picked"] = {
                    k: scan_cuda._pick_chunk(None, B, K, L, D, dev, rule) for k, rule in
                    (("fwd", scan_cuda.FWD_WARPS_PER_SM), ("bwd", scan_cuda.BWD_WARPS_PER_SM))}
                line["chunks"] = {}
                for n in CHUNK_CUTS:
                    c = -(-L // n // scan_cuda.TILE) * scan_cuda.TILE
                    line["chunks"][n] = {
                        "chunk": c,
                        "fwd": ab.device_ms(lambda c=c: scan_cuda.selective_scan_fwd(
                            *t[:7], True, t[7], save_states=True, chunk=c)),
                        "bwd": ab.device_ms(lambda c=c: scan_cuda.selective_scan_bwd(
                            *t, hsave, dy, True, chunk=c))}
            if spec.get("save"):
                y, hs = fwd()
                outs[str(list(shape))] = [y.cpu(), hs.cpu(),
                                          *(g.cpu() for g in bwd() if g is not None)]
                if spec.get("fp32"):
                    t32 = [None if x is None else x.float() for x in t]
                    y32, hs32 = scan_cuda.selective_scan_fwd(*t32[:7], True, t32[7],
                                                             save_states=True)
                    g32 = scan_cuda.selective_scan_bwd(*t32, hs32, dy.float(), True)
                    outs["fp32 " + str(list(shape))] = [
                        y32.cpu(), hs32.cpu(), *(g.cpu() for g in g32 if g is not None)]
        print(json.dumps(line), flush=True)
    if spec.get("save"):
        torch.save(outs, spec["save"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2, help="0: build (and --sass) only")
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--more", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--chunks", action="store_true")
    args = ap.parse_args(argv)
    if not args.trees:
        ap.error("name at least one tree")
    from fusionmamba_torch.tools import _ab

    _ab.needs_card("scan_bf16_ab")
    sys.path.insert(0, os.getcwd())
    from chip_smoke import SEG_PAIRS, SIZE, TRAIN_PAIRS, fullres_scan_shapes, train_calls

    from fusionmamba_torch.config import full_config

    cfg = full_config()
    calls = {}
    pairs = (TRAIN_PAIRS,) + (() if args.train_only else SEG_PAIRS)
    for p in pairs + ((TRAIN_PAIRS // 2,) if args.more else ()):
        t = train_calls(cfg, p, SIZE)
        calls[f"train {p}"] = {"fwd": t["scan"], "bwd": t["scan_bwd"]}
    if args.more:
        full = {s: 1 for s in fullres_scan_shapes(cfg, 2, SIZE)}
        calls["fullres 2"] = {"fwd": full, "bwd": full}
    shapes = sorted({s for c in calls.values() for s in c["fwd"]})

    builds = {tree: _ab.spawn("scan_bf16_ab", tree, {"build_only": True, "sass": args.sass},
                              SCAN_SOURCES) for tree in args.trees}
    for tree, proc in builds.items():
        for ln in _ab.lines(tree, proc):
            print(json.dumps({"tree": tree, **ln}), flush=True)
    result = _ab.compare("scan_bf16_ab", args.trees, shapes, calls, args.rounds,
                         {"fp32": args.fp32}, SCAN_SOURCES)
    if args.chunks:
        last = args.trees[-1]
        spec = {"shapes": [list(s) for s in shapes if s[2] == 1024], "chunks": True}
        for ln in _ab.lines(last, _ab.spawn("scan_bf16_ab", last, spec, SCAN_SOURCES)):
            print(json.dumps({"tree": last, "chunk_sweep": True, **ln}), flush=True)
    print(_ab.smi())
    print(json.dumps(result))
    if any(v != 0.0 for v in result.get("fp32_max_abs_diff_vs_first", {}).values()):
        sys.exit("scan_bf16_ab: fp32 outputs differ from the first tree's")


if __name__ == "__main__":
    main()
