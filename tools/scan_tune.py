#!/usr/bin/env python3
"""Times the selective-scan kernels at each chunk length on one GPU.

    python3 tools/scan_tune.py [--save-every 8 16] [--reps 10]

For every scan shape of the full config (training: encoder batch 12, decoder
6; serving: 16 and 8) it times the forward (serving form, and the training
form that saves states) and the backward (`csrc/selective_scan_fwd.cu`,
`_bwd.cu`) at each candidate chunk length (one chunk included) and at what
`chunk_len` picks for each, for each interval of saved states given, per call: CUDA-event time over back-to-back calls (which includes the host's
launch pace) and the profiler's device time (kernels only, the partial sums'
reductions included; for the backward at the picked chunk length also by
kernel name). One JSON line per shape; the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.profiler import ProfilerActivity, profile

from fusionmamba_torch.device import select_device
from fusionmamba_torch.ops import scan_cuda

# (B, L, D, R), K = 4, N = 16
SHAPES = [(b, L, D, R) for L, D, R in ((1024, 192, 6), (256, 384, 12), (64, 768, 24),
                                       (16, 1536, 48)) for b in (6, 12, 8, 16)]


def times(fn, reps, by_name=None):
    """(event ms, device ms) per call; `by_name` collects device ms per call
    by kernel name."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += e.time_range.end - e.time_range.start
            if by_name is not None:
                found = re.search(r"\w*kernel\w*", e.name)
                name = found.group(0) if found else e.name[:40]
                by_name[name] = round(by_name.get(name, 0.0)
                                      + (e.time_range.end - e.time_range.start) / 1e3 / reps, 4)
    return round(start.elapsed_time(end) / reps, 4), round(dev_us / 1e3 / reps, 4)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-every", type=int, nargs="+", default=[scan_cuda.SAVE_EVERY])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    dev = select_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    K, N = 4, 16
    for B, L, D, R in SHAPES:
        def rnd(*s, scale=1.0, shift=0.0):
            return torch.randn(*s, device=dev, generator=gen) * scale + shift

        t = [rnd(B, K, L, D), rnd(B, K, L, R, scale=0.5),
             -torch.arange(1.0, N + 1, device=dev).expand(K, D, N).contiguous(),
             rnd(B, K, L, N), rnd(B, K, L, N), rnd(K, D, scale=0.1, shift=1.0),
             rnd(K, D, shift=-4.0), rnd(K, D, R, scale=R ** -0.5)]
        dy = rnd(B, K, L, D)
        line = {"shape": [B, L, D, R]}

        def measure(tag, chunk, names=False):
            kw = dict(chunk=chunk)
            line[tag + "_fwd"] = times(
                lambda: scan_cuda.selective_scan_fwd(*t[:7], True, t[7], **kw), args.reps)
            line[tag + "_fwd_save"] = times(
                lambda: scan_cuda.selective_scan_fwd(*t[:7], True, t[7], save_states=True, **kw),
                args.reps)
            if B in (6, 12):
                _, hsave = scan_cuda.selective_scan_fwd(*t[:7], True, t[7], save_states=True,
                                                        **kw)
                by_name = {} if names else None
                line[tag + "_bwd"] = times(
                    lambda: scan_cuda.selective_scan_bwd(*t, hsave, dy, True, **kw), args.reps,
                    by_name)
                if names:
                    line[tag + "_bwd_kernels"] = by_name

        with torch.no_grad():
            for save_every in args.save_every:
                scan_cuda.SAVE_EVERY = save_every
                picks = [scan_cuda._pick_chunk(None, B, K, L, D, dev, w)
                         for w in (scan_cuda.FWD_WARPS_PER_SM, scan_cuda.BWD_WARPS_PER_SM)]
                line["picked_chunk_fwd_bwd"] = picks
                chunks = sorted({c for c in (64, 128, 256, 512) if c < L} | {*picks, max(L, 16)})
                for chunk in chunks:
                    measure(f"s{save_every}_c{chunk}", chunk, names=chunk == picks[1])
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
