#!/usr/bin/env python3
"""Steady-state rate of the MLP forward's wgmma product (3xTF32) on one GPU.

    python3 tools/mlp_gemm_rate.py

Runs the two-pass forward of `fusionmamba_torch.ops.mlp` at square shapes
large enough that every 128x128 tile has a long K loop and the card holds
many waves, so neither the pipeline's fill nor the last wave's tail weigh:
the rate is the engine's own. Device time per pass comes from the profiler.
Beside it, one cuBLAS product of the same fc1 in fp32 and in single TF32
(`allow_tf32`), as yardsticks the port never calls. Rates are of fp32 work
(2 M N K per product) except where marked TF32.
"""
from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.profiler import ProfilerActivity, profile

from fusionmamba_torch.device import select_device
from fusionmamba_torch.ops import mlp


def event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    dev = select_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    for M, C, H in [(4096, 4096, 4096), (8192, 1024, 4096)]:
        x = torch.randn(M, C, device=dev, generator=gen)
        w1 = 0.02 * torch.randn(H, C, device=dev, generator=gen)
        w2 = 0.02 * torch.randn(C, H, device=dev, generator=gen)
        b1, b2 = torch.zeros(H, device=dev), torch.zeros(C, device=dev)
        with torch.no_grad():
            for _ in range(2):
                mlp.mlp_fwd(x, w1, b1, w2, b2, fused=False)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    mlp.mlp_fwd(x, w1, b1, w2, b2, fused=False)
                torch.cuda.synchronize()
        flop = 2 * M * C * H
        passes = {("fc1" if "<true>" in e.key else "fc2"): e.device_time_total / e.count
                  for e in prof.key_averages() if "mlp_fwd_linear_kernel" in e.key}
        line = [f"(M, C, H) = {(M, C, H)}"]
        line += [f"{k} {us:.1f} us, {flop / us / 1e6:.1f} TFLOP/s" for k, us in sorted(passes.items())]
        fp32 = event_ms(lambda: x @ w1.t())
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = event_ms(lambda: x @ w1.t())
        torch.backends.cuda.matmul.allow_tf32 = False
        line.append(f"cuBLAS fc1 fp32 {flop / fp32 / 1e9:.1f} TFLOP/s, "
                    f"single TF32 {flop / tf32 / 1e9:.1f} TFLOP/s TF32")
        print(" | ".join(line), flush=True)


if __name__ == "__main__":
    main()
