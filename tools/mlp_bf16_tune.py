#!/usr/bin/env python3
"""The bf16 MLP kernels' plan against its alternatives, on one GPU.

    python3 tools/mlp_bf16_tune.py

At every MLP shape of a fusion training step (full config, 6 pairs of 256^2,
`chip_smoke.train_calls`), with seeded bf16 inputs, the device time
(torch.profiler, warm L2) of:
  - the forward as `ops/mlp.py`'s plan takes it (`bf16_fused`), the fused
    design (where C <= 192) and the two passes, the two passes with fc2's
    depth uncut, and each launch's share (product kernel, fused kernel,
    reduce);
  - the backward with the plan's depth slices (`bf16_bwd_plan`), with every
    depth uncut, and each launch's share;
  - one PyTorch call of the same forward (F.linear, GELU, F.linear in bf16),
    a yardstick the port never calls;
  - the host's enqueue time a call (20 calls without a synchronisation) of
    the bf16 and the fp32 wrappers, forward (two passes) and backward: the
    bf16 entries encode their TMA tensor maps on every call.
One JSON line a shape, then the sums over a step, the card's name and power
limit on each line. Every output is held against the plain version. Then
the product kernel's steady rate: the two-pass forward at shapes large
enough that every tile has a long depth loop and the card holds many
waves (TFLOP/s of 4 M C H a forward), beside one cuBLAS bf16 product of
the same fc1 (a yardstick the port never calls).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from chip_smoke import train_calls
from fusionmamba_torch.config import full_config
from fusionmamba_torch.device import select_device
from fusionmamba_torch.ops import cuda_lib, mlp


def by_kernel(fn, reps: int = 3):
    """Device ms a call of `fn`, in all and by kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].split()[-1]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return sum(out.values()), out


def enqueue_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def close(got, want) -> bool:
    g, w = got.float(), want.float()
    return bool(torch.all((g - w).abs() <= 8e-3 * w.abs() + 8e-3 * float(w.abs().max())))


def main() -> None:
    dev = select_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cuda_lib.build()
    sms = cuda_lib.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    plan_fwd, plan_bwd = mlp.bf16_fwd_plan, mlp.bf16_bwd_plan
    step = {}
    for (M, C, H), n in sorted(train_calls(full_config(), 6, 256)["mlp"].items()):
        x = torch.randn(M, C, device=dev, generator=gen).bfloat16()
        w1 = (torch.randn(H, C, device=dev, generator=gen) * C ** -0.5).bfloat16()
        b1 = (torch.randn(H, device=dev, generator=gen) * 0.1).bfloat16()
        w2 = (torch.randn(C, H, device=dev, generator=gen) * H ** -0.5).bfloat16()
        b2 = (torch.randn(C, device=dev, generator=gen) * 0.1).bfloat16()
        dy = torch.randn(M, C, device=dev, generator=gen).bfloat16()
        line = {"shape": [M, C, H], "calls_per_step": n, "plan": mlp.bf16_plan(M, C, H, C, sms)}
        want = mlp.fused_mlp_plain(x, w1.t(), b1, w2.t(), b2)
        want_g = mlp.mlp_bwd_plain(x, w1.t(), b1, w2.t(), b2, dy)
        ok = True
        with torch.no_grad():
            designs = {"plan": mlp.bf16_fused(M, C, C, sms), "two_pass": False}
            if C <= mlp.BF16_FUSED_MAX_WIDTH:
                designs["fused"] = True
            for name, fused in designs.items():
                run = lambda fused=fused: mlp.mlp_fwd(x, w1, b1, w2, b2, fused=fused)
                ok &= close(run(), want)
                line[f"fwd_{name}_ms"], line[f"fwd_{name}_by_kernel"] = by_kernel(run)
            mlp.bf16_fwd_plan = lambda M_, H_, C_, s_: H_
            run = lambda: mlp.mlp_fwd(x, w1, b1, w2, b2, fused=False)
            ok &= close(run(), want)
            line["fwd_two_pass_uncut_ms"] = by_kernel(run)[0]
            mlp.bf16_fwd_plan = plan_fwd
            line["fwd_library_ms"] = by_kernel(
                lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2))[0]
            for name in ("plan", "uncut"):
                if name == "uncut":
                    mlp.bf16_bwd_plan = lambda M_, C_, H_, Co, s_: (H_, M_)
                run = lambda: mlp.mlp_bwd(x, w1.t(), b1, w2.t(), b2, dy)
                ok &= all(close(g, w) for g, w in zip(run(), want_g))
                line[f"bwd_{name}_ms"], by = by_kernel(run)
                if name == "plan":
                    line["bwd_plan_by_kernel"] = by
                mlp.bf16_bwd_plan = plan_bwd
            f32 = [t.float() for t in (x, w1, b1, w2, b2, dy)]
            for io, (xx, a, bb1, c, bb2, d) in (("bf16", (x, w1, b1, w2, b2, dy)), ("fp32", f32)):
                line[f"fwd_enqueue_ms_{io}"] = enqueue_ms(
                    lambda: mlp.mlp_fwd(xx, a, bb1, c, bb2, fused=False))
                line[f"bwd_enqueue_ms_{io}"] = enqueue_ms(
                    lambda: mlp.mlp_bwd(xx, a.t(), bb1, c.t(), bb2, d))
        line["ok"], line["card"] = ok, smi
        print(json.dumps(line), flush=True)
        for k, v in line.items():
            if k.endswith("_ms"):
                step[k] = step.get(k, 0.0) + n * v
        if not ok:
            sys.exit(f"mlp bf16 at {(M, C, H)} disagrees with its plain version")
    print(json.dumps({"per_step": step, "card": smi}), flush=True)
    for M, C, H in [(8192, 1024, 4096), (8192, 4096, 4096)]:
        x = torch.randn(M, C, device=dev, generator=gen).bfloat16()
        w1 = (torch.randn(H, C, device=dev, generator=gen) * C ** -0.5).bfloat16()
        w2 = (torch.randn(C, H, device=dev, generator=gen) * H ** -0.5).bfloat16()
        b1, b2 = (torch.zeros(n, device=dev, dtype=torch.bfloat16) for n in (H, C))
        with torch.no_grad():
            ms = by_kernel(lambda: mlp.mlp_fwd(x, w1, b1, w2, b2, fused=False))[0]
            fc1 = by_kernel(lambda: x @ w1.t())[0]
        print(json.dumps({"rate_shape": [M, C, H], "two_pass_ms": ms,
                          "two_pass_tflops": 4 * M * C * H / ms / 1e9,
                          "cublas_fc1_tflops": 2 * M * C * H / fc1 / 1e9, "card": smi}),
              flush=True)


if __name__ == "__main__":
    main()
