#!/usr/bin/env python3
"""Time the dwconv backward (`fusionmamba_torch/csrc/dwconv3x3_bwd.cu`) and
the LN-mean backward (`csrc/layer_norm_bwd.cu`) at every training shape of
the full config under other layouts than their plans', on one NVIDIA GPU.

    python3 tools/bwd_tune.py

dwconv: for each shape and tiling (tile columns tw with the channels that
keep 128 threads a block, tile rows th, the grid sized for 2, 3 or 4 blocks
an SM) one JSON line: the device time a call (torch.profiler) of the tile
kernel and of the reduce, the share of the bytes bound, and whether dx equals
the plan's bit for bit and dw, dbias agree with it to 1e-4 of their largest
entry. LN-mean: the same for the plan's template with 1, 2 and 4 blocks an
SM. Then the card's name and power limit, and the fastest layout of each
shape beside the plan's.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import HBM_BYTES_PER_S, train_calls  # noqa: E402
from fusionmamba_torch.config import full_config  # noqa: E402
from fusionmamba_torch.ops import cuda_lib, dwconv, layer_norm  # noqa: E402


def device_split(fn, reps: int = 10, tries: int = 5):
    """Device ms a call of fn by kernel: {"tiles" or "rows": ms, "reduce": ms}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = collections.Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = "reduce" if "reduce" in e.name else "main"
                out[key] += (e.time_range.end - e.time_range.start) / 1e3 / reps
        if out:
            return dict(out)
    return {}


def dw_tilings(B, H, W, C, sms):
    """BwdPlans with every (tw, th, blocks an SM) the kernel takes here."""
    for tw in (8, 16):
        cq = min(16, dwconv.BWD_MAX_THREADS // tw, dwconv._pow2_at_least(-(-C // 4)))
        c_blocks = -(-C // (4 * cq))
        for th in (1, 2, 4, 8, 16):
            tile = (th + 4) * (tw + 4) + (th + 2) * (tw + 2)
            smem = 16 * cq * max(tile, 10 * tw)
            if smem > dwconv.BWD_MAX_SMEM:
                continue
            tiles = B * -(-H // th) * -(-W // tw)
            for per_sm in (2, 3, 4):
                most = max(1, per_sm * sms // c_blocks)
                per_block = -(-tiles // most)
                yield (tw, th, per_sm), dwconv.BwdPlan(
                    cq, tw, th, (c_blocks, -(-tiles // per_block)), cq * tw, smem, tiles)


def close(got, want):
    return all(bool(((g - r).abs() <= 1e-4 * r.abs().max()).all())
               for g, r in zip(got, want) if g is not None)


def tune_dwconv(dev, sms, gen, best):
    for shape, n in sorted(train_calls(full_config(), 6, 256)["dwconv_bwd"].items()):
        B, H, W, C = shape
        x, dy = (torch.randn(*shape, device=dev, generator=gen) for _ in range(2))
        w = torch.randn(3, 3, C, device=dev, generator=gen) / 3
        b = torch.randn(C, device=dev, generator=gen) / 3
        bound = 1e3 * 4 * (3 * x.numel() + 20 * C) / HBM_BYTES_PER_S
        plan = dwconv.bwd_plan(*shape, sms=sms)
        want = dwconv.dwconv_bwd(x, w, b, dy, "silu", plan)
        rows = []
        for key, cand in [(("plan",), plan)] + list(dw_tilings(*shape, sms)):
            got = dwconv.dwconv_bwd(x, w, b, dy, "silu", cand)
            split = device_split(lambda: dwconv.dwconv_bwd(x, w, b, dy, "silu", cand))
            ms = sum(split.values()) or None
            rows.append((ms or float("inf"), key))
            print(json.dumps({"kernel": "dwconv_bwd", "shape": list(shape), "calls_per_step": n,
                              "tiling": list(key), "plan": cand._asdict(), "device_ms": ms,
                              "tiles_ms": split.get("main"), "reduce_ms": split.get("reduce"),
                              "bound_ms": bound, "share": bound / ms if ms else None,
                              "dx_bit_equal": bool(torch.equal(got[0], want[0])),
                              "dw_db_close": close(got[1:], want[1:])}), flush=True)
        top = min(rows)
        best["dwconv_bwd " + str(shape)] = {
            "calls_per_step": n, "plan": list(plan[:3]), "plan_ms": rows[0][0],
            "best": list(top[1]), "best_ms": top[0], "bound_ms": bound}
        del x, dy, want
        torch.cuda.empty_cache()


def tune_ln_mean(dev, sms, gen, best):
    for shape, n in sorted(train_calls(full_config(), 6, 256)["ln_mean_bwd"].items()):
        B, rows_, C = shape
        x = torch.randn(*shape, device=dev, generator=gen) * 2 + 0.5
        s, dm = torch.randn(C, device=dev, generator=gen), torch.randn(B, C, device=dev,
                                                                        generator=gen)
        bound = 1e3 * 4 * (2 * x.numel() + B * C + 3 * C) / HBM_BYTES_PER_S
        plan = layer_norm.lnm_bwd_plan(*shape, sms)
        rows = []
        for per_sm in ("plan", 1, 2, 4):
            cand = plan if per_sm == "plan" else plan._replace(
                blocks=max(1, min(-(-rows_ // plan.rows_per_step), per_sm * sms // B)))
            split = device_split(lambda: layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5, cand))
            ms = sum(split.values()) or None
            rows.append((ms or float("inf"), str(per_sm)))
            print(json.dumps({"kernel": "ln_mean_bwd", "shape": list(shape), "calls_per_step": n,
                              "blocks_per_sm": per_sm, "plan": cand._asdict(), "device_ms": ms,
                              "rows_ms": split.get("main"), "reduce_ms": split.get("reduce"),
                              "bound_ms": bound, "share": bound / ms if ms else None}),
                  flush=True)
        top = min(rows)
        best["ln_mean_bwd " + str(shape)] = {
            "calls_per_step": n, "plan_blocks": plan.blocks, "plan_ms": rows[0][0],
            "best": top[1], "best_ms": top[0], "bound_ms": bound}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/bwd_tune.py: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sms = cuda_lib.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    best = {}
    tune_ln_mean(dev, sms, gen, best)
    tune_dwconv(dev, sms, gen, best)
    print(smi)
    print(json.dumps({"best": best}))


if __name__ == "__main__":
    main()
