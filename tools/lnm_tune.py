#!/usr/bin/env python3
"""Time the LN-mean forward (`fusionmamba_torch/csrc/ln_mean_fwd.cu`) at every
training and serving shape of the full config with other cluster sizes than
its plan's, on one NVIDIA GPU.

    python3 tools/lnm_tune.py

For each shape and cluster size (1, 2, 4, 8, 11, 13 and 16 blocks a batch row,
and the plan's, where the batch row has chunks enough) one JSON line: the
device time a call (torch.profiler), the time a call by CUDA events over
back-to-back launches, the share of the bytes bound, and whether the result
agrees with the plain version to 1e-4 + 1e-4 |plain| and repeats bit for
bit; and where the plan takes a cluster, the device time of one chunk of
rows a batch row in a block alone (the plan's work a block without the step
across the cluster). Then the card's name and power limit, and the fastest
cluster size of each shape beside the plan's. First, as the floor of any launch, the device
time of a one-element fill.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (HBM_BYTES_PER_S, bytes_and_ops, cuda_ms, device_ms,  # noqa: E402
                        main_path_calls, train_calls)
from fusionmamba_torch.config import full_config  # noqa: E402
from fusionmamba_torch.ops import cuda_lib, layer_norm  # noqa: E402

CLUSTERS = (1, 2, 4, 8, 11, 13, 16)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lnm_tune: needs a CUDA device")
    dev = torch.device("cuda")
    sms = cuda_lib.sm_count(dev)
    cuda_lib.lib()
    train = train_calls(full_config(), 6, 256)["ln_mean"]
    serve = main_path_calls(full_config(), 8, 256)["ln_mean"]
    shapes = {**{s: ("train", n) for s, n in train.items()},
              **{s: ("serve", n) for s, n in serve.items()}}
    gen = torch.Generator(device=dev).manual_seed(0)
    one = torch.zeros(1, device=dev)
    # the least device time of any launch: a one-element fill
    print(json.dumps({"one_element_fill_device_ms": device_ms(lambda: one.fill_(1.0), reps=10)}),
          flush=True)
    best = {}
    for shape, (path, n) in sorted(shapes.items()):
        B, rows, C = shape
        x = torch.randn(B, rows, C, device=dev, generator=gen) * 2.0 + 0.5
        s, b = (torch.randn(C, device=dev, generator=gen) for _ in range(2))
        want = layer_norm.ln_spatial_mean_plain(x, s, b, 1e-5)
        plan = layer_norm.lnm_fwd_plan(B, rows, C, sms)
        chunks = math.ceil(rows / (plan.groups * plan.unroll))
        bound = 1e3 * bytes_and_ops("ln_mean", shape)[0] / HBM_BYTES_PER_S
        for cluster in sorted({c for c in CLUSTERS if c <= chunks} | {plan.cluster}):
            p = plan._replace(cluster=cluster)

            def run(p=p):
                return layer_norm.ln_spatial_mean_fwd(x, s, b, 1e-5, p)

            got = run()
            same = torch.equal(got, run())
            ok = bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
            dev_ms = device_ms(run, reps=10)
            line = {"shape": list(shape), "path": path, "calls": n, "cluster": cluster,
                    "plan": cluster == plan.cluster, "device_ms": dev_ms,
                    "event_ms": cuda_ms(run, 50), "bound_ms": bound,
                    "bound_share": bound / dev_ms if dev_ms else None,
                    "agrees": ok, "bit_identical_twice": same}
            print(json.dumps(line), flush=True)
            if dev_ms and (shape not in best or dev_ms < best[shape][1]):
                best[shape] = (cluster, dev_ms)
        if plan.cluster > 1:
            # one chunk a batch row in one block: a block's work under the
            # plan without the step across the cluster
            one = x[:, :plan.groups * plan.unroll].contiguous()
            alone = layer_norm.lnm_fwd_plan(B, one.shape[1], C, sms)
            print(json.dumps({"shape": list(shape), "one_chunk_alone": list(one.shape),
                              "cluster": alone.cluster,
                              "device_ms": device_ms(lambda: layer_norm.ln_spatial_mean_fwd(
                                  one, s, b, 1e-5, alone), reps=10)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"fastest": {str(k): {"cluster": c, "device_ms": t,
                                           "plan": layer_norm.lnm_fwd_plan(*k, sms).cluster}
                                  for k, (c, t) in best.items()}}), flush=True)


if __name__ == "__main__":
    main()
