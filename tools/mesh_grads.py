#!/usr/bin/env python3
"""Compares the gradients of full-width training steps on one rank and on
two-rank meshes, on one GPU.

    python3 tools/mesh_grads.py [--steps 3]

Runs `--steps` fusion training steps (full config, batch 6 of 256^2, the
synthetic pairs the training CLI makes, DropPath on, seed 0) in processes of
their own: one rank alone, two independent one-rank processes at once,
`--mesh 2,1` and `--mesh 1,2` (two gloo ranks sharing the card). After each
step it gathers the whole gradient; then it prints each run's losses and,
for each pair of runs and each step, the gradients' difference over the
one-rank gradient's norm (all parameters together) and the parameters whose
own relative difference is largest. It also prints how the scan kernel cuts
L at the first stage's shape under each run, which sets part of the
rounding. The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

PAIRS, SIZE = 6, 256


def _worker(rank, world, port, mesh_shape, steps, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from fusionmamba_torch import train
    from fusionmamba_torch.config import full_config
    from fusionmamba_torch.data import SyntheticFusionDataset, batch_iterator
    from fusionmamba_torch.device import select_device
    from fusionmamba_torch.models import VSSMFusion
    from fusionmamba_torch.nn import init_weights
    from fusionmamba_torch.parallel import (apply_tensor_parallel, gather_state_dict,
                                            init_distributed, make_mesh, rank_rows, set_mesh)

    info = init_distributed(select_device("cuda"))
    mesh = make_mesh(*mesh_shape)
    net = init_weights(VSSMFusion(full_config()), seed=0)
    apply_tensor_parallel(net, mesh)
    net.to(info.device)
    opt = train.make_fusion_optimizer(net.parameters())
    train.set_learning_rate(opt, train.reference_fusion_lr(1))
    gen = torch.Generator(device=info.device).manual_seed(0)
    ds = SyntheticFusionDataset(length=PAIRS * steps, size=(SIZE, SIZE))
    rows = rank_rows(PAIRS, mesh) if mesh.data.size > 1 else slice(None)
    losses, grads = [], []
    with set_mesh(mesh):
        for vis, ir in batch_iterator(ds, PAIRS, shuffle=True, seed=1):
            m = train.fusion_train_step(net, opt, torch.from_numpy(vis[rows]).to(info.device),
                                        torch.from_numpy(ir[rows]).to(info.device), gen, mesh)
            losses.append(float(m["loss_total"]))
            g = gather_state_dict(net, mesh, {n: p.grad for n, p in net.named_parameters()})
            grads.append({k: None if v is None else v.cpu() for k, v in g.items()})
    if info.rank == 0:
        torch.save({"losses": losses, "grads": grads}, out)
    if info.created:
        torch.distributed.destroy_process_group()


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(jobs):
    """jobs: (world, mesh_shape, steps, out) started together, each rank a
    process of its own."""
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for world, mesh_shape, steps, out in jobs:
        port = _port()
        procs += [ctx.Process(target=_worker, args=(r, world, port, mesh_shape, steps, out))
                  for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(900)
    if any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"a rank failed: {[p.exitcode for p in procs]}")
    return [torch.load(out, weights_only=False) for *_, out in jobs]


def _compare(a, b):
    """Per step: |b - a| / |a| over all parameters, and the three worst
    parameters by their own relative difference."""
    out = []
    for ga, gb in zip(a["grads"], b["grads"]):
        diff2 = norm2 = 0.0
        per = []
        for k, w in ga.items():
            g = gb[k]
            if w is None or g is None:
                if (w is None) != (g is None):
                    per.append((float("inf"), k))
                continue
            d, n = float((g - w).norm()), float(w.norm())
            diff2, norm2 = diff2 + d * d, norm2 + n * n
            per.append((d / (n + 1e-30), k))
        per.sort(reverse=True)
        out.append({"total_rel": (diff2 / norm2) ** 0.5, "worst": per[:3]})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    from fusionmamba_torch.ops import cuda_lib, scan_cuda

    cuda_lib.build()           # before any rank starts
    dev = torch.device("cuda")
    for name, (B, D) in {"one rank": (12, 192), "2,1": (6, 192), "1,2": (12, 96)}.items():
        for kind, warps in (("forward", scan_cuda.FWD_WARPS_PER_SM),
                            ("backward", scan_cuda.BWD_WARPS_PER_SM)):
            chunk = scan_cuda._pick_chunk(None, B, 4, 1024, D, dev, warps)
            print(json.dumps({"scan_first_stage": name, "shape": [B, 4, 1024, D], "pass": kind,
                              "chunk": chunk, "chunks": -(-1024 // chunk)}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name + ".pt")
        one, = _launch([(1, (1, 1), args.steps, path("one"))])
        pair = _launch([(1, (1, 1), args.steps, path("pair0")),
                        (1, (1, 1), args.steps, path("pair1"))])
        ddp, = _launch([(2, (2, 1), args.steps, path("ddp"))])
        tp, = _launch([(2, (1, 2), args.steps, path("tp"))])
    runs = {"one": one, "pair0": pair[0], "pair1": pair[1], "2,1": ddp, "1,2": tp}
    for name, r in runs.items():
        print(json.dumps({"run": name, "losses": r["losses"]}), flush=True)
    for a, b in (("one", "pair0"), ("one", "pair1"), ("one", "2,1"), ("one", "1,2"),
                 ("2,1", "1,2")):
        print(json.dumps({"against": a, "run": b, "steps": _compare(runs[a], runs[b])}),
              flush=True)


if __name__ == "__main__":
    main()
