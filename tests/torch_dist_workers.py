"""Spawned gloo ranks for the port's multi-process tests (imported by the
tests and by the ranks; it imports nothing of JAX, so a rank starts fast).

`spawn(fn, world, tmp_path, *args)` starts `world` processes (the spawn
method), each joining a gloo group through a FileStore under `tmp_path` (no
port to collide between test workers), runs `fn(*args)` and saves what it
returns; the parent joins them with a timeout and returns the results in
rank order. The `*_case` functions run on a rank, or in the test process
itself as the single-process reference.
"""
from __future__ import annotations

import collections
import contextlib
import multiprocessing
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 120


def _entry(fn, rank, world, store_path, out_path, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world)
        result = fn(*args)
        torch.save({"ok": True, "result": result}, out_path)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out_path)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args) -> list:
    ctx = multiprocessing.get_context("spawn")
    store, outs = os.path.join(tmp_path, "store"), [os.path.join(tmp_path, f"rank{r}.pt")
                                                    for r in range(world)]
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks still running after {JOIN_TIMEOUT_S} s"
    results = []
    for r, path in enumerate(outs):
        got = torch.load(path, weights_only=False) if os.path.exists(path) else None
        assert got is not None and got["ok"], f"rank {r}: {got and got['error']}"
        results.append(got["result"])
    return results


@contextlib.contextmanager
def count_plain_calls():
    """Count the plain versions' calls by shape inside the block, keyed as
    `chip_smoke.main_path_calls` keys the kernels' launches: on the CPU each
    op runs its plain version once where the card launches its kernel once.
    Yields {op: Counter(shape -> calls)}."""
    from fusionmamba_torch.nn import layers
    from fusionmamba_torch.ops import dwconv, layer_norm, mlp
    from fusionmamba_torch.ops import selective_scan as scan_mod

    counts = {k: collections.Counter() for k in
              ("scan", "layer_norm", "ln_mean", "dwconv", "mlp")}
    saved = []

    def patch(module, name, kernel, key):
        orig = getattr(module, name)
        saved.append((module, name, orig))

        def counted(*args, **kwargs):
            counts[kernel][key(*args, **kwargs)] += 1
            return orig(*args, **kwargs)
        setattr(module, name, counted)

    # the LN is counted at the layers' op: the LN-mean's plain version calls
    # the LN's plain version
    patch(layers, "layer_norm_fused", "layer_norm",
          lambda x, scale, bias, gate=None, eps=1e-6, gate_act="none": (
              x.numel() // x.shape[-1], x.shape[-1], gate_act if gate is not None else "none"))
    patch(layer_norm, "ln_spatial_mean_plain", "ln_mean",
          lambda x, *a, **k: (x.shape[0], x.numel() // (x.shape[0] * x.shape[-1]),
                              x.shape[-1]))
    patch(dwconv, "depthwise_conv3x3_plain", "dwconv", lambda x, *a, **k: tuple(x.shape))
    patch(mlp, "fused_mlp_plain", "mlp",
          lambda x, w1, *a: (x.numel() // x.shape[-1], x.shape[-1], w1.shape[1]))
    patch(scan_mod, "selective_scan_plain", "scan",
          lambda u, delta, A, Bm, Cm, D=None, bias=None, sp=False, w=None: (
              *u.shape, 0 if w is None else w.shape[-1]))
    try:
        yield counts
    finally:
        for module, name, orig in reversed(saved):
            setattr(module, name, orig)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def sp_scan_case(n_model: int, inputs: dict, cot: np.ndarray) -> dict:
    """The sequence-parallel scan over a (world // n_model, n_model) mesh
    (L split n_model ways): y and the gradients of sum(y * cot) w.r.t. u,
    delta, A, B, C, D and the bias."""
    from fusionmamba_torch.parallel import make_mesh, selective_scan_seq_parallel

    mesh = make_mesh(None, n_model)
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inputs.items()}
    y = selective_scan_seq_parallel(t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"],
                                    t["bias"], delta_softplus=True, mesh=mesh)
    (y * torch.from_numpy(cot)).sum().backward()
    return {"y": y.detach().numpy(), **{k: v.grad.numpy() for k, v in t.items()}}


def train_case(cfg_kwargs: dict, mesh_shape, batches, steps: int) -> dict:
    """`steps` fusion steps of VSSMFusion(test_config(**cfg_kwargs)) from
    seed-0 weights on the global `batches` (numpy (vis, ir) pairs), DropPath
    drawn from a generator seeded 0, over a mesh of `mesh_shape` (each data
    rank its rows; the model tensor-parallel over the model axis). Returns
    the losses, the first step's gradients and the final state dict, both
    gathered whole, how many parameters were sharded, and each op's calls
    by shape over the steps (`count_plain_calls`)."""
    from fusionmamba_torch import train
    from fusionmamba_torch.config import test_config
    from fusionmamba_torch.models import VSSMFusion
    from fusionmamba_torch.nn import init_weights
    from fusionmamba_torch.parallel import (apply_tensor_parallel, gather_state_dict,
                                            make_mesh, rank_rows, set_mesh)

    mesh = make_mesh(*mesh_shape)
    net = init_weights(VSSMFusion(test_config(**cfg_kwargs)), seed=0)
    sharded = apply_tensor_parallel(net, mesh)
    opt = train.make_fusion_optimizer(net.parameters())
    gen = torch.Generator().manual_seed(0)
    losses, grads = [], None
    with set_mesh(mesh), count_plain_calls() as counts:
        for vis, ir in batches[:steps]:
            rows = rank_rows(vis.shape[0], mesh)
            m = train.fusion_train_step(net, opt, torch.from_numpy(vis[rows]),
                                        torch.from_numpy(ir[rows]), gen, mesh)
            losses.append(float(m["loss_total"]))
            if grads is None:
                grads = gather_state_dict(net, mesh, {n: p.grad for n, p in
                                                      net.named_parameters()})
    return {"losses": losses, "grads": grads, "state": gather_state_dict(net, mesh),
            "sharded": sharded, "calls": counts}


def cli_case(argv) -> dict:
    from fusionmamba_torch import train

    return train.main(argv)
