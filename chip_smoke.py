#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line per result; any failure exits non-zero:
  1. device  - the card, its power limit; fp32 numerics pinned (no TF32).
  2. build   - builds the CUDA kernels from `fusionmamba_torch/csrc`, with
               nvcc's register and shared-memory report.
  3. kernel  - each of the five forward kernels against its plain PyTorch
               version at every shape of the serving path (full config, 8
               pairs of 256^2; the encoder runs both modalities as 16): max
               abs error and its tolerance, kernel, plain and library times
               (CUDA events, warm L2), the profiler's device time of the
               kernel (and of the library call where there is one), and the
               bound: the largest of bytes, fp32 operations and, for the
               scans, special-function calls, with its share of the device
               time. The scan, the MLP, the dwconv and the LN-mean must repeat
               themselves bit for bit. The LN's library call (F.layer_norm) computes the
               same function only where there is no gate: it is timed there
               alone, with the kernel's times at those shapes beside it.
  4. kernel_train - the training path's shapes (6 pairs; the encoder runs 12),
               then the segmentation steps' (2 and 4 pairs; a shape checked
               at an earlier batch is not checked again, only summed):
               each forward kernel as in 3, and each of the five backward
               kernels against the autograd of its plain version: every
               input's gradient, its error against the stated bound, two
               launches bit-identical, times of the backward alone (kernel,
               plain autograd, library autograd), its bound and the bound's
               share of the kernel's device time. The MLP's
               bounds are reckoned at the tensor cores' 3xTF32 rate, with
               the fp32 CUDA-core bound beside them, and its forward must
               repeat itself bit for bit. A `kernel_train_step` line per batch
               sums each kernel's times over a step.
     mlp_paths - both designs of the MLP forward (fused, two passes) at
               each training shape: error against the plain version, time.
     scan_paths - the scan kernels at every training and serving shape, and
               at the full-resolution scan's (L = H*W at each stage's width,
               batch 12), with L cut as the wrapper cuts it and, where that
               is several chunks, as one chunk: forward against the plain
               version, the two backwards against each other, times.
     fullres_ss2d - one SS2D(96, scan_variant="fullres") at 64^2 (L = 4096),
               batch 2, on the card against the same module on the CPU: the
               output and every parameter's gradient.
  5. main_path - `python -m fusionmamba_torch.infer --model full --size 256
               --batch 8` on 20 synthetic pairs (three batches, the last one
               padded), twice: the outputs must be identical 256x256 uint8
               images, and the launch counters, zeroed just before the first
               run, must equal the calls derived from the config. Reports
               pairs/s over the whole warm run and the time of each batch's
               forward with its copies.
     evaluate - `python -m fusionmamba_torch.evaluate_fusion` on the first
               run's outputs against its inputs, with the outputs as their own
               reference: every metric finite, SSIM against the reference 1.
  6. parity  - one seeded pair through the model on the card (kernels) and on
               the CPU (plain versions).
  7. train   - `python -m fusionmamba_torch.train --model full -B 6 -E 1
               --synthetic 72 -j 0`: 12 training steps at 256^2, the batches
               made in the loop. Every loss finite, the ten launch counters
               (zeroed just before) equal to 12 times the config's calls per
               step, the saved state dict loads strictly; step seconds and
               pairs/s.
     train_disk - the same CLI on a PST900-layout folder of 24 pairs at
               1280x720 written from a seed (`--dataset pst900 -j 8`, under
               FUSIONMAMBA_DATA_ROOT): 4 steps through the threaded loader and
               the device prefetch, the launch counters equal to 4 times the
               config's, every loss finite; step seconds, pairs/s and the
               host's wait for the loader a step.
     train_seg - `python -m fusionmamba_torch.train_segmentation --model full`
               on the same folder (written once, with a test split of 6
               pairs): PST900 in mode both, batch 2, 12 steps through `-j 8`
               and one evaluation (3 forwards); then 4 steps of synthetic
               MFNet-class pairs at batch 4 in the default mode, `-j 0`, and
               one evaluation forward. Each: the launch counters (zeroed just
               before) equal to steps x the config's calls a step plus the
               evaluation's forwards, every loss and score finite, both saved
               state dicts loading strictly; step seconds and pairs/s.
     evaluate_seg - `python -m fusionmamba_torch.evaluate_segmentation` of
               the PST900 checkpoint on the test split: every metric finite,
               the report written.
  8. train_parity - the same seeded weights and batches at the test config
               (64^2, batch 2), 5 steps on the card and on the CPU: each
               step's loss and every parameter's step-0 gradient.
     seg_parity - VSSMFusionSeg at the test config (64^2, batch 2) on the
               card and on the CPU from the same weights, batches and dropout
               masks: eval-mode logits and fusion output, then 3 steps of
               `seg_train_step` (mode both, improved loss): each loss, and
               the BatchNorm running statistics after them.
  9. trace   - torch.profiler over three warm forwards of a batch of 8: device
               time by kernel and the card's idle share of the window.
 10. trace_train - the same over three warm training steps of 6 pairs, with
               forward and backward kernels apart.
Then the card's name and power limit as nvidia-smi gives them, the kernels
line (all ten kernels, timed per training step; a kernel's device total sums
the shapes the profiler timed, `device_shapes_covered` of `shapes`), and the
result line.
Without a CUDA device it fails before any phase. It imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from fusionmamba_torch import evaluate_segmentation, infer, train, train_segmentation
from fusionmamba_torch.checkpoints import load_reference_checkpoint
from fusionmamba_torch.config import full_config, test_config
from fusionmamba_torch.data import SyntheticFusionDataset, batch_iterator
from fusionmamba_torch.device import select_device
from fusionmamba_torch.losses import compute_class_weights
from fusionmamba_torch.models import VSSMFusion, VSSMFusionSeg
from fusionmamba_torch.nn import SS2D, init_weights
from fusionmamba_torch.ops import cuda_lib, dwconv, layer_norm, ln_triton, mlp, scan_cuda
from fusionmamba_torch.ops.selective_scan import selective_scan, selective_scan_plain

PAIRS, SIZE, N_IMAGES = 8, 256, 20
TRAIN_PAIRS, TRAIN_STEPS = 6, 12   # the reference's batch; 72 synthetic pairs
# training from a PST900 folder: steps, PST900's image size (H, W), loader threads
DISK_STEPS, DISK_SIZE, DISK_WORKERS = 4, (720, 1280), 8
# segmentation: the batches of PST900 (`train_segmentation.py:128`) and of the
# other datasets (the CLI's default); the PST900 run's 12 steps go over the
# same 24 training pairs as train_disk, its evaluation over 6 test pairs
SEG_PAIRS, SEG_PST900_STEPS, SEG_TEST_PAIRS = (2, 4), 12, 6
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12          # H100 SXM TF32 tensor cores, dense
# exp, log and the reciprocal run on the special-function units: 16 results a
# clock an SM, at the card's top SM clock (set in main from nvidia-smi)
SFU_PER_CLOCK_PER_SM = 16
SFU_CALLS_PER_S = None
# empty profiler captures `device_ms` takes again before it gives up on a shape
DEVICE_MS_TRIES = 5
# the MLP kernels form every fp32 product as three TF32 products (3xTF32,
# fusionmamba_torch/csrc/mma_tf32x3.cuh): their bound is reckoned at a third
# of the TF32 rate, and each of their lines also gives the CUDA-core bound
TENSOR_CORE_KERNELS = ("mlp", "mlp_bwd")
# kernel vs plain version: the same fp32 arithmetic in another order (and
# with fused multiply-adds), so they differ by float32 rounding only; the
# MLP's 3xTF32 products keep fp32-class accuracy and stay inside it with
# 100x to spare (tests/test_torch_tf32x3.py)
KERNEL_RTOL = KERNEL_ATOL = 1e-4
# backward kernel vs autograd of the plain version: gradients that sum over
# up to ~50k rows or 1k steps (dW, dA, dB, dscale, ...) are sums of many
# terms of both signs in another order, so their rounding scales with the
# magnitude summed: each gradient tensor is held to 1e-4 of its own largest
# entry, plus 1e-4 relative
GRAD_RTOL = GRAD_SCALED_ATOL = 1e-4
# card vs CPU end to end: fp32 sums reordered through 34 blocks; 1e-3 is a
# quarter of one uint8 step of the [0, 1] output
PARITY_ATOL = 1e-3
# card vs CPU training: the loss gate of tests/test_optimizer_trajectory.py,
# and each step-0 gradient within 1e-3 of its norm (the whole network's
# forward and backward in another summation order)
TRAIN_LOSS_RTOL = TRAIN_GRAD_RTOL = 1e-3
# card vs CPU segmentation training: the BatchNorm running statistics after
# three steps (0.01 of three batch statistics each, over 64^2 positions)
SEG_BN_ATOL = 1e-4

OPS = ("scan", "layer_norm", "ln_mean", "dwconv", "mlp")
KERNELS = {
    "scan": ("cuda", "fusionmamba_torch/csrc/selective_scan_fwd.cu",
             "fusionmamba_tpu/ops/scan_pallas.py:912"),
    "scan_bwd": ("cuda", "fusionmamba_torch/csrc/selective_scan_bwd.cu",
                 "fusionmamba_tpu/ops/scan_pallas.py:1155"),
    "layer_norm": ("triton", "fusionmamba_torch/ops/ln_triton.py",
                   "fusionmamba_tpu/ops/ln_pallas.py:79"),
    "layer_norm_bwd": ("cuda", "fusionmamba_torch/csrc/layer_norm_bwd.cu",
                       "fusionmamba_tpu/ops/ln_pallas.py:89"),
    "ln_mean": ("cuda", "fusionmamba_torch/csrc/ln_mean_fwd.cu",
                "fusionmamba_tpu/ops/ln_pallas.py:220"),
    "ln_mean_bwd": ("cuda", "fusionmamba_torch/csrc/layer_norm_bwd.cu",
                    "fusionmamba_tpu/ops/ln_pallas.py:236"),
    "dwconv": ("cuda", "fusionmamba_torch/csrc/dwconv3x3_fwd.cu",
               "fusionmamba_tpu/ops/dwconv_pallas.py:76"),
    "dwconv_bwd": ("cuda", "fusionmamba_torch/csrc/dwconv3x3_bwd.cu",
                   "fusionmamba_tpu/ops/dwconv_pallas.py:90"),
    "mlp": ("cuda", "fusionmamba_torch/csrc/fused_mlp_fwd.cu",
            "fusionmamba_tpu/ops/mlp_pallas.py:104"),
    "mlp_bwd": ("cuda", "fusionmamba_torch/csrc/fused_mlp_bwd.cu",
                "fusionmamba_tpu/ops/mlp_pallas.py:112"),
}
# extra operations per element of the LN gate activations
_GATE_OPS = {"none": 0, "silu": 5, "silu_sum": 10}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main_path_calls(cfg, pairs: int, size: int, backward: bool = False):
    """op -> Counter(shape -> calls) for one forward of VSSMFusion(cfg) on
    `pairs` pairs of size x size or, with `backward`, for its backward: the
    same calls but those of the finest VSSBlockCross, whose output the
    decoder never reads (as in the reference), so no gradient runs through
    it. Shapes: scan (B, L, D, R) with K=4; layer_norm (rows, C, gate);
    ln_mean (B, rows, C); dwconv (B, H, W, C); mlp (M, C, hidden)."""
    calls = {k: collections.Counter() for k in OPS}
    g0, nl = size // cfg.patch_size, len(cfg.dims)

    def ln(rows, C, gate="none"):
        calls["layer_norm"][(rows, C, gate)] += 1

    def ssm(B, g, C, convs, gate):
        d = int(cfg.ssm_ratio * C)
        calls["dwconv"][(B, g, g, d)] += convs
        calls["scan"][(B, ((g + 1) // 2) ** 2, d, math.ceil(C / 16))] += 1
        ln(B * g * g, d, gate)

    def vss_block(B, g, C):
        ln(B * g * g, C)
        ssm(B, g, C, 1, "silu")
        calls["ln_mean"][(B, g * g, C)] += 2
        ln(B * g * g, C)
        calls["mlp"][(B * g * g, C, int(C * cfg.mlp_ratio))] += 1

    for _ in range(2):                                   # patch embeds
        ln(pairs * g0 * g0, cfg.dims[0])
    for i, C in enumerate(cfg.dims):                     # shared encoder, 2B
        g = g0 >> i
        for _ in range(cfg.depths[i]):
            vss_block(2 * pairs, g, C)
        if i < nl - 1:
            ln(2 * pairs * (g // 2) ** 2, 4 * C)
    for i, C in enumerate(cfg.dims):                     # cross blocks
        if backward and i == 0:
            continue
        g = g0 >> i
        ln(pairs * g * g, C)
        ln(pairs * g * g, C)
        ssm(pairs, g, C, 2, "silu_sum")
    for i, C in enumerate(cfg.dims_decoder):             # decoder
        g = g0 >> (nl - 1 - i)
        if i > 0:
            ln(pairs * g * g, C)
        for _ in range(cfg.depths_decoder[i]):
            vss_block(pairs, g, C)
    ln(pairs * (4 * g0) ** 2, cfg.dims_decoder[-1] // 4)  # final_up
    return calls


def train_calls(cfg, pairs: int, size: int):
    """kernel -> Counter(shape -> calls) for one training step, all ten
    kernels: the forward's calls and the backward's."""
    fwd, bwd = main_path_calls(cfg, pairs, size), main_path_calls(cfg, pairs, size, True)
    return {**fwd, **{k + "_bwd": c for k, c in bwd.items()}}


def bytes_and_ops(kernel: str, shape):
    """Bytes each call must move (inputs read once, outputs written once,
    fp32), the fp32 operations it does and, for the scans, its calls of the
    special-function units. A backward reads its forward's inputs and the
    cotangent and writes a gradient for each input; it recomputes what its
    forward computed."""
    if kernel == "scan":
        B, L, D, R = shape
        K, N = 4, 16
        elems = B * K * L * D
        nbytes = 4 * (2 * elems + B * K * L * (R + 2 * N) + K * D * (R + N + 2))
        # per state: the exponent, the input term, two FMAs; the dt expansion
        # and softplus. Special functions: an exp per state, softplus' exp and log
        return nbytes, elems * (2 * R + 7 + 7 * N), elems * (N + 2)
    if kernel == "scan_bwd":
        B, L, D, R = shape
        K, N = 4, 16
        elems = B * K * L * D
        # also reads the states the forward saved every SAVE_EVERY steps
        nbytes = 4 * (3 * elems + elems * N // scan_cuda.SAVE_EVERY
                      + 2 * B * K * L * (R + 2 * N) + 2 * K * D * (R + N + 2))
        # recompute (exp, 2 FMAs per state) and the adjoint (about 16 per
        # state), the dt expansion, its two gradients, softplus and its slope.
        # Special functions the gradients need: an exp per state, softplus'
        # exp and log, the slope's reciprocal. (The kernel takes the exp a
        # second time in the adjoint rather than keep it beside the state:
        # its choice, not counted.)
        return nbytes, elems * (20 * N + 6 * R + 15), elems * (N + 3)
    if kernel == "layer_norm":
        rows, C, gate = shape
        n = rows * C
        return 4 * (n * (2 + (gate != "none")) + 2 * C), n * (7 + _GATE_OPS[gate]), 0
    if kernel == "layer_norm_bwd":
        rows, C, gate = shape
        n = rows * C
        return 4 * (n * (3 + 2 * (gate != "none")) + 4 * C), n * (16 + 2 * _GATE_OPS[gate]), 0
    if kernel == "ln_mean":
        B, rows, C = shape
        return 4 * (B * rows * C + B * C + 2 * C), 8 * B * rows * C, 0
    if kernel == "ln_mean_bwd":
        B, rows, C = shape
        return 4 * (2 * B * rows * C + B * C + 3 * C), 12 * B * rows * C, 0
    if kernel in ("dwconv", "dwconv_bwd"):
        B, H, W, C = shape
        n = B * H * W * C
        if kernel == "dwconv":
            return 4 * (2 * n + 10 * C), n * (18 + 1 + 4), 0
        # pre (18), silu' (8), dx (18), dw (18), dbias (1)
        return 4 * (3 * n + 20 * C), n * 63, 0
    M, C, H = shape
    if kernel == "mlp":
        return 4 * (2 * M * C + 2 * C * H + H + C), M * (4 * C * H + 10 * H), 0
    # five products of 2*M*C*H (h, dy W2, dx, dW1, dW2), GELU and its slope
    return 4 * (3 * M * C + 4 * C * H + 2 * H + 2 * C), M * (10 * C * H + 30 * H), 0


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_case(kernel, shape, dev, gen):
    """(inputs, op, plain, library or None, backward) on seeded inputs at
    `shape`, scaled as the model's activations and parameters are: op,
    plain and library take the inputs; backward(inputs, dy) calls the
    backward kernel's wrapper directly."""
    def rnd(*s, scale=1.0, shift=0.0):
        return torch.randn(*s, device=dev, generator=gen) * scale + shift

    if kernel == "scan":
        B, L, D, R = shape
        K, N = 4, 16
        inputs = [rnd(B, K, L, D), rnd(B, K, L, R, scale=0.5),
                  -torch.arange(1.0, N + 1, device=dev).expand(K, D, N).contiguous(),
                  rnd(B, K, L, N), rnd(B, K, L, N), rnd(K, D, scale=0.1, shift=1.0),
                  rnd(K, D, scale=1.0, shift=-4.0), rnd(K, D, R, scale=R ** -0.5)]

        def backward(t, dy):
            _, hsave = scan_cuda.selective_scan_fwd(*t[:7], True, t[7], save_states=True)
            return lambda: scan_cuda.selective_scan_bwd(*t, hsave, dy, True)

        return (inputs,
                lambda *t: selective_scan(*t[:7], delta_softplus=True, dt_lowrank_weight=t[7]),
                lambda *t: selective_scan_plain(*t[:7], delta_softplus=True,
                                                dt_lowrank_weight=t[7]),
                None, backward)
    if kernel == "layer_norm":
        rows, C, gate_act = shape
        inputs = [rnd(rows, C, scale=2.0, shift=0.5), rnd(C), rnd(C)]
        if gate_act != "none":
            inputs.append(rnd(rows, C))

        def backward(t, dy):
            return lambda: layer_norm.layer_norm_bwd(*t[:3], t[3] if len(t) > 3 else None, dy,
                                                     1e-6, gate_act)

        # F.layer_norm computes the same function only without a gate
        library = (lambda x, s, b: F.layer_norm(x, (C,), s, b, 1e-6)) if gate_act == "none" \
            else None
        return (inputs, lambda *t: layer_norm.layer_norm_fused(*t, eps=1e-6, gate_act=gate_act),
                lambda *t: layer_norm.layer_norm_plain(*t, eps=1e-6, gate_act=gate_act),
                library, backward)
    if kernel == "ln_mean":
        B, rows, C = shape
        return ([rnd(B, rows, C, scale=2.0, shift=0.5), rnd(C), rnd(C)],
                lambda *t: layer_norm.ln_spatial_mean(*t, 1e-5),
                lambda *t: layer_norm.ln_spatial_mean_plain(*t, 1e-5), None,
                lambda t, dm: lambda: layer_norm.ln_spatial_mean_bwd(t[0], t[1], dm, 1e-5))
    if kernel == "dwconv":
        B, H, W, C = shape
        return ([rnd(B, H, W, C), rnd(3, 3, C, scale=1 / 3), rnd(C, scale=1 / 3)],
                lambda *t: dwconv.depthwise_conv3x3(*t, "silu"),
                lambda *t: dwconv.depthwise_conv3x3_plain(*t, "silu"),
                lambda x, w, b: F.silu(F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1)[:, None],
                                                b, padding=1, groups=C)).permute(0, 2, 3, 1),
                lambda t, dy: lambda: dwconv.dwconv_bwd(*t, dy, "silu"))
    M, C, H = shape
    # nn.Linear's (out, in) weights, passed as `.t()` views as Mlp.forward does
    return ([rnd(M, C), rnd(H, C, scale=0.02), torch.zeros(H, device=dev),
             rnd(C, H, scale=0.02), torch.zeros(C, device=dev)],
            lambda x, w1, b1, w2, b2: mlp.fused_mlp(x, w1.t(), b1, w2.t(), b2),
            lambda x, w1, b1, w2, b2: mlp.fused_mlp_plain(x, w1.t(), b1, w2.t(), b2),
            lambda x, w1, b1, w2, b2: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2),
            lambda t, dy: lambda: mlp.mlp_bwd(t[0], t[1].t(), t[2], t[3].t(), t[4], dy))


def device_ms(fn, reps: int = 3):
    """Device time per call of `fn` (warm), from torch.profiler: the sum of its
    kernels' durations, without the host's launch pace that paces CUDA events
    over short kernels. A capture sometimes records no device event: it is
    taken again, and None is returned only after DEVICE_MS_TRIES empty ones."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(DEVICE_MS_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return sum(spans) / 1e3 / reps
    return None


def _bound(kernel, shape):
    """(bytes ms, operations ms at the rate the kernel's design uses,
    special-function ms, bound ms on the fp32 CUDA cores)."""
    nbytes, nops, nsfu = bytes_and_ops(kernel, shape)
    bytes_ms, cores_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * nops / FP32_OPS_PER_S
    ops_ms = 1e3 * nops / (TF32_OPS_PER_S / 3) if kernel in TENSOR_CORE_KERNELS else cores_ms
    return bytes_ms, ops_ms, 1e3 * nsfu / SFU_CALLS_PER_S, max(bytes_ms, cores_ms)


def _new_agg():
    """Sums over a kernel's shapes of calls x time. The library call's times
    cover only the shapes where there is one (the LN's ungated shapes), and
    the kernel's times at those same shapes stand beside them
    (`ms_at_library_shapes`, `device_ms_at_library_shapes`); `_summary`
    turns them to None where no shape had a library call. The device times
    sum over the shapes that have one (`device_shapes_covered` of `shapes`;
    the library's over the shapes where both have one), so a shape without
    one leaves the others' sum standing, labelled by its count."""
    return dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, shapes=0, device_shapes_covered=0,
                device_ms=0.0, library_shapes=0, library_device_shapes_covered=0,
                library_ms=0.0, library_device_ms=0.0, ms_at_library_shapes=0.0,
                device_ms_at_library_shapes=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                sfu_ms=0.0, fp32_cores_bound_ms=0.0)


def _add(agg, n, err, ms, plain_ms, lib_ms, dev_ms, lib_dev_ms, bytes_ms, ops_ms, sfu_ms,
         cores_ms):
    agg["max_abs_err"] = max(agg["max_abs_err"], err)
    agg["ms"] += n * ms
    agg["plain_ms"] += n * plain_ms
    agg["shapes"] += 1
    if dev_ms is not None:
        agg["device_shapes_covered"] += 1
        agg["device_ms"] += n * dev_ms
    if lib_ms is not None:
        agg["library_shapes"] += 1
        agg["library_ms"] += n * lib_ms
        agg["ms_at_library_shapes"] += n * ms
        if lib_dev_ms is not None and dev_ms is not None:
            agg["library_device_shapes_covered"] += 1
            agg["library_device_ms"] += n * lib_dev_ms
            agg["device_ms_at_library_shapes"] += n * dev_ms
    agg["bound_ms"] += n * max(bytes_ms, ops_ms, sfu_ms)
    agg["bytes_ms"] += n * bytes_ms
    agg["ops_ms"] += n * ops_ms
    agg["sfu_ms"] += n * sfu_ms
    agg["fp32_cores_bound_ms"] += n * cores_ms


def _summary(agg):
    """The sums of `_new_agg` to report: the library's times None where no
    shape had a library call."""
    out = dict(agg)
    if not agg["library_shapes"]:
        for k in ("library_shapes", "library_device_shapes_covered", "library_ms",
                  "library_device_ms", "ms_at_library_shapes", "device_ms_at_library_shapes"):
            out[k] = None
    return out


def _brief(agg):
    """A kernel's sums per step, for the per-batch summaries."""
    return {k: v for k, v in _summary(agg).items()
            if k in ("ms", "device_ms", "bound_ms", "plain_ms", "library_ms", "shapes",
                     "device_shapes_covered", "max_abs_err")}


def _bound_by(kernel, bytes_ms, ops_ms, sfu_ms):
    """Which of the three terms is the largest. `bound_by` is bytes or
    operations; special-function calls are operations too, so where it is
    operations `operations_kind` says which: fp32 (the tensor cores' 3xTF32
    for the MLP kernels) or special_function."""
    if bytes_ms >= max(ops_ms, sfu_ms):
        return {"bound_by": "bytes"}
    arithmetic = "tf32x3" if kernel in TENSOR_CORE_KERNELS else "fp32"
    return {"bound_by": "operations",
            "operations_kind": "special_function" if sfu_ms >= ops_ms else arithmetic}


def _bound_fields(kernel, bytes_ms, ops_ms, sfu_ms, cores_ms, dev_ms):
    """The bound of one call, what sets it and its share of the kernel's
    device time, for a per-shape line."""
    bound = max(bytes_ms, ops_ms, sfu_ms)
    out = {"bound_ms": bound, "bound_share_of_device_ms": bound / dev_ms if dev_ms else None,
           **_bound_by(kernel, bytes_ms, ops_ms, sfu_ms)}
    if sfu_ms:
        out["special_function_bound_ms"] = sfu_ms
    if kernel in TENSOR_CORE_KERNELS:
        out["fp32_cores_bound_ms"] = cores_ms
    return out


def _forward_line(phase, kernel, shape, n, case, pairs=PAIRS):
    """Check and time one forward kernel at `shape`; emit its line and return
    (err, ms, plain_ms, library_ms, device_ms, library_device_ms, bytes_ms,
    ops_ms, sfu_ms, cores_ms). The scan, the MLP, the dwconv and the LN-mean must
    also repeat themselves bit for bit."""
    inputs, op, plain, library, _ = case
    with torch.no_grad():
        got, want = op(*inputs), plain(*inputs)
        repeats = kernel in ("mlp", "scan", "dwconv", "ln_mean")
        same = not repeats or torch.equal(got, op(*inputs))
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool(torch.all(err <= KERNEL_ATOL + KERNEL_RTOL * want.abs()))
        heavy = kernel == "scan"
        ms = cuda_ms(lambda: op(*inputs), 5 if heavy else 20)
        plain_ms = cuda_ms(lambda: plain(*inputs), 2 if heavy else 10, warmup=1)
        dev_ms, lib_ms, lib_dev_ms = device_ms(lambda: op(*inputs)), None, None
        if library is not None:
            lib_ms = cuda_ms(lambda: library(*inputs), 20)
            lib_dev_ms = device_ms(lambda: library(*inputs))
    bounds = _bound(kernel, shape)
    emit({"phase": phase, "kernel": kernel, "shape": list(shape), "pairs": pairs,
          "calls_per_" + ("forward" if phase == "kernel" else "step"): n,
          "max_abs_err": float(err.max()), "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ok": ok,
          **({"bit_identical_twice": same} if repeats else {}),
          "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "kernel_device_ms": dev_ms, "library_device_ms": lib_dev_ms,
          **_bound_fields(kernel, *bounds, dev_ms)})
    if not ok:
        fail(f"{kernel} at {shape} disagrees with its plain version "
             f"(max abs err {float(err.max())})")
    if not same:
        fail(f"{kernel} at {shape} differs between two launches")
    return (float(err.max()), ms, plain_ms, lib_ms, dev_ms, lib_dev_ms, *bounds)


def phase_kernels(calls, dev):
    """Each forward kernel at every serving shape; sums per forward."""
    results = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for kernel, shapes in calls.items():
        agg = _new_agg()
        for shape, n in sorted(shapes.items(), key=str):
            _add(agg, n, *_forward_line("kernel", kernel, shape, n,
                                        make_case(kernel, shape, dev, gen)))
        torch.cuda.empty_cache()
        results[kernel] = agg
    return results


def _grads(fn, inputs, dy):
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs, dy)


def _backward_line(op, shape, n_bwd, case, dev, gen, pairs):
    """Check and time one backward kernel at `shape` through the op's
    autograd Function against the autograd of the plain version; emit its
    line and return its `_add` terms."""
    inputs, fn, plain, library, backward = case
    inputs = [t.requires_grad_(True) for t in inputs]
    with torch.no_grad():
        dy = torch.randn(fn(*inputs).shape, device=dev, generator=gen)
    got, want = _grads(fn, inputs, dy), _grads(plain, inputs, dy)
    torch.cuda.synchronize()
    err, scaled, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        e = (g - w).abs()
        top = float(w.abs().max())
        ok &= bool(torch.all(e <= GRAD_RTOL * w.abs() + GRAD_SCALED_ATOL * top))
        err, scaled = max(err, float(e.max())), max(scaled, float(e.max()) / max(top, 1e-30))
    with torch.no_grad():
        run = backward([t.detach() for t in inputs], dy)
        first, second = run(), run()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second) if a is not None)
        heavy = op == "scan"
        ms = cuda_ms(run, 5 if heavy else 20)
    out_p = plain(*inputs)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(out_p, inputs, dy, retain_graph=True),
                       1 if heavy else 10, warmup=1)
    with torch.no_grad():
        dev_ms = device_ms(run)
    lib_ms = lib_dev_ms = None
    if library is not None:
        out_l = library(*inputs)

        def lib_run():
            return torch.autograd.grad(out_l, inputs, dy, retain_graph=True)

        lib_ms = cuda_ms(lib_run, 20)
        lib_dev_ms = device_ms(lib_run)
    bounds = _bound(op + "_bwd", shape)
    emit({"phase": "kernel_train", "kernel": op + "_bwd", "shape": list(shape), "pairs": pairs,
          "calls_per_step": n_bwd, "max_abs_err": err, "max_err_over_max_grad": scaled,
          "rtol": GRAD_RTOL, "atol_of_max_grad": GRAD_SCALED_ATOL, "ok": ok,
          "bit_identical_twice": same, "kernel_ms": ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "kernel_device_ms": dev_ms,
          "library_device_ms": lib_dev_ms,
          **_bound_fields(op + "_bwd", *bounds, dev_ms)})
    if not ok:
        fail(f"{op} backward at {shape} disagrees with autograd of its plain version "
             f"(max abs err {err}, {scaled} of the largest gradient)")
    if not same:
        fail(f"{op} backward at {shape} differs between two launches")
    return (err, ms, plain_ms, lib_ms, dev_ms, lib_dev_ms, *bounds)


def phase_kernel_train(calls, dev, pairs, checked):
    """Each forward and backward kernel at every training shape of a step of
    `pairs` pairs; sums per training step. The backward's gradients (through
    the op's autograd Function) are held against the autograd of the plain
    version, two direct launches must agree bit for bit, and the backward is
    timed alone. `checked` holds the results of each (kernel, shape) checked
    by an earlier call (the batches share shapes: the encoder runs 2B): such
    a shape is counted in this step's sums without a second check."""
    results = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for op in OPS:
        fwd, bwd = _new_agg(), _new_agg()
        for shape, n in sorted(calls[op].items(), key=str):
            n_bwd = calls[op + "_bwd"][shape]
            todo = [k for k in (op, op + "_bwd")
                    if (k, shape) not in checked and (k == op or n_bwd)]
            if todo:
                case = make_case(op, shape, dev, gen)
                if op in todo:
                    checked[(op, shape)] = _forward_line("kernel_train", op, shape, n, case,
                                                         pairs)
                if op + "_bwd" in todo:
                    checked[(op + "_bwd", shape)] = _backward_line(op, shape, n_bwd, case, dev,
                                                                   gen, pairs)
                del case
            _add(fwd, n, *checked[(op, shape)])
            if n_bwd:
                _add(bwd, n_bwd, *checked[(op + "_bwd", shape)])
        torch.cuda.empty_cache()
        results[op], results[op + "_bwd"] = fwd, bwd
    return results


def phase_mlp_paths(calls, dev):
    """Both designs of the MLP forward at every training shape, whichever
    the wrapper takes there: the fused kernel (hidden on chip) and the two
    tiled passes, each held against the plain version and timed."""
    gen = torch.Generator(device=dev).manual_seed(4)
    for shape, n in sorted(calls.items(), key=str):
        inputs, _, plain, _, _ = make_case("mlp", shape, dev, gen)
        line = {"phase": "mlp_paths", "shape": list(shape), "calls_per_step": n,
                "wrapper_takes": "fused" if shape[1] <= mlp.FUSED_MAX_OUT else "two_pass"}
        with torch.no_grad():
            want = plain(*inputs)
            for name, fused in (("fused", True), ("two_pass", False)):
                def run():
                    return mlp.mlp_fwd(*inputs, fused=fused)
                err = (run() - want).abs()
                if not bool(torch.all(err <= KERNEL_ATOL + KERNEL_RTOL * want.abs())):
                    fail(f"mlp {name} at {shape} disagrees with its plain version "
                         f"(max abs err {float(err.max())})")
                line[name + "_max_abs_err"] = float(err.max())
                line[name + "_ms"] = cuda_ms(run, 20)
        emit(line)


def fullres_scan_shapes(cfg, batch: int, size: int):
    """(B, L, D, R) of the scan of an SS2D(scan_variant="fullres") at each
    stage's width, at L = H*W of that stage."""
    g0 = size // cfg.patch_size
    return [(batch, (g0 >> i) ** 2, int(cfg.ssm_ratio * C), math.ceil(C / 16))
            for i, C in enumerate(cfg.dims)]


def phase_scan_paths(train_shapes, serve_shapes, fullres_shapes, dev):
    """The scan kernels at every training and serving shape, and at the
    full-resolution scan's shapes, with L cut into chunks as the wrapper cuts
    it (`scan_cuda._pick_chunk`) and, where that is more than one chunk, also
    with L as one chunk: the forward held against the plain version, the two
    backwards' gradients against each other, and the times of the serving
    forward, the training forward (saving states) and the backward."""
    gen = torch.Generator(device=dev).manual_seed(5)
    K = 4
    shapes = {**{s: ("train", n) for s, n in train_shapes.items()},
              **{s: ("serve", n) for s, n in serve_shapes.items()},
              **{s: ("fullres", None) for s in fullres_shapes}}
    for shape, (path, n) in sorted(shapes.items(), key=str):
        B, L, D, R = shape
        t, _, plain, _, _ = make_case("scan", shape, dev, gen)
        one = -(-L // 16) * 16
        picked = {"fwd": scan_cuda._pick_chunk(None, B, K, L, D, dev, scan_cuda.FWD_WARPS_PER_SM),
                  "bwd": scan_cuda._pick_chunk(None, B, K, L, D, dev, scan_cuda.BWD_WARPS_PER_SM)}
        line = {"phase": "scan_paths", "shape": list(shape), "path": path,
                **({} if n is None else
                   {"calls_per_" + ("step" if path == "train" else "forward"): n}),
                "one_chunk": one, "picked_chunk": picked}
        trains = path != "serve"
        cuts = [("picked", picked["fwd"], picked["bwd"])]
        if picked["fwd"] < one or (trains and picked["bwd"] < one):
            cuts.append(("one_chunk", one, one))
        with torch.no_grad():
            want = plain(*t)
            dy = torch.randn(want.shape, device=dev, generator=gen)
            grads = {}
            for name, fwd_chunk, bwd_chunk in cuts:
                def fwd(save=False, chunk=fwd_chunk):
                    return scan_cuda.selective_scan_fwd(*t[:7], True, t[7], save_states=save,
                                                        chunk=chunk)
                err = (fwd() - want).abs()
                if not bool(torch.all(err <= KERNEL_ATOL + KERNEL_RTOL * want.abs())):
                    fail(f"scan {name} at {shape} disagrees with its plain version "
                         f"(max abs err {float(err.max())})")
                line[name + "_max_abs_err"] = float(err.max())
                line[name + "_fwd_ms"] = cuda_ms(fwd, 10)
                if trains:
                    line[name + "_fwd_saving_ms"] = cuda_ms(lambda: fwd(True), 10)
                    hsave = fwd(True)[1]

                    def bwd(chunk=bwd_chunk):
                        return scan_cuda.selective_scan_bwd(*t, hsave, dy, True, chunk=chunk)
                    grads[name] = bwd()
                    line[name + "_bwd_ms"] = cuda_ms(bwd, 10)
            if len(grads) == 2:
                worst = 0.0
                for g, w in zip(grads["picked"], grads["one_chunk"]):
                    e, top = (g - w).abs(), float(w.abs().max())
                    if not bool(torch.all(e <= GRAD_RTOL * w.abs() + GRAD_SCALED_ATOL * top)):
                        fail(f"scan backward at {shape}: chunked and one-chunk gradients differ "
                             f"by {float(e.max())}")
                    worst = max(worst, float(e.max()) / max(top, 1e-30))
                line["bwd_chunked_vs_one_chunk_err_over_max_grad"] = worst
        emit(line)
        del t, want, grads
        torch.cuda.empty_cache()


# where each kernel's launch counter lives
_COUNTERS = {"scan": (scan_cuda, "launches"), "scan_bwd": (scan_cuda, "bwd_launches"),
             "layer_norm": (ln_triton, "layer_norm_launches"),
             "layer_norm_bwd": (layer_norm, "layer_norm_bwd_launches"),
             "ln_mean": (layer_norm, "ln_mean_launches"),
             "ln_mean_bwd": (layer_norm, "ln_mean_bwd_launches"),
             "dwconv": (dwconv, "launches"), "dwconv_bwd": (dwconv, "bwd_launches"),
             "mlp": (mlp, "launches"), "mlp_bwd": (mlp, "bwd_launches")}


def read_launches(kernels=KERNELS):
    return {k: getattr(*_COUNTERS[k]) for k in kernels}


def zero_launches():
    for module, name in _COUNTERS.values():
        setattr(module, name, 0)


def phase_main_path(calls, smi, tmp):
    """The serving CLI twice on N_IMAGES pairs written into `tmp` (`ir`,
    `vis`; the outputs in `out1`, `out2`)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for d in ("ir", "vis"):
        os.makedirs(os.path.join(tmp, d))
        for i in range(N_IMAGES):
            img = rng.integers(0, 256, (220, 300), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(tmp, d, f"pair{i:02d}.png"))
    argv = ["--ir_dir", os.path.join(tmp, "ir"), "--vis_dir", os.path.join(tmp, "vis"),
            "--model", "full", "--size", str(SIZE), "--batch", str(PAIRS),
            "--device", "cuda"]
    zero_launches()
    first = infer.main(argv + ["--out_dir", os.path.join(tmp, "out1")])
    torch.cuda.synchronize()
    launches = read_launches(calls)
    if any(v for k, v in read_launches().items() if k not in calls):
        fail(f"serving launched a backward kernel: {read_launches()}")
    second = infer.main(argv + ["--out_dir", os.path.join(tmp, "out2")])
    names = sorted(os.listdir(os.path.join(tmp, "out1")))
    if names != sorted(os.listdir(os.path.join(tmp, "out2"))) or len(names) != N_IMAGES:
        fail(f"main path wrote {len(names)} images, expected {N_IMAGES}")
    for name in names:
        a = np.asarray(Image.open(os.path.join(tmp, "out1", name)))
        b = np.asarray(Image.open(os.path.join(tmp, "out2", name)))
        if a.shape != (SIZE, SIZE) or a.dtype != np.uint8 or a.min() == a.max():
            fail(f"main path output {name}: shape {a.shape}, dtype {a.dtype}, "
                 f"range {a.min()}..{a.max()}")
        if not np.array_equal(a, b):
            fail(f"main path output {name} differs between two runs")
    batches = len(first["batch_seconds"])
    expected = {k: batches * sum(c.values()) for k, c in calls.items()}
    if launches != expected:
        fail(f"launch counts {launches} differ from the config's {expected}")
    warm = second["batch_seconds"]
    # pairs_per_s covers the whole warm run: image reads and resizes, the
    # forwards with their copies, and the PNG writes
    emit({"phase": "main_path", "pairs": first["pairs"], "batches": batches,
          "launches": launches, "expected_launches": expected,
          "calls_per_forward": {k: sum(c.values()) for k, c in calls.items()},
          "run_seconds_first_run": first["seconds"], "run_seconds": second["seconds"],
          "pairs_per_s": second["pairs"] / second["seconds"],
          "batch_seconds_first_run": first["batch_seconds"], "batch_seconds": warm,
          "median_batch_s": float(np.median(warm)),
          "forward_copies_pairs_per_s": PAIRS / float(np.median(warm)), "card": smi})
    return launches


def phase_parity(dev):
    rng = np.random.default_rng(1)
    x1, x2 = (torch.from_numpy(rng.uniform(0, 1, (1, SIZE, SIZE, 1)).astype(np.float32))
              for _ in range(2))
    with torch.inference_mode():
        gpu = infer.build_model("full", dev)(x1.to(dev), x2.to(dev)).cpu()
        t0 = time.perf_counter()
        cpu = infer.build_model("full", torch.device("cpu"))(x1, x2)
        cpu_s = time.perf_counter() - t0
    if not (torch.isfinite(gpu).all() and gpu.shape == (1, SIZE, SIZE, 1)):
        fail("the card's output is not finite or has the wrong shape")
    err = float((gpu - cpu).abs().max())
    emit({"phase": "parity", "max_abs_err": err, "atol": PARITY_ATOL,
          "output_range": [float(gpu.min()), float(gpu.max())], "cpu_seconds": cpu_s})
    if err > PARITY_ATOL:
        fail(f"card vs CPU max abs error {err} > {PARITY_ATOL}")


def phase_train(calls, smi):
    """12 full-width training steps through the training CLI; returns the
    ten launch counts."""
    steps = TRAIN_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", str(TRAIN_PAIRS * steps), "-B", str(TRAIN_PAIRS), "-E", "1",
                "-j", "0", "--model", "full", "--device", "cuda", "--ckpt_dir", tmp]
        zero_launches()
        stats = train.main(argv)
        torch.cuda.synchronize()
        launches = read_launches()
        # the saved state dict loads strictly into a fresh model
        load_reference_checkpoint(VSSMFusion(full_config()),
                                  os.path.join(tmp, "fusion_model_pst900.pth"))
    torch.cuda.empty_cache()
    expected = {k: stats["steps"] * sum(c.values()) for k, c in calls.items()}
    if stats["steps"] != steps or not all(math.isfinite(v) for v in stats["losses"]):
        fail(f"training ran {stats['steps']} steps with losses {stats['losses']}")
    if launches != expected:
        fail(f"training launch counts {launches} differ from the config's {expected}")
    warm = stats["step_seconds"][1:]
    emit({"phase": "train", "steps": stats["steps"], "pairs_per_step": TRAIN_PAIRS,
          "losses": stats["losses"], "launches": launches, "expected_launches": expected,
          "calls_per_step": {k: sum(c.values()) for k, c in calls.items()},
          "first_step_s": stats["step_seconds"][0], "step_seconds": stats["step_seconds"],
          "median_warm_step_s": float(np.median(warm)),
          "pairs_per_s": TRAIN_PAIRS / float(np.median(warm)),
          "warm_run_pairs_per_s": TRAIN_PAIRS * len(warm) / float(np.sum(warm)),
          "cli_seconds": stats["seconds"], "card": smi})
    return launches


def _write_pst900(root: str, splits, seed: int = 0) -> None:
    """A PST900-layout folder with `splits[split]` pairs a split: RGB, thermal
    and label PNGs at PST900's own 1280x720, smooth random fields (coarse
    noise upsampled by 16, plus fine noise) made from `seed`; labels of the
    5 classes."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = DISK_SIZE

    def field(*extra):
        coarse = rng.uniform(0, 200, (h // 16, w // 16, *extra))
        up = np.kron(coarse, np.ones((16, 16, *([1] * len(extra)))))
        return (up + rng.uniform(0, 55, up.shape)).astype(np.uint8)

    for split, pairs in splits.items():
        base = os.path.join(root, "PST900_RGBT_Dataset", split)
        for sub in ("rgb", "thermal", "labels"):
            os.makedirs(os.path.join(base, sub))
        for i in range(pairs):
            name = f"{i:04d}.png"
            Image.fromarray(field(3)).save(os.path.join(base, "rgb", name))
            Image.fromarray(field()).save(os.path.join(base, "thermal", name))
            Image.fromarray((field() // 52).astype(np.uint8)).save(
                os.path.join(base, "labels", name))


@contextlib.contextmanager
def data_root(root: str):
    """FUSIONMAMBA_DATA_ROOT set to `root` inside the block."""
    before = os.environ.get("FUSIONMAMBA_DATA_ROOT")
    os.environ["FUSIONMAMBA_DATA_ROOT"] = root
    try:
        yield
    finally:
        if before is None:
            del os.environ["FUSIONMAMBA_DATA_ROOT"]
        else:
            os.environ["FUSIONMAMBA_DATA_ROOT"] = before


def phase_train_disk(calls, smi, root: str, write_s: float):
    """DISK_STEPS full-width training steps of the training CLI on the PST900
    folder under `root` through its threaded loader and device prefetch."""
    pairs = TRAIN_PAIRS * DISK_STEPS
    with tempfile.TemporaryDirectory() as ckpt, data_root(root):
        zero_launches()
        stats = train.main(["--dataset", "pst900", "-B", str(TRAIN_PAIRS), "-E", "1",
                            "-j", str(DISK_WORKERS), "--model", "full", "--device", "cuda",
                            "--ckpt_dir", ckpt])
        torch.cuda.synchronize()
        launches = read_launches()
    torch.cuda.empty_cache()
    expected = {k: stats["steps"] * sum(c.values()) for k, c in calls.items()}
    if stats["steps"] != DISK_STEPS or not all(math.isfinite(v) for v in stats["losses"]):
        fail(f"training on disk ran {stats['steps']} steps with losses {stats['losses']}")
    if launches != expected:
        fail(f"training on disk: launch counts {launches} differ from the config's {expected}")
    steps, waits = stats["step_seconds"], stats["loader_wait_seconds"]
    emit({"phase": "train_disk", "dataset": "pst900", "pairs": pairs,
          "image_size": list(DISK_SIZE), "workers": DISK_WORKERS, "steps": stats["steps"],
          "losses": stats["losses"], "launches": launches, "expected_launches": expected,
          "step_seconds": steps, "median_warm_step_s": float(np.median(steps[1:])),
          "pairs_per_s": TRAIN_PAIRS / float(np.median(steps[1:])),
          "loader_wait_ms_per_step": [1e3 * w for w in waits],
          "median_warm_loader_wait_ms": 1e3 * float(np.median(waits[1:])),
          "folder_write_s": write_s, "cli_seconds": stats["seconds"], "card": smi})


def _seg_run(argv, cfg, pairs: int, steps: int, eval_forwards: int, ckpt_dir: str, smi,
             name: str):
    """One run of the segmentation training CLI: launch counts (zeroed just
    before) equal to `steps` training steps of `pairs` pairs plus
    `eval_forwards` forwards of the evaluation, every loss and score finite,
    both checkpoints loading strictly. Emits its line; returns the launch
    counts."""
    zero_launches()
    stats = train_segmentation.main(argv + ["--model", "full", "--device", "cuda",
                                            "--ckpt_dir", ckpt_dir])
    torch.cuda.synchronize()
    launches = read_launches()
    tcalls, fcalls = train_calls(cfg, pairs, SIZE), main_path_calls(cfg, pairs, SIZE)
    expected = {k: steps * sum(c.values()) + eval_forwards * sum(fcalls.get(k, {}).values())
                for k, c in tcalls.items()}
    if stats["steps"] != steps or not all(math.isfinite(v) for v in stats["losses"]):
        fail(f"{name}: {stats['steps']} steps with losses {stats['losses']}")
    if launches != expected:
        fail(f"{name}: launch counts {launches} differ from the config's {expected}")
    scores = stats["evals"][-1] if stats["evals"] else {}
    finite = [k for k in ("mean_iou", "mean_acc", "pixel_acc")
              if k in scores and math.isfinite(scores[k])]
    if len(stats["evals"]) != 1 or len(finite) != 3:
        fail(f"{name}: evaluations {stats['evals']}")
    dataset = argv[argv.index("--dataset") + 1]
    for suffix in ("", "_best"):
        load_reference_checkpoint(
            VSSMFusionSeg(cfg), os.path.join(ckpt_dir, f"segmentation_model_{dataset}{suffix}.pth"))
    warm = stats["step_seconds"][1:]
    emit({"phase": "train_seg", "run": name, "argv": argv, "pairs_per_step": pairs,
          "steps": stats["steps"], "losses": stats["losses"], "launches": launches,
          "expected_launches": expected, "eval_forwards": eval_forwards,
          "scores": {k: scores[k] for k in ("pixel_acc", "mean_acc", "mean_iou", "fw_iou")},
          "class_weights": stats["class_weights"], "step_seconds": stats["step_seconds"],
          "median_warm_step_s": float(np.median(warm)),
          "pairs_per_s": pairs / float(np.median(warm)),
          "loader_wait_ms_per_step": [1e3 * w for w in stats["loader_wait_seconds"]],
          "cli_seconds": stats["seconds"], "card": smi})
    torch.cuda.empty_cache()
    return launches


def phase_train_seg(smi, root: str, ckpt_dir: str) -> str:
    """The segmentation training CLI at full width: PST900 on the folder under
    `root` (mode both: batch 2, 12 steps over its 24 training pairs, the
    poly lr, class weights from the label counts, the improved loss; one
    evaluation of its 6 test pairs in 3 forwards), then 4 steps of synthetic
    MFNet-class pairs at batch 4 in the default mode (segmentation, the
    unweighted loss; one evaluation forward of 4 pairs). Returns the PST900
    checkpoint and the PST900 run's launch counts."""
    with data_root(root):
        launches = _seg_run(["--dataset", "pst900", "--mode", "both", "-E", "1", "-j", str(DISK_WORKERS)],
                 full_config(num_seg_classes=5), 2, SEG_PST900_STEPS, 3, ckpt_dir, smi, "pst900")
    _seg_run(["--dataset", "mfnet", "--synthetic", "16", "-B", "4", "-E", "1", "-j", "0"],
             full_config(num_seg_classes=9), 4, 4, 1, ckpt_dir, smi, "mfnet_synthetic")
    return os.path.join(ckpt_dir, "segmentation_model_pst900.pth"), launches


def phase_evaluate_seg(ckpt: str, root: str):
    """`fusionmamba_torch.evaluate_segmentation` of the PST900 checkpoint on
    the folder's test split: every metric finite, the report written."""
    with tempfile.TemporaryDirectory() as tmp, data_root(root):
        out = os.path.join(tmp, "pst900_segmentation_results.txt")
        got = evaluate_segmentation.main(["--dataset", "pst900", "--ckpt", ckpt, "--model", "full",
                                          "--batch", "2", "--device", "cuda", "--out", out])
        written = open(out).read() if os.path.exists(out) else ""
    values = [v for val in got["metrics"].values()
              for v in (val if isinstance(val, list) else [val])]
    finite = all(math.isfinite(v) for v in values)
    emit({"phase": "evaluate_seg", "samples": got["samples"], "metrics": got["metrics"],
          "all_finite": finite, "report_written": written == got["report"] + "\n",
          "seconds": got["seconds"]})
    if not finite or got["samples"] != SEG_TEST_PAIRS:
        fail(f"segmentation evaluation of {got['samples']} pairs: {got['metrics']}")
    if written != got["report"] + "\n":
        fail("segmentation evaluation did not write its report")


def phase_evaluate(serving_dir: str):
    """`fusionmamba_torch.evaluate_fusion` on the serving phase's outputs
    against their inputs, with the outputs as their own reference."""
    from fusionmamba_torch import evaluate_fusion

    t0 = time.perf_counter()
    fused = os.path.join(serving_dir, "out1")
    got = evaluate_fusion.main(["--ir_dir", os.path.join(serving_dir, "ir"),
                                "--vis_dir", os.path.join(serving_dir, "vis"),
                                "--fused_dir", fused, "--ref_dir", fused])
    means = got["means"]
    finite = all(math.isfinite(v) for rep in got["rows"].values() for v in rep.values())
    emit({"phase": "evaluate", "pairs": len(got["rows"]), "means": means,
          "all_finite": finite, "seconds": time.perf_counter() - t0})
    if not finite or len(got["rows"]) != N_IMAGES:
        fail(f"evaluation of {len(got['rows'])} pairs: a metric is not finite")
    if means["ssim_vs_reference"] != 1.0:
        fail(f"SSIM of the outputs against themselves is {means['ssim_vs_reference']}, not 1")


def phase_train_parity(dev, steps: int = 5):
    """The same seeded weights and batches at the test config on the card
    (kernels) and on the CPU (plain versions)."""
    ds = SyntheticFusionDataset(length=2 * steps, size=(64, 64), seed=4)
    batches = list(batch_iterator(ds, 2, shuffle=True, seed=1))
    runs = {}
    for device in (torch.device("cpu"), dev):
        net = init_weights(VSSMFusion(test_config(drop_path_rate=0.0)), seed=0).to(device)
        opt = train.make_fusion_optimizer(net.parameters())
        losses, grads = [], None
        for vis_y, ir in batches:
            m = train.fusion_train_step(net, opt, torch.from_numpy(vis_y).to(device),
                                        torch.from_numpy(ir).to(device))
            losses.append(float(m["loss_total"]))
            if grads is None:
                grads = {k: None if p.grad is None else p.grad.detach().cpu().clone()
                         for k, p in net.named_parameters()}
        runs[device.type] = losses, grads
    (cpu_l, cpu_g), (gpu_l, gpu_g) = runs["cpu"], runs["cuda"]
    loss_rel = [abs(a - b) / abs(a) for a, b in zip(cpu_l, gpu_l)]
    grad_rel, missing = {}, []
    for k, want in cpu_g.items():
        got = gpu_g[k]
        if (want is None) != (got is None):
            missing.append(k)
        elif want is not None:
            grad_rel[k] = float((got - want).norm() / (want.norm() + 1e-12))
    worst = max(grad_rel, key=grad_rel.get)
    emit({"phase": "train_parity", "steps": steps, "losses_cpu": cpu_l, "losses_card": gpu_l,
          "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
          "params_with_grad": len(grad_rel), "params_without_grad": len(cpu_g) - len(grad_rel),
          "max_grad_rel_err": grad_rel[worst], "worst_param": worst,
          "grad_rtol": TRAIN_GRAD_RTOL})
    if missing:
        fail(f"parameters with a gradient on one device only: {missing}")
    if max(loss_rel) > TRAIN_LOSS_RTOL or grad_rel[worst] > TRAIN_GRAD_RTOL:
        fail(f"card vs CPU training: loss rel err {max(loss_rel)}, {worst} grad rel err "
             f"{grad_rel[worst]}")


def phase_seg_parity(dev, steps: int = 3):
    """VSSMFusionSeg at the test config (5 classes, 64^2, batch 2) from the
    same seeded weights on the card (kernels) and on the CPU (plain
    versions): the eval-mode logits and fusion output, then `steps` training
    steps (mode both, the improved loss with class weights from the labels)
    on the same batches and injected dropout keep-masks: each step's loss,
    and the BatchNorm running statistics after them."""
    cfg, B, size = test_config(num_seg_classes=5), 2, 64
    rng = np.random.default_rng(6)

    def images():
        coarse = np.kron(rng.uniform(0, 1, (B, size // 8, size // 8)), np.ones((1, 8, 8)))
        return torch.from_numpy((0.1 + 0.7 * coarse + 0.2 * rng.uniform(
            0, 1, (B, size, size)))[..., None].astype(np.float32))

    batches = [(images(), images(), torch.from_numpy(np.kron(
        rng.integers(0, 5, (B, size // 8, size // 8)), np.ones((1, 8, 8), np.int64))))
        for _ in range(steps)]
    c2 = 2 * (cfg.dims_decoder[-1] // 4)
    masks = [torch.from_numpy(rng.uniform(0, 1, (B, size, size, c2)) < 0.7) for _ in range(steps)]
    weights = compute_class_weights(torch.bincount(
        torch.cat([b[2].flatten() for b in batches]), minlength=5))
    runs = []
    for device in (torch.device("cpu"), dev):
        net = init_weights(VSSMFusionSeg(cfg), seed=0).to(device)
        x1, x2 = batches[0][0].to(device), batches[0][1].to(device)
        with torch.inference_mode():
            out = {k: v.cpu() for k, v in net.eval()(x1, x2).items()}
        opt = train.make_seg_optimizer(net.parameters())
        losses = []
        for (vis_y, ir, lbl), mask in zip(batches, masks):
            m = train.seg_train_step(net, opt, vis_y.to(device), ir.to(device), lbl.to(device),
                                     num_classes=5, mode="both", class_weights=weights.to(device),
                                     improved=True, drop_mask=mask.to(device))
            losses.append(float(m["total"]))
        stats = {k: v.cpu() for k, v in net.state_dict().items() if "running_" in k}
        runs.append((out, losses, stats))
    (cpu_o, cpu_l, cpu_s), (gpu_o, gpu_l, gpu_s) = runs
    out_err = {k: float((gpu_o[k] - cpu_o[k]).abs().max()) for k in cpu_o}
    loss_rel = [abs(a - b) / abs(a) for a, b in zip(cpu_l, gpu_l)]
    stat_err = max(float((gpu_s[k] - v).abs().max()) for k, v in cpu_s.items())
    finite = all(bool(torch.isfinite(v).all()) for v in gpu_o.values())
    emit({"phase": "seg_parity", "steps": steps, "eval_max_abs_err": out_err,
          "eval_atol": PARITY_ATOL, "losses_cpu": cpu_l, "losses_card": gpu_l,
          "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
          "bn_running_stats_max_abs_err": stat_err, "bn_atol": SEG_BN_ATOL})
    if not finite or max(out_err.values()) > PARITY_ATOL:
        fail(f"segmentation card vs CPU: eval outputs differ by {out_err}")
    if max(loss_rel) > TRAIN_LOSS_RTOL or stat_err > SEG_BN_ATOL:
        fail(f"segmentation card vs CPU training: loss rel err {max(loss_rel)}, BatchNorm "
             f"statistics err {stat_err}")


def phase_fullres_ss2d(dev):
    """One SS2D(96, scan_variant="fullres") at 64^2 (the scan at L = 4096),
    batch 2, on the card (kernels, forward and backward) against the same
    module on the CPU (plain versions): the output and the gradient of every
    parameter for a seeded cotangent."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 96)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 64, 64, 96)).astype(np.float32))
    cpu_mod = init_weights(SS2D(96, 16, scan_variant="fullres"), seed=0)
    runs = []
    for device, mod in ((torch.device("cpu"), cpu_mod), (dev, copy.deepcopy(cpu_mod).to(dev))):
        t0 = time.perf_counter()
        out = mod(x.to(device))
        (out * cot.to(device)).sum().backward()
        runs.append((out.detach().cpu(), {k: p.grad.cpu() for k, p in mod.named_parameters()},
                     time.perf_counter() - t0))
    (cpu_o, cpu_g, cpu_s), (gpu_o, gpu_g, gpu_s) = runs
    err = (gpu_o - cpu_o).abs()
    out_ok = bool(torch.all(err <= KERNEL_ATOL + KERNEL_RTOL * cpu_o.abs()))
    grad_rel = {k: float((gpu_g[k] - w).norm() / (w.norm() + 1e-12)) for k, w in cpu_g.items()}
    worst = max(grad_rel, key=grad_rel.get)
    emit({"phase": "fullres_ss2d", "shape": [2, 64, 64, 96], "scan_L": 64 * 64,
          "max_abs_err": float(err.max()), "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL,
          "grad_rel_err": grad_rel, "worst_param": worst, "grad_rtol": TRAIN_GRAD_RTOL,
          "cpu_seconds": cpu_s, "card_seconds_first_call": gpu_s})
    if not out_ok:
        fail(f"fullres SS2D: card vs CPU output differs by {float(err.max())}")
    if grad_rel[worst] > TRAIN_GRAD_RTOL:
        fail(f"fullres SS2D: card vs CPU gradient of {worst} differs by {grad_rel[worst]}")


# kernel-name fragments of each kernel in a profiler trace, then the groups
# of the library's kernels
_TRACE_NAMES = {"scan": ("selective_scan_fwd_kernel",),
                "scan_bwd": ("selective_scan_bwd", "scan_bwd_reduce"),
                "scan_carry": ("carry_kernel",),   # the chunk carries, forward and backward
                "layer_norm": ("ln_fwd",), "layer_norm_bwd": ("ln_bwd_kernel", "ln_bwd_reduce"),
                "ln_mean": ("lnm_fwd_kernel",),
                "ln_mean_bwd": ("lnm_bwd_kernel", "lnm_bwd_reduce"),
                "dwconv": ("dwconv3x3_fwd_kernel",),
                "dwconv_bwd": ("dwconv3x3_bwd_kernel", "dwconv3x3_bwd_reduce"),
                "mlp": ("mlp_fwd_",), "mlp_bwd": ("mlp_bwd_",),
                "library_conv": ("conv", "fprop", "dgrad", "wgrad", "cudnn"),
                "library_matmul": ("gemm", "cutlass", "cublas"),
                "optimizer": ("adam", "multi_tensor")}


def _trace(run, reps: int):
    """torch.profiler over `reps` calls of `run` (warm): (window ms, device busy
    ms, device ms by kernel group), or None without device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for st, en in spans[1:]:
        if st > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    by_kernel = collections.Counter()
    for e in events:
        name = e.name.lower()
        group = next((k for k, frags in _TRACE_NAMES.items()
                      if any(f.lower() in name for f in frags)), "other")
        by_kernel[group] += e.time_range.end - e.time_range.start
    return window_us / 1e3, busy / 1e3, by_kernel


def phase_trace(dev, forwards: int = 3):
    """Device time by kernel over `forwards` warm forwards of the main path's
    batch, from torch.profiler, and the share of the window the card was idle."""
    net = infer.build_model("full", dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x1, x2 = (torch.rand(PAIRS, SIZE, SIZE, 1, device=dev, generator=gen) for _ in range(2))
    with torch.inference_mode():
        for _ in range(2):
            net(x1, x2)
        got = _trace(lambda: net(x1, x2), forwards)
    if got is None:
        emit({"phase": "trace", "device_time": "not measured (no device events)"})
        return
    window, busy, by_kernel = got
    emit({"phase": "trace", "forwards": forwards, "pairs_per_forward": PAIRS,
          "window_ms": window, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / window,
          "device_ms_per_forward": {k: v / 1e3 / forwards for k, v in by_kernel.most_common()}})


def phase_trace_train(dev, steps: int = 3):
    """The same over `steps` warm training steps of the training path's
    batch (full config, 6 pairs of 256^2, DropPath on)."""
    gc.collect()
    torch.cuda.empty_cache()
    net = init_weights(VSSMFusion(full_config()), seed=0).to(dev)
    opt = train.make_fusion_optimizer(net.parameters())
    gen = torch.Generator(device=dev).manual_seed(3)
    x1, x2 = (torch.rand(TRAIN_PAIRS, SIZE, SIZE, 1, device=dev, generator=gen)
              for _ in range(2))
    for _ in range(2):
        train.fusion_train_step(net, opt, x1, x2, gen)
    got = _trace(lambda: train.fusion_train_step(net, opt, x1, x2, gen), steps)
    del net, opt
    torch.cuda.empty_cache()
    if got is None:
        emit({"phase": "trace_train", "device_time": "not measured (no device events)"})
        return
    window, busy, by_kernel = got
    emit({"phase": "trace_train", "steps": steps, "pairs_per_step": TRAIN_PAIRS,
          "window_ms": window, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / window,
          "device_ms_per_step": {k: v / 1e3 / steps for k, v in by_kernel.most_common()}})


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    t_start = time.perf_counter()
    dev = select_device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    global SFU_CALLS_PER_S
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SFU_CALLS_PER_S = SFU_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "sms": sms, "max_sm_clock_mhz": max_sm_mhz,
          "special_function_calls_per_s": SFU_CALLS_PER_S,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})

    t0 = time.perf_counter()
    path, log = cuda_lib.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": str(path),
          "ptxas": ptxas})

    calls = main_path_calls(full_config(), PAIRS, SIZE)
    tcalls = train_calls(full_config(), TRAIN_PAIRS, SIZE)
    serving = phase_kernels(calls, dev)
    checked = {}
    results = phase_kernel_train(tcalls, dev, TRAIN_PAIRS, checked)
    for pairs in SEG_PAIRS:
        per_step = phase_kernel_train(train_calls(full_config(), pairs, SIZE), dev, pairs,
                                      checked)
        emit({"phase": "kernel_train_step", "pairs": pairs, "per_step": {
            k: _brief(r) for k, r in per_step.items()}})
    emit({"phase": "kernel_train_step", "pairs": TRAIN_PAIRS, "per_step": {
        k: _brief(r) for k, r in results.items()}})
    phase_mlp_paths(tcalls["mlp"], dev)
    phase_scan_paths(tcalls["scan"], calls["scan"],
                     fullres_scan_shapes(full_config(), 2 * TRAIN_PAIRS, SIZE), dev)
    phase_fullres_ss2d(dev)
    emit({"phase": "kernel", "per_forward_of_serving": {
        k: {m: v for m, v in _summary(r).items() if m not in ("bytes_ms", "ops_ms", "sfu_ms")
            and (k in TENSOR_CORE_KERNELS or m != "fp32_cores_bound_ms")}
        for k, r in serving.items()}})
    with tempfile.TemporaryDirectory() as serving_dir:
        phase_main_path(calls, smi, serving_dir)
        phase_evaluate(serving_dir)
    phase_parity(dev)
    launches = phase_train(tcalls, smi)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        _write_pst900(root, {"train": TRAIN_PAIRS * DISK_STEPS, "test": SEG_TEST_PAIRS})
        write_s = time.perf_counter() - t0
        phase_train_disk(tcalls, smi, root, write_s)
        ckpt, seg_launches = phase_train_seg(smi, root, os.path.join(root, "ckpt"))
        phase_evaluate_seg(ckpt, root)
    phase_train_parity(dev)
    phase_seg_parity(dev)
    phase_trace(dev)
    phase_trace_train(dev)

    kernels = []
    for k, (route, source, replaces) in KERNELS.items():
        r = _summary(results[k])
        kernels.append({
            "name": k, "route": route, "source": source, "replaces": replaces,
            "launches": launches[k], "launches_train_seg": seg_launches[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            **_bound_by(k, r["bytes_ms"], r["ops_ms"], r["sfu_ms"]),
            "library_ms": r["library_ms"], "device_ms": r["device_ms"], "shapes": r["shapes"],
            "device_shapes_covered": r["device_shapes_covered"],
            "library_device_ms": r["library_device_ms"],
            "ms_at_library_shapes": r["ms_at_library_shapes"],
            "device_ms_at_library_shapes": r["device_ms_at_library_shapes"],
            **({"fp32_cores_bound_ms": r["fp32_cores_bound_ms"]}
               if k in TENSOR_CORE_KERNELS else {})})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "times": "per training step of the main path (full config, 6 pairs of 256^2): "
                   "sum over its shapes of calls x time; launches from the 12-step run, "
                   "launches_train_seg from the segmentation CLI's PST900 run"})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})


if __name__ == "__main__":
    main()
