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
     kernel_bf16 - each of the ten kernels' bf16-I/O variants at the
               training step's shapes (6 pairs; the encoder runs 12) on the
               bf16 inputs a bf16 step hands it, against its plain version:
               the output and every gradient (each in its input's dtype)
               within 8e-3 |plain| + 8e-3 max|plain|, two launches
               bit-identical, its time and device time beside the fp32
               kernel's device time, and the bf16 bound (bytes halved where
               the I/O is bf16, the MLP's products at the bf16 rate); a
               `kernel_bf16_step` line sums them a step.
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
     lm_scan_paths - the scan kernel at the Mamba LM's shapes: K = 1 and a
               full-rank dt (R = 0), d_inner 1536, L = 2048, batch 1 and 4, and
               the parity config's shape; L cut as the wrapper cuts it and as
               one chunk, each against the plain version and bit-identical
               twice, with times and the bound (the full dt's bytes counted).
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
     sync_free - a warm fusion step (6 pairs) and a warm segmentation step
               (mode both, class weights on the card, 2 pairs) at full width,
               fp32 and bf16, under torch.cuda.set_sync_debug_mode("error"):
               neither synchronises with the host; the fusion loss with its
               cached band matrices bit-identical to the uncached one.
     train_bf16 - the training CLI as in train with `--precision bf16`, 4
               steps on 24 pairs: every loss finite, the checkpoint fp32 and
               loading strictly, each kernel's bf16 launches equal to 4 times
               the config's calls a step and no fp32 launch; the median step
               and pairs/s beside train's.
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
     visualize_seg - `python -m fusionmamba_torch.visualize_segmentation` of
               the PST900 checkpoint on its 6 test pairs, batch 1: the launch
               counters (zeroed just before) equal to 6 batch-1 forwards, six
               256 x 1280 x 3 grids; seconds a sample.
     seg_tools - `fusionmamba_torch.tools.color_convert` rgb2y and y2rgb on
               the folder's test RGB images, `tools.check_dataset` classes,
               dist (6 pairs a split) and macc: the class counts equal a numpy
               recount of the label PNGs.
     visualize_kernel - the five forward kernels at the batch-1 shapes, as
               in 3; batch1_vs_batch2 - their device time a forward at batch 1
               and at batch 2, the two measured in turns.
     lm_score - `MambaLMHeadModel` at mamba-130m's widths (d_model 768, 24
               layers, vocabulary 50280, RMSNorm), weights from seed 0: 4
               random sequences of 2048 tokens in inference_mode, 6 forwards
               with the counters zeroed just before (24 scan launches each, no
               other kernel), finite logits, tokens/s over 5 warm forwards,
               then one traced forward (the scan's share of the device time).
     lm_decode - the cached decode step at each of 2 x 256 positions against
               the full forward's logits there (1e-3 of the largest |logit|),
               with no scan launch.
     lm_generate - `generate` at 4 prompts of 32 tokens, 64 new tokens, greedy
               and sampled (temperature 0.7, top-p 0.9, repetition penalty
               1.2), per-token loop and CUDA-graph decode from one generator
               seed, twice each: identical tokens, no scan launch; new tokens/s
               and the graph's capture time.
     lm_parity - a small LM (d_model 64, 2 layers, vocabulary 256) on the card
               and on the CPU from one state dict: logits within 1e-4, 16
               greedy tokens identical.
     parallel_kernels - every kernel at the shapes one rank of a 2-rank mesh
               gives it (batch 3 a rank under --mesh 2,1; d_inner and the MLP's
               hidden halved under 1,2; L halved, down to 8 steps, under 1,2
               with the sequence-parallel scan) that no earlier phase checked,
               forward and backward as in 4, and a step's sums a rank.
  8. train_parity - the same seeded weights and batches at the test config
               (64^2, batch 2), 5 steps on the card and on the CPU: each
               step's loss and every parameter's step-0 gradient.
     train_bf16_parity - the same in bf16 (kernels' bf16 variants on the
               card, plain versions on the CPU): each loss within 1e-2
               relative, the masters fp32.
     seg_parity - VSSMFusionSeg at the test config (64^2, batch 2) on the
               card and on the CPU from the same weights, batches and dropout
               masks: eval-mode logits and fusion output, then 3 steps of
               `seg_train_step` (mode both, improved loss): each loss, and
               the BatchNorm running statistics after them.
     one_rank_reference, ddp_train, tp_train, sp_train - the training CLI at
               full width, batch 6, 3 steps on 18 synthetic pairs: on one rank
               in a process of its own, then on two ranks sharing cuda:0 over
               gloo (each spawned with torchrun's environment) under --mesh 2,1, 1,2 and
               1,2 --scan_impl sp: each rank's launch counts (zeroed in the rank
               just before) equal to 3 x the calls a step the config gives one
               rank, the losses and the gathered checkpoint equal to the
               one-rank run's; pairs/s (the ranks share the card: no scaling
               measure) and peak memory a rank.
     remat_train - 3 steps of batch 6 with no remat, remat_light and remat:
               the same losses, launch counts with remat's repeated forward
               calls, peak memory of each.
  9. trace   - torch.profiler over three warm forwards of a batch of 8: device
               time by kernel and the card's idle share of the window.
 10. trace_train - the same over three warm training steps of 6 pairs, with
               forward and backward kernels apart; trace_train_bf16 the same
               at --precision bf16.
Then the card's name and power limit as nvidia-smi gives them, the kernels
line (all ten kernels, timed per training step; a kernel's device total sums
the shapes the profiler timed, `device_shapes_covered` of `shapes`; launches
of the training run, of the segmentation CLI's PST900 run, of the LM's scoring
forwards and of visualize_segmentation's run; bf16_launches of the bf16
training run and the bf16 variant's times, error and bound from
kernel_bf16), and the result line.
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

from fusionmamba_torch import (evaluate_segmentation, infer, train, train_segmentation,
                               visualize_segmentation)
from fusionmamba_torch.checkpoints import load_reference_checkpoint
from fusionmamba_torch.config import full_config, test_config
from fusionmamba_torch.data import SyntheticFusionDataset, batch_iterator
from fusionmamba_torch.device import select_device
from fusionmamba_torch.losses import compute_class_weights
from fusionmamba_torch.models import VSSMFusion, VSSMFusionSeg
from fusionmamba_torch.models.mamba_lm import MambaLMHeadModel, decode_graph, generate
from fusionmamba_torch.nn import SS2D, init_lm_weights, init_weights
from fusionmamba_torch.ops import cuda_lib, dwconv, layer_norm, ln_triton, mlp, scan_cuda
from fusionmamba_torch.ops.selective_scan import selective_scan, selective_scan_plain
from fusionmamba_torch.tools import check_dataset, color_convert

PAIRS, SIZE, N_IMAGES = 8, 256, 20
TRAIN_PAIRS, TRAIN_STEPS = 6, 12   # the reference's batch; 72 synthetic pairs
# training from a PST900 folder: steps, PST900's image size (H, W), loader threads
DISK_STEPS, DISK_SIZE, DISK_WORKERS = 4, (720, 1280), 8
# segmentation: the batches of PST900 (`train_segmentation.py:128`) and of the
# other datasets (the CLI's default); the PST900 run's 12 steps go over the
# same 24 training pairs as train_disk, its evaluation over 6 test pairs
SEG_PAIRS, SEG_PST900_STEPS, SEG_TEST_PAIRS = (2, 4), 12, 6
# visualize_segmentation: the PST900 checkpoint on the 6 test pairs, batch 1
VIS_SAMPLES = 6
# the Mamba LM at mamba-130m's widths (the JAX MambaLMHeadModel defaults:
# d_model 768, 24 layers, d_state 16, d_inner 1536, dt_rank 48; RMSNorm as the
# released checkpoints), its vocabulary 50277 padded to a multiple of 8.
# Scoring: 4 sequences of 2048 tokens, 5 warm forwards timed; the decode check:
# 2 x 256 positions; generation: 4 prompts of 32 tokens, 64 new tokens
LM_VOCAB, LM_WIDTH, LM_LAYERS = 50280, 768, 24
LM_SCORE_BATCH, LM_SCORE_LEN, LM_SCORE_REPS = 4, 2048, 5
LM_DECODE_BATCH, LM_DECODE_LEN = 2, 256
LM_GEN_BATCH, LM_GEN_PROMPT, LM_GEN_NEW = 4, 32, 64
# card vs CPU at a small LM: d_model 64, 2 layers, vocab 256, 2 x 64 tokens
LM_PARITY_WIDTH, LM_PARITY_LAYERS, LM_PARITY_VOCAB = 64, 2, 256
LM_PARITY_BATCH, LM_PARITY_LEN = 2, 64
# multi-rank training: two ranks on the one card over gloo, 3 steps of the
# training batch each; name -> (mesh, scan_impl)
MULTI_RANK_RUNS = {"ddp_train": ("2,1", "adaptive"), "tp_train": ("1,2", "adaptive"),
                   "sp_train": ("1,2", "sp")}
MULTI_RANK_STEPS = 3
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12          # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
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
# the LM's cached decode step against its full forward, at every position:
# the step's plain-torch exp against the scan kernel's ex2.approx (2 ulp a
# step), through 24 layers and the tied head; 1e-3 of the largest |logit|
LM_DECODE_RTOL = 1e-3
# the small LM on the card against the CPU: two layers and a 256-word head,
# each a fp32 sum in another order
LM_PARITY_ATOL = 1e-4
# remat against none over 3 steps: the same deterministic kernels on the same
# inputs, but a parameter read twice in a block (BiAttn) sums its two
# gradients in another order, and Adam turns a last-bit change of a
# near-zero gradient into a full lr step
REMAT_LOSS_RTOL = 1e-5
# a bf16 kernel against its plain version on the same bf16 inputs: both
# compute in fp32 and round to bf16 at the same places, but fp32 sums in
# another order can move a value across a rounding boundary; each output and
# each gradient is held to two bf16 ulps of the plain value plus two of the
# tensor's largest entry, |err| <= 8e-3 |plain| + 8e-3 max|plain|
BF16_RTOL = BF16_ATOL_OF_MAX = 8e-3
# bf16 training: 4 steps of the training batch through the CLI; card vs CPU
# at the test config, each loss within 1e-2 relative (bf16 keeps about 3
# significant digits, and the card's and the CPU's products and sums round
# in other orders through the whole network)
TRAIN_BF16_STEPS = 4
TRAIN_BF16_LOSS_RTOL = 1e-2

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


def main_path_calls(cfg, pairs: int, size: int, part: str = "forward", n_model: int = 1):
    """op -> Counter(shape -> calls) for one forward of VSSMFusion(cfg) on
    `pairs` pairs of size x size (`part` "forward"), for its backward
    ("backward": the same calls but those of the finest VSSBlockCross, whose
    output the decoder never reads, as in the reference, so no gradient runs
    through it), or for the forward calls that its backward makes again
    ("recompute": with cfg.remat every VSSBlock's, with cfg.remat_light each
    VSSBlock's two LN-means and its MLP). On one rank of a mesh whose model
    axis has `n_model` ranks, the shapes are the rank's: SS2D modules whose
    in_proj is column-parallel (2 * d_inner >= 128) run the dwconv and the
    scan on d_inner / n_model channels, their out_norm on all of them; MLPs
    whose hidden is >= 128 run on hidden / n_model; with cfg.scan_impl "sp"
    every scan runs on all its channels and L / n_model steps. Shapes: scan
    (B, K, L, D, R), K = 4; layer_norm (rows, C, gate); ln_mean (B, rows, C);
    dwconv (B, H, W, C); mlp (M, C, hidden)."""
    calls = {k: collections.Counter() for k in OPS}
    g0, nl = size // cfg.patch_size, len(cfg.dims)
    sp = cfg.scan_impl == "sp" and n_model > 1
    recompute = part == "recompute"

    def ln(rows, C, gate="none"):
        calls["layer_norm"][(rows, C, gate)] += 1

    def ssm(B, g, C, convs, gate):
        d = int(cfg.ssm_ratio * C)
        dc = d // n_model if n_model > 1 and 2 * d >= 128 else d
        L, R = ((g + 1) // 2) ** 2, math.ceil(C / 16)
        calls["dwconv"][(B, g, g, dc)] += convs
        calls["scan"][(B, 4, L // n_model, d, R) if sp else (B, 4, L, dc, R)] += 1
        ln(B * g * g, d, gate)

    def vss_block(B, g, C):
        hidden = int(C * cfg.mlp_ratio)
        if n_model > 1 and hidden >= 128:
            hidden //= n_model
        whole = not recompute or cfg.remat
        if recompute and not (cfg.remat or cfg.remat_light):
            return
        if whole:
            ln(B * g * g, C)
            ssm(B, g, C, 1, "silu")
        calls["ln_mean"][(B, g * g, C)] += 2
        if whole:
            ln(B * g * g, C)
        calls["mlp"][(B * g * g, C, hidden)] += 1

    for _ in range(0 if recompute else 2):               # patch embeds
        ln(pairs * g0 * g0, cfg.dims[0])
    for i, C in enumerate(cfg.dims):                     # shared encoder, 2B
        g = g0 >> i
        for _ in range(cfg.depths[i]):
            vss_block(2 * pairs, g, C)
        if i < nl - 1 and not recompute:
            ln(2 * pairs * (g // 2) ** 2, 4 * C)
    for i, C in enumerate(cfg.dims):                     # cross blocks
        if recompute or (part == "backward" and i == 0):
            continue
        g = g0 >> i
        ln(pairs * g * g, C)
        ln(pairs * g * g, C)
        ssm(pairs, g, C, 2, "silu_sum")
    for i, C in enumerate(cfg.dims_decoder):             # decoder
        g = g0 >> (nl - 1 - i)
        if i > 0 and not recompute:
            ln(pairs * g * g, C)
        for _ in range(cfg.depths_decoder[i]):
            vss_block(pairs, g, C)
    if not recompute:
        ln(pairs * (4 * g0) ** 2, cfg.dims_decoder[-1] // 4)  # final_up
    return calls


def train_calls(cfg, pairs: int, size: int, n_model: int = 1):
    """kernel -> Counter(shape -> calls) for one training step on one rank,
    all ten kernels: the forward kernels' calls (those that remat repeats in
    the backward included) and the backward kernels'."""
    fwd, rec, bwd = (main_path_calls(cfg, pairs, size, part, n_model)
                     for part in ("forward", "recompute", "backward"))
    return {**{k: fwd[k] + rec[k] for k in fwd}, **{k + "_bwd": c for k, c in bwd.items()}}


def bytes_and_ops(kernel: str, shape, io: int = 4):
    """Bytes each call must move (inputs read once, outputs written once),
    the operations it does and, for the scans, its calls of the
    special-function units. `io` is the bytes of an element of the kernel's
    I/O tensors (4 for fp32, 2 for its bf16 variant: the activations, the
    scan's dt, B, C and low-rank weight, the MLP's weights); what the kernels
    read as fp32 whatever the I/O (the scan's A, D, bias and saved states,
    the LN's and the dwconv's parameters, the LN-mean's output and
    cotangent, every parameter gradient they sum in fp32 but the scan's dW
    and the MLP's) counts 4. A backward reads its forward's inputs and the
    cotangent and writes a gradient for each input; it recomputes what its
    forward computed."""
    if kernel == "scan":
        B, K, L, D, R = shape
        N = 16
        elems = B * K * L * D
        # dt: the low-rank (B, K, L, R), or at R = 0 the full (B, K, L, D)
        dt = B * K * L * (R or D)
        nbytes = io * (2 * elems + dt + 2 * B * K * L * N + K * D * R) + 4 * K * D * (N + 2)
        # per state: the exponent, the input term, two FMAs; the dt expansion
        # and softplus. Special functions: an exp per state, softplus' exp and log
        return nbytes, elems * (2 * R + 7 + 7 * N), elems * (N + 2)
    if kernel == "scan_bwd":
        B, K, L, D, R = shape
        N = 16
        elems = B * K * L * D
        dt = B * K * L * (R or D)
        # also reads the states the forward saved every SAVE_EVERY steps
        nbytes = (io * (3 * elems + 2 * (dt + 2 * B * K * L * N) + 2 * K * D * R)
                  + 4 * (elems * N // scan_cuda.SAVE_EVERY + 2 * K * D * (N + 2)))
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
        return io * n * (2 + (gate != "none")) + 4 * 2 * C, n * (7 + _GATE_OPS[gate]), 0
    if kernel == "layer_norm_bwd":
        rows, C, gate = shape
        n = rows * C
        return (io * n * (3 + 2 * (gate != "none")) + 4 * 4 * C,
                n * (16 + 2 * _GATE_OPS[gate]), 0)
    if kernel == "ln_mean":
        B, rows, C = shape
        return io * B * rows * C + 4 * (B * C + 2 * C), 8 * B * rows * C, 0
    if kernel == "ln_mean_bwd":
        B, rows, C = shape
        return io * 2 * B * rows * C + 4 * (B * C + 3 * C), 12 * B * rows * C, 0
    if kernel in ("dwconv", "dwconv_bwd"):
        B, H, W, C = shape
        n = B * H * W * C
        if kernel == "dwconv":
            return io * 2 * n + 4 * 10 * C, n * (18 + 1 + 4), 0
        # pre (18), silu' (8), dx (18), dw (18), dbias (1)
        return io * 3 * n + 4 * 20 * C, n * 63, 0
    M, C, H = shape
    if kernel == "mlp":
        return io * (2 * M * C + 2 * C * H + H + C), M * (4 * C * H + 10 * H), 0
    # five products of 2*M*C*H (h, dy W2, dx, dW1, dW2), GELU and its slope
    return io * (3 * M * C + 4 * C * H + 2 * H + 2 * C), M * (10 * C * H + 30 * H), 0


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


def make_case(kernel, shape, dev, gen, dtype=torch.float32):
    """(inputs, op, plain, library or None, backward) on seeded inputs at
    `shape`, scaled as the model's activations and parameters are: op,
    plain and library take the inputs; backward(inputs, dy) calls the
    backward kernel's wrapper directly. With dtype bf16 the inputs are the
    bf16 casts that a bf16 training step hands the ops (the parameters
    included; the scan's A, D and bias stay fp32, as SS2D passes them), and
    the backward passes what its kernel reads as fp32 as fp32, as the ops do
    (`.float()` is the identity on an fp32 tensor)."""
    def rnd(*s, scale=1.0, shift=0.0):
        return torch.randn(*s, device=dev, generator=gen) * scale + shift

    if kernel == "scan":
        # K directions; at R = 0 the dt is full-rank (the Mamba LM's) and
        # there is no low-rank weight
        B, K, L, D, R = shape
        N = 16
        inputs = [rnd(B, K, L, D), rnd(B, K, L, R or D, scale=0.5),
                  -torch.arange(1.0, N + 1, device=dev).expand(K, D, N).contiguous(),
                  rnd(B, K, L, N), rnd(B, K, L, N), rnd(K, D, scale=0.1, shift=1.0),
                  rnd(K, D, scale=1.0, shift=-4.0),
                  rnd(K, D, R, scale=R ** -0.5) if R else None]
        inputs = [t if t is None or i in (2, 5, 6) else t.to(dtype) for i, t in enumerate(inputs)]

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
        inputs = [t.to(dtype) for t in inputs]

        def backward(t, dy):
            return lambda: layer_norm.layer_norm_bwd(t[0], t[1].float(), t[2].float(),
                                                     t[3] if len(t) > 3 else None, dy, 1e-6,
                                                     gate_act)

        # F.layer_norm computes the same function only without a gate
        library = (lambda x, s, b: F.layer_norm(x, (C,), s, b, 1e-6)) if gate_act == "none" \
            else None
        return (inputs, lambda *t: layer_norm.layer_norm_fused(*t, eps=1e-6, gate_act=gate_act),
                lambda *t: layer_norm.layer_norm_plain(*t, eps=1e-6, gate_act=gate_act),
                library, backward)
    if kernel == "ln_mean":
        B, rows, C = shape
        return ([t.to(dtype) for t in (rnd(B, rows, C, scale=2.0, shift=0.5), rnd(C), rnd(C))],
                lambda *t: layer_norm.ln_spatial_mean(*t, 1e-5),
                lambda *t: layer_norm.ln_spatial_mean_plain(*t, 1e-5), None,
                lambda t, dm: lambda: layer_norm.ln_spatial_mean_bwd(t[0], t[1].float(), dm,
                                                                     1e-5))
    if kernel == "dwconv":
        B, H, W, C = shape
        return ([t.to(dtype) for t in (rnd(B, H, W, C), rnd(3, 3, C, scale=1 / 3),
                                       rnd(C, scale=1 / 3))],
                lambda *t: dwconv.depthwise_conv3x3(*t, "silu"),
                lambda *t: dwconv.depthwise_conv3x3_plain(*t, "silu"),
                lambda x, w, b: F.silu(F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1)[:, None],
                                                b, padding=1, groups=C)).permute(0, 2, 3, 1),
                lambda t, dy: lambda: dwconv.dwconv_bwd(t[0], t[1].float(), t[2].float(), dy,
                                                        "silu"))
    M, C, H = shape
    # nn.Linear's (out, in) weights, passed as `.t()` views as Mlp.forward does
    return ([t.to(dtype) for t in (rnd(M, C), rnd(H, C, scale=0.02), torch.zeros(H, device=dev),
                                   rnd(C, H, scale=0.02), torch.zeros(C, device=dev))],
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


def _bound(kernel, shape, io: int = 4):
    """(bytes ms, operations ms at the rate the kernel's design uses,
    special-function ms, bound ms on the fp32 CUDA cores) at I/O elements of
    `io` bytes. The MLP's products run on the tensor cores: in fp32 at a
    third of the TF32 rate (3xTF32), in bf16 (io 2) the work is bf16
    products at the bf16 rate."""
    nbytes, nops, nsfu = bytes_and_ops(kernel, shape, io)
    bytes_ms, cores_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * nops / FP32_OPS_PER_S
    tensor_rate = TF32_OPS_PER_S / 3 if io == 4 else BF16_OPS_PER_S
    ops_ms = 1e3 * nops / tensor_rate if kernel in TENSOR_CORE_KERNELS else cores_ms
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


def _forward_line(phase, kernel, shape, n, case, pairs=PAIRS, extra=None):
    """Check and time one forward kernel at `shape`; emit its line (with
    `extra`'s fields) and return (err, ms, plain_ms, library_ms, device_ms,
    library_device_ms, bytes_ms, ops_ms, sfu_ms, cores_ms). The scan, the MLP,
    the dwconv and the LN-mean must also repeat themselves bit for bit.
    `pairs` None: the line has none (a shape of the LM)."""
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
    emit({"phase": phase, "kernel": kernel, "shape": list(shape),
          **({} if pairs is None else {"pairs": pairs}), **(extra or {}),
          "calls_per_" + ("step" if phase in ("kernel_train", "parallel_kernels")
                          else "forward"): n,
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


def phase_kernels(calls, dev, phase="kernel", pairs=PAIRS):
    """Each forward kernel at every shape of a forward of `pairs` pairs;
    sums per forward."""
    results = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for kernel, shapes in calls.items():
        agg = _new_agg()
        for shape, n in sorted(shapes.items(), key=str):
            _add(agg, n, *_forward_line(phase, kernel, shape, n,
                                        make_case(kernel, shape, dev, gen), pairs))
        torch.cuda.empty_cache()
        results[kernel] = agg
    return results


def _grads(fn, inputs, dy):
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs, dy)


def _backward_line(op, shape, n_bwd, case, dev, gen, pairs, phase="kernel_train"):
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
    emit({"phase": phase, "kernel": op + "_bwd", "shape": list(shape), "pairs": pairs,
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


def phase_kernel_train(calls, dev, pairs, checked, phase="kernel_train"):
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
                    checked[(op, shape)] = _forward_line(phase, op, shape, n, case, pairs)
                if op + "_bwd" in todo:
                    checked[(op + "_bwd", shape)] = _backward_line(op, shape, n_bwd, case, dev,
                                                                   gen, pairs, phase)
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
    """(B, K, L, D, R) of the scan of an SS2D(scan_variant="fullres") at each
    stage's width, at L = H*W of that stage."""
    g0 = size // cfg.patch_size
    return [(batch, 4, (g0 >> i) ** 2, int(cfg.ssm_ratio * C), math.ceil(C / 16))
            for i, C in enumerate(cfg.dims)]


def phase_scan_paths(train_shapes, serve_shapes, fullres_shapes, dev):
    """The scan kernels at every training and serving shape, and at the
    full-resolution scan's shapes, with L cut into chunks as the wrapper cuts
    it (`scan_cuda._pick_chunk`) and, where that is more than one chunk, also
    with L as one chunk: the forward held against the plain version, the two
    backwards' gradients against each other, and the times of the serving
    forward, the training forward (saving states) and the backward."""
    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = {**{s: ("train", n) for s, n in train_shapes.items()},
              **{s: ("serve", n) for s, n in serve_shapes.items()},
              **{s: ("fullres", None) for s in fullres_shapes}}
    for shape, (path, n) in sorted(shapes.items(), key=str):
        B, K, L, D, R = shape
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


# where each kernel's bf16-variant counter lives (the counters above count
# the launches of both variants)
_BF16_COUNTERS = {k: (module, "bf16_" + name) for k, (module, name) in _COUNTERS.items()}


def read_launches(kernels=KERNELS, bf16=False):
    return {k: getattr(*(_BF16_COUNTERS if bf16 else _COUNTERS)[k]) for k in kernels}


def zero_launches():
    for module, name in (*_COUNTERS.values(), *_BF16_COUNTERS.values()):
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
    ten launch counts and the phase's line."""
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
    line = {"phase": "train", "steps": stats["steps"], "pairs_per_step": TRAIN_PAIRS,
            "losses": stats["losses"], "launches": launches, "expected_launches": expected,
            "calls_per_step": {k: sum(c.values()) for k, c in calls.items()},
            "first_step_s": stats["step_seconds"][0], "step_seconds": stats["step_seconds"],
            "median_warm_step_s": float(np.median(warm)),
            "pairs_per_s": TRAIN_PAIRS / float(np.median(warm)),
            "warm_run_pairs_per_s": TRAIN_PAIRS * len(warm) / float(np.sum(warm)),
            "cli_seconds": stats["seconds"], "card": smi}
    emit(line)
    return launches, line


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


def _bf16_check(got, want):
    """(max abs error, within BF16_RTOL |want| + BF16_ATOL_OF_MAX max|want|
    and of want's dtype)."""
    g, w = got.float(), want.float()
    e = (g - w).abs()
    ok = bool(torch.all(e <= BF16_RTOL * w.abs() + BF16_ATOL_OF_MAX * float(w.abs().max())))
    return float(e.max()), ok and got.dtype == want.dtype


def phase_kernel_bf16(tcalls, dev, checked, smi):
    """Each of the ten kernels' bf16 variants at every shape of a training
    step (6 pairs; the encoder runs 12), on the bf16 inputs a bf16 step
    hands it, against its plain version on the same inputs: the output (and
    through the op's autograd Function every input's gradient, each in its
    input's dtype) within BF16_RTOL / BF16_ATOL_OF_MAX, two launches
    bit-identical, the kernel's time and device time beside the fp32
    kernel's device time at the shape (kernel_train's, from `checked`), and
    the bf16 bound (bytes halved where I/O is bf16; the MLP's products at the
    bf16 rate). Returns the per-step sums of each kernel."""
    gen = torch.Generator(device=dev).manual_seed(7)
    sums = {}
    for op in OPS:
        for k in (op, op + "_bwd"):
            sums[k] = dict(device_ms=0.0, fp32_device_ms=0.0, ms=0.0, bound_ms=0.0,
                           fp32_bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, sfu_ms=0.0,
                           max_abs_err=0.0, shapes=0)
        for shape, n in sorted(tcalls[op].items(), key=str):
            n_bwd = tcalls[op + "_bwd"][shape]
            inputs, fn, plain, _, backward = make_case(op, shape, dev, gen, torch.bfloat16)
            reps = 5 if op == "scan" else 20
            for k, calls in [(op, n)] + ([(op + "_bwd", n_bwd)] if n_bwd else []):
                if k == op:
                    with torch.no_grad():
                        got, again, want = fn(*inputs), fn(*inputs), plain(*inputs)
                        torch.cuda.synchronize()
                        err, ok = _bf16_check(got, want)
                        same = torch.equal(got, again)

                        def run():
                            return fn(*inputs)

                        ms, dev_ms = cuda_ms(run, reps), device_ms(run)
                else:
                    live = [t.detach().requires_grad_(True) for t in inputs]
                    with torch.no_grad():
                        out = fn(*live)
                    dy = torch.randn(out.shape, device=dev, generator=gen).to(out.dtype)
                    del out
                    got, want = _grads(fn, live, dy), _grads(plain, live, dy)
                    torch.cuda.synchronize()
                    err, ok = 0.0, True
                    for t, g, w in zip(live, got, want):
                        e, good = _bf16_check(g, w)
                        err, ok = max(err, e), ok and good and g.dtype == t.dtype
                    with torch.no_grad():
                        run = backward([t.detach() for t in inputs], dy)
                        first, second = run(), run()
                        torch.cuda.synchronize()
                        same = all(torch.equal(a, b) for a, b in zip(first, second)
                                   if a is not None)
                        ms, dev_ms = cuda_ms(run, reps), device_ms(run)
                b = _bound(k, shape, io=2)
                fp32_dev = checked[(k, shape)][4]
                fp32_bound = max(_bound(k, shape)[:3])
                emit({"phase": "kernel_bf16", "kernel": k, "shape": list(shape),
                      "pairs": TRAIN_PAIRS, "calls_per_step": calls, "max_abs_err": err,
                      "rtol": BF16_RTOL, "atol_of_max": BF16_ATOL_OF_MAX, "ok": ok,
                      "bit_identical_twice": same, "kernel_ms": ms, "kernel_device_ms": dev_ms,
                      "fp32_kernel_device_ms": fp32_dev, "fp32_bound_ms": fp32_bound,
                      **_bound_fields(k, *b, dev_ms), "card": smi})
                if not ok:
                    fail(f"{k} bf16 at {shape} disagrees with its plain version "
                         f"(max abs err {err})")
                if not same:
                    fail(f"{k} bf16 at {shape} differs between two launches")
                agg = sums[k]
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                agg["shapes"] += 1
                agg["ms"] += calls * ms
                agg["device_ms"] += calls * (dev_ms or 0.0)
                agg["fp32_device_ms"] += calls * (fp32_dev or 0.0)
                agg["bound_ms"] += calls * max(b[:3])
                agg["fp32_bound_ms"] += calls * fp32_bound
                for name, v in zip(("bytes_ms", "ops_ms", "sfu_ms"), b[:3]):
                    agg[name] += calls * v
            del inputs
        torch.cuda.empty_cache()
    emit({"phase": "kernel_bf16_step", "pairs": TRAIN_PAIRS, "per_step": sums, "card": smi})
    return sums


def phase_sync_free(dev, smi):
    """A warm fusion step (full config, 6 pairs) and a warm segmentation
    step (mode both, the improved loss with class weights on the card, 2
    pairs), each at fp32 and at bf16, under
    torch.cuda.set_sync_debug_mode("error"): no host-device synchronisation
    inside either step; and the fusion loss with its cached band matrices
    bit-identical to the loss with fresh ones (the parent's formula)."""
    from fusionmamba_torch.losses import fusion_loss
    ssim_mod = sys.modules["fusionmamba_torch.losses.ssim"]
    rng = np.random.default_rng(9)

    def images(b):
        return [torch.from_numpy((0.02 + 0.2 * rng.uniform(0, 1, (b, SIZE, SIZE, 1))).astype(
            np.float32)).to(dev) for _ in range(2)]

    vis, ir = images(TRAIN_PAIRS)
    svis, sir = images(SEG_PAIRS[0])
    lbl = torch.from_numpy(rng.integers(0, 5, (SEG_PAIRS[0], SIZE, SIZE))).to(dev)
    weights = compute_class_weights([9e3, 3e2, 1e3, 2e2, 4e3]).to(dev)
    line = {"phase": "sync_free", "card": smi}
    for precision in ("fp32", "bf16"):
        dtype = train.resolve_compute_dtype(precision)
        net = init_weights(VSSMFusion(full_config()), seed=0).to(dev)
        opt = train.make_fusion_optimizer(net.parameters())
        seg = init_weights(VSSMFusionSeg(full_config(num_seg_classes=5)), seed=0).to(dev)
        seg_opt = train.make_seg_optimizer(seg.parameters())
        gen = torch.Generator(device=dev).manual_seed(0)

        def steps():
            a = train.fusion_train_step(net, opt, vis, ir, gen, compute_dtype=dtype)
            b = train.seg_train_step(seg, seg_opt, svis, sir, lbl, num_classes=5, mode="both",
                                     class_weights=weights, improved=True, generator=gen,
                                     compute_dtype=dtype)
            return a, b

        steps()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a, b = steps()
        except RuntimeError as e:
            fail(f"a warm {precision} training step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        vals = [float(v) for v in (*a.values(), *b.values())]
        if not all(math.isfinite(v) for v in vals):
            fail(f"sync_free {precision}: losses {vals}")
        line[precision + "_losses"] = vals
        del net, opt, seg, seg_opt
        torch.cuda.empty_cache()
    cached = fusion_loss(vis, ir, vis.flip(0))
    orig = ssim_mod.band_tensor
    ssim_mod.band_tensor = lambda taps, L, same, device: torch.from_numpy(
        ssim_mod.band_matrix(taps, L, same)).to(device)
    try:
        fresh = fusion_loss(vis, ir, vis.flip(0))
    finally:
        ssim_mod.band_tensor = orig
    line["loss_bit_identical_to_uncached"] = all(torch.equal(x, y) for x, y in zip(cached, fresh))
    emit(line)
    if not line["loss_bit_identical_to_uncached"]:
        fail("the fusion loss with cached band matrices differs from the uncached one")


def phase_train_bf16(tcalls, smi, fp32_line):
    """`python -m fusionmamba_torch.train --model full -B 6 -E 1 --synthetic
    24 -j 0 --precision bf16`: 4 mixed-precision steps. Every loss finite,
    the saved state dict fp32 and loading strictly, each kernel's bf16
    launches equal to 4 x the config's calls a step and no fp32 launch; the
    median step and pairs/s beside the fp32 train phase's of this call (no
    claim: bf16 is not tuned for speed yet)."""
    steps = TRAIN_BF16_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", str(TRAIN_PAIRS * steps), "-B", str(TRAIN_PAIRS), "-E", "1",
                "-j", "0", "--model", "full", "--device", "cuda", "--ckpt_dir", tmp,
                "--precision", "bf16"]
        zero_launches()
        stats = train.main(argv)
        torch.cuda.synchronize()
        total, bf16 = read_launches(), read_launches(bf16=True)
        path = os.path.join(tmp, "fusion_model_pst900.pth")
        saved = torch.load(path, weights_only=True)
        fp32_saved = all(v.dtype == torch.float32 for v in saved.values() if v.is_floating_point())
        load_reference_checkpoint(VSSMFusion(full_config()), path)
    torch.cuda.empty_cache()
    expected = {k: stats["steps"] * sum(c.values()) for k, c in tcalls.items()}
    fp32_launches = {k: total[k] - bf16[k] for k in total}
    warm = stats["step_seconds"][1:]
    emit({"phase": "train_bf16", "steps": stats["steps"], "pairs_per_step": TRAIN_PAIRS,
          "losses": stats["losses"], "bf16_launches": bf16, "fp32_launches": fp32_launches,
          "expected_bf16_launches": expected, "checkpoint_fp32": fp32_saved,
          "first_step_s": stats["step_seconds"][0], "step_seconds": stats["step_seconds"],
          "median_warm_step_s": float(np.median(warm)),
          "pairs_per_s": TRAIN_PAIRS / float(np.median(warm)),
          "fp32_median_warm_step_s": fp32_line["median_warm_step_s"],
          "fp32_pairs_per_s": fp32_line["pairs_per_s"], "card": smi})
    if stats["steps"] != steps or not all(math.isfinite(v) for v in stats["losses"]):
        fail(f"bf16 training ran {stats['steps']} steps with losses {stats['losses']}")
    if not fp32_saved:
        fail("bf16 training saved a state dict that is not fp32")
    if bf16 != expected or any(fp32_launches.values()):
        fail(f"bf16 training launches: bf16 {bf16} (expected {expected}), fp32 {fp32_launches}")
    return bf16


def phase_train_bf16_parity(dev, smi, steps: int = 5):
    """The same seeded weights and batches at the test config (64^2, batch 2)
    in bf16, 5 steps on the card (kernels) and on the CPU (plain versions):
    each loss within TRAIN_BF16_LOSS_RTOL; the masters stay fp32."""
    ds = SyntheticFusionDataset(length=2 * steps, size=(64, 64), seed=4)
    batches = list(batch_iterator(ds, 2, shuffle=True, seed=1))
    runs = {}
    for device in (torch.device("cpu"), dev):
        net = init_weights(VSSMFusion(test_config(drop_path_rate=0.0)), seed=0).to(device)
        opt = train.make_fusion_optimizer(net.parameters())
        losses = []
        for vis_y, ir in batches:
            m = train.fusion_train_step(net, opt, torch.from_numpy(vis_y).to(device),
                                        torch.from_numpy(ir).to(device),
                                        compute_dtype=torch.bfloat16)
            losses.append(float(m["loss_total"]))
        if not all(p.dtype == torch.float32 for p in net.parameters()):
            fail("bf16 training left a master parameter that is not fp32")
        runs[device.type] = losses
    rel = [abs(a - b) / abs(a) for a, b in zip(runs["cpu"], runs["cuda"])]
    emit({"phase": "train_bf16_parity", "steps": steps, "losses_cpu": runs["cpu"],
          "losses_card": runs["cuda"], "loss_rel_err": rel, "loss_rtol": TRAIN_BF16_LOSS_RTOL,
          "card": smi})
    if max(rel) > TRAIN_BF16_LOSS_RTOL:
        fail(f"card vs CPU bf16 training: loss rel err {max(rel)}")


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


def phase_lm_scan_paths(dev):
    """The scan kernel at the LM's shapes (K = 1, a full-rank dt, R = 0),
    with L cut as the wrapper cuts it and as one chunk: each against the
    plain version, two launches bit-identical, times, device times and the
    bound with the full dt's bytes. The shapes: mamba-130m's d_inner at
    L = 2048, batch 1 and 4 (the scoring batch), and `lm_parity`'s small LM."""
    gen = torch.Generator(device=dev).manual_seed(8)
    shapes = {(1, 1, LM_SCORE_LEN, 2 * LM_WIDTH, 0): LM_LAYERS,
              (LM_SCORE_BATCH, 1, LM_SCORE_LEN, 2 * LM_WIDTH, 0): LM_LAYERS,
              (LM_PARITY_BATCH, 1, LM_PARITY_LEN, 2 * LM_PARITY_WIDTH, 0): LM_PARITY_LAYERS}
    for shape, n in shapes.items():
        B, K, L, D, R = shape
        case = make_case("scan", shape, dev, gen)
        picked = scan_cuda._pick_chunk(None, B, K, L, D, dev, scan_cuda.FWD_WARPS_PER_SM)
        one = -(-L // 16) * 16
        _forward_line(
            "lm_scan_paths", "scan", shape, n, case, pairs=None,
            extra={"cut": "picked", "chunk": picked, "chunks": -(-L // picked)})
        if picked < one:
            t, plain = case[0], case[2]
            with torch.no_grad():
                want = plain(*t)

                def run():
                    return scan_cuda.selective_scan_fwd(*t[:7], True, t[7], chunk=one)
                got = run()
                same = torch.equal(got, run())
                err = (got - want).abs()
                ok = bool(torch.all(err <= KERNEL_ATOL + KERNEL_RTOL * want.abs()))
                ms, dev_ms = cuda_ms(run, 5), device_ms(run)
            bound = max(_bound("scan", shape)[:3])
            emit({"phase": "lm_scan_paths", "kernel": "scan", "shape": list(shape),
                  "cut": "one_chunk", "chunk": one, "chunks": 1, "max_abs_err": float(err.max()),
                  "ok": ok, "bit_identical_twice": same, "kernel_ms": ms,
                  "kernel_device_ms": dev_ms, "bound_ms": bound,
                  "bound_share_of_device_ms": bound / dev_ms if dev_ms else None})
            if not ok or not same:
                fail(f"scan at {shape} in one chunk: max abs err {float(err.max())}, "
                     f"bit-identical {same}")
        del case
        torch.cuda.empty_cache()


def phase_batch1_vs_batch2(dev, rounds: int = 2):
    """Device ms a forward of each forward kernel at batch 1 (the forward of
    visualize_segmentation) and at batch 2, from one generator's inputs, the
    two batches measured in turns (1, 2, then 2, 1, ...) so that both see the
    card in the same state; a shape's time is the mean over the passes whose
    profiler capture held a device event (None for a kernel with a shape
    that had none in any pass)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    calls = {b: main_path_calls(full_config(), b, SIZE) for b in (1, 2)}
    out = {}
    for kernel in OPS:
        cases = {b: [(n, make_case(kernel, shape, dev, gen))
                     for shape, n in sorted(calls[b][kernel].items(), key=str)] for b in (1, 2)}
        times = {b: [[] for _ in cases[b]] for b in (1, 2)}
        with torch.no_grad():
            for r in range(rounds):
                for b in ((1, 2) if r % 2 == 0 else (2, 1)):
                    for got, (n, (inputs, op, *_)) in zip(times[b], cases[b]):
                        ms = device_ms(lambda: op(*inputs))
                        if ms is not None:
                            got.append(ms)
        sums = {b: None if not all(times[b]) else sum(
            n * float(np.mean(t)) for t, (n, _) in zip(times[b], cases[b])) for b in (1, 2)}
        out[kernel] = {"batch_1": sums[1], "batch_2": sums[2],
                       "ratio": sums[1] / sums[2] if sums[1] and sums[2] else None}
        del cases
        torch.cuda.empty_cache()
    emit({"phase": "batch1_vs_batch2", "rounds": rounds, "device_ms_per_forward": out})


def build_lm(dev):
    """The LM at mamba-130m's widths (RMSNorm, as the released checkpoints),
    weights from seed 0, in eval mode on `dev`."""
    return init_lm_weights(MambaLMHeadModel(LM_VOCAB, LM_WIDTH, LM_LAYERS, rms_norm=True),
                           seed=0).eval().to(dev)


def phase_lm_score(model, dev, smi):
    """Scoring: B = 4 random sequences of L = 2048 tokens through the full
    forward in `inference_mode`, 1 + LM_SCORE_REPS forwards with the launch
    counters zeroed just before: exactly LM_LAYERS scan launches a forward
    and no other kernel's, finite logits; tokens/s over the warm forwards
    (CUDA events); then one traced forward: device time by kernel group and
    the scan's share. Returns the launch counts."""
    gen = torch.Generator(device=dev).manual_seed(9)
    tokens = torch.randint(0, LM_VOCAB, (LM_SCORE_BATCH, LM_SCORE_LEN), device=dev,
                           generator=gen)
    forwards = 1 + LM_SCORE_REPS
    with torch.inference_mode():
        zero_launches()
        t0 = time.perf_counter()
        logits = model(tokens)[0]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        shape = list(logits.shape)
        del logits
        ms = cuda_ms(lambda: model(tokens), LM_SCORE_REPS, warmup=0)
        launches = read_launches()
        got = _trace(lambda: model(tokens), 1)
    expected = {k: forwards * LM_LAYERS if k == "scan" else 0 for k in KERNELS}
    line = {"phase": "lm_score", "batch": LM_SCORE_BATCH, "seq_len": LM_SCORE_LEN,
            "layers": LM_LAYERS, "d_model": LM_WIDTH, "vocab": LM_VOCAB, "forwards": forwards,
            "launches": launches, "expected_launches": expected, "logits_shape": shape,
            "logits_finite": finite, "first_forward_s": first_s, "forward_ms": ms,
            "tokens_per_s": LM_SCORE_BATCH * LM_SCORE_LEN / (ms / 1e3), "card": smi}
    if got is not None:
        window, busy, by_kernel = got
        scan_ms = (by_kernel["scan"] + by_kernel["scan_carry"]) / 1e3
        bound = LM_LAYERS * max(_bound("scan", (LM_SCORE_BATCH, 1, LM_SCORE_LEN,
                                                2 * LM_WIDTH, 0))[:3])
        line.update({"window_ms": window, "device_busy_ms": busy,
                     "device_idle_share": 1.0 - busy / window,
                     "device_ms_by_group": {k: v / 1e3 for k, v in by_kernel.most_common()},
                     "scan_device_ms": scan_ms, "scan_share_of_busy": scan_ms / busy,
                     "scan_bound_ms": bound, "scan_bound_share": bound / scan_ms})
    else:
        line["device_time"] = "not measured (no device events)"
    emit(line)
    if shape != [LM_SCORE_BATCH, LM_SCORE_LEN, LM_VOCAB] or not finite:
        fail(f"LM scoring: logits of shape {shape}, finite {finite}")
    if launches != expected:
        fail(f"LM scoring: launch counts {launches} differ from {expected}")
    return launches


def phase_lm_decode(model, dev):
    """The cached decode step at every position of B = 2 sequences of
    L = 256 tokens against the full forward's logits there, within
    LM_DECODE_RTOL of the largest |logit|; no scan launch while decoding."""
    gen = torch.Generator(device=dev).manual_seed(10)
    tokens = torch.randint(0, LM_VOCAB, (LM_DECODE_BATCH, LM_DECODE_LEN), device=dev,
                           generator=gen)
    with torch.inference_mode():
        full = model(tokens)[0]
        caches = model.init_caches(LM_DECODE_BATCH)
        before = scan_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = torch.zeros((), device=dev)
        for i in range(LM_DECODE_LEN):
            step = model(tokens[:, i:i + 1], caches)[0]
            err = torch.maximum(err, (step - full[:, i:i + 1]).abs().max())
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / LM_DECODE_LEN
        scans = scan_cuda.launches - before
        top = float(full.abs().max())
    err = float(err)
    emit({"phase": "lm_decode", "batch": LM_DECODE_BATCH, "positions": LM_DECODE_LEN,
          "max_abs_err": err, "max_abs_logit": top, "rtol_of_max_logit": LM_DECODE_RTOL,
          "err_over_max_logit": err / top, "scan_launches_while_decoding": scans,
          "decode_step_ms": step_ms})
    if not err <= LM_DECODE_RTOL * top:
        fail(f"LM decode vs full forward: max abs err {err} > {LM_DECODE_RTOL} x {top}")
    if scans:
        fail(f"LM decode launched the scan kernel {scans} times")


def phase_lm_parity(dev):
    """A small LM (d_model 64, 2 layers, vocab 256) on the card and on the
    CPU from one state dict: logits within LM_PARITY_ATOL, and 16 greedy
    tokens (the card's through the captured decode step) identical."""
    cpu = init_lm_weights(MambaLMHeadModel(LM_PARITY_VOCAB, LM_PARITY_WIDTH, LM_PARITY_LAYERS,
                                           rms_norm=True), seed=1).eval()
    card = MambaLMHeadModel(LM_PARITY_VOCAB, LM_PARITY_WIDTH, LM_PARITY_LAYERS, rms_norm=True)
    card.load_state_dict(cpu.state_dict())
    card.eval().to(dev)
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, LM_PARITY_VOCAB, (LM_PARITY_BATCH, LM_PARITY_LEN), generator=gen)
    with torch.inference_mode():
        err = float((card(tokens.to(dev))[0].cpu() - cpu(tokens)[0]).abs().max())
    prompt = tokens[:, :8]
    want = generate(cpu, prompt, 16, temperature=0.0)
    got = generate(card, prompt.to(dev), 16, temperature=0.0).cpu()
    same = torch.equal(got, want)
    emit({"phase": "lm_parity", "d_model": LM_PARITY_WIDTH, "layers": LM_PARITY_LAYERS,
          "vocab": LM_PARITY_VOCAB, "tokens": [LM_PARITY_BATCH, LM_PARITY_LEN],
          "max_abs_err": err, "atol": LM_PARITY_ATOL, "greedy_tokens_identical": same})
    if err > LM_PARITY_ATOL or not same:
        fail(f"LM card vs CPU: logits differ by {err}, greedy tokens identical {same}")


def phase_lm_generate(model, dev, smi):
    """`generate` at full width, B = 4, a 32-token prompt, 64 new tokens,
    greedy and sampled (temperature 0.7, top_p 0.9, repetition penalty 1.2),
    each per-token loop (`compiled=False`) and CUDA graph (`compiled=True`)
    from the same generator seed, twice: all four token sets identical. New
    tokens/s of each warm run (host clock to a synchronize), the graph's
    capture time; no scan launch (the prefill runs through decode steps)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    prompt = torch.randint(0, LM_VOCAB, (LM_GEN_BATCH, LM_GEN_PROMPT), device=dev, generator=gen)
    before = scan_cuda.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_graph(model, LM_GEN_BATCH)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    line = {"phase": "lm_generate", "batch": LM_GEN_BATCH, "prompt": LM_GEN_PROMPT,
            "new_tokens": LM_GEN_NEW, "graph_capture_s": capture_s, "card": smi}
    for mode, kw in (("greedy", dict(temperature=0.0)),
                     ("sampled", dict(temperature=0.7, top_p=0.9, repetition_penalty=1.2))):
        runs = {}
        for compiled in (False, True, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(model, prompt, LM_GEN_NEW, compiled=compiled,
                           generator=torch.Generator(device=dev).manual_seed(13), **kw)
            torch.cuda.synchronize()
            name = "graph" if compiled else "loop"
            line[f"{mode}_{name}_new_tokens_per_s"] = LM_GEN_BATCH * LM_GEN_NEW / (
                time.perf_counter() - t0)
            runs.setdefault(name, []).append(out)
        outs = runs["loop"] + runs["graph"]
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        line[f"{mode}_identical"] = same
        line[f"{mode}_distinct_new_tokens"] = int(outs[0][:, LM_GEN_PROMPT:].unique().numel())
        if not same or outs[0].shape != (LM_GEN_BATCH, LM_GEN_PROMPT + LM_GEN_NEW):
            emit(line)
            fail(f"LM generate ({mode}): loop and graph tokens differ")
    line["scan_launches"] = scan_cuda.launches - before
    emit(line)
    if line["scan_launches"]:
        fail(f"LM generate launched the scan kernel {line['scan_launches']} times")


def phase_visualize_seg(ckpt: str, root: str, smi):
    """`fusionmamba_torch.visualize_segmentation` of the PST900 checkpoint on
    VIS_SAMPLES test pairs, one pair a forward: the launch counters, zeroed
    just before, equal to VIS_SAMPLES x the batch-1 forward's calls; one
    256 x 1280 x 3 grid a sample. Returns the launch counts."""
    from PIL import Image

    cfg = full_config(num_seg_classes=5)
    calls = main_path_calls(cfg, 1, SIZE)
    with tempfile.TemporaryDirectory() as out, data_root(root):
        zero_launches()
        got = visualize_segmentation.main(["--dataset", "pst900", "--ckpt", ckpt,
                                           "--out_dir", out, "--num_samples", str(VIS_SAMPLES),
                                           "--model", "full", "--device", "cuda"])
        torch.cuda.synchronize()
        launches = read_launches()
        shapes = [np.asarray(Image.open(os.path.join(out, f))).shape
                  for f in sorted(os.listdir(out))]
    expected = {k: VIS_SAMPLES * sum(calls.get(k, {}).values()) for k in KERNELS}
    secs = got["sample_seconds"]
    emit({"phase": "visualize_seg", "samples": got["written"], "grid_shapes": shapes,
          "launches": launches, "expected_launches": expected,
          "sample_seconds": secs, "median_warm_sample_s": float(np.median(secs[1:])),
          "cli_seconds": got["seconds"], "card": smi})
    if got["written"] != VIS_SAMPLES or shapes != [(SIZE, 5 * SIZE, 3)] * VIS_SAMPLES:
        fail(f"visualize_segmentation wrote {got['written']} grids of shapes {shapes}")
    if launches != expected:
        fail(f"visualize_segmentation: launch counts {launches} differ from {expected}")
    return launches


def phase_seg_tools(root: str):
    """`tools.color_convert` rgb2y on the PST900 folder's test RGB images and
    y2rgb back into them; `tools.check_dataset` classes on the test split,
    dist over the first SEG_TEST_PAIRS pairs of each split, macc. The class
    counts equal a numpy recount of the label PNGs as the dataset reads them
    (nearest-resized to 256^2, clipped to [0, 8])."""
    from PIL import Image

    t0 = time.perf_counter()
    rgb = os.path.join(root, "PST900_RGBT_Dataset", "test", "rgb")
    limit = SEG_TEST_PAIRS
    with tempfile.TemporaryDirectory() as tmp, data_root(root):
        n_y = color_convert.main(["rgb2y", "--input", rgb, "--output", os.path.join(tmp, "y")])
        n_rgb = color_convert.main(["y2rgb", "--fused", os.path.join(tmp, "y"), "--rgb", rgb,
                                    "--output", os.path.join(tmp, "rgb")])
        back = np.asarray(Image.open(os.path.join(tmp, "rgb", sorted(os.listdir(rgb))[0])))
        classes = check_dataset.main(["classes", "--dataset", "pst900", "--num_classes", "5"])
        dist = check_dataset.main(["dist", "--dataset", "pst900", "--num_classes", "5",
                                   "--limit", str(limit)])
        macc = check_dataset.main(["macc"])

    def recount(split):
        counts = np.zeros(5, np.int64)
        labels = os.path.join(root, "PST900_RGBT_Dataset", split, "labels")
        for name in sorted(os.listdir(labels))[:limit]:
            with Image.open(os.path.join(labels, name)) as img:
                lbl = np.asarray(img.convert("L").resize((SIZE, SIZE), Image.NEAREST))
            # the dataset clips to [0, 8], the audit to its 5 classes
            counts += np.bincount(np.clip(lbl, 0, 4).ravel(), minlength=5)
        return counts

    want = {split: recount(split) for split in ("train", "test")}
    ok = (np.array_equal(classes["test"], want["test"])
          and all(np.array_equal(dist[s], want[s]) for s in want))
    emit({"phase": "seg_tools", "rgb2y_images": n_y, "y2rgb_images": n_rgb,
          "y2rgb_shape": list(back.shape), "classes_test": classes["test"].tolist(),
          "dist_train": dist["train"].tolist(), "recount": {k: v.tolist() for k, v in want.items()},
          "counts_equal_recount": ok, "macc": macc, "seconds": time.perf_counter() - t0})
    if n_y != limit or n_rgb != limit or back.shape != (DISK_SIZE[0], DISK_SIZE[1], 3):
        fail(f"color_convert wrote {n_y} and {n_rgb} images, of shape {back.shape}")
    if not ok:
        fail(f"check_dataset counts {classes}, {dist} differ from the recount {want}")


# ---------------------------------------------------------------------------
# multi-process training: two ranks on the one card over gloo
# ---------------------------------------------------------------------------

def _mesh_calls(mesh: str, scan_impl: str):
    """(config, pairs a rank, model ranks) of a 2-rank `mesh` at the training
    batch: 2,1 splits the batch, 1,2 the wide projections (and with "sp" the
    scans' sequence)."""
    n_data, n_model = (int(v) for v in mesh.split(","))
    return full_config(scan_impl=scan_impl), TRAIN_PAIRS // n_data, n_model


def phase_parallel_kernels(dev, checked):
    """Each kernel at every shape one rank of a 2-rank mesh gives it that no
    earlier phase checked: batch 3 a rank under 2,1; d_inner and the MLP's
    hidden halved under 1,2; and with the sequence-parallel scan L halved
    (down to 8 steps, below one 16-step tile): forward and backward against
    the plain version and its autograd, bit-identical twice. Sums a step on
    one rank in a `parallel_kernels_step` line per mesh."""
    t0 = time.perf_counter()
    for name, (mesh, impl) in MULTI_RANK_RUNS.items():
        cfg, pairs, n_model = _mesh_calls(mesh, impl)
        per_step = phase_kernel_train(train_calls(cfg, pairs, SIZE, n_model), dev, pairs,
                                      checked, "parallel_kernels")
        emit({"phase": "parallel_kernels_step", "run": name, "mesh": mesh, "scan_impl": impl,
              "pairs_a_rank": pairs, "per_step": {k: _brief(r) for k, r in per_step.items()}})
    emit({"phase": "parallel_kernels", "seconds": time.perf_counter() - t0})


def _rank_main(rank: int, world: int, port: int, argv, out: str) -> None:
    """One rank of a multi-rank training run, with torchrun's environment:
    the training CLI, its launch counts zeroed just before and read just
    after, saved with its stats to `out`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    zero_launches()
    stats = train.main(argv)
    with open(out, "w") as f:
        json.dump({"stats": stats, "launches": read_launches()}, f)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(argv, world: int, tmp: str, timeout_s: float = 300.0):
    """`world` ranks of the training CLI (the spawn method; the kernels are
    built already, so no rank builds them); their results in rank order. A
    rank that fails or outlives `timeout_s` fails the run."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port, outs = _free_port(), [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, argv, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes) or not all(os.path.exists(o) for o in outs):
        fail(f"multi-rank training {argv}: rank exit codes {codes}")
    return [json.load(open(o)) for o in outs]


def _state_close(got: dict, want: dict, steps: int):
    """The worst parameter of two state dicts after `steps` Adam steps from
    the same weights, by the gate of tests/test_optimizer_trajectory.py:
    within 2e-3 by norm, or an rms drift below a quarter of the lr budget.
    Returns (all pass, worst key, its relative error)."""
    budget = 1e-4 / 0.75 * steps
    worst, worst_rel, ok = None, 0.0, set(got) == set(want)
    for k, v in want.items():
        a, b = got[k].double(), v.double()
        if a.shape != b.shape:
            return False, k, float("inf")
        rel = float((a - b).norm() / (b.norm() + 1e-12))
        rms = float((a - b).norm() / math.sqrt(b.numel()))
        if rel >= 2e-3 and rms >= 0.25 * budget:
            ok = False
        if rel > worst_rel:
            worst, worst_rel = k, rel
    return ok, worst, worst_rel


def _train_argv(ckpt_dir: str):
    return ["--synthetic", str(TRAIN_PAIRS * MULTI_RANK_STEPS), "-B", str(TRAIN_PAIRS), "-E",
            "1", "-j", "0", "--model", "full", "--device", "cuda", "--ckpt_dir", ckpt_dir]


def phase_one_rank_reference(tmp: str, smi):
    """The training CLI on one rank in a process of its own (as each rank of
    the multi-rank runs is), on their data and seed: their reference. Its
    launch counts equal the config's. Returns its stats and checkpoint."""
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = os.path.join(tmp, "one")
    got = _run_ranks(_train_argv(ckpt), 1, tmp)[0]
    stats = got["stats"]
    expected = {k: MULTI_RANK_STEPS * sum(c.values())
                for k, c in train_calls(full_config(), TRAIN_PAIRS, SIZE).items()}
    state = torch.load(os.path.join(ckpt, "fusion_model_pst900.pth"), map_location="cpu",
                       weights_only=True)
    warm = stats["step_seconds"][1:]
    emit({"phase": "one_rank_reference", "steps": stats["steps"], "losses": stats["losses"],
          "launches": got["launches"], "expected_launches": expected,
          "step_seconds": stats["step_seconds"], "median_warm_step_s": float(np.median(warm)),
          "pairs_per_s": TRAIN_PAIRS / float(np.median(warm)),
          "peak_memory_bytes": stats["peak_memory_bytes"][0], "card": smi})
    if got["launches"] != expected or stats["world"] != 1:
        fail(f"one-rank reference: world {stats['world']}, launch counts {got['launches']} "
             f"differ from the config's {expected}")
    return stats, state


def phase_multi_rank_train(name: str, reference, tmp: str, smi):
    """Two ranks on cuda:0 over gloo through the training CLI (`--mesh`):
    every rank's launch counts equal MULTI_RANK_STEPS times the calls a step
    that the config gives one rank, the losses and the gathered checkpoint
    equal the one-rank run's (loss within TRAIN_LOSS_RTOL; parameters by
    `_state_close`); pairs/s and peak memory a rank. The ranks share the one
    card: the pairs/s says nothing of scaling."""
    mesh, impl = MULTI_RANK_RUNS[name]
    cfg, pairs, n_model = _mesh_calls(mesh, impl)
    ref_stats, ref_state = reference
    ckpt = os.path.join(tmp, name)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _run_ranks(_train_argv(ckpt) + ["--mesh", mesh, "--scan_impl", impl], 2, tmp)
    seconds = time.perf_counter() - t0
    calls = train_calls(cfg, pairs, SIZE, n_model)
    expected = {k: MULTI_RANK_STEPS * sum(c.values()) for k, c in calls.items()}
    state = torch.load(os.path.join(ckpt, "fusion_model_pst900.pth"), map_location="cpu",
                       weights_only=True)
    load_reference_checkpoint(VSSMFusion(full_config()),
                              os.path.join(ckpt, "fusion_model_pst900.pth"))
    ok, worst, worst_rel = _state_close(state, ref_state, MULTI_RANK_STEPS)
    stats = ranks[0]["stats"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(stats["losses"], ref_stats["losses"])]
    warm = stats["step_seconds"][1:]
    emit({"phase": name, "mesh": mesh, "scan_impl": impl, "world": stats["world"],
          "backend": stats["backend"], "ranks_share_one_card": True,
          "pairs_per_step": TRAIN_PAIRS, "pairs_a_rank": pairs, "steps": stats["steps"],
          "losses": stats["losses"], "losses_one_rank": ref_stats["losses"],
          "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
          "checkpoint_matches_one_rank": ok, "worst_param": worst, "worst_param_rel": worst_rel,
          "launches_by_rank": [r["launches"] for r in ranks], "expected_launches": expected,
          "step_seconds": stats["step_seconds"], "median_warm_step_s": float(np.median(warm)),
          "pairs_per_s": TRAIN_PAIRS / float(np.median(warm)),
          "pairs_per_s_note": "two ranks share one card over gloo: not a scaling measurement",
          "peak_memory_bytes_by_rank": stats["peak_memory_bytes"], "run_seconds": seconds,
          "card": smi})
    if stats["world"] != 2 or stats["backend"] != "gloo" or stats["mesh"] != [
            int(v) for v in mesh.split(",")]:
        fail(f"{name}: ran as world {stats['world']}, backend {stats['backend']}, "
             f"mesh {stats['mesh']}")
    if any(r["launches"] != expected for r in ranks):
        fail(f"{name}: launch counts {[r['launches'] for r in ranks]} differ from the "
             f"config's {expected}")
    if (stats["steps"] != MULTI_RANK_STEPS or max(loss_rel) > TRAIN_LOSS_RTOL
            or any(r["stats"]["losses"] != stats["losses"] for r in ranks)):
        fail(f"{name}: losses {[r['stats']['losses'] for r in ranks]} against the one-rank "
             f"run's {ref_stats['losses']}")
    if not ok:
        fail(f"{name}: the gathered checkpoint differs from the one-rank run's at {worst} "
             f"({worst_rel} by norm)")
    return ranks[0]["launches"]


def phase_remat_train(dev, smi):
    """MULTI_RANK_STEPS training steps at full width, batch 6, with no remat,
    remat_light and remat, from the same weights, batches and DropPath
    generator: the same losses, launch counts equal the config's (remat's
    repeated forward calls included), and the peak memory of each: remat's
    below none's, remat_light's not above it. (remat_light recomputes the
    MLP, BiAttn and ECA, whose fused kernels keep no intermediate that the
    checkpoint could drop: it saves time in no case and memory hardly.)"""
    rng = np.random.default_rng(11)
    batches = [tuple(torch.from_numpy(rng.uniform(0, 1, (TRAIN_PAIRS, SIZE, SIZE, 1)).astype(
        np.float32)).to(dev) for _ in range(2)) for _ in range(MULTI_RANK_STEPS)]
    runs = {}
    for name, flags in (("none", {}), ("remat_light", {"remat_light": True}),
                        ("remat", {"remat": True})):
        cfg = full_config(**flags)
        net = init_weights(VSSMFusion(cfg), seed=0).to(dev)
        opt = train.make_fusion_optimizer(net.parameters())
        gen = torch.Generator(device=dev).manual_seed(0)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        losses, seconds = [], []
        for vis, ir in batches:
            t0 = time.perf_counter()
            losses.append(float(train.fusion_train_step(net, opt, vis, ir, gen)["loss_total"]))
            seconds.append(time.perf_counter() - t0)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        expected = {k: MULTI_RANK_STEPS * sum(c.values())
                    for k, c in train_calls(cfg, TRAIN_PAIRS, SIZE).items()}
        runs[name] = losses, peak
        emit({"phase": "remat_train", "remat": name, "steps": MULTI_RANK_STEPS,
              "pairs_per_step": TRAIN_PAIRS, "losses": losses, "launches": launches,
              "expected_launches": expected, "peak_memory_bytes": peak,
              "peak_over_none": peak / runs["none"][1], "step_seconds": seconds,
              "card": smi})
        del net, opt
        torch.cuda.empty_cache()
        if launches != expected:
            fail(f"remat_train {name}: launch counts {launches} differ from the config's "
                 f"{expected}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, runs["none"][0]))
        if rel > REMAT_LOSS_RTOL:
            fail(f"remat_train {name}: losses {losses} against {runs['none'][0]} without remat")
        if peak > runs["none"][1] or (name == "remat" and peak >= runs["none"][1]):
            fail(f"remat_train {name}: peak memory {peak} against {runs['none'][1]} without "
                 f"remat")


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


def phase_trace_train(dev, steps: int = 3, precision: str = "fp32"):
    """The same over `steps` warm training steps of the training path's
    batch (full config, 6 pairs of 256^2, DropPath on), at `precision`
    (phase `trace_train`, and `trace_train_bf16` for bf16)."""
    phase = "trace_train" if precision == "fp32" else "trace_train_" + precision
    dtype = train.resolve_compute_dtype(precision)
    gc.collect()
    torch.cuda.empty_cache()
    net = init_weights(VSSMFusion(full_config()), seed=0).to(dev)
    opt = train.make_fusion_optimizer(net.parameters())
    gen = torch.Generator(device=dev).manual_seed(3)
    x1, x2 = (torch.rand(TRAIN_PAIRS, SIZE, SIZE, 1, device=dev, generator=gen)
              for _ in range(2))
    for _ in range(2):
        train.fusion_train_step(net, opt, x1, x2, gen, compute_dtype=dtype)
    got = _trace(lambda: train.fusion_train_step(net, opt, x1, x2, gen, compute_dtype=dtype),
                 steps)
    del net, opt
    torch.cuda.empty_cache()
    if got is None:
        emit({"phase": phase, "device_time": "not measured (no device events)"})
        return
    window, busy, by_kernel = got
    emit({"phase": phase, "steps": steps, "pairs_per_step": TRAIN_PAIRS,
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
                         torch.backends.cudnn.allow_tf32],
          "allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction})

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
    bf16 = phase_kernel_bf16(tcalls, dev, checked, smi)
    phase_mlp_paths(tcalls["mlp"], dev)
    phase_scan_paths(tcalls["scan"], calls["scan"],
                     fullres_scan_shapes(full_config(), 2 * TRAIN_PAIRS, SIZE), dev)
    phase_fullres_ss2d(dev)
    phase_lm_scan_paths(dev)
    phase_parallel_kernels(dev, checked)
    emit({"phase": "kernel", "per_forward_of_serving": {
        k: {m: v for m, v in _summary(r).items() if m not in ("bytes_ms", "ops_ms", "sfu_ms")
            and (k in TENSOR_CORE_KERNELS or m != "fp32_cores_bound_ms")}
        for k, r in serving.items()}})
    with tempfile.TemporaryDirectory() as serving_dir:
        phase_main_path(calls, smi, serving_dir)
        phase_evaluate(serving_dir)
    phase_parity(dev)
    launches, train_line = phase_train(tcalls, smi)
    phase_sync_free(dev, smi)
    bf16_launches = phase_train_bf16(tcalls, smi, train_line)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        _write_pst900(root, {"train": TRAIN_PAIRS * DISK_STEPS, "test": SEG_TEST_PAIRS})
        write_s = time.perf_counter() - t0
        phase_train_disk(tcalls, smi, root, write_s)
        ckpt, seg_launches = phase_train_seg(smi, root, os.path.join(root, "ckpt"))
        phase_evaluate_seg(ckpt, root)
        vis_launches = phase_visualize_seg(ckpt, root, smi)
        phase_seg_tools(root)
    # the five forward kernels at the batch-1 shapes of visualize_segmentation,
    # beside their sums a forward at batch 2 (the segmentation step's forward)
    phase_kernels(main_path_calls(full_config(), 1, SIZE), dev, "visualize_kernel", 1)
    phase_batch1_vs_batch2(dev)
    lm = build_lm(dev)
    lm_launches = phase_lm_score(lm, dev, smi)
    phase_lm_decode(lm, dev)
    phase_lm_generate(lm, dev, smi)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm_parity(dev)
    phase_train_parity(dev)
    phase_train_bf16_parity(dev, smi)
    phase_seg_parity(dev)
    with tempfile.TemporaryDirectory() as tmp:
        reference = phase_one_rank_reference(tmp, smi)
        multi = {name: phase_multi_rank_train(name, reference, tmp, smi)
                 for name in MULTI_RANK_RUNS}
    phase_remat_train(dev, smi)
    phase_trace(dev)
    phase_trace_train(dev)
    phase_trace_train(dev, precision="bf16")

    kernels = []
    for k, (route, source, replaces) in KERNELS.items():
        r = _summary(results[k])
        kernels.append({
            "name": k, "route": route, "source": source, "replaces": replaces,
            "launches": launches[k], "launches_train_seg": seg_launches[k],
            "launches_lm": lm_launches[k], "launches_visualize": vis_launches[k],
            **{f"launches_{name}_rank0": multi[name][k] for name in MULTI_RANK_RUNS},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            **_bound_by(k, r["bytes_ms"], r["ops_ms"], r["sfu_ms"]),
            "library_ms": r["library_ms"], "device_ms": r["device_ms"], "shapes": r["shapes"],
            "device_shapes_covered": r["device_shapes_covered"],
            "library_device_ms": r["library_device_ms"],
            "ms_at_library_shapes": r["ms_at_library_shapes"],
            "device_ms_at_library_shapes": r["device_ms_at_library_shapes"],
            **({"fp32_cores_bound_ms": r["fp32_cores_bound_ms"]}
               if k in TENSOR_CORE_KERNELS else {}),
            "bf16_launches": bf16_launches[k], "bf16_max_abs_err": bf16[k]["max_abs_err"],
            "bf16_ms": bf16[k]["ms"], "bf16_device_ms": bf16[k]["device_ms"],
            "bf16_bound_ms": bf16[k]["bound_ms"],
            "bf16_bound_by": _bound_by(k, bf16[k]["bytes_ms"], bf16[k]["ops_ms"],
                                       bf16[k]["sfu_ms"])["bound_by"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "times": "per training step of the main path (full config, 6 pairs of 256^2): "
                   "sum over its shapes of calls x time; launches from the 12-step run, "
                   "launches_train_seg from the segmentation CLI's PST900 run, launches_lm "
                   "from the LM's scoring forwards, launches_visualize from "
                   "visualize_segmentation's run, launches_<run>_rank0 from rank 0 of "
                   "each two-rank training run; bf16_launches from the 4-step bf16 run "
                   "(train_bf16), the bf16_* times, errors and bounds from kernel_bf16"})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})


if __name__ == "__main__":
    main()
