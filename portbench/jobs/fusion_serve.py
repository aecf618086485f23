"""Fusion serving as `fusionmamba_torch.infer` times a batch: float32 host
batches of (IR, VIS) pairs copied to the device, `VSSMFusion` in eval mode
under `inference_mode`, the output clamped to [0, 1] and copied back. One
client sends the next batch when the last returns (a folder job).

A sample of the window's batches, drawn from the seed (`kept_units`, a
reservoir over all of them), keeps its outputs; after the window the
reference fuses the same inputs, and the widest gap of an output pixel is
the number compared.

Mix keys: batch, precision (fp32), ring, kept_units, reference_rows,
trace_units, warm_units.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from portbench import build, compare, harness
from portbench.reference import fusion as ref_fusion
from portbench.reference import products, weights

# the faults `portbench/faults.py` plants in the forward of the model that
# `build.model` makes
FAULTS = ("half_batch", "answer_altered")


def _inputs(cell):
    mix, size = cell.mix, cell.config["image_size"]
    rng = np.random.Generator(np.random.PCG64(cell.seed))
    return rng.random((mix["ring"], 2, mix["batch"], size, size, 1), dtype=np.float32)


class Run:
    def __init__(self, cell):
        self.cell, mix = cell, cell.mix
        self.device = torch.device(cell.device)
        self.items_per_unit = mix["batch"]
        self.net = build.model(cell.config, self.device).eval()
        weights.load(self.net, weights.fusion_weights(cell.config, cell.seed, self.device))
        self.ring = _inputs(cell)
        harness.stamp("weights and inputs")
        self.pick = random.Random(cell.seed)
        self.kept, self.n = [], 0
        for i in range(mix["warm_units"]):
            self._serve(i)

    def _serve(self, i):
        a, b = self.ring[i % len(self.ring)]
        with torch.inference_mode():
            out = self.net(torch.from_numpy(a).to(self.device), torch.from_numpy(b).to(self.device))
            return out.clamp(0.0, 1.0).cpu().numpy()

    def unit(self):
        out, j = self._serve(self.n), self.n
        k = self.cell.mix["kept_units"]
        if j < k:
            self.kept.append((j, out))
        else:
            r = self.pick.randrange(j + 1)
            if r < k:
                self.kept[r] = (j, out)
        self.n += 1

    def failed(self) -> int:
        return 0

    def release(self):
        del self.net

    def _reference(self, control: bool) -> list:
        cell, dev = self.cell, self.device
        net = ref_fusion.FusionNet(cell.config, dev).eval()
        weights.load(net, weights.fusion_weights(cell.config, cell.seed, dev))
        rows = cell.mix["reference_rows"]
        outs = []
        with torch.no_grad(), products.control(cell.mix["precision"], control):
            for j, _ in self.kept:
                a, b = (torch.from_numpy(t).to(dev) for t in self.ring[j % len(self.ring)])
                outs.append(torch.cat([
                    net(a[s:s + rows], b[s:s + rows]).clamp(0.0, 1.0).cpu()
                    for s in range(0, a.shape[0], rows)]))
        return outs

    def _gap(self, got: list, want: list) -> dict:
        return {"pixel_gap": max(compare.out_gap(g, w) for g, w in zip(got, want))}

    def check(self) -> dict:
        self.ref = self._reference(control=False)
        return self._gap([torch.from_numpy(out) for _, out in self.kept], self.ref)

    def check_control(self) -> dict:
        return self._gap(self._reference(control=True), self.ref)
