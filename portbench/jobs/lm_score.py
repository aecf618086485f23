"""Scoring with the Mamba LM: each unit copies a batch of token ids to the
device and runs `MambaLMHeadModel.forward` under `inference_mode` to the
logits; units are dispatched back to back.

A sample of the window's units, drawn from the seed (`kept_units`, a
reservoir over all of them), keeps its logits on the device; after the
window the reference scores the same tokens, and the widest gap between the
two log-softmaxes, over every position and every word, is the number
compared.

Mix keys: batch, seq_len, precision (fp32), ring, kept_units, trace_units,
warm_units.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from portbench import build, harness
from portbench.reference import mamba_lm as ref_lm
from portbench.reference import products, weights

# the faults `portbench/faults.py` plants in the forward of the model that
# `build.model` makes
FAULTS = ("half_batch", "answer_altered")


def reference_config(config: dict) -> dict:
    return {**config, "vocab_size": build.maker(config).padded_vocab(config)}


def _tokens(cell):
    mix = cell.mix
    rng = np.random.Generator(np.random.PCG64(cell.seed))
    return rng.integers(0, cell.config["vocab_size"], (mix["ring"], mix["batch"], mix["seq_len"]),
                        dtype=np.int64)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest |log_softmax(got) - log_softmax(want)|, a row at a time."""
    return max((torch.log_softmax(g.double(), -1) - torch.log_softmax(w.double(), -1))
               .abs().max().item() for g, w in zip(got, want))


class Run:
    def __init__(self, cell):
        self.cell, mix = cell, cell.mix
        self.device = torch.device(cell.device)
        self.items_per_unit = mix["batch"] * mix["seq_len"]
        self.net = build.model(cell.config, self.device).eval()
        weights.load(self.net, weights.lm_weights(reference_config(cell.config), cell.seed,
                                                  self.device))
        self.ring = _tokens(cell)
        harness.stamp("weights and inputs")
        self.pick = random.Random(cell.seed)
        self.kept, self.n = [], 0
        for i in range(mix["warm_units"]):
            self._score(i)

    def _score(self, i):
        with torch.inference_mode():
            return self.net(torch.from_numpy(self.ring[i % len(self.ring)]).to(self.device))[0]

    def unit(self):
        out, j = self._score(self.n), self.n
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

    def _each(self, fn) -> float:
        """The largest fn(reference model, tokens, program's logits) over the
        kept units."""
        cell, dev = self.cell, self.device
        cfg = reference_config(cell.config)
        net = ref_lm.MambaLM(cfg, dev)
        weights.load(net, weights.lm_weights(cfg, cell.seed, dev))
        with torch.no_grad():
            return max(fn(net, torch.from_numpy(self.ring[j % len(self.ring)]).to(dev), got)
                       for j, got in self.kept)

    def check(self) -> dict:
        return {"logprob_gap": self._each(lambda net, tokens, got: _gap(got, net(tokens)))}

    def check_control(self) -> dict:
        """The control (`products.control`) in the program's place, against
        the reference."""
        def fn(net, tokens, got):
            with products.control(self.cell.mix["precision"], True):
                ctrl = net(tokens)
            return _gap(ctrl, net(tokens))
        return {"logprob_gap": self._each(fn)}
