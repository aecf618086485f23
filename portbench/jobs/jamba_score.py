"""Scoring with Jamba: each unit copies a batch of token ids to the device and
runs `JambaForCausalLM.forward` under `inference_mode` to the logits; units
are dispatched back to back.

A sample of the window's units, drawn from the seed (`kept_units`, a
reservoir over all of them), keeps its logits and its routers' logits on the
device. After the window the reference scores the same tokens a sequence at
a time, told the program's route (the program's own `route` of its routers'
logits): at rows whose 2nd and 3rd reference probabilities lie within the
limits file's `tie_width`, it takes the program's top-k, since a flip there
is fp32 rounding and would reach every later position through the scan and
attention. The numbers compared: `logprob_gap`, the widest gap between the
two log-softmaxes over every position and word; `route_mismatch`, the rows,
over the kept units and the expert layers, whose two top-k sets differ
outside the tie width. `detail` records the rows within it (`tie_rows`) and
the largest gap between the two routers' probabilities (`route_prob_gap`).

Mix keys: batch, seq_len, precision (fp32), ring, kept_units, trace_units,
warm_units.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from fusionmamba_torch.models.jamba import route
from portbench import build, harness
from portbench.reference import jamba as ref_jamba
from portbench.reference import products

# the faults `portbench/faults.py` plants in the forward of the model that
# `build.model` makes
FAULTS = ("half_batch", "answer_altered")
# positions a time in the log-softmax gap (a float64 copy of each side's rows)
GAP_ROWS = 512


def _tokens(cell):
    mix = cell.mix
    rng = np.random.Generator(np.random.PCG64(cell.seed))
    return rng.integers(0, cell.config["vocab_size"], (mix["ring"], mix["batch"], mix["seq_len"]),
                        dtype=np.int64)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest |log_softmax(got) - log_softmax(want)| of two (L, V)
    logits, GAP_ROWS positions at a time."""
    return max((torch.log_softmax(got[i:i + GAP_ROWS].double(), -1)
                - torch.log_softmax(want[i:i + GAP_ROWS].double(), -1)).abs().max().item()
               for i in range(0, got.shape[0], GAP_ROWS))


class Run:
    def __init__(self, cell):
        self.cell, mix = cell, cell.mix
        self.device = torch.device(cell.device)
        self.items_per_unit = mix["batch"] * mix["seq_len"]
        self.tau = cell.limits["tie_width"]
        self.net = build.model(cell.config, self.device).eval()
        ref_jamba.load_weights(self.net, ref_jamba.model_config(cell.config), cell.seed,
                               self.device)
        self.ring = _tokens(cell)
        harness.stamp("weights and inputs")
        self.pick = random.Random(cell.seed)
        self.kept, self.n = [], 0
        self.detail = None
        for i in range(mix["warm_units"]):
            self._score(i)

    def _score(self, i):
        with torch.inference_mode():
            return self.net(torch.from_numpy(self.ring[i % len(self.ring)]).to(self.device))

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

    def _routes(self, router_logits, b: int) -> list:
        """The program's route of sequence b: (probabilities, top-k) an
        expert layer, over that sequence's rows."""
        top_k = ref_jamba.model_config(self.cell.config)["num_experts_per_tok"]
        length = self.cell.mix["seq_len"]
        rows = [r[b * length:(b + 1) * length] for r in router_logits]
        return [(torch.softmax(r, -1, dtype=torch.float32), route(r, top_k)[1]) for r in rows]

    def _each(self, fn) -> dict:
        """fn(reference, tokens (1, L), the program's logits (L, V) and route)
        -> (gap, `Routes`) for every sequence of the kept units; the widest
        gap and the summed route counts."""
        cell, dev = self.cell, self.device
        cfg = ref_jamba.model_config(cell.config)
        net = ref_jamba.JambaLM(cfg, ref_jamba.experts_held(cell.config), dev)
        ref_jamba.load_weights(net, cfg, cell.seed, dev)
        gap, mismatch, ties, prob_gap = 0.0, 0, 0, 0.0
        with torch.no_grad():
            for j, (logits, router_logits) in self.kept:
                tokens = torch.from_numpy(self.ring[j % len(self.ring)]).to(dev)
                for b in range(tokens.shape[0]):
                    g, rec = fn(net, tokens[b:b + 1], logits[b], self._routes(router_logits, b))
                    gap = max(gap, g)
                    mismatch, ties = mismatch + rec.mismatch, ties + rec.ties
                    prob_gap = max(prob_gap, rec.prob_gap)
        self.detail = {"tie_rows": ties, "route_prob_gap": prob_gap, "tie_width": self.tau}
        return {"logprob_gap": gap, "route_mismatch": float(mismatch)}

    def _exact(self, net, tokens, routes):
        with products.control(self.cell.mix["precision"], False):
            return net(tokens, routes, self.tau)

    def check(self) -> dict:
        def fn(net, tokens, got, routes):
            want, rec = self._exact(net, tokens, routes)
            return _gap(got, want[0]), rec
        return self._each(fn)

    def check_control(self) -> dict:
        """The control (`products.control`) in the program's place, its own
        route included, against the reference."""
        def fn(net, tokens, got, routes):
            with products.control(self.cell.mix["precision"], True):
                ctrl, taken = net(tokens)
            want, rec = self._exact(net, tokens, taken.taken)
            return _gap(ctrl[0], want[0]), rec
        return self._each(fn)
