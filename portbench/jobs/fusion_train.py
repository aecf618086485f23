"""Fusion training: `fusionmamba_torch.train.loop.fusion_train_step` (forward,
clamp, Fusionloss, backward, Adam at the mix's lr, DropPath on)
dispatched back to back on a ring of distinct random pairs made on the
device from the seed.

Set-up builds the one model and optimizer that the window drives, and
drives them through the first `checked_steps` steps with the window's own
call and feed: their losses, the first gradient (read back from Adam's
first moment) and the change of every parameter are kept. After the window,
the reference runs the same steps from the same weights, pairs and DropPath
draws, and the gaps of those three are the numbers compared.

Mix keys: batch, precision (fp32 | bf16), ring, lr (the same number for
the program's Adam and the reference's), checked_steps, reference_rows
(rows the reference runs at a time), trace_units.
"""
from __future__ import annotations


import torch

from fusionmamba_torch.train.loop import (fusion_train_step, make_fusion_optimizer,
                                          resolve_compute_dtype)
from portbench import build, compare, harness
from portbench.reference import fusion as ref_fusion
from portbench.reference import products, weights

# the faults `portbench/faults.py` plants in this job's path: the forward of
# the model that `build.model` makes, and the step function STEP of this module
FAULTS = ("state_unchanged", "half_batch", "answer_altered")
STEP = "fusion_train_step"

# generator streams of a seed (`weights.generator`); 0 makes the weights
INPUTS, DROP_PATH = 1, 2
BETA1 = 0.9
# a leaf whose first reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared (a
# rule on the reference's gradient, not on names)
NOUGHT = 1e-3


def _inputs(cell, device):
    mix, size = cell.mix, cell.config["image_size"]
    gen = weights.generator(cell.seed, INPUTS, device)
    shape = (mix["ring"], mix["batch"], size, size, 1)
    return (torch.rand(shape, generator=gen, device=device),
            torch.rand(shape, generator=gen, device=device))


def _by_name(module):
    """The parameters in the order of their names: the program's modules and
    the reference's register them in other orders."""
    return [p for _, p in sorted(module.named_parameters())]


def _norms(tensors):
    return torch.stack([t.detach().float().norm() for t in tensors]).cpu()


def _quantiles(gaps):
    """The leaves' gaps at the 25th, 50th, 75th and 90th percentiles, for the
    calibration's record."""
    q = torch.quantile(gaps, torch.tensor([0.25, 0.5, 0.75, 0.9], dtype=gaps.dtype))
    return [float(v) for v in q]


def _whole_gap(got, want) -> float:
    """|the norm over all leaves, program - reference| / the reference's."""
    got, want = got.double(), want.double()
    return float((got.norm() - want.norm()).abs() / want.norm())


class Run:
    def __init__(self, cell):
        self.cell, mix = cell, cell.mix
        dev = self.device = torch.device(cell.device)
        self.items_per_unit = mix["batch"]
        self.dtype = resolve_compute_dtype(mix["precision"])
        self.net = build.model(cell.config, dev)
        weights.load(self.net, weights.fusion_weights(cell.config, cell.seed, dev))
        self.params = _by_name(self.net)
        self.opt = make_fusion_optimizer(self.params, lr=mix["lr"])
        self.vis, self.ir = _inputs(cell, dev)
        self.dp_gen = weights.generator(cell.seed, DROP_PATH, dev)
        harness.stamp("weights and inputs")
        start = [p.detach().clone() for p in self.params]
        losses = []
        self.k = 0
        # the first step's output, as the model hands it to the clamp
        hook = self.net.register_forward_hook(
            lambda m, i, out: setattr(self, "output", out.detach().float().clone()))
        for _ in range(mix["checked_steps"]):
            losses.append(self._step())
            if self.k == 1:
                hook.remove()
                moments = [self.opt.state[p]["exp_avg"] if p in self.opt.state
                           else torch.zeros_like(p) for p in self.params]
                self.grad_norms = _norms(m / (1.0 - BETA1) for m in moments)
        self.losses = [float(v) for v in losses]
        harness.stamp("checked steps")
        self.update_norms = _norms(p - s for p, s in zip(self.params, start))
        del start
        self.window_losses = []

    def _step(self):
        i = self.k % self.cell.mix["ring"]
        out = fusion_train_step(self.net, self.opt, self.vis[i], self.ir[i],
                                generator=self.dp_gen, compute_dtype=self.dtype)
        self.k += 1
        return out["loss_total"]

    def unit(self):
        self.window_losses.append(self._step())

    def failed(self) -> int:
        if not self.window_losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.window_losses))).sum())

    def release(self):
        del self.net, self.opt, self.params, self.vis, self.ir, self.window_losses
        self.output = self.output.cpu()

    def _reference(self, control: bool):
        """The reference's losses, first-gradient norms and change norms over
        the checked steps (as the control when `control`)."""
        cell, mix, dev = self.cell, self.cell.mix, self.device
        net = ref_fusion.FusionNet(cell.config, dev)
        weights.load(net, weights.fusion_weights(cell.config, cell.seed, dev))
        params = _by_name(net)
        start = [p.detach().clone() for p in params]
        adam = ref_fusion.Adam(params, lr=mix["lr"])
        vis, ir = _inputs(cell, dev)
        gen = weights.generator(cell.seed, DROP_PATH, dev)
        rows = (net.dp_rows(), 2 * mix["batch"])
        losses = []
        with products.control(mix["precision"], control):
            for k in range(mix["checked_steps"]):
                table = torch.rand(rows, generator=gen, device=dev)
                adam.zero_grad()
                loss, out = ref_fusion.train_step(net, vis[k], ir[k], table,
                                                  mix["reference_rows"])
                losses.append(float(loss))
                if k == 0:
                    output = out
                    grads = _norms(p.grad if p.grad is not None else torch.zeros_like(p)
                                   for p in params)
                adam.step()
        changes = _norms(p - s for p, s in zip(params, start))
        return output, losses, grads, changes

    def _gaps(self, got, want) -> dict:
        """The first step's output (the widest gap), the loss of the worst
        step, and the median leaf's gap of the first gradient and of the
        change (over the leaves the reference moves): a worst leaf's gap is
        the noise of the leaves whose sums cancel most, and swings from seed
        to seed (PERF.md). `self.detail` keeps the worst leaves and the
        losses for the calibration's record."""
        output, losses, grads, changes = got
        ref_output, ref_losses, ref_grads, ref_changes = want
        live = ref_grads > 0
        moved = ref_grads >= NOUGHT * ref_grads[live].median()
        g = compare.leaf_gaps(grads, ref_grads)[live]
        u = compare.leaf_gaps(changes, ref_changes)[moved]
        names = sorted(n for n, _ in ref_fusion.FusionNet(self.cell.config, "meta")
                       .named_parameters())
        self.detail = {"losses": losses, "reference_losses": ref_losses,
                       "grad_q": _quantiles(g), "update_q": _quantiles(u),
                       "grad_whole": _whole_gap(grads[live], ref_grads[live]),
                       "update_whole": _whole_gap(changes[moved], ref_changes[moved]),
                       "grad_worst": g.max().item(),
                       "grad_worst_leaf": [n for n, k in zip(names, live) if k][int(g.argmax())],
                       "update_worst": u.max().item(),
                       "update_worst_leaf": [n for n, k in zip(names, moved) if k][int(u.argmax())],
                       "left_out": int((~moved).sum()), "leaves": len(names)}
        return {"output_gap": compare.out_gap(output, ref_output),
                "loss_gap": compare.rel_gap(losses, ref_losses),
                "grad_median_gap": g.median().item(), "update_median_gap": u.median().item()}

    def check(self) -> dict:
        self.ref = self._reference(control=False)
        return self._gaps((self.output, self.losses, self.grad_norms, self.update_norms),
                          self.ref)

    def check_control(self) -> dict:
        """The control in the program's place: the reference in the precision
        next below the mix's (`products.control`)."""
        return self._gaps(self._reference(control=True), self.ref)
