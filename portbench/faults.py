"""Faults planted in the timed path, for the checks that `correct` catches
them: a step that leaves the state unchanged, half of the batch left out
(the mean taken over the rest), an answer altered where it is produced.
`plant(cell, fault)` breaks the path that the cell's job drives and
returns the function that mends it. Used by `calibrate.py --fault` (on the
card, at the cell's own size) and by the CPU tests.

Each job declares what it can have: `FAULTS`, the names of its faults, and
in a training job `STEP`, the name of its step function `step(net, opt,
*batch, **kw)`, which half a batch or an unchanged state replaces. An
altered answer (and, in a job without a step, half a batch) breaks the
forward of the model that `build.model` makes, whatever its maker."""
from __future__ import annotations

import torch

from . import build, harness


def _replace(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    return lambda: setattr(owner, name, old)


def _first_output(result):
    """The tensor a model returns, and how to put a changed one back."""
    if isinstance(result, tuple):
        return result[0], lambda t: (t,) + tuple(result[1:])
    return result, lambda t: t


def _wrap_model(alter):
    real = build.model

    def make(config, device):
        net = real(config, device)
        forward = net.forward

        def broken(*args, **kwargs):
            out, put = _first_output(forward(*args, **kwargs))
            return put(alter(out))
        net.forward = broken
        return net
    return _replace(build, "model", make)


def _altered(out):
    """The first answer of the batch changed: an image shifted by 0.1, or one
    logit raised by 1."""
    out = out.clone()
    if out.dim() == 4:
        out[0] = out[0] + 0.1
    else:
        out[0, 0, 0] += 1.0
    return out


def _halved(out):
    half = out.shape[0] // 2
    return torch.cat([out[:half], torch.zeros_like(out[half:])])


def of(mix: dict) -> tuple:
    """The faults that the job of `mix` can have."""
    return harness.job_module(mix).FAULTS


def _broken_step(real, fault: str):
    def step(net, opt, *batch, **kw):
        if fault == "half_batch":
            half = batch[0].shape[0] // 2
            return real(net, opt, *(b[:half] for b in batch), **kw)
        before = [p.detach().clone() for p in net.parameters()]
        out = real(net, opt, *batch, **kw)
        with torch.no_grad():
            for p, b in zip(net.parameters(), before):
                p.copy_(b)
        return out
    return step


def plant(cell, fault: str):
    job = harness.job_module(cell.mix)
    if fault not in job.FAULTS:
        raise ValueError(f"{cell.mix['job']} has no fault {fault!r}")
    if fault == "answer_altered":
        return _wrap_model(_altered)
    step = getattr(job, "STEP", None)
    if step is None:
        return _wrap_model(_halved)
    return _replace(job, step, _broken_step(getattr(job, step), fault))
