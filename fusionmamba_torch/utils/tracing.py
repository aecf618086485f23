"""The port's own record of what it does: spans at its layer boundaries and
one registry of counts.

`span(name)` marks a layer (the training step and its phases, a model's
forward and its stages, a decoder's kinds of layer). The spans: `train.step`
and its phases; `fusion.forward` and its stages; `lm.forward` (`lm.embed`,
`lm.layers`, `lm.head`); `jamba.forward` (`jamba.embed`; each layer's mixer,
`jamba.mamba` or `jamba.attention`, and its feed-forward, `jamba.moe`, routing
included, or `jamba.mlp`, each with its norm and residual add; `jamba.head`).
With no profiler recording it is a shared no-op
behind one check; under a recording profiler it is a
`torch.profiler.record_function`, so the span lands on the profiler's
timeline, on the clock of the device's events, nested under the span open
around it. Nothing else switches it: no flag, no environment variable.

`counts` is always on. It holds every launch of a hand-written kernel, keyed
by its C entry point (`ops/cuda_lib.py::launch`; the entry's name tells fp32
from bf16 and forward from backward), the Triton LN forward's launches
(`triton_ln_fwd`, `triton_ln_fwd_bf16`), the launches of a design variant
(`<entry>:quads`, `<entry>:one_launch`), and the copies the port makes itself
(`copies:<site>`, and their bytes written, `copy_bytes:<site>`), counted
only where a copy is made (site `jamba.moe`: the expert layer's gather of its
rows and its scatter-add back; site `linear`: an operand that `ops.linear`'s
kernel cannot read where it lies), the expert layer's rows
(`moe_rows:routed`, top-k times the tokens; `moe_rows:held`, the rows its
held experts computed), and the calls of `ops.linear` that took `F.linear`
in place of its kernel (`linear:library`).

`record()` profiles a block at the user scope: the spans, and where a card
is in use the device's activity and the runtime calls that launched it, but
no operator, so a recording of a training step stays cheap for the host.
"""
from __future__ import annotations

import collections
import contextlib

import torch

counts: collections.Counter = collections.Counter()

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the block as span `name` while a
    profiler records, and does nothing otherwise."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)


def copied(site: str, out: torch.Tensor) -> torch.Tensor:
    """Count `out` as a copy the port made under `site` (its bytes written),
    and return it: a gather's result, or the rows a scatter writes."""
    counts["copies:" + site] += 1
    counts["copy_bytes:" + site] += out.nbytes
    return out


def _copied(site: str, t: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return out if out is t else copied(site, out)


def contiguous(t: torch.Tensor, site: str) -> torch.Tensor:
    """`t.contiguous()`, a copy counted under `site` where one is made."""
    return _copied(site, t, t.contiguous())


def cast(t: torch.Tensor, dtype: torch.dtype, site: str) -> torch.Tensor:
    """`t.to(dtype)`, a copy counted under `site` where one is made."""
    return _copied(site, t, t.to(dtype))


class Recording:
    """What `record` captured: `result` is the profiler's (its `save(path)`
    writes a Chrome trace), `events` its events; both set when the block
    ends."""
    result = None
    events: list = []


@contextlib.contextmanager
def record():
    """Profile the block at the user scope (module doc), the device's work
    waited for before the profiler stops. Yields a `Recording`."""
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as ap
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available()
    activities = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    config = ap.profile(use_device="cuda" if cuda else None).config()
    ap._prepare_profiler(config, activities)
    ap._enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    rec = Recording()
    try:
        yield rec
        if cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        rec.result = ap._disable_profiler()
        rec.events = list(rec.result.events())
