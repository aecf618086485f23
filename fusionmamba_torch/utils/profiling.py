"""Trace capture (the counterpart of the JAX package's `utils/profiling.py`):
the program's spans and the device's activity, written as a Chrome trace."""
from __future__ import annotations

import contextlib
import os

from . import tracing


@contextlib.contextmanager
def trace(logdir: str = "logs/trace"):
    """Record the block at the user scope (`tracing.record`: the program's
    spans and, where a card is in use, the device's kernels and copies and
    the runtime calls that launched them, but no operator, so the host runs
    at about its untraced pace) and write `<logdir>/trace.json`, a Chrome
    trace (chrome://tracing, Perfetto). Yields the `tracing.Recording`."""
    os.makedirs(logdir, exist_ok=True)
    with tracing.record() as rec:
        yield rec
    rec.result.save(os.path.join(logdir, "trace.json"))
