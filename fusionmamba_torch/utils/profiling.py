"""Timing and trace capture (the counterpart of the JAX package's
`utils/profiling.py`): wall time with the device synchronised, and a
`torch.profiler` capture written as a Chrome trace."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _sync() -> None:
    """Wait for the card's queued work, where a card is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 10, **kwargs) -> dict:
    """Median, mean and least wall time of fn(*args, **kwargs), each call
    ended by a device synchronisation."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"median_s": times[len(times) // 2], "mean_s": sum(times) / len(times),
            "min_s": times[0], "iters": iters}


@contextlib.contextmanager
def trace(logdir: str = "logs/trace"):
    """Profile the block (host and, where a card is in use, device
    activity) and write `<logdir>/trace.json`, a Chrome trace
    (chrome://tracing, Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
