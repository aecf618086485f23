"""Arithmetic that the metric readers share: the table of peaks, a kernel's
least time at its shapes, and the model's share of the chip's peak."""
from __future__ import annotations

import functools

from .harness import HERE, load_json, load_module

@functools.cache
def peaks() -> dict:
    return load_json(HERE / "peaks.json")


def io_bytes(win) -> int:
    """Bytes of an element of the kernels' I/O tensors in this cell."""
    return 2 if win.cell.mix.get("precision") == "bf16" else 4


def bound_s(calls: dict, io: int) -> float:
    """Least seconds of `calls` (kernel -> Counter(shape -> calls)): each
    call at the larger of its bytes over the memory's rate, its operations
    over the rate its design runs them at, and its special-function calls
    over theirs."""
    p = peaks()
    total = 0.0
    for kernel, shapes in calls.items():
        mod = load_module(HERE / "kernels" / f"{kernel}.py")
        for shape, n in shapes.items():
            nbytes, ops, sfu = mod.work(shape, io)
            total += n * max(nbytes / p["hbm_bytes_per_s"], ops / p[mod.rate(io)],
                             sfu / p["sfu_calls_per_s"])
    return total


def device_s(win, functions) -> float:
    return sum(win.trace.by_function.get(f, 0.0) for f in functions)


def roofline(win, calls_per_unit: dict) -> float | None:
    """The kernels' least time over their device time in the traced window,
    in %; None where the trace holds none of their events."""
    spent = device_s(win, calls_per_unit)
    if spent <= 0.0:
        return None
    return 100.0 * win.units * bound_s(calls_per_unit, io_bytes(win)) / spent


def mfu(win, flops_per_item: float) -> float:
    """Model FLOPs of the traced window's work over the window and the peak of
    the cell's compute dtype, in %."""
    peak = peaks()[win.cell.mix.get("precision", "fp32")]
    return 100.0 * flops_per_item * win.items / (win.trace.window_s * peak)


def idle_share(win) -> float:
    return 100.0 * (1.0 - win.trace.busy_s / win.trace.window_s)


def span_ms(win, span: str, key: str = "device_ms") -> float | None:
    """`key` of the program's span `span` (`spans.reduce`'s row), ms a unit
    of the traced window; None where the program has no such span."""
    row = win.trace.spans.get(span)
    return None if row is None else row[key]
