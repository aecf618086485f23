"""The program's spans, read against the device: a capture at the user scope
and its reduction into device and idle time by span.

The capture profiles a few units with the device's activity and the host at
the user scope only (`record_function` spans and the runtime calls that
launch device work, no operator), so the host runs at about its untraced
pace. The reduction, for each span name, a unit:

- `host_ms`: the host's time inside the span;
- `device_ms`: the busy union of the device events launched while the span
  was open, on any thread (autograd launches the backward's kernels from a
  thread of its own while the main thread waits inside its span); an event
  is mapped to its launch by correlation id;
- `self_device_ms`: of those, the events whose innermost open span it was;
- `idle_ms`: the device's idle gaps whose middle falls inside the span on
  the main thread; `self_idle_ms` the gaps of which it was the innermost
  span there, the gaps under no span going to OUTSIDE.

`trace.capture` runs this capture after its own two profiles, and the
per-layer metrics of `source` `program_span` and `program_counter` read its
table and the difference of the program's counts
(`fusionmamba_torch.utils.tracing.counts`, where the program has them) a
unit. By hand, `python3 -m portbench.spans --workload NAME --seed N` sets a
cell up as `run.py` does, runs `trace.capture` and then this capture over
the mix's `trace_units`, and prints both; then ROUNDS device-alone and span
captures in turns, whose idle shares give the span capture's cost.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import json
import sys
import time

# the span the capture opens around its units and their last sync, whose
# range is the window
WINDOW = "portbench.spans.window"
OUTSIDE = "(outside the program's spans)"
# device-alone and span captures in turns, for the span capture's cost
ROUNDS = 3
# seconds the profiler stays on after the window's last sync: CUPTI hands
# over the records of the last kernels some time after they end, and a
# profiler stopped at once lost the last training step's optimizer kernels
# in 4 of 14 captures on an H100, none of 14 with this wait
SETTLE_S = 0.2


@dataclasses.dataclass
class Event:
    """A profiler event as the reduction reads it (times in ns)."""
    name: str
    start: int
    end: int
    thread: int
    device: bool
    annotation: bool
    correlation: int
    linked: int = 0


def from_kineto(e) -> Event:
    import torch
    return Event(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                 e.device_type() != torch.autograd.DeviceType.CPU, e.is_user_annotation(),
                 e.correlation_id(), e.linked_correlation_id())


def _merge(intervals):
    merged = []
    for st, en in sorted(intervals):
        if merged and st <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], en)
        else:
            merged.append([st, en])
    return merged


def _busy(intervals) -> int:
    return sum(en - st for st, en in _merge(intervals))


def _innermost(spans, t):
    """The shortest of `spans` (sorted by start) open at t, or None."""
    i = bisect.bisect_right([s.start for s in spans], t)
    best = None
    for s in spans[:i]:
        if s.end >= t and (best is None or s.end - s.start < best.end - best.start):
            best = s
    return best


def reduce(events: list, units: int) -> dict:
    """{"window_ms", "busy_ms", "idle_ms", "spans": {name: {...}}, "unmatched"}
    a unit, from the events of a capture (module doc)."""
    host = [e for e in events if not e.device]
    window = next(e for e in host if e.annotation and e.name == WINDOW)
    spans = sorted((e for e in host if e.annotation and e.name != WINDOW),
                   key=lambda e: e.start)
    names = {s.name for s in spans}
    # device-side copies of the spans, where the profiler makes them
    device = [e for e in events if e.device and not e.annotation and e.name not in names]
    launch = {e.correlation: e.start for e in host if not e.annotation and e.correlation > 0}
    by_id = {s.correlation: s for s in spans}
    main = window.thread
    on_main = [s for s in spans if s.thread == main]

    incl, own, unmatched = collections.defaultdict(list), collections.defaultdict(list), 0
    for e in device:
        t = launch.get(e.correlation)
        if t is None and e.linked in by_id:
            t = by_id[e.linked].start
        if t is None:
            unmatched += 1
            continue
        iv = (e.start, e.end)
        for name in {s.name for s in spans if s.start <= t <= s.end}:
            incl[name].append(iv)
        inner = _innermost(spans, t)
        own[inner.name if inner else OUTSIDE].append(iv)

    merged = _merge([(e.start, e.end) for e in device])
    edges = [window.start] + [x for iv in merged for x in iv] + [window.end]
    idle, self_idle = collections.Counter(), collections.Counter()
    for st, en in zip(edges[0::2], edges[1::2]):
        if en <= st:
            continue
        mid = (st + en) / 2
        for name in {s.name for s in on_main if s.start <= mid <= s.end}:
            idle[name] += en - st
        inner = _innermost(on_main, mid)
        self_idle[inner.name if inner else OUTSIDE] += en - st

    ms = 1e-6 / units
    host_ns = collections.Counter()
    for s in spans:
        host_ns[s.name] += s.end - s.start
    table = {}
    for name in sorted(names | set(own) | set(self_idle)):
        table[name] = {"host_ms": host_ns[name] * ms, "device_ms": _busy(incl[name]) * ms,
                       "self_device_ms": _busy(own[name]) * ms, "idle_ms": idle[name] * ms,
                       "self_idle_ms": self_idle[name] * ms}
    busy = _busy([(e.start, e.end) for e in device])
    window_ns = window.end - window.start
    return {"window_ms": window_ns * ms, "busy_ms": busy * ms,
            "idle_ms": (window_ns - busy) * ms,
            "program_idle_ms": sum(v for k, v in self_idle.items() if k != OUTSIDE) * ms,
            "spans": table, "unmatched": unmatched}


def _counts():
    """The program's counts, where it keeps them."""
    try:
        from fusionmamba_torch.utils import tracing
    except ImportError:
        return collections.Counter()
    return collections.Counter(tracing.counts)


@contextlib.contextmanager
def _user_scope(cuda: bool):
    """The profiler on with the device's activity and the host's user scope
    alone; yields a list that holds the profiler's events when it stops."""
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as ap
    from torch.profiler import ProfilerActivity

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    config = ap.profile(use_device="cuda" if cuda else None).config()
    ap._prepare_profiler(config, acts)
    ap._enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    out = []
    try:
        yield out
    finally:
        out.extend(ap._disable_profiler().events())


def capture(unit, n: int, device) -> dict:
    """`n` calls of `unit` (warm) under the user-scope profiler, reduced;
    with "counts", the program's counts that the calls added, a unit, and
    "kinds", how many events of each kind the capture recorded."""
    from torch.profiler import record_function

    from .harness import sync

    sync(device)
    before = _counts()
    with _user_scope(device.type == "cuda") as raw:
        with record_function(WINDOW):
            for _ in range(n):
                unit()
            sync(device)
        time.sleep(SETTLE_S)
    after = _counts()
    events = [from_kineto(e) for e in raw]
    out = reduce(events, n)
    out["counts"] = {k: (after[k] - before[k]) / n for k in sorted(after) if after[k] != before[k]}
    out["kinds"] = {"spans": sum(e.annotation and not e.device for e in events),
                    "device": sum(e.device and not e.annotation for e in events),
                    "runtime": sum(not e.annotation and not e.device for e in events),
                    "operators": sum(e.name.startswith("aten::") for e in events)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="spans of a cell's units against the device")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch

    from fusionmamba_torch.device import select_device

    from . import harness
    from . import trace as tr
    select_device("cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.make_cell(spec, args.workload, args.seed, 0.0, True, dev)
    run = harness.job_module(cell.mix).Run(cell)
    n = int(cell.mix["trace_units"])
    alone = tr.capture(run.unit, n, dev)
    spans = capture(run.unit, n, dev)
    # the cost of the span capture: the idle shares of device-alone captures
    # (as `trace.capture` records its metrics) and span captures in turns
    from torch.profiler import ProfilerActivity
    turns = []
    for _ in range(ROUNDS):
        events, window_s = tr._profile(run.unit, n, dev, [ProfilerActivity.CUDA])
        busy_us, _ = tr._busy([(e.time_range.start, e.time_range.end)
                               for e in tr._device_events(events)])
        again = capture(run.unit, n, dev)
        turns.append([1.0 - busy_us / 1e6 / window_s, again["idle_ms"] / again["window_ms"]])
    line = {"workload": args.workload, "seed": args.seed, "units": n,
            "device": torch.cuda.get_device_name(dev),
            "setup_s": time.perf_counter() - t_start,
            "device_alone": {"window_ms": 1e3 * alone.window_s / n,
                             "busy_ms": 1e3 * alone.busy_s / n,
                             "idle_share": 1.0 - alone.busy_s / alone.window_s,
                             "optimizer_ms": 1e3 * alone.by_function.get("optimizer", 0.0) / n,
                             "copy_events": alone.copy_events / n},
            "span_capture": spans, "idle_shares_alone_then_spans": turns}
    spans["idle_share"] = spans["idle_ms"] / spans["window_ms"]
    for name, row in spans["spans"].items():
        print(f"portbench.spans: {name:40s} " + " ".join(f"{k} {v:9.3f}" for k, v in row.items()),
              file=sys.stderr)
    for key, v in spans["counts"].items():
        print(f"portbench.spans: count {key} {v:g}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
