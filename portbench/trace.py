"""The traced window: torch.profiler over a few units, reduced to what the
per-layer metrics read, one unit more whose idle gaps are named, and the
program's spans and counts over as many units again (`spans.py`).

The reduction is `chip_smoke.py::_trace`'s, copied: the union of the device
events' intervals is the busy time; device time is grouped by the kernel
function each event belongs to (`kernels/*.py`, first match in their order);
copy and cast events are those whose name holds "copy". Added here: the
device operations that took most time, and the idle gaps between device
events named by the innermost host operation open at the gap.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from pathlib import Path

from . import spans as program_spans
from .harness import HERE, load_module, sync

# idle gaps shorter than this are summed as one entry, not named
NAMED_GAP_US = 20.0
# how far back among the host operations a gap's name is looked for
HOST_LOOKBACK = 4000
TOP = 10
UNIT = "portbench.unit"
IN_UNIT = UNIT + " (no operator open: Python between operators)"
OUTSIDE = "(outside the units)"


def kernel_table() -> list:
    """(function, event-name fragments, work or None) of every `kernels/*.py`,
    in the order events are matched: by each file's ORDER, then its name.
    Files that name the same function add their fragments to it."""
    mods = [load_module(p) for p in sorted((HERE / "kernels").glob("*.py"))]
    mods.sort(key=lambda m: (m.ORDER, Path(m.__file__).name))
    return [(m.FUNCTION, tuple(f.lower() for f in m.EVENTS), getattr(m, "work", None))
            for m in mods]


def function_of(name: str, table: list) -> str:
    low = name.lower()
    for function, frags, _ in table:
        if any(f in low for f in frags):
            return function
    return "other"


@dataclasses.dataclass
class Summary:
    units: int
    window_s: float
    busy_s: float
    by_function: dict          # function -> device seconds
    by_name: dict              # kernel name -> device seconds
    copy_events: int
    gaps: dict                 # host operation -> idle seconds of one more unit
    spans: dict                # program span -> `spans.reduce`'s row, ms a unit
    counts: dict               # the program's counts a unit

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _busy(spans):
    """Union of (start, end) spans, and the merged intervals."""
    merged = []
    for st, en in sorted(spans):
        if merged and st <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], en)
        else:
            merged.append([st, en])
    return sum(en - st for st, en in merged), merged


def _gap_names(merged, host):
    """Idle seconds between device intervals by the shortest host operation
    that covers each gap's middle."""
    host.sort()
    starts = [h[0] for h in host]
    units = [(st, en) for st, en, name in host if name == UNIT]
    out = collections.Counter()
    for (_, prev_end), (next_start, _) in zip(merged, merged[1:]):
        gap = next_start - prev_end
        if gap < NAMED_GAP_US:
            out[f"(idle gaps under {NAMED_GAP_US:g} us)"] += gap / 1e6
            continue
        mid = prev_end + gap / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for st, en, name in host[max(0, i - HOST_LOOKBACK):i][::-1]:
            if en >= mid and name != UNIT and (best is None or en - st < best[0]):
                best = (en - st, name)
        if best is None:
            best = (0, IN_UNIT if any(st <= mid <= en for st, en in units) else OUTSIDE)
        out[best[1]] += gap / 1e6
    return dict(out)


def _profile(unit, n: int, device, activities):
    from torch.profiler import profile, record_function

    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function(UNIT):
                unit()
        sync(device)
        window_s = time.perf_counter() - t0
    return prof.events(), window_s


def _device_events(events):
    import torch
    # a record_function's span also shows on the device's timeline
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name != UNIT]


def capture(unit, n: int, device) -> Summary:
    """Profile `n` calls of `unit` (warm) with the device's activity alone,
    for the busy time and the device time by kernel (recording the host's
    operators as well would slow the host several fold and open idle gaps
    that an untraced run does not have); then one more call with the host's
    operators too, whose idle gaps are named by them; last, `n` calls under
    the program's spans (`spans.capture`), so that its profile changes
    nothing that the two before it read."""
    import torch
    from torch.profiler import ProfilerActivity

    table = kernel_table()
    events, window_s = _profile(unit, n, device, [ProfilerActivity.CUDA])
    dev_events = _device_events(events)
    if not dev_events:
        raise RuntimeError("the traced window captured no device event")
    busy_us, _ = _busy([(e.time_range.start, e.time_range.end) for e in dev_events])
    by_function, by_name = collections.Counter(), collections.Counter()
    copies = 0
    for e in dev_events:
        s = (e.time_range.end - e.time_range.start) / 1e6
        by_function[function_of(e.name, table)] += s
        by_name[e.name] += s
        copies += "copy" in e.name.lower()
    del events, dev_events
    events, _ = _profile(unit, 1, device, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA]
    _, merged = _busy([(e.time_range.start, e.time_range.end) for e in _device_events(events)])
    gaps = _gap_names(merged, host)
    del events, host
    program = program_spans.capture(unit, n, device)
    return Summary(n, window_s, busy_us / 1e6, dict(by_function), dict(by_name), copies, gaps,
                   program["spans"], program["counts"])
