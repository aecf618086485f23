"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel sits in a file of its own that this module finds by name:
`configs/<config>.json` (whose `model` names `makers/<model>.py`, found by
`build.py`), `mixes/<traffic>.json` (whose `job` names `jobs/<job>.py`),
`limits/<workload>.json`, `metrics/<metric>.py` (or, where there is no such
file, `metrics/<prefix>.py` for a metric named `<prefix>.<cells>`) and
every `kernels/*.py`; the CPU tests' sizes in `tests/tiny/<config>.json`.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "fusionmamba_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file at `path` as a module (its name may hold dots)."""
    name = "portbench_" + "_".join(path.relative_to(HERE).with_suffix("").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def job_module(mix: dict):
    """`jobs/<job>.py` of a traffic mix: its `Run`, and the faults it can
    have (`FAULTS`, and for a training job `STEP`)."""
    return load_module(HERE / "jobs" / f"{mix['job']}.py")


def metric_file(name: str) -> Path:
    """`metrics/<name>.py`; where that does not exist and the name is
    `<prefix>.<cells>`, `metrics/<prefix>.py`, the one reader of a quantity
    that several kinds of cell report under names of their own."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return path


# (phase, seconds since the process started) of the run's set-up, for the
# record on standard error
STAMPS: list = []
T_START = [time.perf_counter()]


def stamp(phase: str) -> None:
    STAMPS.append((phase, round(time.perf_counter() - T_START[0], 3)))


def forbidden_modules() -> list:
    """The forbidden top-level names that `sys.modules` holds, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """What a job is given: the workload entry, its configuration, its
    traffic mix and limits, and the run's arguments."""
    workload: dict
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    spec: dict = dataclasses.field(default_factory=dict)


def make_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool, device) -> Cell:
    matches = [w for w in spec["workloads"] if w["name"] == name]
    if not matches:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = matches[0]
    config = {e["name"]: e for e in spec["configs"]}[wl["config"]]
    return Cell(wl, load_json(ROOT / config["file"]),
                load_json(HERE / "mixes" / f"{wl['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"), seed, seconds, trace, device, spec)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    """What the metric readers read: the window's counts and times, the
    set-up time, and with --trace 1 the reduced trace."""
    cell: Cell
    units: int
    items: int
    window_s: float
    setup_s: float
    unit_seconds: list
    trace: object = None


def measure(run, cell: Cell, t_start: float) -> Window:
    """The window: units dispatched back to back until `cell.seconds` have
    passed (with --trace 1, the mix's `trace_units` under the profiler),
    from a synchronised start to the synchronisation after the last."""
    import torch
    dev = cell.device
    sync(dev)
    setup_s = time.perf_counter() - t_start
    stamp("window opens")
    if cell.trace:
        from . import trace as tr
        summary = tr.capture(run.unit, int(cell.mix["trace_units"]), dev)
        return Window(cell, summary.units, summary.units * run.items_per_unit, summary.window_s,
                      setup_s, [], summary)
    stamps = []
    t0 = time.perf_counter()
    last = t0
    while True:
        run.unit()
        now = time.perf_counter()
        stamps.append(now - last)
        last = now
        if now - t0 >= cell.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    return Window(cell, len(stamps), len(stamps) * run.items_per_unit, window_s, setup_s, stamps)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def read_metrics(spec: dict, win: Window) -> dict:
    kind = "per_layer" if win.cell.trace else "end_to_end"
    out = {}
    for m in spec[kind]:
        if not applies(m, win.cell.workload["name"]):
            continue
        value = load_module(metric_file(m["name"])).read(win)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limit; a missing or non-finite
    reading fails."""
    out = {}
    for name, limit in limits["limits"].items():
        value = readings.get(name)
        out[name] = {"value": value if value is None or math.isfinite(value) else str(value),
                     "limit": limit}
    return out


def correct(checks: dict) -> bool:
    return all(isinstance(c["value"], float) and c["value"] <= c["limit"] for c in checks.values())


def run_cell(cell: Cell, t_start: float) -> dict:
    """Set up, measure, free the program, check; returns the result line
    (without the device's name and count, which `main` adds)."""
    import torch
    job = job_module(cell.mix)
    stamp("job imported")
    run = job.Run(cell)
    stamp("program set up")
    win = measure(run, cell, t_start)
    print(f"portbench: set-up phases (s since start): {STAMPS}", file=sys.stderr)
    print(f"portbench: window units (ms): {unit_summary(win.unit_seconds)}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    attempted, failed = win.units, run.failed()
    run.release()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = run.check()
    checks = judge(readings, cell.limits)
    line = {"correct": correct(checks) and failed == 0, "attempted": attempted, "failed": failed,
            "metrics": read_metrics(cell.spec, win),
            "device": {"memory_peak_bytes": peak}}
    if win.trace is not None:
        line["device"].update(busy_s=win.trace.busy_s, window_s=win.trace.window_s)
        line["breakdown"] = win.trace.breakdown()
    line["checks"] = checks
    return line


def unit_summary(seconds: list) -> dict:
    """The window's unit times in ms: quantiles, and how many units took
    over 1.05 times the median (for the record on standard error)."""
    import statistics
    if len(seconds) < 2:
        return {}
    ms = sorted(1e3 * s for s in seconds)
    q = statistics.quantiles(ms, n=100)
    med = statistics.median(ms)
    return {"units": len(ms), "p50": round(med, 3), "p90": round(q[89], 3),
            "p95": round(q[94], 3), "p99": round(q[98], 3), "max": round(ms[-1], 3),
            "over_1.05_median": sum(v > 1.05 * med for v in ms)}


def main(args, t_start: float) -> int:
    T_START[0] = t_start
    spec = load_json(ROOT / "BENCHMARK.json")
    import torch
    stamp("torch imported")
    matches = [w for w in spec["workloads"] if w["name"] == args.workload]
    if not matches:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = matches[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from fusionmamba_torch.device import select_device
    select_device("cuda")      # the program's numerics: full fp32, deterministic cuDNN
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats(dev)
    stamp("device ready")
    cell = make_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), dev)
    line = run_cell(cell, t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds forbidden modules {found}", file=sys.stderr)
        return 1
    line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                      **line["device"]}
    checks = line.pop("checks")
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
