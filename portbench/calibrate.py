#!/usr/bin/env python3
"""The readings that a cell's limits are set from, for several seeds in one
process: the program's numbers against the reference and, with --control,
the control's (the reference in the next precision below the cell's, in the
program's place).

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,3 [--units 4] [--control 3]
        [--fault state_unchanged|half_batch|answer_altered] [--traffic MIX]

Each seed runs the cell's set-up, `--units` units of its window (none for
training, whose numbers come from set-up), frees the program and checks;
the first `--control` seeds also run the control. `--traffic` runs the
workload's configuration under another mix of `mixes/`, one that no cell
uses yet. One JSON line a seed.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default=None, help="plant this fault (portbench/faults.py)")
    ap.add_argument("--traffic", default=None, help="a mix of portbench/mixes/ in the cell's place")
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "portbench", "triton")
    sys.path.insert(0, ROOT)
    import torch

    from portbench import faults, harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from fusionmamba_torch.device import select_device
    dev = select_device("cuda")
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.make_cell(spec, args.workload, seed, 0.0, False, dev)
        if args.traffic:
            cell.mix = harness.load_json(harness.HERE / "mixes" / f"{args.traffic}.json")
        job = harness.job_module(cell.mix)
        mend = faults.plant(cell, args.fault) if args.fault else (lambda: None)
        try:
            run = job.Run(cell)
            for _ in range(args.units):
                run.unit()
        finally:
            mend()
        harness.sync(dev)
        t1 = time.perf_counter()
        run.release()
        gc.collect()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "traffic": args.traffic, "seed": seed, "fault": args.fault, "setup_s": t1 - t0,
                "program": run.check()}
        t2 = time.perf_counter()
        line["reference_s"] = t2 - t1
        line["program_detail"] = getattr(run, "detail", None)
        if i < args.control:
            line["control"] = run.check_control()
            line["control_s"] = time.perf_counter() - t2
            line["control_detail"] = getattr(run, "detail", None)
        line["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
