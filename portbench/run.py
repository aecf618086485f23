#!/usr/bin/env python3
"""The benchmark of fusionmamba_torch, the PyTorch and CUDA port, on one
NVIDIA GPU: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Builds (or reuses, under build/ in the checkout) the port's kernels, makes
the weights and inputs from the seed, warms up, measures for S seconds
(with --trace 1, a few units under torch.profiler instead), checks what the
window produced against the plain reference, and prints one JSON line: the
cell's end-to-end metrics (--trace 0) or per-layer metrics (--trace 1), the
device, and each compared number beside its limit. Without a CUDA device it
exits with 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # Triton's kernel cache at a fixed place inside the checkout, so that only
    # a cell's first run there compiles
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "portbench", "triton")
    sys.path.insert(0, ROOT)
    from portbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
