#!/usr/bin/env python3
"""Instruction mix of the selective-scan kernels' machine code.

    python3 tools/scan_sass.py [--dump DIR]

Builds the port's CUDA kernels, disassembles the two scan objects with
`cuobjdump -sass` and prints, for each kernel, one JSON line: its instruction
count and how many of them are special-function (MUFU), shared-memory loads
and stores (LDS, STS), shuffles, barriers, fused multiply-adds and other
fp32 arithmetic, and for every backward branch (a loop) the number of
instructions the loop body spans. With --dump the disassembly is also written
to DIR, one file per source. Needs nvcc and cuobjdump (the CUDA toolkit).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fusionmamba_torch.ops import cuda_lib

GROUPS = {"mufu": ("MUFU",), "lds": ("LDS",), "sts": ("STS",), "shfl": ("SHFL",),
          "bar": ("BAR",), "ffma": ("FFMA",), "fmul_fadd": ("FMUL", "FADD"),
          "global": ("LDG", "STG", "LDGSTS"), "branch": ("BRA",)}
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)(.*?);")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    lib_path, _ = cuda_lib.build()
    cuobjdump = str(Path(cuda_lib._nvcc()).with_name("cuobjdump"))
    for src in ("selective_scan_fwd.cu", "selective_scan_bwd.cu"):
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path.parent / (src + ".o"))],
                              capture_output=True, text=True, check=True).stdout
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            Path(args.dump, src + ".sass").write_text(sass)
        for chunk in sass.split("Function : ")[1:]:
            name = chunk.split("\n", 1)[0].strip()
            counts, loops, n = collections.Counter(), [], 0
            for addr, op, rest in LINE.findall(chunk):
                n += 1
                for group, prefixes in GROUPS.items():
                    if op.split(".")[0] in prefixes:
                        counts[group] += 1
                target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
                if target and int(target.group(1), 16) < int(addr, 16):
                    loops.append((int(addr, 16) - int(target.group(1), 16)) // 16 + 1)
            print(json.dumps({"source": src, "kernel": name[:90], "instructions": n,
                              **counts, "loop_body_instructions": loops}), flush=True)


if __name__ == "__main__":
    main()
