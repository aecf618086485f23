#!/usr/bin/env python3
"""The tensor-core and copy instructions of the MLP kernels' machine code.

    python3 tools/mlp_sass.py

Builds the port's CUDA kernels, disassembles the two MLP objects
(`fused_mlp_fwd.cu`, `fused_mlp_bwd.cu`) with `cuobjdump -sass` and prints,
for each kernel, one JSON line: its I/O type as the mangled name gives it
(the bf16 variants are the `bf` namespace's, the engine's
`fm_wg::product_kernel` and the reduces instantiated for bf16), and how
many of its instructions are warpgroup products (HGMMA) and warp products
(HMMA) by operand type, TF32 ones of either, and TMA tensor loads
(UTMALDG). A bf16 kernel with products must hold bf16 HGMMA, TMA loads and
no TF32 instruction; the script exits 1 otherwise. Needs nvcc and cuobjdump
(the CUDA toolkit).
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fusionmamba_torch.ops import cuda_lib

# an instruction's opcode with its modifiers (HGMMA.64x64x16.F32.BF16)
OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Za-z0-9_.]*)")


def main() -> None:
    lib_path, _ = cuda_lib.build()
    cuobjdump = str(Path(cuda_lib._nvcc()).with_name("cuobjdump"))
    bad = []
    for src in ("fused_mlp_fwd.cu", "fused_mlp_bwd.cu"):
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path.parent / (src + ".o"))],
                              capture_output=True, text=True, check=True).stdout
        for chunk in sass.split("Function : ")[1:]:
            name = chunk.split("\n", 1)[0].strip()
            ops = collections.Counter(OP.findall(chunk))
            products = {op: n for op, n in ops.items() if op.startswith(("HGMMA", "HMMA"))}
            tf32 = sum(n for op, n in products.items() if "TF32" in op)
            bf16 = sum(n for op, n in products.items() if "BF16" in op)
            tma = sum(n for op, n in ops.items() if op.startswith("UTMALDG"))
            bf16_names = ("bf12fused_kernel", "bf13hidden_kernel", "fm_wg", "nv_bfloat16")
            io = "bf16" if any(k in name for k in bf16_names) else "fp32"
            print(json.dumps({"source": src, "kernel": name[:100], "io": io,
                              "products": products, "tf32_products": tf32,
                              "bf16_products": bf16, "tma_loads": tma}), flush=True)
            if io == "bf16" and products and (tf32 or not bf16 or not tma):
                bad.append(name)
    if bad:
        sys.exit(f"bf16 kernels with TF32 products, or without bf16 ones or TMA: {bad}")


if __name__ == "__main__":
    main()
