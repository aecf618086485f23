"""Build and load the port's CUDA kernels (`fusionmamba_torch/csrc/*.cu`).

Every source is compiled by `nvcc` for `sm_90a` (one process per source, all
started together), and the objects are linked into one shared library with a
plain C interface that `ctypes` loads. Each C entry point launches its kernel
on the stream it is given and returns `cudaGetLastError()`.

The build happens at first use, into `build/fusionmamba_torch/<hash>/` beside
the package, where `<hash>` covers the sources and the flags: an edited source
gets a fresh build and a finished build is reused. Nothing is compiled when a
module is imported, so the CPU path needs no CUDA toolkit. A process whose
environment sets FM_CUDA_SOURCES (a comma-separated subset of SOURCES) builds
and loads only those sources: a timing tool need not wait for the others.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "fusionmamba_torch"
SOURCES = ("selective_scan_fwd.cu", "selective_scan_bwd.cu", "dwconv3x3_fwd.cu",
           "dwconv3x3_bwd.cu", "fused_mlp_fwd.cu", "fused_mlp_bwd.cu", "layer_norm_bwd.cu",
           "ln_mean_fwd.cu", "linear_tf32x3.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libfusionmamba_kernels.so"
SOURCES_ENV = "FM_CUDA_SOURCES"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    # u, dt, W, A, B, C, D, bias, out, hsave, carry, sdel, batch, K, L, dim, N,
    # R, softplus, save_every, chunk_len, stream
    "fm_selective_scan_fwd": (_P,) * 12 + (_I,) * 9 + (_P,),
    # u, dt, W, A, B, C, D, bias, hsave, dy, du, ddt, dW, dA, dB, dC, dD, dbias,
    # scratch, batch, K, L, dim, N, R, T, softplus, chunk_len, stream
    "fm_selective_scan_bwd": (_P,) * 19 + (_I,) * 9 + (_P,),
    # x, w (C,9), bias, out, B, H, W, C, act_silu, cq, tw, th, grid x, y, z,
    # params, stream
    "fm_dwconv3x3_fwd": (_P,) * 4 + (_I,) * 12 + (_P,),
    # x, w (C,9), bias, dy, dx, part, out (10,C), B, H, W, C, act_silu, cq, tw,
    # th, grid x, y, params, stream
    "fm_dwconv3x3_bwd": (_P,) * 7 + (_I,) * 11 + (_P,),
    # x, w1 (H,C), b1, w2 (C_out,H), b2, y, hidden (or null), partial (or
    # null), M, C, H, C_out, slice_h, stream
    "fm_fused_mlp_fwd": (_P,) * 8 + (_I,) * 5 + (_P,),
    # x, dy, w1, b1, w2, a_buf, g_buf, db1_p, db2_p, dx_p, dw1_p, dw2_p, dx,
    # dw1, db1, dw2, db2, M, C, H, C_out, slice_dx, slice_w, hidden blocks,
    # product blocks (the fp32 engine's grids), stream
    "fm_fused_mlp_bwd": (_P,) * 17 + (_I,) * 8 + (_P,),
    # x, gate, scale, bias, dy, dx, dgate, part, dscale, dbias, rows, C,
    # gate kind, values, lanes, masked, quads, blocks, params, eps, stream
    "fm_layer_norm_bwd": (_P,) * 10 + (_I,) * 9 + (_F, _P),
    # x, scale, dm, xmean, dx, part, dscale, dbias, B, rows, C, values, lanes,
    # masked, quads, blocks, params, eps, stream
    "fm_ln_mean_bwd": (_P,) * 8 + (_I,) * 9 + (_F, _P),
    # x, scale, bias, out, xmean, B, rows, C, values, lanes, masked, quads,
    # unroll, cluster, params, eps, stream
    "fm_ln_mean_fwd": (_P,) * 5 + (_I,) * 10 + (_F, _P),
}
# every kernel also has a bf16-I/O variant, `<name>_bf16`, with the same
# arguments: the tensors that its wrapper's check names bf16 are bf16 there
# (the LN's, LN-mean's and dwconv's parameters also where `params` is 1; the
# fp32 entries take only 0), and the math inside stays fp32
SIGNATURES.update({name + "_bf16": args for name, args in list(SIGNATURES.items())})
# fp32 only: x, w, y, M, N, K, ldx, ldw, blocks, stream
SIGNATURES["fm_linear"] = (_P,) * 3 + (_I,) * 6 + (_P,)
IO_DTYPES = (torch.float32, torch.bfloat16)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def sources() -> tuple[str, ...]:
    """The sources this process builds: SOURCES, or the subset of them that
    FM_CUDA_SOURCES names."""
    names = os.environ.get(SOURCES_ENV)
    if not names:
        return SOURCES
    unknown = set(names.split(",")) - set(SOURCES)
    if unknown:
        raise ValueError(f"{SOURCES_ENV}: no such source {sorted(unknown)}")
    return tuple(s for s in SOURCES if s in names.split(","))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, "|", *srcs)).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out}")
    return "".join(outs)


def build() -> tuple[Path, str]:
    """Compile the kernels if this source set has no library yet. Returns the
    library's path and the compiler's output (empty when it was built before)."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / LIB_NAME
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path, ""
        nvcc = _nvcc()
        objs = [out_dir / (s + ".o") for s in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                        for s, o in zip(srcs, objs)])
        tmp = out_dir / (LIB_NAME + ".tmp")
        log += _run_all([[nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                          "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib_path)
    return lib_path, log


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()[0]))
        subset = sources() != SOURCES
        for name, argtypes in SIGNATURES.items():
            if subset and not hasattr(handle, name):
                continue  # an entry of a source left out of this build
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, *args, device: torch.device) -> None:
    """Call C entry point `name` on the current stream of `device`, counted
    in `tracing.counts[name]`; raise on a launch error."""
    tracing.counts[name] += 1
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name(device)})")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The number of SMs of the card `device`."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def needs_grad(*tensors) -> bool:
    """Whether an op on these tensors (None allowed) must record its backward:
    the ops take their autograd Function then, and their forward kernel
    alone otherwise (serving, `torch.inference_mode`)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def entry(name: str, io: torch.dtype) -> str:
    """The C entry point of kernel `name` for I/O dtype `io`."""
    return name + "_bf16" if io == torch.bfloat16 else name


def io_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    """The I/O dtype a kernel takes from `t`: float32 or bfloat16."""
    if t.dtype not in IO_DTYPES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    return t.dtype


def param_dtype(io: torch.dtype, *params) -> torch.dtype:
    """The dtype in which the LN, LN-mean and dwconv kernels read their
    parameters (scale, bias, the conv's weight; None skipped) beside
    activations of I/O dtype `io`: bf16 where `io` and every parameter is
    bf16 (a bf16 step's casts, read as they are and widened as they are
    loaded), else fp32 (the ops cast to it)."""
    bf16 = io == torch.bfloat16 and all(p is None or p.dtype == torch.bfloat16 for p in params)
    return torch.bfloat16 if bf16 else torch.float32


def check_cuda(name: str, io: torch.dtype, *tensors: torch.Tensor, fp32=(),
               params=()) -> torch.dtype:
    """Reject what the kernels do not take: tensors on the CPU, on different
    cards or not contiguous, `tensors` whose dtype is not `io` (the I/O
    dtype, float32 or bfloat16), `fp32` ones (what the kernels read as fp32
    whatever the I/O dtype) whose dtype is not float32, and `params` (None
    skipped) not all of `param_dtype(io, *params)`, which is returned."""
    params = [p for p in params if p is not None]
    pdt = param_dtype(io, *params)
    dev = (tensors or fp32 or params)[0].device
    for want, group in ((io, tensors), (torch.float32, fp32), (pdt, params)):
        for t in group:
            if t.device != dev or t.device.type != "cuda":
                raise ValueError(f"{name}: all tensors must be on one CUDA device")
            if t.dtype != want:
                raise TypeError(f"{name}: expected {want}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: expected contiguous tensors")
    return pdt
