"""The native preprocessing library of the port: PIL-exact bicubic resize,
BT.601 gray and / 255 in C++ with OpenMP, bound by ctypes. The port's
counterpart of `fusionmamba_tpu/data/native.py`, built from its own copy of
the source (`fusionmamba_torch/native/preprocess.cpp`, the same bytes as the
JAX package's `native/preprocess.cpp`), so both packages give the same bits.

The library is built with g++ at first use, never at import, into
`build/fusionmamba_torch/native-<hash of the source and flags>/` beside the
kernels' builds, under a file lock (loader threads reach it together). The
flags are the JAX package's Makefile's, without `-march=native` or
`-ffast-math`: contracting the double sums into FMAs would change the
rounding. A compiler without OpenMP (no libgomp) builds the same source
without `-fopenmp`, with a warning: its loops then run on one thread a call
and compute the same bits. A build that fails otherwise raises with the
compiler's log; nothing falls back to PIL.

`FusionDataset` takes `preprocess_pair` for its vis/ir items, as the JAX
dataset does where its library loads. The resize accumulates in double where
PIL uses 8.8 fixed point, so the two can differ by one uint8 step;
`datasets.preprocess_pair_plain` is the PIL version.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "preprocess.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "fusionmamba_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17")
LIB_NAME = "libpreprocess.so"

pairs = 0   # pairs preprocessed by `preprocess_pair`

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}"


def build() -> Path:
    """Compile the library if this source has none yet; returns its path."""
    out_dir = _build_dir()
    lib_path = out_dir / LIB_NAME
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native preprocessing library needs a C++ "
                               "compiler")
        tmp = out_dir / (LIB_NAME + ".tmp")

        def compile_with(flags):
            done = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            return done.returncode, done.stdout + done.stderr

        rc, log = compile_with(CXX_FLAGS)
        if rc != 0:
            serial_rc, serial_log = compile_with([f for f in CXX_FLAGS if f != "-fopenmp"])
            if serial_rc != 0:
                raise RuntimeError(f"building {SOURCE.name} failed ({rc}):\n{log}\n"
                                   f"and without -fopenmp ({serial_rc}):\n{serial_log}")
            warnings.warn(f"{SOURCE.name} built without OpenMP, one thread a call; with "
                          f"-fopenmp ({rc}):\n{log}")
        os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i = ctypes.c_int
            handle.resize_bicubic_u8.argtypes = [u8, i, i, i, u8, i, i]
            handle.rgb_to_gray_u8.argtypes = [u8, i, i, u8]
            handle.preprocess_pair_item.argtypes = [u8, i, i, u8, i, i, i, i, f32, f32]
            handle.preprocess_num_threads.restype = i
            _lib = handle
    return _lib


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> (out_h, out_w[, C]), PIL BICUBIC's
    arithmetic in double."""
    squeeze = img.ndim == 2
    img = np.ascontiguousarray(img[..., None] if squeeze else img, np.uint8)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    lib().resize_bicubic_u8(img, h, w, c, out, out_h, out_w)
    return out[..., 0] if squeeze else out


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> (H, W): BT.601 luma, rounded."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((h, w), np.uint8)
    lib().rgb_to_gray_u8(rgb, h, w, out)
    return out


def preprocess_pair(rgb: np.ndarray, ir: np.ndarray,
                    out_hw=(256, 256)) -> tuple[np.ndarray, np.ndarray]:
    """The visible image's luma and the IR image, each resized to out_hw and
    / 255: (vis_y, ir) float32 (H, W, 1) in [0, 1], in one call that holds no
    GIL."""
    global pairs
    rgb = np.ascontiguousarray(rgb, np.uint8)
    ir = np.ascontiguousarray(ir, np.uint8)
    oh, ow = out_hw
    vis_y = np.empty((oh, ow), np.float32)
    ir_out = np.empty((oh, ow), np.float32)
    lib().preprocess_pair_item(rgb, rgb.shape[0], rgb.shape[1], ir, ir.shape[0], ir.shape[1],
                               oh, ow, vis_y, ir_out)
    with _lock:
        pairs += 1
    return vis_y[..., None], ir_out[..., None]


def num_threads() -> int:
    """The OpenMP threads a call may use."""
    return lib().preprocess_num_threads()
