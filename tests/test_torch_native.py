"""The port's native preprocessing library (`fusionmamba_torch/data/native.py`)
against the JAX package's (`fusionmamba_tpu/data/native.py`), on the CPU.

Both come from the same C++ source (the port keeps its own copy), built with
the same flags, so their outputs are held equal bit for bit; against the
port's PIL version (`datasets.preprocess_pair_plain`) to one uint8 step,
1/255 (+1e-6 for the float32 division), since PIL resizes in 8.8 fixed point
and the library in double. Inputs are seeded numpy images.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fusionmamba_torch.data import native, preprocess_pair_plain
from fusionmamba_tpu.data import native as jnative

REPO = Path(__file__).resolve().parent.parent
OUT = (256, 256)
SIZES = [(720, 1280), (300, 220), (100, 90)]


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    # smooth fields with noise on top: both the lobes' overshoot and
    # flat regions reach the rounding
    coarse = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3))
    smooth = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    rgb = np.clip(smooth + rng.normal(0, 20, smooth.shape), 0, 255).astype(np.uint8)
    ir = rng.integers(0, 256, (h, w), np.uint8)
    return rgb, ir


def test_jax_library_loads():
    assert jnative.available()


def test_source_is_a_copy_of_the_jax_package():
    assert native.SOURCE.read_bytes() == (REPO / "native" / "preprocess.cpp").read_bytes()


@pytest.mark.parametrize("h,w", SIZES)
def test_preprocess_pair_equals_jax_and_near_pil(h, w):
    rgb, ir = _images(h, w, h + w)
    before = native.pairs
    got = native.preprocess_pair(rgb, ir, OUT)
    want = jnative.preprocess_pair(rgb, ir, OUT)
    assert native.pairs == before + 1
    for g, jw, pw in zip(got, want, preprocess_pair_plain(rgb, ir, OUT)):
        assert g.dtype == np.float32 and g.shape == (*OUT, 1)
        np.testing.assert_array_equal(g, jw)
        np.testing.assert_allclose(g, pw, rtol=0, atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h,w", SIZES)
def test_resize_bicubic_equals_jax(h, w, channels):
    rgb, ir = _images(h, w, 3 * h + w)
    img = ir if channels == 1 else rgb
    got = native.resize_bicubic(img, *OUT)
    np.testing.assert_array_equal(got, jnative.resize_bicubic(img, *OUT))
    assert got.shape == OUT + img.shape[2:]


@pytest.mark.parametrize("h,w", SIZES)
def test_rgb_to_gray_equals_jax(h, w):
    rgb, _ = _images(h, w, h * w)
    np.testing.assert_array_equal(native.rgb_to_gray(rgb), jnative.rgb_to_gray(rgb))


def test_builds_at_first_call_not_at_import(tmp_path):
    """In a fresh process: importing the package and its data modules loads
    and builds nothing; the first call builds under BUILD_ROOT."""
    script = f"""
import numpy as np
from pathlib import Path
import fusionmamba_torch.data
from fusionmamba_torch.data import native
assert native._lib is None
native.BUILD_ROOT = Path({str(tmp_path)!r})
assert not list(native.BUILD_ROOT.iterdir())
out = native.resize_bicubic(np.zeros((5, 7), np.uint8), 3, 4)
assert out.shape == (3, 4) and native._lib is not None
built = list(native.BUILD_ROOT.glob("native-*/libpreprocess.so"))
assert len(built) == 1, built
"""
    subprocess.run([sys.executable, "-c", script], check=True, cwd=REPO, timeout=300)


def test_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", sys.executable)   # not a compiler: it fails on the flags
    with pytest.raises(RuntimeError, match="preprocess.cpp failed"):
        native.build()


def test_builds_without_openmp_where_the_compiler_has_none(tmp_path):
    """A g++ that refuses -fopenmp (no libgomp) builds the library without
    it, with a warning; the serial library gives the JAX library's bits."""
    fake = tmp_path / "gxx"
    fake.write_text("#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
                    "echo \"cannot read spec file 'libgomp.spec'\" >&2 && exit 1; done\n"
                    "exec g++ \"$@\"\n")
    fake.chmod(0o755)
    rgb, ir = _images(300, 220, 7)
    np.save(tmp_path / "rgb.npy", rgb)
    np.save(tmp_path / "ir.npy", ir)
    script = f"""
import warnings
import numpy as np
from pathlib import Path
from fusionmamba_torch.data import native
native.BUILD_ROOT = Path({str(tmp_path / "build")!r})
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    vis, ir = native.preprocess_pair(np.load({str(tmp_path / "rgb.npy")!r}),
                                     np.load({str(tmp_path / "ir.npy")!r}), (256, 256))
assert any("without OpenMP" in str(w.message) for w in caught), caught
assert native.num_threads() == 1
np.save({str(tmp_path / "vis_out.npy")!r}, vis)
np.save({str(tmp_path / "ir_out.npy")!r}, ir)
"""
    subprocess.run([sys.executable, "-c", script], check=True, cwd=REPO, timeout=300,
                   env={**os.environ, "CXX": str(fake)})
    want = jnative.preprocess_pair(rgb, ir, OUT)
    np.testing.assert_array_equal(np.load(tmp_path / "vis_out.npy"), want[0])
    np.testing.assert_array_equal(np.load(tmp_path / "ir_out.npy"), want[1])
