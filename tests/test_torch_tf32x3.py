"""The numerics of the fused-MLP kernels' tensor-core products, emulated.

`fusionmamba_torch/csrc/mma_tf32x3.cuh` splits every fp32 operand x into
big = tf32(x) and small = x - big and forms each product as
small*big + big*small + big*big with fp32 sums ("3xTF32"). This emulates
TF32 rounding in numpy: big is the fp32 bit pattern rounded to 10 mantissa
bits, to nearest with ties away from zero (as `cvt.rna.tf32.f32` does), and
small enters the tensor cores truncated to 10 mantissa bits. The products
of the rounded values are exact in float64 and rounded to fp32 once, so
what is measured is the split's error, not the order of the fp32 sums
(which the tolerance already allows for). It runs the whole MLP (fc1,
exact GELU in fp32, fc2) at the model's widths with inputs drawn as
`chip_smoke.make_case` draws them (x ~ N(0, 1), weights N(0, 0.02^2), zero
biases), and compares with a float64 reference against the kernels'
tolerance on the card, 1e-4 + 1e-4 |ref|.

3xTF32 must stay inside it with 100x to spare at both widths. A single
TF32 product must break it at C = 768 (K = 3072 in fc2): that is why the
kernels pay for three. At C = 96 a single product would still pass, so only
the deep stages force the split.
"""
import math

import numpy as np
import pytest
import torch

RTOL = ATOL = 1e-4   # chip_smoke.KERNEL_RTOL / KERNEL_ATOL


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _tf32(a):
    """Round to nearest, ties away from zero."""
    return ((_bits(a) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_truncated(a):
    return (_bits(a) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul64(a, b):
    return (torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
            @ torch.from_numpy(np.ascontiguousarray(b, dtype=np.float64))).numpy()


def _mm_3xtf32(a, b):
    ab, bb = _tf32(a), _tf32(b)
    al, bl = _tf32_truncated(a - ab), _tf32_truncated(b - bb)
    return ((_matmul64(al, bb) + _matmul64(ab, bl)) + _matmul64(ab, bb)).astype(np.float32)


def _mm_tf32(a, b):
    return _matmul64(_tf32(a), _tf32(b)).astype(np.float32)


def _gelu(h):
    t = torch.from_numpy(h)
    return (0.5 * t * (1.0 + torch.erf(t / math.sqrt(2.0)))).numpy()


def _mlp(x, w1, b1, w2, b2, mm):
    return mm(_gelu(mm(x, w1) + b1), w2) + b2


@pytest.mark.parametrize("M,C,H", [(64, 768, 3072), (64, 96, 384)])
def test_3xtf32_keeps_the_kernel_tolerance(M, C, H):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, C)).astype(np.float32)
    w1 = (0.02 * rng.standard_normal((H, C))).astype(np.float32).T   # nn.Linear (out, in)
    w2 = (0.02 * rng.standard_normal((C, H))).astype(np.float32).T
    b1, b2 = np.zeros(H, np.float32), np.zeros(C, np.float32)
    want = _mlp(*(a.astype(np.float64) for a in (x, w1, b1, w2, b2)), _matmul64)

    def worst(mm):
        got = _mlp(x, w1, b1, w2, b2, mm)
        assert got.dtype == np.float32
        return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))

    assert worst(_mm_3xtf32) < 0.01
    if C == 768:
        assert worst(_mm_tf32) > 1.0
