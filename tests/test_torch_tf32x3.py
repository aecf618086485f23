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

The fp32 backward's engine (`csrc/wgmma_tf32x3.cuh`) splits each operand
piece in shared memory, after TMA has copied it as it lies: a K-major piece
(stored [row][k]) lands in the planes' own 128-byte-swizzled layout, an
MN-major one (stored [k][row], four 32-row boxes) is transposed as it is
split. Both restagings are replayed here index for index from the source's
arithmetic (and the product launch's A operand, read from either layout
into registers and split there): the planes they give must be the same,
element for element, and
the three-product error of a weight gradient's depth (K = 3072, and K =
524288, the batch-64 step's deepest dW1) must stay under a hundredth of the
card's gradient gate (1e-4 of the value plus 1e-4 of the largest entry).
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


# ---------------------------------------------------------------------------
# the fp32 backward engine's restaging (wgmma_tf32x3.cuh)
# ---------------------------------------------------------------------------

TILE, BK = 128, 32          # a piece: 128 rows x 32 of depth (kTile, kBK)


def _plane_at(r, k):
    """`plane_at`: row r of 128 bytes, its 16-byte chunk k / 4 swizzled with
    r % 8 (the hardware's 128-byte swizzle)."""
    return r * BK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)


def _raw_k_major(a):
    """Shared memory after TMA copies a (128, 32) piece stored [row][k]: two
    64-row boxes of 128-byte rows in the 128-byte swizzle."""
    raw = np.zeros(TILE * BK, np.float32)
    r, k = np.meshgrid(np.arange(TILE), np.arange(BK), indexing="ij")
    raw[_plane_at(r, k)] = a
    return raw


def _raw_mn_major(a):
    """... and after it copies a piece stored [k][row]: four boxes of 32 rows
    (inner) by 32 of depth, box r / 32, its row k, chunk (r % 32 / 4) ^ k % 8."""
    raw = np.zeros(TILE * BK, np.float32)
    r, k = np.meshgrid(np.arange(TILE), np.arange(BK), indexing="ij")
    raw[(r >> 5) * (32 * BK) + k * BK + ((((r & 31) >> 2) ^ (k & 7)) << 2) + (r & 3)] = a
    return raw


def _split_bits(v):
    big = _tf32(v)
    return big, (np.asarray(v, np.float32) - big).astype(np.float32)


def _split_k_major(raw):
    """`split_piece<0>`: 16 bytes at a time, in place of the raw layout."""
    return _split_bits(raw)


def _split_at(t):
    """`SplitAt`: thread t's offsets of its raw reads and its plane rows."""
    w, k = t // 32, t & 31
    raw = [(w >> 1) * (32 * BK) + k * BK + (((4 * (w & 1) + i) ^ (k & 7)) << 2) for i in range(4)]
    return raw, [_plane_at(16 * w + m, k) for m in range(8)]


def _split_mn_major(raw):
    """`split_piece<1>`: thread t of 256, warp w = t / 32 and lane k = t % 32,
    reads rows 4c .. 4c + 3 of depth k for c = 4w .. 4w + 3 at `SplitAt`'s
    raw offsets and writes row 16w + q at its plane offsets. Every plane
    element is written once, where `plane_at(16w + q, k)` says."""
    big, small = np.full(TILE * BK, np.nan, np.float32), np.full(TILE * BK, np.nan, np.float32)
    written = np.zeros(TILE * BK, np.int32)
    for t in range(256):
        w, k = t // 32, t & 31
        raw_at, row = _split_at(t)
        for i in range(4):
            c = 4 * w + i
            at = raw_at[i]
            assert at == (c >> 3) * (32 * BK) + k * BK + (((c & 7) ^ (k & 7)) << 2)
            hi, lo = _split_bits(raw[at:at + 4])
            for j in range(4):
                q = 4 * i + j
                p = row[q & 7] + BK * (q & 8)
                assert p == _plane_at(4 * c + j, k)
                big[p], small[p] = hi[j], lo[j]
                written[p] += 1
    assert (written == 1).all()
    return big, small


def test_transposed_restage_equals_the_k_major_split():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((TILE, BK)).astype(np.float32)
    a[5, 3], a[100, 31] = 0.0, -1e-30      # zero and a tiny value split too
    big_k, small_k = _split_k_major(_raw_k_major(a))
    big_n, small_n = _split_mn_major(_raw_mn_major(a))
    assert np.array_equal(big_n.view(np.uint32), big_k.view(np.uint32))
    assert np.array_equal(small_n.view(np.uint32), small_k.view(np.uint32))
    # and the planes hold x = big + small at (r, k), big the TF32 round
    r, k = np.meshgrid(np.arange(TILE), np.arange(BK), indexing="ij")
    assert np.array_equal(big_k[_plane_at(r, k)], _tf32(a))
    assert np.array_equal(big_k[_plane_at(r, k)] + small_k[_plane_at(r, k)], a)


def _raw_at(raw, mn, r, k):
    """`raw_at`: element (r, k) of a landed piece, K-major or MN-major."""
    if mn:
        return raw[(r >> 5) * (32 * BK) + k * BK + ((((r & 31) >> 2) ^ (k & 7)) << 2) + (r & 3)]
    return raw[_plane_at(r, k)]


@pytest.mark.parametrize("mn", [False, True])
def test_register_fragments_read_the_piece_as_it_lies(mn):
    """`load_a` (the product launch's A operand, split in registers): thread
    t's fragment register i of depth step kk holds element (16 (t / 32) +
    lane / 4 + 8 (i % 2), 8 kk + lane % 4 + 4 (i / 2)) of the piece, read
    from either landed layout; the 256 threads read every element once."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((TILE, BK)).astype(np.float32)
    raw = _raw_mn_major(a) if mn else _raw_k_major(a)
    seen = np.zeros((TILE, BK), np.int32)
    for t in range(256):
        lane = t & 31
        r, k = t // 32 * 16 + lane // 4, lane & 3
        for kk in range(BK // 8):
            for i in range(4):
                rr, kq = r + 8 * (i & 1), 8 * kk + k + 4 * (i >> 1)
                assert _raw_at(raw, mn, rr, kq) == a[rr, kq]
                seen[rr, kq] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("K", [3072, 524288])
def test_3xtf32_keeps_the_gradient_gate_at_a_deep_weight_gradient(K):
    """dW = P^T Q over K rows, as the product launch forms dW1 = g^T x (P
    and Q standard normal, 8 columns each): the split's error against a
    float64 reference, over the card's gate (about 1e-3 of it at both
    depths; a single TF32 product 1.7 and 3.2)."""
    rng = np.random.default_rng(K)
    p = rng.standard_normal((K, 8)).astype(np.float32)
    q = rng.standard_normal((K, 8)).astype(np.float32)
    want = _matmul64(p.T, q)
    gate = RTOL * np.abs(want) + ATOL * np.abs(want).max()

    def worst(mm):
        return float(np.max(np.abs(mm(p.T, q).astype(np.float64) - want) / gate))

    assert worst(_mm_3xtf32) < 0.01
    assert worst(_mm_tf32) > 1.0      # one TF32 product would break the gate
