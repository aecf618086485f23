"""`fusionmamba_torch/ops/linear.py`: y = x Wᵀ on the 3xTF32 kernel
(`csrc/linear_tf32x3.cu`) where it engages, `F.linear` otherwise.

On the CPU: the kernel's walk takes every output tile once, in a fixed
order, at the LM cells' shapes and at ragged ones; the rule that sends a
call to `F.linear` (counted under `linear:library`); the operands' rows read
where they lie or copied once (counted under `copies:linear`); `linear` equal to
`F.linear` bit for bit; and a replay of the kernel's arithmetic (the
engine's TF32 split, three products a depth step of 8, small terms first,
fp32 sums) against a float64 product at K = 8192.

On the card (marked `cuda`, skipped without one; run there with
`python -m pytest --noconftest -q tests/test_torch_linear.py`): the kernel
against fp32 `F.linear` at every LM cell shape and on the views the Mamba
block hands it (one it cannot read through a counted copy), two launches
bit-identical, the C entry refusing rows it cannot read, and the Mamba block and a
mamba-130m-wide LM against the same modules on `F.linear`.
"""
import collections
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fusionmamba_torch.ops import cuda_lib
from fusionmamba_torch.ops import linear as lin
from fusionmamba_torch.utils import tracing

# the LM cells' products (M, K, N): mamba-130m at 8 x 2048 tokens (in_proj,
# x_proj, dt_proj, out_proj, the tied head), Jamba's Mamba layers at
# 2 x 16384 (in_proj, x_proj, dt_proj, out_proj)
CELL_SHAPES = [(16384, 768, 3072), (16384, 1536, 80), (16384, 48, 1536), (16384, 1536, 768),
               (16384, 768, 50280),
               (32768, 4096, 16384), (32768, 8192, 288), (32768, 256, 8192), (32768, 8192, 4096)]
RAGGED_SHAPES = [(128, 4, 1), (129, 36, 130), (1000, 100, 257), (3000, 12, 9)]
SMS = 132    # an H100 SXM's SMs
CSRC = Path(lin.__file__).resolve().parent.parent / "csrc"

# kernel against fp32 F.linear: the same sums in another order, each
# product 3xTF32 (fp32-class, see test_replay_keeps_fp32_class_error)
TOL = dict(rtol=1e-4, atol=1e-4)


@contextlib.contextmanager
def counted():
    before = collections.Counter(tracing.counts)
    out = collections.Counter()
    yield out
    out.update(tracing.counts)
    out.subtract(before)
    for k in [k for k, v in out.items() if v == 0]:
        del out[k]


# ---------------------------------------------------------------------------
# the walk


@pytest.mark.parametrize("M,K,N", CELL_SHAPES + RAGGED_SHAPES)
def test_walk_takes_every_tile_once_in_a_fixed_order(M, K, N):
    tiles_m, tiles_n = -(-M // 128), -(-N // 128)
    tiles = tiles_m * tiles_n
    blocks = lin.grid(M, N, SMS)
    assert blocks == min(SMS, tiles)
    order = [lin.tile_of(t, tiles_m, tiles_n) for t in range(tiles)]
    assert sorted(order) == [(m, n) for m in range(tiles_m) for n in range(tiles_n)]
    assert order == [lin.tile_of(t, tiles_m, tiles_n) for t in range(tiles)]
    # the order: bands of BAND row tiles, row tiles fastest, then columns
    for t, (m, n) in enumerate(order):
        band, rows = m // lin.BAND, min(lin.BAND, tiles_m - m // lin.BAND * lin.BAND)
        assert t == band * lin.BAND * tiles_n + n * rows + m % lin.BAND
    # block b takes tiles b, b + blocks, ...: every tile by one block
    taken = [order[t] for b in range(blocks) for t in range(b, tiles, blocks)]
    assert len(taken) == tiles and set(taken) == set(order)


def test_walk_constants_are_the_source_s():
    src = (CSRC / "linear_tf32x3.cu").read_text() + (CSRC / "wgmma_tf32x3.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kBand"] == lin.BAND
    assert consts["kTile"] == lin.TILE


# ---------------------------------------------------------------------------
# the rule


def _case(why):
    """(x, weight, grad) that `linear` sends to F.linear for `why`."""
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(2, 64, 32, generator=g), torch.randn(24, 32, generator=g)
    if why == "rows":
        return x[:, :63], w, False
    if why == "grad":
        return x, w.requires_grad_(), True
    if why == "dtype_bf16":
        return x.bfloat16(), w.bfloat16(), False
    if why == "dtype_fp64":
        return x.double(), w.double(), False
    return x, w, False          # "cpu": fp32, 128 rows, no grad, on the CPU


@pytest.mark.parametrize("why", ["rows", "grad", "dtype_bf16", "dtype_fp64", "cpu"])
def test_the_rest_takes_the_library_counted_once(why):
    x, w, grad = _case(why)
    with torch.set_grad_enabled(grad):
        assert lin.engages(x, w) == (why == "cpu")
        with counted() as c:
            got = lin.linear(x, w)
    assert c == {"linear:library": 1}
    assert torch.equal(got, F.linear(x, w))
    assert got.requires_grad == grad


def test_engages_where_the_algorithm_fits():
    """What the card would give the kernel: the fp32 no-grad rows of a tile
    and more, as views of the Mamba block (in_proj's chunks, x_proj's dt
    columns), and a recorded grad on tensors that need none."""
    x = torch.randn(2, 64, 16)
    w = torch.randn(10, 16, requires_grad=True)
    dbc = torch.randn(2, 64, 80)
    assert lin.engages(x, w.detach())
    assert lin.engages(dbc[..., :48], torch.randn(30, 48))
    assert lin.engages(torch.randn(2, 64, 32).chunk(2, -1)[1], torch.randn(5, 16))
    assert lin.engages(dbc[..., 1:49], torch.randn(30, 48))   # read through a copy
    with torch.no_grad():
        assert lin.engages(x, w)
    assert not lin.engages(x, w)


def _layout(kind):
    g = torch.Generator().manual_seed(2)
    if kind == "contiguous":
        return torch.randn(3, 50, 24, generator=g)
    if kind == "chunk":
        return torch.randn(2, 100, 64, generator=g).chunk(2, -1)[1]
    if kind == "columns":                     # x_proj's dt columns, rows 80 floats apart
        return torch.randn(2, 100, 80, generator=g)[..., :48]
    if kind == "unaligned_start":
        return torch.randn(2, 100, 80, generator=g)[..., 1:49]
    if kind == "rows_24_bytes":
        return torch.randn(200, 6, generator=g)[:, :5]
    if kind == "transposed":                  # no (rows, K) view
        return torch.randn(2, 32, 64, generator=g).transpose(1, 2)
    return torch.randn(1, 16, generator=g).expand(200, 16)   # "expanded": rows 0 apart


@pytest.mark.parametrize("kind", ["contiguous", "chunk", "columns", "unaligned_start",
                                  "rows_24_bytes", "transposed", "expanded"])
def test_rows_reads_in_place_or_copies_once_counted(kind):
    t = _layout(kind)
    K = t.shape[-1]
    with counted() as c:
        got = lin.rows(t)
    assert torch.equal(got, t.reshape(-1, K))
    assert got.stride(1) == 1 and got.stride(0) >= K and got.stride(0) % 4 == 0
    assert got.data_ptr() % 16 == 0
    if kind in ("contiguous", "chunk", "columns"):
        assert c == {} and got.data_ptr() == t.data_ptr()
    else:
        assert c == {"copies:linear": 1, "copy_bytes:linear": t.numel() * 4}
        assert got.stride(0) == -(-K // 4) * 4


# ---------------------------------------------------------------------------
# the CPU path


@pytest.mark.parametrize("view", ["contiguous", "chunk", "columns", "batched"])
def test_cpu_linear_is_f_linear_bit_for_bit(view):
    g = torch.Generator().manual_seed(3)
    if view == "contiguous":
        x, w = torch.randn(300, 96, generator=g), torch.randn(40, 96, generator=g)
    elif view == "chunk":
        x, w = torch.randn(2, 100, 64, generator=g).chunk(2, -1)[1], torch.randn(48, 32,
                                                                                 generator=g)
    elif view == "columns":
        x, w = torch.randn(2, 100, 80, generator=g)[..., :48], torch.randn(96, 48, generator=g)
    else:
        x, w = torch.randn(4, 50, 24, generator=g), torch.randn(40, 24, generator=g)
    assert torch.equal(lin.linear(x, w), F.linear(x, w))


# ---------------------------------------------------------------------------
# the kernel's arithmetic, replayed


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _big(a):
    """`fm::split_tf32`'s big: the TF32 round, ties away from zero."""
    return ((_bits(a) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_read(a):
    """What the tensor cores read of an fp32 operand: its TF32 truncation."""
    return (_bits(a) & np.uint32(0xFFFFE000)).view(np.float32)


def _steps(a, b):
    """(M, N, K / 8): each depth step's 8 products summed, exactly."""
    M, N = a.shape[0], b.shape[0]
    return np.einsum("mjk,njk->mnj", a.reshape(M, -1, 8).astype(np.float64),
                     b.reshape(N, -1, 8).astype(np.float64))


def _accumulate(*terms):
    """fp32 sums over the depth steps, each step adding its terms in order."""
    acc = np.zeros(terms[0].shape[:2], np.float32)
    for j in range(terms[0].shape[2]):
        for t in terms:
            acc = (acc.astype(np.float64) + t[:, :, j]).astype(np.float32)
    return acc


def test_replay_keeps_fp32_class_error():
    """x ~ N(0, 1) and W ~ N(0, 0.02^2), as the LMs' weights are drawn, at
    K = 8192 (Jamba's x_proj and out_proj): the three products (small x big
    W, big x small W, big x big W, as the kernel issues them) stay within
    1e-5 of the largest |y| of the float64 product; one TF32 product does
    not come within 1e-4 of it."""
    rng = np.random.default_rng(0)
    M, N, K = 16, 16, 8192
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (0.02 * rng.standard_normal((N, K))).astype(np.float32)
    want = x.astype(np.float64) @ w.astype(np.float64).T
    xb, wb = _big(x), _big(w)
    xs, ws = x - xb, w - wb
    assert np.array_equal(xb + xs, x) and np.array_equal(wb + ws, w)   # the split is exact
    got = _accumulate(_steps(_tf32_read(xs), wb), _steps(xb, _tf32_read(ws)), _steps(xb, wb))
    one = _accumulate(_steps(_tf32_read(x), _tf32_read(w)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-5 * scale
    assert np.abs(one - want).max() > 1e-4 * scale


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    from fusionmamba_torch.device import select_device
    return select_device("cuda")


def _kernel(x, w, copied=()):
    """The kernel's y, its launch counted once, and the operands `copied`
    counted as copies."""
    with torch.inference_mode(), counted() as c:
        y = lin.linear(x, w)
    want = {"fm_linear": 1}
    if copied:
        want.update({"copies:linear": len(copied),
                     "copy_bytes:linear": sum(t.numel() * 4 for t in copied)})
    assert c == want
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", CELL_SHAPES + RAGGED_SHAPES)
def test_kernel_matches_f_linear(dev, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, device=dev, generator=g)
    w = 0.02 * torch.randn(N, K, device=dev, generator=g)
    got = _kernel(x, w)
    again = _kernel(x, w)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    torch.testing.assert_close(got, F.linear(x, w), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernel_reads_the_block_views_as_they_lie(dev):
    """in_proj's chunks (rows 2 d_inner apart) and x_proj's dt columns (rows
    R + 2N apart) at mamba-130m's widths, without a copy; what it cannot
    read through a counted copy: a start 4 bytes past 16, and rows of 36
    bytes (d_model 16, d_state 4: x_proj's rows hold dt_rank 1 + 2 x 4
    floats) with a weight of rows 4 bytes long."""
    g = torch.Generator(device=dev).manual_seed(5)
    xz = torch.randn(2, 1024, 3072, device=dev, generator=g)
    dbc = torch.randn(2, 1024, 80, device=dev, generator=g)
    small = torch.randn(2, 1024, 9, device=dev, generator=g)
    for x, N, k_copied in ((xz.chunk(2, -1)[0], 768, 0), (xz.chunk(2, -1)[1], 768, 0),
                           (dbc[..., :48], 1536, 0), (dbc[..., 1:49], 1536, 1),
                           (small[..., :1], 32, 2)):
        w = 0.02 * torch.randn(N, x.shape[-1], device=dev, generator=g)
        copied = (x, w)[:k_copied]
        got = _kernel(x, w, copied)
        torch.testing.assert_close(got, F.linear(x.contiguous(), w), **TOL)
        assert torch.equal(got, _kernel(x, w, copied))


def _plain_linear(monkeypatch):
    from fusionmamba_torch.models import mamba_lm
    monkeypatch.setattr(mamba_lm, "linear", F.linear)


@pytest.mark.cuda
def test_mamba_block_and_lm_match_the_library_path(dev, monkeypatch):
    """A Mamba block at mamba-130m's widths (1 x 2048 tokens) within 1e-4,
    and a mamba-130m-wide LM of 4 layers (2 x 1024 tokens) within the
    scoring cell's log-softmax limit, 1e-3, of the same modules on
    F.linear; the LM's kernel launches 4 a layer and 1 for the head, none
    of its products on the library and no operand copied."""
    from fusionmamba_torch.models.mamba_lm import MambaBlock, MambaLMHeadModel
    from fusionmamba_torch.nn import init_lm_weights

    torch.manual_seed(0)
    blk = MambaBlock(768).to(dev).eval()
    lm = init_lm_weights(MambaLMHeadModel(50280, 768, 4, rms_norm=True), seed=0).eval().to(dev)
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(1, 2048, 768, device=dev, generator=g)
    tokens = torch.randint(0, 50280, (2, 1024), device=dev, generator=g)
    with torch.inference_mode(), counted() as c:
        got_blk = blk(x)[0]
        got_lm = lm(tokens)[0]
    assert c["fm_linear"] == 4 + 4 * 4 + 1 and c["linear:library"] == 0
    assert c["copies:linear"] == 0
    _plain_linear(monkeypatch)
    with torch.inference_mode():
        want_blk = blk(x)[0]
        want_lm = lm(tokens)[0]
    torch.testing.assert_close(got_blk, want_blk, **TOL)
    gap = (torch.log_softmax(got_lm.double(), -1) - torch.log_softmax(want_lm.double(), -1))
    assert float(gap.abs().max()) < 1e-3


@pytest.mark.cuda
def test_kernel_entry_refuses_rows_it_cannot_read(dev):
    """A row stride the tensor map cannot take raises at the C entry; it
    does not fall back."""
    x = torch.randn(256, 6, device=dev)[:, :5]
    with pytest.raises(RuntimeError, match="fm_linear"):
        cuda_lib.launch("fm_linear", x.data_ptr(), x.data_ptr(), x.data_ptr(), 256, 5, 5, 6, 8,
                        1, device=x.device)
