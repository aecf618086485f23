"""The port's kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc and triton; skips without one. Run on the card
with (the repository's conftest pins JAX, which the GPU machine may not have):

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Inputs come from a seeded torch.Generator. Tolerances: the kernels and the
plain versions do the same fp32 arithmetic in another order (and fused
multiply-adds), so they differ by float32 rounding, a few ulp of the
magnitudes summed; 1e-4 relative to the output scale bounds that with room.
The MLP kernels form each fp32 product as three TF32 products, which keeps
fp32-class accuracy (tests/test_torch_tf32x3.py holds the margin).
"""
import collections
import math

import pytest
import torch

from fusionmamba_torch.device import select_device
from fusionmamba_torch.ops import cuda_lib, dwconv, layer_norm, mlp, scan_cuda
from fusionmamba_torch.ops.selective_scan import selective_scan, selective_scan_plain
from fusionmamba_torch.utils.tracing import counts as COUNTS

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    return select_device("cuda")


def _rand(gen, *shape, scale=1.0, shift=0.0):
    return torch.randn(*shape, generator=gen) * scale + shift


# every (L, D, R) of the full config's scans at a small batch, the decoder's
# batch 6 and the serving encoder's 16 at L = 1024, the segmentation steps'
# batches 4 and 8 (encoders of 2 and 4 pairs), the full-resolution scan's
# L = H*W (4096 at 64^2: the training encoder's 12 and one SS2D's 2; and the
# deeper stages' 1024, 256, 64 at their widths), and L around multiples of
# the 16-step tile and of the chunk (chunk = 32 steps where it is given), all
# at K = 4 directions; then the Mamba LM's K = 1 with a full-rank dt (R = 0)
# at mamba-130m's d_inner 1536, L = 2048, batch 1 and 4, as the wrapper cuts
# L and as one chunk, and a ragged K = 1 case in chunks of 32; then shapes of
# one rank of two: L halved by the sequence-parallel scan (512 and 8 steps)
# and d_inner halved by tensor parallelism (96 of the encoder's 192, 768 of
# the coarsest 1536)
_SCAN_SHAPES = [
    (2, 1, 8, 4, 3, None, 4), (2, 33, 70, 16, 0, None, 4), (1, 100, 64, 16, 5, None, 4),
    (16, 1024, 192, 16, 6, None, 4), (16, 16, 1536, 16, 48, None, 4),
    (4, 1024, 192, 16, 6, None, 4), (8, 256, 384, 16, 12, None, 4),
    (4, 16, 1536, 16, 48, None, 4), (12, 4096, 192, 16, 6, None, 4),
    (2, 4096, 192, 16, 6, None, 4), (12, 1024, 384, 16, 12, None, 4),
    (12, 256, 768, 16, 24, None, 4), (12, 64, 1536, 16, 48, None, 4),
    (6, 1024, 192, 16, 6, None, 4), (2, 256, 384, 16, 12, None, 4),
    (2, 64, 768, 16, 24, None, 4), (2, 16, 1536, 16, 48, None, 4),
    (1, 1024, 192, 16, 6, 64, 4), (2, 65, 40, 16, 6, 32, 4), (2, 63, 40, 16, 0, 32, 4),
    (2, 64, 40, 8, 6, 32, 4), (1, 97, 33, 3, 5, 32, 4), (1, 15, 192, 16, 6, None, 4),
    (1, 17, 192, 16, 6, None, 4),
    (1, 2048, 1536, 16, 0, None, 1), (4, 2048, 1536, 16, 0, None, 1),
    (1, 2048, 1536, 16, 0, 2048, 1), (4, 2048, 1536, 16, 0, 2048, 1),
    (3, 100, 40, 16, 0, 32, 1),
    (12, 512, 192, 16, 6, None, 4), (12, 8, 1536, 16, 48, None, 4),
    (12, 1024, 96, 16, 6, None, 4), (6, 16, 768, 16, 48, None, 4)]


def _scan_case(seed, batch, L, D, N, R, shift=-2.0, a_spread=2.5, a_scale=1.0, K=4):
    g = torch.Generator().manual_seed(seed)
    return [_rand(g, batch, K, L, D), _rand(g, batch, K, L, R or D, scale=0.5),
            -a_scale * torch.exp(torch.rand(K, D, N, generator=g) * a_spread),
            _rand(g, batch, K, L, N), _rand(g, batch, K, L, N), _rand(g, K, D),
            _rand(g, K, D, scale=0.5, shift=shift),
            _rand(g, K, D, R, scale=R ** -0.5) if R else None]


@pytest.mark.parametrize("batch,L,D,N,R,chunk,K", _SCAN_SHAPES)
def test_scan_kernel(dev, batch, L, D, N, R, chunk, K):
    """Forward against the plain version, with and without saved states;
    two launches bit-identical; an explicit chunk length where given."""
    args = [t if t is None else t.to(dev)
            for t in _scan_case(L * 7 + D, batch, L, D, N, R, K=K)]
    before = COUNTS["fm_selective_scan_fwd"]
    if chunk is None:
        got = selective_scan(*args[:7], delta_softplus=True, dt_lowrank_weight=args[7])
    else:
        got = scan_cuda.selective_scan_fwd(*args[:7], True, args[7], chunk=chunk)
    torch.cuda.synchronize()
    assert COUNTS["fm_selective_scan_fwd"] == before + 1
    want = selective_scan_plain(*args[:7], delta_softplus=True, dt_lowrank_weight=args[7])
    torch.testing.assert_close(got, want, **TOL)
    again, hsave = scan_cuda.selective_scan_fwd(*args[:7], True, args[7], save_states=True,
                                                chunk=chunk)
    assert torch.equal(got, again)
    assert hsave.shape == (batch * K, -(-L // scan_cuda.SAVE_EVERY), D, N)
    assert torch.isfinite(hsave).all()


@pytest.mark.parametrize("chunk", [None, 32])
def test_scan_kernel_large_dt(dev, chunk):
    """dt * A far past the TPU kernel's rescale clip: exact here too, also
    where the carries between chunks underflow to 0."""
    g = torch.Generator().manual_seed(3)
    B, K, L, D, N = 2, 4, 200, 32, 16
    u, Bm, Cm = _rand(g, B, K, L, D), _rand(g, B, K, L, N), _rand(g, B, K, L, N)
    dt = _rand(g, B, K, L, D, shift=8.0)
    A = -torch.exp(torch.rand(K, D, N, generator=g) * 1.5)
    args = [t.to(dev) for t in (u, dt, A, Bm, Cm)]
    got = scan_cuda.selective_scan_fwd(*args, None, None, True, None, chunk=chunk)
    want = selective_scan_plain(*args, delta_softplus=True)
    torch.testing.assert_close(got, want, **TOL)


# "raw": gate_act "none" with a gate, which multiplies by the raw gate
@pytest.mark.parametrize("gate_act", ["none", "silu", "silu_sum", "raw"])
@pytest.mark.parametrize("rows,C", [(1, 24), (37, 96), (4096, 192), (64, 1536), (131072, 24),
                                    (128, 1536)])
def test_layer_norm_kernel(dev, gate_act, rows, C):
    g = torch.Generator().manual_seed(rows + C)
    x = _rand(g, rows, C, scale=2.0, shift=0.5).to(dev)
    s, b = _rand(g, C).to(dev), _rand(g, C).to(dev)
    gate = None if gate_act == "none" else _rand(g, rows, C).to(dev)
    gate_act = "none" if gate_act == "raw" else gate_act
    before = COUNTS["triton_ln_fwd"]
    got = layer_norm.layer_norm_fused(x, s, b, gate, 1e-6, gate_act)
    torch.cuda.synchronize()
    assert COUNTS["triton_ln_fwd"] == before + 1
    torch.testing.assert_close(got, layer_norm.layer_norm_plain(x, s, b, gate, 1e-6, gate_act),
                               **TOL)


# ragged (rows 1 and 37; C 24, 48, 100 and 1000, masked where not a template
# width), every fusion training shape (B = 12 and 6), the serving encoder's
# 16, and the segmentation steps' (B = 2, 4 and 8)
_LNM_SHAPES = [(1, 1, 24), (3, 37, 96), (2, 37, 48), (5, 1, 100), (2, 300, 1000),
               (12, 4096, 96), (12, 1024, 192), (12, 256, 384), (12, 64, 768),
               (6, 4096, 96), (6, 1024, 192), (6, 256, 384), (6, 64, 768), (16, 4096, 96),
               (8, 64, 768), (2, 4096, 96), (2, 1024, 192), (2, 256, 384), (2, 64, 768),
               (4, 4096, 96), (4, 64, 768), (8, 4096, 96), (8, 256, 384)]


@pytest.mark.parametrize("B,rows,C", _LNM_SHAPES)
def test_ln_spatial_mean_kernel(dev, B, rows, C):
    """Against the plain version; two launches bit-identical."""
    g = torch.Generator().manual_seed(rows + C)
    x = _rand(g, B, rows, C, scale=2.0, shift=0.5).to(dev)
    s, b = _rand(g, C).to(dev), _rand(g, C).to(dev)
    before = COUNTS["fm_ln_mean_fwd"]
    got = layer_norm.ln_spatial_mean(x, s, b, 1e-5)
    again = layer_norm.ln_spatial_mean(x, s, b, 1e-5)
    torch.cuda.synchronize()
    assert COUNTS["fm_ln_mean_fwd"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, layer_norm.ln_spatial_mean_plain(x, s, b, 1e-5), **TOL)


@pytest.mark.parametrize("cluster", [1, 2, 5, 8, 11, 16])
def test_ln_spatial_mean_kernel_clusters(dev, cluster):
    """Every cluster size the plan can pick, at a shape where each block of
    the largest walks one chunk: against the plain version, bit-identical
    twice."""
    g = torch.Generator().manual_seed(cluster)
    x = _rand(g, 6, 1024, 192, scale=2.0, shift=0.5).to(dev)
    s, b = _rand(g, 192).to(dev), _rand(g, 192).to(dev)
    plan = layer_norm.lnm_fwd_plan(6, 1024, 192)._replace(cluster=cluster)
    got = layer_norm.ln_spatial_mean_fwd(x, s, b, 1e-5, plan)
    assert torch.equal(got, layer_norm.ln_spatial_mean_fwd(x, s, b, 1e-5, plan))
    torch.testing.assert_close(got, layer_norm.ln_spatial_mean_plain(x, s, b, 1e-5), **TOL)


# every fusion training shape (B = 12 and 6), two serving shapes (16 and 8),
# the segmentation steps' smallest and largest (B = 2 and 4), and ragged ones:
# C of 3, 6 and 40 (not a multiple of 4, of the block's 64 channels), H and W
# not multiples of the tile (fwd_plan), a 1x1 image
_DWCONV_SHAPES = [
    (2, 5, 7, 3), (3, 9, 13, 6), (2, 11, 19, 40), (1, 1, 1, 8), (1, 1, 1, 3), (2, 3, 70, 192),
    (16, 64, 64, 192), (8, 8, 8, 1536),
    (12, 64, 64, 192), (6, 64, 64, 192), (12, 32, 32, 384), (6, 32, 32, 384),
    (12, 16, 16, 768), (6, 16, 16, 768), (12, 8, 8, 1536), (6, 8, 8, 1536),
    (2, 8, 8, 1536), (2, 64, 64, 192), (4, 16, 16, 768), (4, 64, 64, 192)]


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape", _DWCONV_SHAPES)
def test_dwconv_kernel(dev, act, shape):
    """Against the plain version, with and without a bias; two launches
    bit-identical."""
    g = torch.Generator().manual_seed(sum(shape))
    C = shape[-1]
    x = _rand(g, *shape).to(dev)
    w, b = _rand(g, 3, 3, C, scale=0.3).to(dev), _rand(g, C).to(dev)
    before = COUNTS["fm_dwconv3x3_fwd"]
    got = dwconv.depthwise_conv3x3(x, w, b, act)
    torch.cuda.synchronize()
    assert COUNTS["fm_dwconv3x3_fwd"] == before + 1
    torch.testing.assert_close(got, dwconv.depthwise_conv3x3_plain(x, w, b, act), **TOL)
    assert torch.equal(got, dwconv.depthwise_conv3x3(x, w, b, act))
    torch.testing.assert_close(dwconv.depthwise_conv3x3(x, w, None, act),
                               dwconv.depthwise_conv3x3_plain(x, w, None, act), **TOL)


@pytest.mark.parametrize("shape", [(2, 9, 13, 8), (6, 8, 8, 1536)])
def test_dwconv_kernel_unaligned(dev, shape):
    """x and the output 4 bytes off a 16-byte boundary: the kernel's scalar
    loads and stores."""
    g = torch.Generator().manual_seed(7)
    n = 1
    for d in shape:
        n *= d
    x = _rand(g, n + 1).to(dev)[1:].view(shape)
    out = torch.empty(n + 1, device=dev)[1:].view(shape)
    w, b = _rand(g, 3, 3, shape[-1], scale=0.3).to(dev), _rand(g, shape[-1]).to(dev)
    want = dwconv.depthwise_conv3x3_plain(x, w, b, "silu")
    plan = dwconv.fwd_plan(*shape, sms=cuda_lib.sm_count(dev))
    w_c = w.permute(2, 0, 1).contiguous()    # the kernel's (C, 3, 3) layout
    cuda_lib.launch("fm_dwconv3x3_fwd", x.data_ptr(), w_c.data_ptr(), b.data_ptr(),
                    out.data_ptr(), *shape, 1, plan.cq, plan.tw, plan.th, *plan.grid, 0, device=dev)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **TOL)


_MLP_SHAPES = [(1, 16, 64), (37, 96, 384), (100, 20, 72), (512, 768, 3072),
               (768, 768, 3072), (384, 768, 3072), (49152, 96, 384),
               (128, 768, 3072), (8192, 96, 384)]


@pytest.mark.parametrize("M,C,H", _MLP_SHAPES)
def test_mlp_kernel(dev, M, C, H):
    """The tensor-core kernel at fp32 accuracy, ragged and main-path shapes;
    two launches bit-identical."""
    g = torch.Generator().manual_seed(M + C)
    x = _rand(g, M, C).to(dev)
    w1, b1 = _rand(g, C, H, scale=C ** -0.5).to(dev), _rand(g, H, scale=0.1).to(dev)
    w2, b2 = _rand(g, H, C, scale=H ** -0.5).to(dev), _rand(g, C, scale=0.1).to(dev)
    before = COUNTS["fm_fused_mlp_fwd"]
    got = mlp.fused_mlp(x, w1, b1, w2, b2)
    again = mlp.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert COUNTS["fm_fused_mlp_fwd"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, mlp.fused_mlp_plain(x, w1, b1, w2, b2), **TOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("M,C,H", _MLP_SHAPES)
def test_mlp_kernel_both_paths(dev, M, C, H, fused):
    """Both forward designs (hidden on chip, two passes) at every shape,
    whichever the wrapper would pick."""
    g = torch.Generator().manual_seed(M + 3 * C)
    x = _rand(g, M, C).to(dev)
    w1, b1 = _rand(g, H, C, scale=C ** -0.5).to(dev), _rand(g, H, scale=0.1).to(dev)
    w2, b2 = _rand(g, C, H, scale=H ** -0.5).to(dev), _rand(g, C, scale=0.1).to(dev)
    got = mlp.mlp_fwd(x, w1, b1, w2, b2, fused=fused)
    torch.testing.assert_close(got, mlp.fused_mlp_plain(x, w1.t(), b1, w2.t(), b2), **TOL)


# ---------------------------------------------------------------------------
# backward kernels against the autograd of the plain versions
#
# Gradients that sum over many rows (dW, dA, dB, dscale, ...) are sums of
# thousands of terms of both signs taken in another order, so their float32
# rounding scales with the magnitude summed, not with the (possibly small)
# result: each gradient is held to 1e-4 of its own largest entry, plus 1e-4
# relative.
# ---------------------------------------------------------------------------

def _grads(fn, inputs, dy):
    inputs = [t.detach().requires_grad_(True) if t is not None else None for t in inputs]
    out = fn(*inputs)
    live = [t for t in inputs if t is not None]
    return out, torch.autograd.grad(out, live, dy)


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()) + 1e-30)


def _check_backward(kernel, plain, inputs, dy, counter):
    """kernel vs plain gradients; two kernel backwards must be bit-identical
    and launch the backward kernel once each."""
    before = COUNTS[counter]
    y, got = _grads(kernel, inputs, dy)
    _, again = _grads(kernel, inputs, dy)
    torch.cuda.synchronize()
    assert COUNTS[counter] == before + 2
    yw, want = _grads(plain, inputs, dy)
    torch.testing.assert_close(y, yw, **TOL)
    _assert_grads_close(got, want)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch,L,D,N,R,shift", [
    (2, 1, 8, 4, 3, 0.0), (2, 33, 70, 16, 0, 0.0), (1, 100, 64, 16, 5, 0.0),
    (2, 1024, 192, 16, 6, -4.0), (12, 16, 1536, 16, 48, -4.0), (2, 64, 96, 16, 0, 8.0),
    (6, 1024, 192, 16, 6, -4.0), (2, 256, 384, 16, 12, -4.0), (2, 64, 768, 16, 24, -4.0),
    (1, 15, 192, 16, 6, -4.0), (1, 17, 192, 16, 6, -4.0),
    (4, 1024, 192, 16, 6, -4.0), (12, 4096, 192, 16, 6, -4.0), (2, 4096, 192, 16, 6, -4.0),
    (12, 8, 1536, 16, 48, -4.0), (12, 1024, 96, 16, 6, -4.0)])
def test_scan_backward_kernel(dev, batch, L, D, N, R, shift):
    """shift 8: softplus(dt) ~ 8 per step, far past the TPU kernel's rescale
    clip; the backward is exact there too."""
    inputs = [None if t is None else t.to(dev)
              for t in _scan_case(L * 3 + D, batch, L, D, N, R, shift, 1.5)]
    g = torch.Generator().manual_seed(L + D)
    dy = _rand(g, batch, 4, L, D).to(dev)

    def kernel(*a):
        return selective_scan(*a[:7], delta_softplus=True, dt_lowrank_weight=a[7])

    def plain(*a):
        return selective_scan_plain(*a[:7], delta_softplus=True, dt_lowrank_weight=a[7])

    _check_backward(kernel, plain, inputs, dy, "fm_selective_scan_bwd")


@pytest.mark.parametrize("batch,L,D,N,R,chunk,shift", [
    (1, 1024, 192, 16, 6, 64, -4.0), (2, 65, 40, 16, 6, 32, 0.0), (2, 63, 40, 16, 0, 32, 0.0),
    (2, 64, 40, 8, 6, 32, 0.0), (1, 97, 33, 3, 5, 32, 0.0), (2, 96, 32, 16, 0, 32, 8.0),
    (2, 256, 384, 16, 12, 256, -4.0)])
def test_scan_backward_kernel_chunks(dev, batch, L, D, N, R, chunk, shift):
    """The backward with an explicit chunk length (several chunks joined by
    adjoint carries, or one) against autograd of the plain version; two
    launches bit-identical."""
    t = [None if x is None else x.to(dev)
         for x in _scan_case(L * 5 + D, batch, L, D, N, R, shift, 1.5)]
    g = torch.Generator().manual_seed(L + 2 * D)
    dy = _rand(g, batch, 4, L, D).to(dev)
    _, hsave = scan_cuda.selective_scan_fwd(*t[:7], True, t[7], save_states=True, chunk=chunk)
    got = scan_cuda.selective_scan_bwd(*t, hsave, dy, True, chunk=chunk)
    again = scan_cuda.selective_scan_bwd(*t, hsave, dy, True, chunk=chunk)
    torch.cuda.synchronize()
    live = [x.detach().requires_grad_(True) for x in t if x is not None]
    args = live + [None] * (8 - len(live))
    out = selective_scan_plain(*args[:7], delta_softplus=True, dt_lowrank_weight=args[7])
    want = torch.autograd.grad(out, live, dy)
    _assert_grads_close([x for x in got if x is not None], want)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("L,D,R,chunk", [(96, 40, 6, 32), (96, 70, 0, 32), (256, 32, 2, 64),
                                         (100, 130, 6, 48)])
def test_scan_backward_kernel_ragged_d_slow_decay(dev, L, D, R, chunk):
    """D not a multiple of the block's 64 channels, several chunks of three or
    more 8-step tiles each, and |A| near 0.01, so that a state or an adjoint
    hardly decays within a chunk: whatever a lane past D carried would reach
    the sums over the block's channels (dB, dC, d(dt)) at full size."""
    t = [None if x is None else x.to(dev)
         for x in _scan_case(L + D, 2, L, D, 16, R, 0.0, 1.5, a_scale=0.01)]
    g = torch.Generator().manual_seed(L * D)
    dy = _rand(g, 2, 4, L, D).to(dev)
    y, hsave = scan_cuda.selective_scan_fwd(*t[:7], True, t[7], save_states=True, chunk=chunk)
    got = scan_cuda.selective_scan_bwd(*t, hsave, dy, True, chunk=chunk)
    torch.cuda.synchronize()
    live = [x.detach().requires_grad_(True) for x in t if x is not None]
    args = live + [None] * (8 - len(live))
    out = selective_scan_plain(*args[:7], delta_softplus=True, dt_lowrank_weight=args[7])
    want = torch.autograd.grad(out, live, dy)
    torch.testing.assert_close(y, out.detach(), **TOL)
    _assert_grads_close([x for x in got if x is not None], want)


# the training path's widest shapes of each kind ((393216, 24) the final
# expand, (49152, 96) the first stage, (384, 1536) a gated deep SS2D), every
# template, C outside the templates (40, 1000: the masked variant), one row,
# and fewer rows than the grid's row groups; "raw" is gate_act "none" with a
# gate
@pytest.mark.parametrize("gate_act", ["none", "silu", "silu_sum", "raw"])
@pytest.mark.parametrize("rows,C", [(1, 24), (37, 96), (4096, 192), (64, 1536), (393216, 24),
                                    (49152, 96), (384, 1536), (300, 384), (70, 768), (3, 1536),
                                    (5, 40), (1, 1000), (300, 1000), (128, 1536)])
def test_layer_norm_backward_kernel(dev, gate_act, rows, C):
    """Against autograd of the plain version; two launches bit-identical,
    one count each."""
    g = torch.Generator().manual_seed(rows * C)
    inputs = [_rand(g, rows, C, scale=2.0, shift=0.5), _rand(g, C), _rand(g, C)]
    if gate_act != "none":
        inputs.append(_rand(g, rows, C))
    inputs = [t.to(dev) for t in inputs]
    dy = _rand(g, rows, C).to(dev)
    gate_act = "none" if gate_act == "raw" else gate_act

    def kernel(x, s, b, gate=None):
        return layer_norm.layer_norm_fused(x, s, b, gate, 1e-6, gate_act)

    def plain(x, s, b, gate=None):
        return layer_norm.layer_norm_plain(x, s, b, gate, 1e-6, gate_act)

    _check_backward(kernel, plain, inputs, dy, "fm_layer_norm_bwd")


# the model's widths at B = 12 and 6 (every template it uses), C outside the
# templates (40, 1000: the masked variant), one row, fewer rows than a block's
# row groups
@pytest.mark.parametrize("B,rows,C", [(1, 1, 24), (3, 37, 96), (12, 4096, 96), (8, 64, 768),
                                      (6, 1024, 192), (12, 1024, 192), (6, 256, 384),
                                      (12, 256, 384), (6, 64, 768), (5, 37, 40), (2, 9, 1000),
                                      (2, 4096, 96), (2, 64, 768), (4, 1024, 192)])
def test_ln_spatial_mean_backward_kernel(dev, B, rows, C):
    g = torch.Generator().manual_seed(rows + 7 * C)
    inputs = [_rand(g, B, rows, C, scale=2.0, shift=0.5).to(dev), _rand(g, C).to(dev),
              _rand(g, C).to(dev)]
    dm = _rand(g, B, C).to(dev)
    _check_backward(lambda x, s, b: layer_norm.ln_spatial_mean(x, s, b, 1e-5),
                    lambda x, s, b: layer_norm.ln_spatial_mean_plain(x, s, b, 1e-5),
                    inputs, dm, "fm_ln_mean_bwd")


def _unaligned(g, dev, *shape, **kw):
    """A contiguous tensor 4 bytes off a 16-byte boundary."""
    n = math.prod(shape)
    return _rand(g, n + 1, **kw).to(dev)[1:].view(shape)


@pytest.mark.parametrize("B,rows,C", [(6, 256, 384), (2, 9, 40)])
def test_ln_spatial_mean_backward_kernel_unaligned(dev, B, rows, C):
    g = torch.Generator().manual_seed(B * rows + C)
    x = _unaligned(g, dev, B, rows, C, scale=2.0, shift=0.5)
    s, b, dm = _rand(g, C).to(dev), _rand(g, C).to(dev), _rand(g, B, C).to(dev)
    got = layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5)
    _, want = _grads(lambda *a: layer_norm.ln_spatial_mean_plain(*a, 1e-5), [x, s, b], dm)
    _assert_grads_close(got, want)


# every training shape's width at B = 12 and 6, C not a multiple of 4 (3)
# and of a block's channels (40), H and W not multiples of the tile, a 1x1
# image
@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 1, 8), (12, 64, 64, 192), (6, 8, 8, 1536),
                                   (6, 64, 64, 192), (12, 32, 32, 384), (6, 32, 32, 384),
                                   (12, 16, 16, 768), (2, 11, 19, 40), (3, 9, 13, 6),
                                   (2, 8, 8, 1536), (2, 16, 16, 768), (4, 8, 8, 1536),
                                   (4, 64, 64, 192)])
def test_dwconv_backward_kernel(dev, act, has_bias, shape):
    g = torch.Generator().manual_seed(sum(shape) + has_bias)
    C = shape[-1]
    inputs = [_rand(g, *shape).to(dev), _rand(g, 3, 3, C, scale=0.3).to(dev),
              _rand(g, C).to(dev) if has_bias else None]
    dy = _rand(g, *shape).to(dev)
    _check_backward(lambda x, w, b: dwconv.depthwise_conv3x3(x, w, b, act),
                    lambda x, w, b: dwconv.depthwise_conv3x3_plain(x, w, b, act),
                    inputs, dy, "fm_dwconv3x3_bwd")


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape", [(2, 9, 13, 8), (6, 32, 32, 384)])
def test_dwconv_backward_kernel_unaligned(dev, act, shape):
    """x and dy 4 bytes off a 16-byte boundary: the kernel's scalar loads."""
    g = torch.Generator().manual_seed(sum(shape) + 5)
    C = shape[-1]
    x, dy = _unaligned(g, dev, *shape), _unaligned(g, dev, *shape)
    w, b = _rand(g, 3, 3, C, scale=0.3).to(dev), _rand(g, C).to(dev)
    got = dwconv.dwconv_bwd(x, w, b, dy, act)
    _, want = _grads(lambda *a: dwconv.depthwise_conv3x3_plain(*a, act), [x, w, b], dy)
    _assert_grads_close(got, want)


# the benchmark's batch-64 training step (`chip_smoke.train_calls(full_config(),
# 64, 256)["mlp_bwd"]`): C = 96 .. 768, M = 4096 .. 524288
_MLP_CELL = [(524288, 96, 384), (262144, 96, 384), (131072, 192, 768), (65536, 192, 768),
             (32768, 384, 1536), (16384, 384, 1536), (8192, 768, 3072), (4096, 768, 3072)]


@pytest.mark.parametrize("M,C,H", [(1, 16, 64), (37, 96, 384), (100, 20, 72), (768, 768, 3072),
                                   (384, 768, 3072), (49152, 96, 384), (128, 768, 3072),
                                   (8192, 96, 384), (300, 40, 160), (1000, 192, 768),
                                   (8448, 16, 64), (200, 32, 128), (3072, 384, 768),
                                   (384, 768, 1536), *_MLP_CELL])
def test_mlp_backward_kernel(dev, M, C, H):
    """fp32 (the 3xTF32 wgmma engine): against the plain version, two
    launches bit-identical. Shapes: the batch-64 step's, the test config's
    widths (16, 32), ragged M and C (a 32-deep stage with a tail at C = 40,
    20), a tensor-parallel rank's half hidden (H = 2C)."""
    g = torch.Generator().manual_seed(M + C)
    # weights as nn.Linear's (out, in) tensors passed as `.t()` views, as Mlp does
    w1 = _rand(g, H, C, scale=C ** -0.5).to(dev)
    w2 = _rand(g, C, H, scale=H ** -0.5).to(dev)
    inputs = [_rand(g, M, C).to(dev), w1, _rand(g, H, scale=0.1).to(dev), w2,
              _rand(g, C, scale=0.1).to(dev)]
    dy = _rand(g, M, C).to(dev)
    _check_backward(lambda x, a, b1, c, b2: mlp.fused_mlp(x, a.t(), b1, c.t(), b2),
                    lambda x, a, b1, c, b2: mlp.fused_mlp_plain(x, a.t(), b1, c.t(), b2),
                    inputs, dy, "fm_fused_mlp_bwd")


def test_mlp_backward_counts_its_engine(dev):
    """Each fp32 backward call is one `fm_fused_mlp_bwd` launch on the TF32
    wgmma engine; a bf16 call counts neither."""
    g = torch.Generator().manual_seed(11)
    M, C, H = 300, 40, 160
    args = [_rand(g, *s).to(dev) for s in ((M, C), (C, H), (H,), (H, C), (C,), (M, C))]
    keys = ("fm_fused_mlp_bwd", "fm_fused_mlp_bwd:wgmma_tf32x3", "fm_fused_mlp_bwd_bf16")
    before = [COUNTS[k] for k in keys]
    mlp.mlp_bwd(*args)
    assert [COUNTS[k] - b for k, b in zip(keys, before)] == [1, 1, 0]
    mlp.mlp_bwd(*(t.to(BF16) for t in args))
    torch.cuda.synchronize()
    assert [COUNTS[k] - b for k, b in zip(keys, before)] == [1, 1, 1]


# sha256 of the bf16 backward's gradients (`_bf16_bwd_digest`) as the port
# computed them before the fp32 backward moved to its own engine (commit
# 6e8aeaf, on an H100 SXM): the bf16 path must keep them bit for bit
_BF16_BWD_DIGESTS = {
    (300, 40, 160): "d1c605a21a64a74e00d957807f1f5e0bada00c217f4943b9b7d4b49e17b1dfc2",
    (3072, 96, 384): "8b8dd540cdce8d0938aef358fea85b5fa9f7932a8a0550c0dfeda21f0cf9b487",
    (512, 768, 3072): "34b7e430ed0f39f82711c618f6ed60e97a939e11b94fc1b44d0880bbff55a84a",
    (20000, 96, 384): "9d4157fbdf31df66e4f0591c6c2af3ea4320082cbc340bd6079cb7adda637997"}


def _bf16_bwd_digest(M, C, H):
    """The sha256 of mlp_bwd's five bf16 gradients on seeded inputs."""
    import hashlib

    g = torch.Generator().manual_seed(M + 3 * C + H)
    x, dy = _rand(g, M, C), _rand(g, M, C)
    w1, w2 = _rand(g, C, H, scale=C ** -0.5), _rand(g, H, C, scale=H ** -0.5)
    b1, b2 = _rand(g, H, scale=0.1), _rand(g, C, scale=0.1)
    dev = torch.device("cuda")
    out = mlp.mlp_bwd(*(t.to(dev, BF16) for t in (x, w1, b1, w2, b2, dy)))
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("shape", [(300, 40, 160), (3072, 96, 384), (512, 768, 3072),
                                   (20000, 96, 384)])
def test_mlp_backward_bf16_unchanged(dev, shape):
    assert _bf16_bwd_digest(*shape) == _BF16_BWD_DIGESTS[shape]


def test_model_backward_on_card_matches_cpu(dev):
    """loss.backward() through a small model on the card gives every
    parameter the gradient the CPU plain path gives it. (The finest
    VSSBlockCross's output is never read, as in the reference, so its
    parameters get none on either device.) fp32 sums are reordered through
    the whole network and its backward, so each gradient is held to 1e-3 of
    its norm."""
    from fusionmamba_torch.config import test_config
    from fusionmamba_torch.losses import fusion_loss
    from fusionmamba_torch.models import VSSMFusion
    from fusionmamba_torch.nn import init_weights

    g = torch.Generator().manual_seed(5)
    x1, x2 = torch.rand(2, 32, 32, 1, generator=g), torch.rand(2, 32, 32, 1, generator=g)
    grads = {}
    for device in (torch.device("cpu"), dev):
        net = init_weights(VSSMFusion(test_config(drop_path_rate=0.0)), seed=3).to(device)
        a, b = x1.to(device), x2.to(device)
        fusion_loss(a, b, net(a, b).clamp(0.0, 1.0)).total.backward()
        grads[device.type] = {k: p.grad for k, p in net.named_parameters()}
    assert sum(w is not None for w in grads["cpu"].values()) > 0.8 * len(grads["cpu"])
    for k, want in grads["cpu"].items():
        got = grads["cuda"][k]
        if want is None:
            assert got is None and k.startswith("Cross_block.0."), k
            continue
        assert got is not None, f"{k} has no gradient on the card"
        rel = float((got.cpu() - want).norm() / (want.norm() + 1e-12))
        assert rel < 1e-3, (k, rel)


def test_lm_generate_graph_matches_loop_on_card(dev):
    """A small Mamba LM on the card: its full forward (the scan kernel at
    K = 1, R = 0) against the same weights on the CPU, 1e-4; then `generate`
    with the decode step captured in a CUDA graph (`compiled=True`) against
    the per-token loop (`compiled=False`), greedy and sampled from one
    generator seed: identical tokens, and no scan launch (the prefill runs
    through decode steps)."""
    from fusionmamba_torch.models.mamba_lm import MambaLMHeadModel, generate
    from fusionmamba_torch.nn import init_lm_weights

    cpu = init_lm_weights(MambaLMHeadModel(256, 64, 2, rms_norm=True), seed=1).eval()
    model = init_lm_weights(MambaLMHeadModel(256, 64, 2, rms_norm=True), seed=1).eval().to(dev)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 256, (2, 40), generator=g)
    before = COUNTS["fm_selective_scan_fwd"]
    with torch.inference_mode():
        got = model(tokens.to(dev))[0]
        want = cpu(tokens)[0]
    assert COUNTS["fm_selective_scan_fwd"] == before + 2
    torch.testing.assert_close(got.cpu(), want, **TOL)
    prompt = tokens[:, :5].to(dev)
    before = COUNTS["fm_selective_scan_fwd"]
    for kw in (dict(temperature=0.0), dict(temperature=0.7, top_p=0.9, repetition_penalty=1.2),
               dict(temperature=1.0, top_k=8, min_p=0.1)):
        runs = [generate(model, prompt, 12, compiled=compiled,
                         generator=torch.Generator(device=dev).manual_seed(4), **kw)
                for compiled in (False, True, True)]
        assert runs[0].shape == (2, 17)
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[1], runs[2]), kw
    assert COUNTS["fm_selective_scan_fwd"] == before


# ---------------------------------------------------------------------------
# bf16 I/O: each kernel's bf16 variant against its plain version on the same
# bf16 inputs (fp32 for what the kernels read as fp32). Both compute in fp32
# and round to bf16 at the same places; sums in another order can move a
# value across a rounding boundary, so each output and each gradient is held
# to two bf16 ulps of the plain value plus two of the tensor's largest entry:
# |err| <= 8e-3 |plain| + 8e-3 max|plain|.
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def _bf16_close(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    g, w = got.float(), want.float()
    bound = 8e-3 * w.abs() + 8e-3 * float(w.abs().max()) + 1e-30
    assert bool(((g - w).abs() <= bound).all()), float(((g - w).abs() - bound).max())


def _check_bf16(kernel, plain, inputs, dy, counters):
    """The bf16 kernels (forward and, with dy, backward) against the plain
    version: outputs and every gradient in their inputs' dtypes; two
    launches bit-identical; each bf16 counter in `counters` advanced."""
    befores = [COUNTS[k] for k in counters]
    if dy is None:
        with torch.no_grad():
            y, again = kernel(*inputs), kernel(*inputs)
            want = plain(*inputs)
        torch.cuda.synchronize()
        _bf16_close(y, want)
        assert torch.equal(y, again)
    else:
        y, got = _grads(kernel, inputs, dy)
        _, again = _grads(kernel, inputs, dy)
        torch.cuda.synchronize()
        yw, want = _grads(plain, inputs, dy)
        _bf16_close(y, yw)
        for t, g, w, a in zip([t for t in inputs if t is not None], got, want, again):
            assert g.dtype == t.dtype
            _bf16_close(g, w)
            assert torch.equal(g, a)
    for k, b in zip(counters, befores):
        assert COUNTS[k] >= b + 2, k


@pytest.mark.parametrize("batch,L,D,N,R,chunk", [
    (2, 64, 96, 16, 6, None), (2, 65, 40, 16, 6, 32), (2, 33, 70, 16, 0, None),
    (12, 1024, 192, 16, 6, None), (12, 16, 1536, 16, 48, None), (1, 97, 33, 3, 5, 32)])
def test_scan_kernels_bf16(dev, batch, L, D, N, R, chunk):
    """u, dt, W, B, C, y and their gradients bf16; A, D, the bias and theirs
    fp32; with an explicit chunk length the forward's and the backward's
    chunked passes."""
    case = _scan_case(L + D, batch, L, D, N, R, shift=-1.0)
    io = {0, 1, 3, 4, 7}
    args = [None if t is None else (t.to(BF16) if i in io else t).to(dev)
            for i, t in enumerate(case)]
    dy = torch.randn(batch, 4, L, D, generator=torch.Generator().manual_seed(1)).to(dev, BF16)

    def kernel(u, dt, A, Bm, Cm, Dp, bias, W):
        if chunk is None:
            return selective_scan(u, dt, A, Bm, Cm, Dp, bias, delta_softplus=True,
                                  dt_lowrank_weight=W)
        return scan_cuda.selective_scan_fwd(u, dt, A, Bm, Cm, Dp, bias, True, W, chunk=chunk)

    def plain(*a):
        return selective_scan_plain(*a[:7], delta_softplus=True, dt_lowrank_weight=a[7])

    _check_bf16(kernel, plain, args, None, ["fm_selective_scan_fwd_bf16"])
    if chunk is None:
        _check_bf16(kernel, plain, args, dy, ["fm_selective_scan_bwd_bf16"])
    else:
        with torch.no_grad():
            _, hsave = scan_cuda.selective_scan_fwd(*args[:7], True, args[7], save_states=True)
        got = scan_cuda.selective_scan_bwd(*args, hsave, dy, True, chunk=chunk)
        whole = scan_cuda.selective_scan_bwd(*args, hsave, dy, True, chunk=16 * (L // 16 + 1))
        for a, b in zip(got, whole):
            if a is not None:
                assert a.dtype == b.dtype
                _bf16_close(a, b)


# the bf16 scans' tensor-core and MUFU designs: every training shape of the
# fusion step (batch 6, the encoder's 12; K = 4), explicit chunks (one and
# several, also at R = 0), ragged D with slow decay, and a dt view that
# starts 2 bytes past an aligned address
_BF16_TRAIN_SCANS = [(b, L, D, R) for b in (6, 12)
                     for L, D, R in ((1024, 192, 6), (256, 384, 12), (64, 768, 24),
                                     (16, 1536, 48))]


def _bf16_scan_args(dev, seed, batch, L, D, N, R, shift=-1.0, a_scale=1.0, dt_offset=0):
    case = _scan_case(seed, batch, L, D, N, R, shift=shift, a_scale=a_scale)
    io = {0, 1, 3, 4, 7}
    args = [None if t is None else (t.to(BF16) if i in io else t).to(dev)
            for i, t in enumerate(case)]
    if dt_offset:
        store = torch.empty(args[1].numel() + dt_offset, device=dev, dtype=BF16)
        view = store[dt_offset:].view(args[1].shape)
        view.copy_(args[1])
        args[1] = view
    return args


def _bf16_scan_plain(*a):
    return selective_scan_plain(*a[:7], delta_softplus=True, dt_lowrank_weight=a[7])


def _bf16_chunked_check(args, dy, chunk):
    """The kernels with L cut into `chunk`-step chunks against the plain
    version (the output, every gradient), two launches bit-identical."""
    with torch.no_grad():
        y, hsave = scan_cuda.selective_scan_fwd(*args[:7], True, args[7], save_states=True,
                                                chunk=chunk)
        again = scan_cuda.selective_scan_fwd(*args[:7], True, args[7], chunk=chunk)
        got = scan_cuda.selective_scan_bwd(*args, hsave, dy, True, chunk=chunk)
        got2 = scan_cuda.selective_scan_bwd(*args, hsave, dy, True, chunk=chunk)
    torch.cuda.synchronize()
    yw, want = _grads(_bf16_scan_plain, args, dy)
    _bf16_close(y, yw)
    assert torch.equal(y, again)
    for g, w, g2 in zip([g for g in got if g is not None], want,
                        [g for g in got2 if g is not None]):
        _bf16_close(g, w)
        assert torch.equal(g, g2)


@pytest.mark.parametrize("batch,L,D,R", _BF16_TRAIN_SCANS)
def test_scan_kernels_bf16_training_shapes(dev, batch, L, D, R):
    """The fusion step's bf16 scans through the op (forward and, through its
    autograd Function, the backward) against the plain version."""
    args = _bf16_scan_args(dev, L + D + batch, batch, L, D, 16, R)
    dy = torch.randn(batch, 4, L, D, generator=torch.Generator().manual_seed(L)).to(dev, BF16)

    def kernel(u, dt, A, Bm, Cm, Dp, bias, W):
        return selective_scan(u, dt, A, Bm, Cm, Dp, bias, delta_softplus=True,
                              dt_lowrank_weight=W)

    _check_bf16(kernel, _bf16_scan_plain, args, None, ["fm_selective_scan_fwd_bf16"])
    _check_bf16(kernel, _bf16_scan_plain, args, dy, ["fm_selective_scan_bwd_bf16"])


@pytest.mark.parametrize("batch,L,D,R,chunk", [
    (2, 256, 384, 12, 64), (2, 256, 384, 12, 256), (6, 1024, 192, 6, 128),
    (6, 1024, 192, 6, 1024), (2, 64, 768, 24, 16), (2, 63, 40, 0, 32), (2, 64, 96, 0, 64),
    (1, 97, 33, 5, 32)])
def test_scan_kernels_bf16_chunks(dev, batch, L, D, R, chunk):
    """One chunk and several (the forward's local and carry passes, the
    backward's adjoint carries), R = 0 (the full dt: the block-wide delta
    phase) and an odd R (16-bit operand loads)."""
    args = _bf16_scan_args(dev, L * 3 + D, batch, L, D, 16, R)
    dy = torch.randn(batch, 4, L, D, generator=torch.Generator().manual_seed(D)).to(dev, BF16)
    _bf16_chunked_check(args, dy, chunk)


@pytest.mark.parametrize("L,D,R,chunk", [(96, 40, 6, 32), (96, 70, 0, 32), (256, 32, 2, 64),
                                         (100, 130, 6, 48)])
def test_scan_backward_kernel_bf16_ragged_d_slow_decay(dev, L, D, R, chunk):
    """The bf16 twin of test_scan_backward_kernel_ragged_d_slow_decay: D not a
    multiple of the blocks' channels, several chunks, |A| near 0.01, so that
    whatever a lane past D carried would reach the sums over the block's
    channels (dB, dC, d(dt), dW) at full size."""
    args = _bf16_scan_args(dev, L + D, 2, L, D, 16, R, shift=0.0, a_scale=0.01)
    dy = torch.randn(2, 4, L, D, generator=torch.Generator().manual_seed(L * D)).to(dev, BF16)
    _bf16_chunked_check(args, dy, chunk)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("R", [72, 128, 200])
def test_scan_kernels_bf16_wide_rank(dev, R, chunk):
    """A dt rank past the backward's 8 warps x 8 columns of d(dt) (SS2D's
    ceil(d_model / 16) at d_model > 1024): warps take a second and third
    column group, the last one ragged at R = 200; several chunks and one."""
    args = _bf16_scan_args(dev, R + chunk, 2, 64, 130, 16, R)
    dy = torch.randn(2, 4, 64, 130, generator=torch.Generator().manual_seed(R)).to(dev, BF16)
    _bf16_chunked_check(args, dy, chunk)


@pytest.mark.parametrize("R", [6, 5])
def test_scan_kernels_bf16_misaligned_dt(dev, R):
    """dt a view 2 bytes past an aligned address (its tiles staged a value
    at a time), at an even and an odd R."""
    args = _bf16_scan_args(dev, 11 + R, 2, 80, 96, 16, R, dt_offset=1)
    assert args[1].data_ptr() % 4 == 2
    dy = torch.randn(2, 4, 80, 96, generator=torch.Generator().manual_seed(R)).to(dev, BF16)
    _bf16_chunked_check(args, dy, 32)
    _bf16_chunked_check(args, dy, 80 + 16)


# the backward's bf16 design: every model width (C = 24 ... 1536, two to
# 128 lanes a row), C outside its templates (40, 100: masked quads; 30 and
# 3: not a multiple of 4, the strided templates), rows that leave groups of
# a block idle (5), and (49152, 96) and (393216, 24), the training step's
# largest
@pytest.mark.parametrize("gate_act", ["none", "silu", "silu_sum", "raw"])
@pytest.mark.parametrize("rows,C", [(37, 96), (4096, 192), (64, 1536), (37, 100), (300, 24),
                                    (37, 40), (5, 384), (70, 768), (9, 30), (11, 3),
                                    (49152, 96), (393216, 24)])
def test_layer_norm_kernels_bf16(dev, gate_act, rows, C):
    """x, the gate, y, dx and dgate bf16; scale and bias bf16 parameters that
    enter the kernels as fp32 (their gradients return in bf16)."""
    g = torch.Generator().manual_seed(rows + C)
    x = _rand(g, rows, C, scale=2.0, shift=0.5)
    s, b = _rand(g, C, scale=0.2, shift=1.0), _rand(g, C, scale=0.2)
    gate = None if gate_act == "none" else _rand(g, rows, C)
    act = "none" if gate_act == "raw" else gate_act
    inputs = [t if t is None else t.to(dev, BF16) for t in (x, s, b, gate)]
    dy = _rand(g, rows, C).to(dev, BF16)

    def kernel(x, s, b, gate):
        return layer_norm.layer_norm_fused(x, s, b, gate, 1e-6, act)

    def plain(x, s, b, gate):
        return layer_norm.layer_norm_plain(x, s, b, gate, 1e-6, act)

    _check_bf16(kernel, plain, inputs, dy, ["triton_ln_fwd_bf16", "fm_layer_norm_bwd_bf16"])


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("gate_act", ["none", "silu"])
@pytest.mark.parametrize("rows,C", [(37, 96), (64, 384)])
def test_layer_norm_backward_bf16_misaligned(dev, gate_act, rows, C, offset):
    """x, the gate and dy `offset` elements (2 or 4 bytes) off an 8-byte
    boundary: the plan takes the strided templates, and their result agrees
    with the quads' on aligned copies of the same values."""
    g = torch.Generator().manual_seed(rows + C + offset)

    def view(*shape, **kw):
        n = math.prod(shape)
        return _rand(g, n + offset, **kw).to(dev, BF16)[offset:].view(shape)

    x, dy = view(rows, C, scale=2.0, shift=0.5), view(rows, C)
    gate = view(rows, C) if gate_act != "none" else None
    s, b = _rand(g, C, scale=0.2, shift=1.0).to(dev), _rand(g, C, scale=0.2).to(dev)
    assert not layer_norm.bwd_plan(rows, C, io=BF16, aligned=False).quads
    got = layer_norm.layer_norm_bwd(x, s, b, gate, dy, 1e-6, gate_act)
    copies = [None if t is None else t.clone() for t in (x, gate, dy)]
    assert all(t is None or t.data_ptr() % 8 == 0 for t in copies)
    want = layer_norm.layer_norm_bwd(copies[0], s, b, copies[1], copies[2], 1e-6, gate_act)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        if w is not None:
            _bf16_close(a, w)


@pytest.mark.parametrize("B,rows,C", [(3, 37, 96), (12, 4096, 96), (2, 300, 1000), (8, 64, 768)])
def test_ln_spatial_mean_kernels_bf16(dev, B, rows, C):
    """x and dx bf16; the (B, C) mean and its cotangent fp32."""
    g = torch.Generator().manual_seed(B * rows + C)
    x = _rand(g, B, rows, C, scale=2.0, shift=0.5).to(dev, BF16)
    s, b = _rand(g, C, scale=0.2, shift=1.0).to(dev), _rand(g, C, scale=0.2).to(dev)
    dm = _rand(g, B, C).to(dev)

    def kernel(x, s, b):
        return layer_norm.ln_spatial_mean(x, s, b, 1e-5)

    def plain(x, s, b):
        return layer_norm.ln_spatial_mean_plain(x, s, b, 1e-5)

    before = COUNTS["fm_ln_mean_fwd_bf16"]
    y, got = _grads(kernel, [x, s, b], dm)
    yw, want = _grads(plain, [x, s, b], dm)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and COUNTS["fm_ln_mean_fwd_bf16"] == before + 1
    torch.testing.assert_close(y, yw, rtol=1e-4, atol=1e-4)   # fp32 out, no bf16 rounding
    for t, gk, w in zip((x, s, b), got, want):
        assert gk.dtype == t.dtype
        _bf16_close(gk, w)


# the bf16 LN-mean designs: every model width (C = 24 ... 1536: 2 to 128
# lanes a row), C outside the quads templates (40, 100, 1000: masked quads),
# rows that leave a block's groups idle (5, 37), one row, the fusion step's
# shapes at batch 12 and 6 and the serving encoder's largest (16, 4096, 96)
_LNM_BF16_SHAPES = [(1, 1, 24), (3, 37, 96), (2, 300, 24), (12, 4096, 96), (6, 1024, 192),
                    (12, 256, 384), (6, 256, 384), (6, 64, 768), (2, 16, 1536), (5, 37, 40),
                    (2, 5, 100), (2, 300, 1000), (16, 4096, 96)]


def _lnm_bf16_case(seed, B, rows, C, params, dev, offset=0):
    """bf16 x (`offset` elements past an 8-byte boundary), scale and bias of
    dtype `params`, an fp32 cotangent of the (B, C) mean."""
    g = torch.Generator().manual_seed(seed)
    n = B * rows * C
    x = _rand(g, n + offset, scale=2.0, shift=0.5).to(dev, BF16)[offset:].view(B, rows, C)
    s, b = _rand(g, C, scale=0.2, shift=1.0).to(dev, params), _rand(g, C, scale=0.2).to(dev, params)
    return x, s, b, _rand(g, B, C).to(dev)


def _lnm(x, s, b):
    return layer_norm.ln_spatial_mean(x, s, b, 1e-5)


def _lnm_designs():
    """The LN-mean's bf16 launches so far on the forward's quads and in the
    backward's one launch."""
    return COUNTS["fm_ln_mean_fwd_bf16:quads"], COUNTS["fm_ln_mean_bwd_bf16:one_launch"]


def _lnm_plain(x, s, b):
    return layer_norm.ln_spatial_mean_plain(x, s, b, 1e-5)


@pytest.mark.parametrize("params", [BF16, torch.float32])
@pytest.mark.parametrize("B,rows,C", _LNM_BF16_SHAPES)
def test_ln_spatial_mean_bf16_quads(dev, B, rows, C, params):
    """The LN-mean pair's bf16 designs, with bf16 and with fp32 parameters:
    the fp32 mean against the plain version at 1e-4 (no bf16 rounding), dx,
    dscale and dbias at the bf16 gate, each gradient in its input's dtype;
    bit-identical over two launches; every forward on the quads and every
    backward in one launch."""
    x, s, b, dm = _lnm_bf16_case(B * rows + C, B, rows, C, params, dev)
    assert layer_norm.lnm_fwd_plan(B, rows, C, io=BF16).quads
    assert layer_norm.lnm_bwd_plan(B, rows, C, io=BF16).quads
    before = _lnm_designs()
    y, got = _grads(_lnm, [x, s, b], dm)
    y2, again = _grads(_lnm, [x, s, b], dm)
    yw, want = _grads(_lnm_plain, [x, s, b], dm)
    torch.cuda.synchronize()
    assert _lnm_designs() == (before[0] + 2, before[1] + 2)
    assert y.dtype == torch.float32 and torch.equal(y, y2)
    torch.testing.assert_close(y, yw, rtol=1e-4, atol=1e-4)
    for t, gk, ga, w in zip((x, s, b), got, again, want):
        assert gk.dtype == t.dtype and torch.equal(gk, ga)
        _bf16_close(gk, w)


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("B,rows,C", [(3, 37, 96), (6, 256, 384), (2, 9, 40)])
def test_ln_spatial_mean_bf16_misaligned(dev, B, rows, C, offset):
    """x `offset` elements (2 or 4 bytes) off an 8-byte boundary: both plans
    take the strided templates (the backward two launches), and their results
    agree with the quads' on an aligned copy of the same values, with bf16
    parameters."""
    x, s, b, dm = _lnm_bf16_case(B + rows + C + offset, B, rows, C, BF16, dev, offset)
    assert not layer_norm.lnm_fwd_plan(B, rows, C, io=BF16, aligned=False).quads
    assert not layer_norm.lnm_bwd_plan(B, rows, C, io=BF16, aligned=False).quads
    quads, one = _lnm_designs()
    y, xmean = layer_norm.ln_spatial_mean_fwd(x, s, b, 1e-5, with_mean=True)
    assert xmean is None
    got = [y, *layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5)]
    assert _lnm_designs() == (quads, one)
    copy = x.clone()
    assert copy.data_ptr() % 8 == 0
    y, xmean = layer_norm.ln_spatial_mean_fwd(copy, s, b, 1e-5, with_mean=True)
    want = [y, *layer_norm.ln_spatial_mean_bwd(copy, s, dm, 1e-5, xmean=xmean)]
    assert COUNTS["fm_ln_mean_bwd_bf16:one_launch"] == one + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    for a, w in zip(got[1:], want[1:]):
        _bf16_close(a, w)


# the one-launch backward's grids at (6, 256, 384): blocks that walk 16, 4
# and 1 row steps of their batch row, and more blocks than row steps
@pytest.mark.parametrize("blocks", [1, 4, 16, 40])
def test_ln_spatial_mean_bwd_bf16_grids(dev, blocks):
    """Each grid against the plain version at the bf16 gate, bit-identical
    over two launches, in one launch; without the forward's means the
    one-launch plan is refused."""
    B, rows, C = 6, 256, 384
    x, s, b, dm = _lnm_bf16_case(blocks, B, rows, C, BF16, dev)
    _, xmean = layer_norm.ln_spatial_mean_fwd(x, s, b, 1e-5, with_mean=True)
    plan = layer_norm.lnm_bwd_plan(B, rows, C, io=BF16)._replace(blocks=blocks)
    got = layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5, plan, xmean=xmean)
    again = layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5, plan, xmean=xmean)
    _, want = _grads(_lnm_plain, [x, s, b], dm)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _bf16_close(g.to(w.dtype), w)
    assert len(_kernel_launches(
        lambda: layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5, plan, xmean=xmean))) == 1
    with pytest.raises(ValueError, match="xmean"):
        layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5, plan)


def _kernel_launches(run, captures=3):
    """The kernels `run` launches on the card, by the profiler (memsets and
    copies excluded), once `run` has been called before: the most that any
    of `captures` captures of one call recorded (a capture sometimes misses
    a kernel, never adds one)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    best = []
    for _ in range(captures):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and "memset" not in e.name.lower() and "memcpy" not in e.name.lower()]
        best = max(best, names, key=len)
    return best


@pytest.mark.parametrize("params", [BF16, torch.float32])
@pytest.mark.parametrize("B,rows,C,offset", [(6, 256, 384, 0), (12, 4096, 96, 0),
                                             (2, 5, 100, 0), (3, 37, 96, 1), (2, 9, 30, 0)])
def test_ln_spatial_mean_bf16_launches(dev, B, rows, C, offset, params):
    """The launches of a call, counted by the profiler: one for every
    forward as BiAttn calls it (no cast of the parameters), one for a
    backward on the quads and two off them (misaligned x, C = 30), as the
    plans say."""
    x, s, b, dm = _lnm_bf16_case(rows + C, B, rows, C, params, dev, offset)
    aligned = x.data_ptr() % 8 == 0
    with torch.no_grad():
        assert len(_kernel_launches(lambda: _lnm(x, s, b))) == 1
    _, xmean = layer_norm.ln_spatial_mean_fwd(x, s, b, 1e-5, with_mean=True)
    plan = layer_norm.lnm_bwd_plan(B, rows, C, io=BF16, aligned=aligned)
    assert plan.quads == (aligned and C % 4 == 0) == (xmean is not None)
    names = _kernel_launches(lambda: layer_norm.ln_spatial_mean_bwd(x, s, dm, 1e-5, xmean=xmean))
    assert len(names) == (1 if plan.quads else 2), names


# the backward's bf16 design: blocks that walk one tile and several (12, 64,
# 64, 192 walks five tiles a block), grids of fewer blocks than SMs at the
# small images (2, 8, 8, 1536 and 4, 16, 16, 768), a ragged image and C (40),
# C = 24 (a channel block with lanes past C), C not a multiple of 4 (3:
# scalar staging), a 1x1 image
@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (12, 64, 64, 192), (6, 8, 8, 1536),
                                   (2, 8, 8, 1536), (4, 16, 16, 768), (12, 32, 32, 384),
                                   (2, 11, 19, 40), (1, 1, 1, 8), (3, 9, 13, 6),
                                   (2, 8, 8, 24)])
def test_dwconv_kernels_bf16(dev, act, has_bias, shape):
    """x, out, dy and dx bf16 (C = 3 takes the scalar path); w and bias bf16
    parameters that enter the kernels as fp32 (gradients back in bf16)."""
    g = torch.Generator().manual_seed(sum(shape))
    C = shape[-1]
    inputs = [_rand(g, *shape).to(dev, BF16), _rand(g, 3, 3, C, scale=0.3).to(dev, BF16),
              _rand(g, C, scale=0.1).to(dev, BF16) if has_bias else None]
    dy = _rand(g, *shape).to(dev, BF16)
    _check_bf16(lambda x, w, b: dwconv.depthwise_conv3x3(x, w, b, act=act),
                lambda x, w, b: dwconv.depthwise_conv3x3_plain(x, w, b, act=act),
                inputs, dy, ["fm_dwconv3x3_fwd_bf16", "fm_dwconv3x3_bwd_bf16"])


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape", [(2, 9, 13, 8), (6, 16, 16, 768)])
def test_dwconv_backward_bf16_misaligned(dev, act, shape, offset):
    """x and dy `offset` elements (2 or 4 bytes) off an 8-byte boundary: the
    kernel's scalar staging, against autograd of the plain version."""
    g = torch.Generator().manual_seed(sum(shape) + offset)
    C = shape[-1]

    def view():
        n = math.prod(shape)
        return _rand(g, n + offset).to(dev, BF16)[offset:].view(shape)

    x, dy = view(), view()
    w, b = _rand(g, 3, 3, C, scale=0.3).to(dev), _rand(g, C, scale=0.1).to(dev)
    got = dwconv.dwconv_bwd(x, w, b, dy, act)
    _, want = _grads(lambda *a: dwconv.depthwise_conv3x3_plain(*a, act), [x, w, b], dy)
    torch.cuda.synchronize()
    _bf16_close(got[0], want[0])
    for a, w_ in zip(got[1:], want[1:]):
        _bf16_close(a, w_)


# the bf16 dwconv forward's own kernel (staged as bf16 by cp.async): the
# model's shapes, ragged ones, C not a multiple of 4 (3, 6: masked staging),
# tiles of 1 to 16 rows
@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
@pytest.mark.parametrize("shape", [(6, 8, 8, 1536), (6, 16, 16, 768), (12, 32, 32, 384),
                                   (6, 64, 64, 192), (2, 5, 7, 3), (3, 9, 13, 6),
                                   (2, 11, 19, 40), (1, 1, 1, 8), (2, 7, 33, 12), (2, 4, 4, 20)])
def test_dwconv_forward_bf16_designs(dev, act, has_bias, shape, monkeypatch):
    """The bf16 forward kernel against its plain version at the bf16 gate,
    bit-identical twice and under other rows of a tile."""
    g = torch.Generator().manual_seed(sum(shape))
    C = shape[-1]
    x = _rand(g, *shape).to(dev, BF16)
    w = _rand(g, C, 3, 3, scale=0.3).to(dev, BF16).permute(1, 2, 0)
    b = _rand(g, C, scale=0.1).to(dev, BF16) if has_bias else None
    before = COUNTS["fm_dwconv3x3_fwd_bf16"]
    with torch.no_grad():
        got, again = dwconv.depthwise_conv3x3(x, w, b, act), dwconv.depthwise_conv3x3(x, w, b, act)
        for rows in (1, 4):
            monkeypatch.setattr(dwconv, "BF16_FWD_MAX_ROWS", rows)
            other = dwconv.fwd_plan(*shape, sms=cuda_lib.sm_count(dev), io=BF16)
            assert torch.equal(dwconv.dwconv_fwd(x, w, b, act, other), got), other
    torch.cuda.synchronize()
    assert COUNTS["fm_dwconv3x3_fwd_bf16"] == before + 4
    _bf16_close(got, dwconv.depthwise_conv3x3_plain(x, w, b, act))
    assert torch.equal(got, again)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 9, 13, 8), (6, 16, 16, 768)])
def test_dwconv_forward_bf16_misaligned(dev, shape, offset):
    """x and the output `offset` elements off an 8-byte boundary: the bf16
    kernel's masked staging and stores, against the aligned call on copies
    of the same values, bit for bit."""
    g = torch.Generator().manual_seed(sum(shape) + offset)
    C, n = shape[-1], math.prod(shape)
    x = _rand(g, n + offset).to(dev, BF16)[offset:].view(shape)
    w = _rand(g, 3, 3, C, scale=0.3).to(dev, BF16)
    b = _rand(g, C, scale=0.1).to(dev, BF16)
    plan = dwconv.fwd_plan(*shape, sms=cuda_lib.sm_count(dev), io=BF16)
    w_c = w.permute(2, 0, 1).contiguous()
    out = torch.empty(n + offset, device=dev, dtype=BF16)[offset:].view(shape)
    cuda_lib.launch("fm_dwconv3x3_fwd_bf16", x.data_ptr(), w_c.data_ptr(), b.data_ptr(),
                    out.data_ptr(), *shape, 1, plan.cq, plan.tw, plan.th, *plan.grid, 1, device=dev)
    with torch.no_grad():
        want = dwconv.depthwise_conv3x3(x.clone(), w, b, "silu")
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    _bf16_close(out, dwconv.depthwise_conv3x3_plain(x, w, b, "silu"))


# K10: a bf16 step hands the LN and the dwconv their parameters' bf16 casts,
# which the kernels read as they are (#3, #4, #7, #8). Widening bf16 to fp32
# is exact, so every output and gradient equals the same call on the fp32
# casts of those parameters bit for bit (the fp32 gradients rounded to bf16,
# as autograd's cast of a `.float()` rounds them), with the same launches.

_LN_COUNTERS = ["triton_ln_fwd", "triton_ln_fwd_bf16", "fm_layer_norm_bwd",
                "fm_layer_norm_bwd_bf16", "fm_layer_norm_bwd_bf16:quads"]
_DW_COUNTERS = ["fm_dwconv3x3_fwd", "fm_dwconv3x3_fwd_bf16", "fm_dwconv3x3_bwd",
                "fm_dwconv3x3_bwd_bf16"]


def _both_param_routes(op, inputs, params, dy, counters):
    """op's output and gradients with the bf16 parameters (indices `params`
    of `inputs`) as they are and with their fp32 casts as the leaves, and
    the counters' advance in each route."""
    routes = []
    for cast in (False, True):
        args = [t.float() if cast and i in params and t is not None else t
                for i, t in enumerate(inputs)]
        before = [COUNTS[k] for k in counters]
        y, grads = _grads(op, args, dy)
        torch.cuda.synchronize()
        routes.append((y, grads, [COUNTS[k] - b for k, b in zip(counters, before)]))
    return routes


def _assert_same_routes(routes, inputs):
    (y, grads, moved), (y32, grads32, moved32) = routes
    assert torch.equal(y, y32)
    assert moved == moved32 and all(n == 1 for n in moved if n), (moved, moved32)
    for t, g, g32 in zip([t for t in inputs if t is not None], grads, grads32):
        assert g.dtype == t.dtype
        assert torch.equal(g, g32.to(t.dtype))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("gate_act", ["none", "silu", "silu_sum", "raw"])
@pytest.mark.parametrize("rows,C", [(1536, 768), (6144, 192), (37, 100), (11, 3), (9, 30)])
def test_layer_norm_bf16_params_equal_their_fp32_casts(dev, gate_act, rows, C, offset):
    """#3 and #4 with bf16 scale and bias against the same call on their fp32
    casts: bit-identical output, dx, dgate, dscale and dbias (each in its
    input's dtype), the same launches (offset 1: x, the gate and dy off an
    8-byte boundary, the strided templates)."""
    g = torch.Generator().manual_seed(rows + C + offset)

    def act(*shape, **kw):
        n = math.prod(shape)
        return _rand(g, n + offset, **kw).to(dev, BF16)[offset:].view(shape)

    x, dy = act(rows, C, scale=2.0, shift=0.5), act(rows, C)
    gate = None if gate_act == "none" else act(rows, C)
    s, b = _rand(g, C, scale=0.2, shift=1.0).to(dev, BF16), _rand(g, C, scale=0.2).to(dev, BF16)
    gact = "none" if gate_act == "raw" else gate_act

    def op(x, s, b, gate):
        return layer_norm.layer_norm_fused(x, s, b, gate, 1e-6, gact)

    inputs = [x, s, b, gate]
    _assert_same_routes(_both_param_routes(op, inputs, (1, 2), dy, _LN_COUNTERS), inputs)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
@pytest.mark.parametrize("shape", [(6, 16, 16, 768), (12, 64, 64, 192), (2, 5, 7, 3),
                                   (2, 11, 19, 40), (2, 8, 8, 24)])
def test_dwconv_bf16_params_equal_their_fp32_casts(dev, act, has_bias, shape, offset):
    """#7 and #8 with a bf16 weight (a view of a (C, 3, 3) tensor, as SS2D
    passes it) and bias against the same call on their fp32 casts:
    bit-identical output, dx, dw and dbias (each in its input's dtype), the
    same launches (offset 1: x and dy off an 8-byte boundary)."""
    g = torch.Generator().manual_seed(sum(shape) + offset)
    C, n = shape[-1], math.prod(shape)
    x = _rand(g, n + offset).to(dev, BF16)[offset:].view(shape)
    dy = _rand(g, n + offset).to(dev, BF16)[offset:].view(shape)
    w = _rand(g, C, 3, 3, scale=0.3).to(dev, BF16).permute(1, 2, 0)
    b = _rand(g, C, scale=0.1).to(dev, BF16) if has_bias else None

    def op(x, w, b):
        return dwconv.depthwise_conv3x3(x, w, b, act)

    inputs = [x, w, b]
    _assert_same_routes(_both_param_routes(op, inputs, (1, 2), dy, _DW_COUNTERS), inputs)


@pytest.mark.parametrize("which", ["layer_norm", "dwconv"])
def test_bf16_forward_launches_no_cast(dev, which):
    """A bf16 forward of each op on bf16 parameters, as a bf16 step calls it
    (with a gradient to record): its kernel, launched once, and no cast. A
    cast is a PyTorch operator (`_to_copy`, `copy_`), so the
    operators the call dispatches are logged (below the profiler, which on
    the card's machine sometimes records no event): an allocation, and no
    copy, cast, clone or fill."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(5)
    if which == "layer_norm":
        x, gate = (_rand(g, 1536, 768).to(dev, BF16) for _ in range(2))
        s, b = (_rand(g, 768).to(dev, BF16).requires_grad_(True) for _ in range(2))
        counter = "triton_ln_fwd_bf16"

        def run():
            return layer_norm.layer_norm_fused(x, s, b, gate, 1e-6, "silu")
    else:
        x = _rand(g, 6, 16, 16, 768).to(dev, BF16)
        w = _rand(g, 768, 3, 3).to(dev, BF16).permute(1, 2, 0).requires_grad_(True)
        b = _rand(g, 768).to(dev, BF16).requires_grad_(True)
        counter = "fm_dwconv3x3_fwd_bf16"

        def run():
            return dwconv.depthwise_conv3x3(x, w, b, "silu")
    run()
    ops, before = [], COUNTS[counter]
    with Log():
        y = run()
    torch.cuda.synchronize()
    assert COUNTS[counter] == before + 1 and y.dtype == BF16 and y.requires_grad
    assert "aten::empty_like" in ops, ops
    assert not any(k in op for op in ops for k in ("copy", "_to", "clone", "fill")), ops


@pytest.mark.parametrize("M,C,H", [
    (1, 16, 64), (37, 96, 384), (512, 768, 3072), (3072, 96, 384), (768, 192, 768),
    (200, 96, 384), (1000, 192, 768), (3072, 384, 768), (384, 768, 1536), (300, 40, 160),
    (20000, 96, 384)])
def test_mlp_kernels_bf16(dev, M, C, H):
    """Every tensor bf16: the forward (fused where its widths allow, and
    two-pass), and the backward with its bf16 roundings of the hidden and of
    dL/dh, against the plain version that rounds at the same places; the
    backward launched twice directly, bit-identical. Shapes: a 64-deep slice
    with a tail (C = 96, 40), M not a multiple of 64, the smallest, a
    tensor-parallel rank's half hidden (H = 2C), and one where the wrapper
    takes the fused forward."""
    g = torch.Generator().manual_seed(M + C + H)
    x = _rand(g, M, C).to(dev, BF16)
    w1, b1 = _rand(g, H, C, scale=C ** -0.5).to(dev, BF16), _rand(g, H, scale=0.1).to(dev, BF16)
    w2, b2 = _rand(g, C, H, scale=H ** -0.5).to(dev, BF16), _rand(g, C, scale=0.1).to(dev, BF16)
    want = mlp.fused_mlp_plain(x, w1.t(), b1, w2.t(), b2)
    for fused in (True, False) if C <= mlp.BF16_FUSED_MAX_WIDTH else (False,):
        with torch.no_grad():
            got = mlp.mlp_fwd(x, w1, b1, w2, b2, fused=fused)
        _bf16_close(got, want)
    dy = _rand(g, M, C).to(dev, BF16)
    _check_bf16(lambda x, a, b1, c, b2: mlp.fused_mlp(x, a.t(), b1, c.t(), b2),
                lambda x, a, b1, c, b2: mlp.fused_mlp_plain(x, a.t(), b1, c.t(), b2),
                [x, w1, b1, w2, b2], dy, ["fm_fused_mlp_fwd_bf16", "fm_fused_mlp_bwd_bf16"])
    first = mlp.mlp_bwd(x, w1.t(), b1, w2.t(), b2, dy)
    second = mlp.mlp_bwd(x, w1.t(), b1, w2.t(), b2, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_mlp_kernel_bf16_width_limit(dev):
    """bf16 widths must be whole 16-byte copies: multiples of 8; the fused
    bf16 forward takes widths up to BF16_FUSED_MAX_WIDTH."""
    x = torch.zeros(4, 20, device=dev, dtype=BF16)
    w1, b1 = torch.zeros(20, 72, device=dev, dtype=BF16), torch.zeros(72, device=dev, dtype=BF16)
    w2, b2 = torch.zeros(72, 20, device=dev, dtype=BF16), torch.zeros(20, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match="multiples of 8"):
        mlp.fused_mlp(x, w1, b1, w2, b2)
    C = mlp.BF16_FUSED_MAX_WIDTH + 8
    x = torch.zeros(4, C, device=dev, dtype=BF16)
    w1, b1 = torch.zeros(4 * C, C, device=dev, dtype=BF16), torch.zeros(4 * C, device=dev, dtype=BF16)
    w2, b2 = torch.zeros(C, 4 * C, device=dev, dtype=BF16), torch.zeros(C, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match="fused bf16 forward"):
        mlp.mlp_fwd(x, w1, b1, w2, b2, fused=True)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_train_steps_never_wait_for_the_card(dev, precision):
    """A warm fusion step and a warm segmentation step (mode both, the
    improved loss with class weights on the card) under
    torch.cuda.set_sync_debug_mode("error"): no host-device synchronisation
    inside either step."""
    from fusionmamba_torch.config import test_config
    from fusionmamba_torch.models import VSSMFusion, VSSMFusionSeg
    from fusionmamba_torch.nn import init_weights
    from fusionmamba_torch.train import (fusion_train_step, make_fusion_optimizer,
                                         make_seg_optimizer, resolve_compute_dtype,
                                         seg_train_step)

    dtype = resolve_compute_dtype(precision)
    g = torch.Generator().manual_seed(6)
    vis, ir = (torch.rand(2, 32, 32, 1, generator=g).to(dev) for _ in range(2))
    labels = torch.randint(0, 5, (2, 32, 32), generator=g).to(dev)
    weights = torch.tensor([1.0, 3.0, 2.0, 4.0, 1.5], device=dev)
    net = init_weights(VSSMFusion(test_config(drop_path_rate=0.1)), seed=1).to(dev)
    opt = make_fusion_optimizer(net.parameters())
    gen = torch.Generator(device=dev).manual_seed(0)
    seg = init_weights(VSSMFusionSeg(test_config(num_seg_classes=5)), seed=2).to(dev)
    seg_opt = make_seg_optimizer(seg.parameters())

    def steps():
        a = fusion_train_step(net, opt, vis, ir, gen, compute_dtype=dtype)
        b = seg_train_step(seg, seg_opt, vis, ir, labels, num_classes=5, mode="both",
                           class_weights=weights, improved=True, generator=gen,
                           compute_dtype=dtype)
        return a, b

    steps()          # warm: the kernels build, the losses' matrices are made
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, b = steps()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(v)) for v in (*a.values(), *b.values()))


# ---------------------------------------------------------------------------
# spans and copy counts (`utils/tracing.py`) on the card
# ---------------------------------------------------------------------------

def _owners(rec):
    """{device event name: the spans that own its launches}: each device
    event is mapped to its runtime launch by correlation id, and the launch,
    on whatever thread, to the shortest program span open at its time."""
    from torch.autograd import DeviceType
    spans = [e for e in rec.events if e.is_user_annotation() and e.device_type() == DeviceType.CPU]
    launch = {e.correlation_id(): e.start_ns() for e in rec.events
              if e.device_type() == DeviceType.CPU and not e.is_user_annotation()}
    out = {}
    for e in rec.events:
        if e.device_type() == DeviceType.CPU or e.is_user_annotation():
            continue
        t = launch.get(e.correlation_id())
        open_ = [s for s in spans if t is not None and s.start_ns() <= t <= s.end_ns()]
        inner = min(open_, key=lambda s: s.end_ns() - s.start_ns()).name() if open_ else None
        out.setdefault(e.name(), set()).add(inner)
    return out


def test_spans_own_their_kernels_and_the_backward_kernels(dev):
    """A span around one hand-written kernel owns that kernel's device
    event; a span around `loss.backward()` owns the backward's kernels,
    which autograd launches from a thread of its own; the recording holds no
    operator."""
    from fusionmamba_torch.utils import tracing
    g = torch.Generator().manual_seed(3)
    x = _rand(g, 2, 16, 16, 64).to(dev).requires_grad_(True)
    w = _rand(g, 64, 3, 3, scale=0.3).to(dev).permute(1, 2, 0).requires_grad_(True)
    b = _rand(g, 64).to(dev).requires_grad_(True)
    dwconv.depthwise_conv3x3(x, w, b, "silu").sum().backward()     # warm
    torch.cuda.synchronize()
    for _ in range(3):   # a recording now and then misses its first kernels
        with tracing.record() as rec:
            (x.detach() + 1).sum()
            torch.cuda.synchronize()
            with tracing.span("conv"):
                y = dwconv.depthwise_conv3x3(x, w, b, "silu")
            loss = y.square().sum()
            with tracing.span("backward"):
                loss.backward()
        owners = _owners(rec)
        fwd = [n for n in owners if "dwconv3x3_fwd_kernel" in n]
        bwd = [n for n in owners if "dwconv3x3_bwd" in n]
        if fwd and bwd:
            break
    assert fwd and bwd, sorted(owners)
    assert all(owners[n] == {"conv"} for n in fwd)
    assert all(owners[n] == {"backward"} for n in bwd)
    assert not any(e.name().startswith("aten::") for e in rec.events)


def test_copy_sites_count_only_the_copies_they_make(dev):
    """The dwconv's weight: a (3, 3, C) view of a (C, 3, 3) tensor needs no
    copy, a contiguous (3, 3, C) one a copy of 9 C floats. The MLP's weights:
    the transposes of nn.Linear weights need none, contiguous (C, H) and
    (H, C) ones a copy each of C H floats."""
    from fusionmamba_torch.utils import tracing
    g = torch.Generator().manual_seed(4)
    C, H = 64, 256
    x = _rand(g, 2, 8, 8, C).to(dev)
    w_view = _rand(g, C, 3, 3).to(dev).permute(1, 2, 0)
    before = collections.Counter(tracing.counts)
    dwconv.depthwise_conv3x3(x, w_view, None)
    dwconv.depthwise_conv3x3(x, w_view.contiguous(), None)
    x2 = _rand(g, 32, C).to(dev)
    w1, w2 = _rand(g, H, C).to(dev), _rand(g, C, H).to(dev)
    mlp.fused_mlp(x2, w1.t(), torch.zeros(H, device=dev), w2.t(), torch.zeros(C, device=dev))
    mlp.fused_mlp(x2, w1.t().contiguous(), torch.zeros(H, device=dev), w2.t().contiguous(),
                  torch.zeros(C, device=dev))
    got = {k: v - before[k] for k, v in tracing.counts.items()
           if k.startswith("cop") and v != before[k]}
    assert got == {"copies:dwconv.weight": 1, "copy_bytes:dwconv.weight": 9 * C * 4,
                   "copies:mlp.weights": 2, "copy_bytes:mlp.weights": 2 * C * H * 4}
