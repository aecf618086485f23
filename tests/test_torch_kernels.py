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
import math

import pytest
import torch

from fusionmamba_torch.device import select_device
from fusionmamba_torch.ops import cuda_lib, dwconv, layer_norm, ln_triton, mlp, scan_cuda
from fusionmamba_torch.ops.selective_scan import selective_scan, selective_scan_plain

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
    before = scan_cuda.launches
    if chunk is None:
        got = selective_scan(*args[:7], delta_softplus=True, dt_lowrank_weight=args[7])
    else:
        got = scan_cuda.selective_scan_fwd(*args[:7], True, args[7], chunk=chunk)
    torch.cuda.synchronize()
    assert scan_cuda.launches == before + 1
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
    before = ln_triton.layer_norm_launches
    got = layer_norm.layer_norm_fused(x, s, b, gate, 1e-6, gate_act)
    torch.cuda.synchronize()
    assert ln_triton.layer_norm_launches == before + 1
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
    before = layer_norm.ln_mean_launches
    got = layer_norm.ln_spatial_mean(x, s, b, 1e-5)
    again = layer_norm.ln_spatial_mean(x, s, b, 1e-5)
    torch.cuda.synchronize()
    assert layer_norm.ln_mean_launches == before + 2
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
    before = dwconv.launches
    got = dwconv.depthwise_conv3x3(x, w, b, act)
    torch.cuda.synchronize()
    assert dwconv.launches == before + 1
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
                    out.data_ptr(), *shape, 1, plan.cq, plan.tw, plan.th, *plan.grid, device=dev)
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
    before = mlp.launches
    got = mlp.fused_mlp(x, w1, b1, w2, b2)
    again = mlp.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert mlp.launches == before + 2
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
    module, name = counter
    before = getattr(module, name)
    y, got = _grads(kernel, inputs, dy)
    _, again = _grads(kernel, inputs, dy)
    torch.cuda.synchronize()
    assert getattr(module, name) == before + 2
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

    _check_backward(kernel, plain, inputs, dy, (scan_cuda, "bwd_launches"))


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

    _check_backward(kernel, plain, inputs, dy, (layer_norm, "layer_norm_bwd_launches"))


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
                    inputs, dm, (layer_norm, "ln_mean_bwd_launches"))


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
                    inputs, dy, (dwconv, "bwd_launches"))


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


@pytest.mark.parametrize("M,C,H", [(1, 16, 64), (37, 96, 384), (100, 20, 72), (768, 768, 3072),
                                   (384, 768, 3072), (49152, 96, 384), (128, 768, 3072),
                                   (8192, 96, 384)])
def test_mlp_backward_kernel(dev, M, C, H):
    g = torch.Generator().manual_seed(M + C)
    # weights as nn.Linear's (out, in) tensors passed as `.t()` views, as Mlp does
    w1 = _rand(g, H, C, scale=C ** -0.5).to(dev)
    w2 = _rand(g, C, H, scale=H ** -0.5).to(dev)
    inputs = [_rand(g, M, C).to(dev), w1, _rand(g, H, scale=0.1).to(dev), w2,
              _rand(g, C, scale=0.1).to(dev)]
    dy = _rand(g, M, C).to(dev)
    _check_backward(lambda x, a, b1, c, b2: mlp.fused_mlp(x, a.t(), b1, c.t(), b2),
                    lambda x, a, b1, c, b2: mlp.fused_mlp_plain(x, a.t(), b1, c.t(), b2),
                    inputs, dy, (mlp, "bwd_launches"))


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
    before = scan_cuda.launches
    with torch.inference_mode():
        got = model(tokens.to(dev))[0]
        want = cpu(tokens)[0]
    assert scan_cuda.launches == before + 2
    torch.testing.assert_close(got.cpu(), want, **TOL)
    prompt = tokens[:, :5].to(dev)
    before = scan_cuda.launches
    for kw in (dict(temperature=0.0), dict(temperature=0.7, top_p=0.9, repetition_penalty=1.2),
               dict(temperature=1.0, top_k=8, min_p=0.1)):
        runs = [generate(model, prompt, 12, compiled=compiled,
                         generator=torch.Generator(device=dev).manual_seed(4), **kw)
                for compiled in (False, True, True)]
        assert runs[0].shape == (2, 17)
        assert torch.equal(runs[0], runs[1]) and torch.equal(runs[1], runs[2]), kw
    assert scan_cuda.launches == before


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
    befores = [getattr(m, n) for m, n in counters]
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
    for (m, n), b in zip(counters, befores):
        assert getattr(m, n) >= b + 2, n


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

    _check_bf16(kernel, plain, args, None, [(scan_cuda, "bf16_launches")])
    if chunk is None:
        _check_bf16(kernel, plain, args, dy, [(scan_cuda, "bf16_bwd_launches")])
    else:
        with torch.no_grad():
            _, hsave = scan_cuda.selective_scan_fwd(*args[:7], True, args[7], save_states=True)
        got = scan_cuda.selective_scan_bwd(*args, hsave, dy, True, chunk=chunk)
        whole = scan_cuda.selective_scan_bwd(*args, hsave, dy, True, chunk=16 * (L // 16 + 1))
        for a, b in zip(got, whole):
            if a is not None:
                assert a.dtype == b.dtype
                _bf16_close(a, b)


@pytest.mark.parametrize("gate_act", ["none", "silu", "silu_sum", "raw"])
@pytest.mark.parametrize("rows,C", [(37, 96), (4096, 192), (64, 1536), (37, 100)])
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

    _check_bf16(kernel, plain, inputs, dy, [(ln_triton, "bf16_layer_norm_launches"),
                                            (layer_norm, "bf16_layer_norm_bwd_launches")])


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

    before = layer_norm.bf16_ln_mean_launches
    y, got = _grads(kernel, [x, s, b], dm)
    yw, want = _grads(plain, [x, s, b], dm)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and layer_norm.bf16_ln_mean_launches == before + 1
    torch.testing.assert_close(y, yw, rtol=1e-4, atol=1e-4)   # fp32 out, no bf16 rounding
    for t, gk, w in zip((x, s, b), got, want):
        assert gk.dtype == t.dtype
        _bf16_close(gk, w)


@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (12, 64, 64, 192), (6, 8, 8, 1536)])
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
                inputs, dy, [(dwconv, "bf16_launches"), (dwconv, "bf16_bwd_launches")])


@pytest.mark.parametrize("M,C,H", [(1, 16, 64), (37, 96, 384), (512, 768, 3072), (3072, 96, 384),
                                   (768, 192, 768)])
def test_mlp_kernels_bf16(dev, M, C, H):
    """Every tensor bf16: the forward (fused and two-pass), and the backward
    with its bf16 roundings of the hidden and of dL/dh, against the plain
    version that rounds at the same places."""
    g = torch.Generator().manual_seed(M + C + H)
    x = _rand(g, M, C).to(dev, BF16)
    w1, b1 = _rand(g, H, C, scale=C ** -0.5).to(dev, BF16), _rand(g, H, scale=0.1).to(dev, BF16)
    w2, b2 = _rand(g, C, H, scale=H ** -0.5).to(dev, BF16), _rand(g, C, scale=0.1).to(dev, BF16)
    want = mlp.fused_mlp_plain(x, w1.t(), b1, w2.t(), b2)
    for fused in (True, False):
        with torch.no_grad():
            got = mlp.mlp_fwd(x, w1, b1, w2, b2, fused=fused)
        _bf16_close(got, want)
    dy = _rand(g, M, C).to(dev, BF16)
    _check_bf16(lambda x, a, b1, c, b2: mlp.fused_mlp(x, a.t(), b1, c.t(), b2),
                lambda x, a, b1, c, b2: mlp.fused_mlp_plain(x, a.t(), b1, c.t(), b2),
                [x, w1, b1, w2, b2], dy, [(mlp, "bf16_launches"), (mlp, "bf16_bwd_launches")])


def test_mlp_kernel_bf16_width_limit(dev):
    """bf16 widths must be whole 16-byte copies: multiples of 8."""
    x = torch.zeros(4, 20, device=dev, dtype=BF16)
    w1, b1 = torch.zeros(20, 72, device=dev, dtype=BF16), torch.zeros(72, device=dev, dtype=BF16)
    w2, b2 = torch.zeros(72, 20, device=dev, dtype=BF16), torch.zeros(20, device=dev, dtype=BF16)
    with pytest.raises(ValueError, match="multiples of 8"):
        mlp.fused_mlp(x, w1, b1, w2, b2)


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
