"""The port's ops (plain PyTorch versions, CPU) against the JAX package's.

Inputs come from seeded numpy generators and cross between the frameworks as
numpy arrays. Where the JAX op is a Pallas kernel it runs in interpret mode,
as the JAX package's own tests run it. Tolerances, unless a test says
otherwise: both sides compute in float32 with sums taken in another order, so
they agree to float32 rounding of the magnitudes summed; 1e-5 (absolute and
relative) bounds that for these O(1) inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch.ops import dwconv, layer_norm, mlp, scan2d
from fusionmamba_torch.ops.selective_scan import selective_scan, selective_scan_plain
from fusionmamba_tpu.ops import dwconv_pallas, ln_pallas, mlp_pallas
from fusionmamba_tpu.ops import scan2d as jscan2d
from fusionmamba_tpu.ops.scan_pallas import selective_scan_pallas
from fusionmamba_tpu.ops.selective_scan import selective_scan as jax_selective_scan

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def _scan_inputs(seed, batch, K, L, D, N, R, dt_shift):
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.standard_normal((batch, K, L, D)).astype(f)
    dt = (0.5 * rng.standard_normal((batch, K, L, R))).astype(f)
    W = rng.uniform(-R ** -0.5, R ** -0.5, (K, D, R)).astype(f)
    A = -np.exp(rng.uniform(0.0, 1.5, (K, D, N))).astype(f)
    Bm = rng.standard_normal((batch, K, L, N)).astype(f)
    Cm = rng.standard_normal((batch, K, L, N)).astype(f)
    Dp = rng.standard_normal((K, D)).astype(f)
    bias = (rng.standard_normal((K, D)) + dt_shift).astype(f)
    return u, dt, A, Bm, Cm, Dp, bias, W


def _port_scan(u, dt, A, Bm, Cm, Dp, bias, W):
    t = [torch.from_numpy(a) for a in (u, dt, A, Bm, Cm, Dp, bias, W)]
    return selective_scan(*t[:7], delta_softplus=True, dt_lowrank_weight=t[7])


# dt_shift 8: softplus(dt) ~ 8 per step, so |A| * sum(dt) passes the TPU
# kernel's rescale clip of 72 within a few steps; L=300 spans two of the TPU
# kernel's 256-step chunks
@pytest.mark.parametrize("L,dt_shift", [(1, 0.0), (40, 0.0), (300, 8.0), (64, 8.0)])
def test_scan_plain_matches_jax_ref(L, dt_shift):
    args = _scan_inputs(L, 2, 4, L, 8, 4, 2, dt_shift)
    want = jax_selective_scan(*map(jnp.asarray, args[:7]), delta_softplus=True,
                              impl="ref", dt_lowrank_weight=jnp.asarray(args[7]))
    _close(_port_scan(*args), want)


@pytest.mark.parametrize("L,dt_shift", [(1, 0.0), (64, 8.0)])
def test_scan_plain_matches_pallas_doubling(L, dt_shift):
    args = _scan_inputs(100 + L, 1, 2, L, 16, 4, 2, dt_shift)
    want = selective_scan_pallas(*map(jnp.asarray, args[:7]), delta_softplus=True,
                                 interpret=True, algo="doubling",
                                 dt_lowrank_weight=jnp.asarray(args[7]))
    # the doubling kernel composes the decays in a tree, not step by step
    _close(_port_scan(*args), want, rtol=2e-5, atol=2e-5)


def test_scan_full_dt_matches_lowrank():
    """Without dt_lowrank_weight the op takes the expanded dt."""
    u, dt, A, Bm, Cm, Dp, bias, W = map(torch.from_numpy,
                                        _scan_inputs(7, 2, 4, 9, 8, 4, 2, 0.0))
    full = torch.einsum("bklr,kdr->bkld", dt, W)
    torch.testing.assert_close(
        selective_scan_plain(u, full, A, Bm, Cm, Dp, bias, True),
        selective_scan_plain(u, dt, A, Bm, Cm, Dp, bias, True, dt_lowrank_weight=W))


@pytest.mark.parametrize("H,W", [(8, 6), (7, 5), (1, 1)])
def test_efficient_scan_merge_bit_exact(H, W):
    x = np.random.default_rng(H * W).standard_normal((2, H, W, 3)).astype(np.float32)
    xs = scan2d.efficient_scan(torch.from_numpy(x))
    jxs = jscan2d.efficient_scan(jnp.asarray(x))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    ys = np.random.default_rng(1).standard_normal(xs.shape).astype(np.float32)
    np.testing.assert_array_equal(
        scan2d.efficient_merge(torch.from_numpy(ys), H, W).numpy(),
        np.asarray(jscan2d.efficient_merge(jnp.asarray(ys), H, W)))
    np.testing.assert_array_equal(scan2d.efficient_merge(xs, H, W).numpy(), x)


@pytest.mark.parametrize("gate_act", [None, "none", "silu", "silu_sum"])
def test_layer_norm_matches_pallas(gate_act):
    rng = np.random.default_rng(0)
    x = (2.0 * rng.standard_normal((2, 4, 3, 12)) + 0.5).astype(np.float32)
    s, b = (rng.standard_normal(12).astype(np.float32) for _ in range(2))
    gate = None if gate_act is None else rng.standard_normal(x.shape).astype(np.float32)
    act = gate_act or "none"
    want = ln_pallas.layer_norm_fused(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
        None if gate is None else jnp.asarray(gate), eps=1e-6, impl="pallas",
        interpret=True, gate_act=act)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    _close(layer_norm.layer_norm_fused(t(x), t(s), t(b), t(gate), 1e-6, act), want)


def test_ln_spatial_mean_matches_pallas():
    rng = np.random.default_rng(1)
    x = (2.0 * rng.standard_normal((2, 4, 4, 12)) + 0.5).astype(np.float32)
    s, b = (rng.standard_normal(12).astype(np.float32) for _ in range(2))
    want = ln_pallas.ln_spatial_mean(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                     eps=1e-5, impl="pallas", interpret=True)
    got = layer_norm.ln_spatial_mean(*map(torch.from_numpy, (x, s, b)), 1e-5)
    assert got.shape == (2, 12) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
def test_dwconv_matches_pallas(act, has_bias):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, 8))).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32) if has_bias else None
    want = dwconv_pallas.depthwise_conv3x3(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        impl="pallas", interpret=True, act=act)
    got = dwconv.depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                                   None if b is None else torch.from_numpy(b), act)
    _close(got, want)


def test_mlp_matches_pallas_and_exact_gelu():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 8)).astype(np.float32)
    w1 = (rng.standard_normal((8, 32)) / np.sqrt(8)).astype(np.float32)
    w2 = (rng.standard_normal((32, 8)) / np.sqrt(32)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(32)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(8)).astype(np.float32)
    jx = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    got = mlp.fused_mlp(*[torch.from_numpy(a) for a in (x, w1, b1, w2, b2)])
    # the Pallas kernel's polynomial erf is within 1.5e-7 of erf
    _close(got, mlp_pallas.fused_mlp(*jx, interpret=True))
    exact = jax.nn.gelu(jx[0] @ jx[1] + jx[2], approximate=False) @ jx[3] + jx[4]
    _close(got, exact)


@pytest.mark.parametrize("op", ["scan", "ln", "ln_mean", "dwconv", "mlp"])
def test_ops_take_no_other_device(op):
    """The plain version serves only CPU tensors; other devices raise."""
    m = torch.empty(2, 4, 4, 8, device="meta")
    v = torch.empty(8, device="meta")
    calls = {
        "scan": lambda: selective_scan(
            torch.empty(1, 4, 3, 8, device="meta"), torch.empty(1, 4, 3, 8, device="meta"),
            torch.empty(4, 8, 2, device="meta"), torch.empty(1, 4, 3, 2, device="meta"),
            torch.empty(1, 4, 3, 2, device="meta")),
        "ln": lambda: layer_norm.layer_norm_fused(m, v, v),
        "ln_mean": lambda: layer_norm.ln_spatial_mean(m, v, v),
        "dwconv": lambda: dwconv.depthwise_conv3x3(m, torch.empty(3, 3, 8, device="meta")),
        "mlp": lambda: mlp.fused_mlp(m, torch.empty(8, 16, device="meta"),
                                     torch.empty(16, device="meta"),
                                     torch.empty(16, 8, device="meta"), v),
    }
    with pytest.raises(ValueError, match="no implementation"):
        calls[op]()


# ---------------------------------------------------------------------------
# gradients: the plain versions under autograd against jax.grad of the JAX ops
#
# Every input's gradient is compared for one seeded non-uniform cotangent.
# Gradients that sum over rows or steps (weights, scales, the scan's A, B,
# C) are sums of many terms of both signs in another order, so each is held
# to 1e-5 of its own largest entry plus 1e-5 relative; the doubling kernel,
# which composes decays in a tree, to 2e-5.
# ---------------------------------------------------------------------------

def _torch_grads(fn, arrays, cot):
    ts = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in arrays]
    fn(*ts).backward(torch.from_numpy(cot))
    return [t.grad for t in ts if t is not None]


def _jax_grads(fn, arrays, cot):
    live = [i for i, a in enumerate(arrays) if a is not None]

    def loss(*xs):
        full = [None] * len(arrays)
        for i, x in zip(live, xs):
            full[i] = x
        return jnp.sum(fn(*full) * jnp.asarray(cot))

    return jax.grad(loss, argnums=tuple(range(len(live))))(
        *[jnp.asarray(arrays[i]) for i in live])


def _grads_close(got, want, tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol * float(np.abs(w).max()))


def _cotangent(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_scan_fn(u, dt, A, Bm, Cm, Dp, bias, W):
    return selective_scan(u, dt, A, Bm, Cm, Dp, bias, delta_softplus=True, dt_lowrank_weight=W)


@pytest.mark.parametrize("L,dt_shift", [(1, 0.0), (40, 0.0), (300, 8.0)])
def test_scan_grads_match_jax_ref(L, dt_shift):
    args = _scan_inputs(200 + L, 2, 4, L, 8, 4, 2, dt_shift)
    cot = _cotangent(L, args[0].shape)

    def jfn(u, dt, A, Bm, Cm, Dp, bias, W):
        return jax_selective_scan(u, dt, A, Bm, Cm, Dp, bias, delta_softplus=True, impl="ref",
                                  dt_lowrank_weight=W)

    _grads_close(_torch_grads(_port_scan_fn, args, cot), _jax_grads(jfn, args, cot))


@pytest.mark.parametrize("L,dt_shift", [(1, 0.0), (64, 8.0)])
def test_scan_grads_match_pallas_doubling(L, dt_shift):
    args = _scan_inputs(300 + L, 1, 2, L, 16, 4, 2, dt_shift)
    cot = _cotangent(L + 1, args[0].shape)

    def jfn(u, dt, A, Bm, Cm, Dp, bias, W):
        return selective_scan_pallas(u, dt, A, Bm, Cm, Dp, bias, delta_softplus=True,
                                     interpret=True, algo="doubling", dt_lowrank_weight=W)

    _grads_close(_torch_grads(_port_scan_fn, args, cot), _jax_grads(jfn, args, cot), tol=2e-5)


@pytest.mark.parametrize("gate_act", [None, "none", "silu", "silu_sum"])
def test_layer_norm_grads_match_pallas(gate_act):
    rng = np.random.default_rng(10)
    x = (2.0 * rng.standard_normal((2, 4, 3, 12)) + 0.5).astype(np.float32)
    s, b = (rng.standard_normal(12).astype(np.float32) for _ in range(2))
    gate = None if gate_act is None else rng.standard_normal(x.shape).astype(np.float32)
    act = gate_act or "none"
    cot = _cotangent(11, x.shape)
    got = _torch_grads(lambda *a: layer_norm.layer_norm_fused(*a, 1e-6, act), (x, s, b, gate), cot)
    want = _jax_grads(lambda *a: ln_pallas.layer_norm_fused(
        *a, eps=1e-6, impl="pallas", interpret=True, gate_act=act), (x, s, b, gate), cot)
    _grads_close(got, want)


def test_ln_spatial_mean_grads_match_pallas():
    rng = np.random.default_rng(12)
    x = (2.0 * rng.standard_normal((2, 4, 4, 12)) + 0.5).astype(np.float32)
    s, b = (rng.standard_normal(12).astype(np.float32) for _ in range(2))
    cot = _cotangent(13, (2, 12))
    got = _torch_grads(lambda *a: layer_norm.ln_spatial_mean(*a, 1e-5), (x, s, b), cot)
    want = _jax_grads(lambda *a: ln_pallas.ln_spatial_mean(
        *a, eps=1e-5, impl="pallas", interpret=True), (x, s, b), cot)
    _grads_close(got, want)


@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
def test_dwconv_grads_match_pallas(act, has_bias):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, 8))).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32) if has_bias else None
    cot = _cotangent(15, x.shape)
    got = _torch_grads(lambda *a: dwconv.depthwise_conv3x3(*a, act), (x, w, b), cot)
    want = _jax_grads(lambda *a: dwconv_pallas.depthwise_conv3x3(
        *a, impl="pallas", interpret=True, act=act), (x, w, b), cot)
    _grads_close(got, want)


def test_mlp_grads_match_pallas():
    """The Pallas kernel's polynomial erf and its derivative are within
    ~1.5e-7 of the exact GELU's, below the tolerance."""
    rng = np.random.default_rng(16)
    arrays = (rng.standard_normal((4, 5, 8)).astype(np.float32),
              (rng.standard_normal((8, 32)) / np.sqrt(8)).astype(np.float32),
              (0.1 * rng.standard_normal(32)).astype(np.float32),
              (rng.standard_normal((32, 8)) / np.sqrt(32)).astype(np.float32),
              (0.1 * rng.standard_normal(8)).astype(np.float32))
    cot = _cotangent(17, (4, 5, 8))
    got = _torch_grads(mlp.fused_mlp, arrays, cot)
    want = _jax_grads(lambda *a: mlp_pallas.fused_mlp(*a, interpret=True), arrays, cot)
    _grads_close(got, want)
