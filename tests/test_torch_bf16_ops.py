"""The port's ops in bf16 (the plain versions the CPU runs, which follow the
kernels' bf16-I/O contract) against the JAX package's: the Pallas kernels
in interpret mode, as the JAX package's own tests run them, and the scan
against its `assoc` path (never the TPU's cumsum rounding). The forward and
every gradient, each in the dtype the kernels' contract gives it: the I/O
tensors bf16, what the kernels read as fp32 (the scan's A, D and dt bias,
the LN-mean's output) fp32, and a bf16 parameter's gradient bf16, summed in
fp32 and rounded once.

Inputs come from seeded numpy generators, rounded to bf16, and cross as
numpy arrays (a bf16 value widened to fp32 is exact). Tolerances: the JAX
package's own bf16 tests (`tests/test_ln.py`, `test_mlp.py`,
`test_scan.py::test_bf16_io`): 3e-2 relative and 3e-2 or 5e-2 absolute,
the reference's bf16 kernel gate; a gradient's absolute term is scaled by
its largest entry, since a sum over many rows carries its terms' rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch.ops import dwconv, layer_norm, mlp
from fusionmamba_torch.ops.selective_scan import selective_scan
from fusionmamba_tpu.ops import dwconv_pallas, ln_pallas, mlp_pallas
from fusionmamba_tpu.ops.selective_scan import selective_scan as jax_selective_scan

BF = torch.bfloat16
JBF = jnp.bfloat16


def _bf(a):
    """numpy fp32 -> its bf16 rounding, as a numpy fp32 array (exact in both
    frameworks)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF).float().numpy()


def _close(got, want, rtol=3e-2, atol=5e-2):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the ops in bf16: the port's plain versions against the JAX functions
# ---------------------------------------------------------------------------

def _grads_port(fn, arrays, dtypes, cot):
    ts = [None if a is None else torch.from_numpy(a).to(d).requires_grad_(True)
          for a, d in zip(arrays, dtypes)]
    out = fn(*ts)
    out.float().backward(torch.from_numpy(cot))
    return out, [None if t is None else t.grad for t in ts]


def _grads_jax(fn, arrays, dtypes, cot):
    live = [i for i, a in enumerate(arrays) if a is not None]
    xs = [None if a is None else jnp.asarray(a, d) for a, d in zip(arrays, dtypes)]

    def f(*vals):
        full = list(xs)
        for i, v in zip(live, vals):
            full[i] = v
        out = fn(*full)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), gs = jax.value_and_grad(f, argnums=tuple(range(len(live))), has_aux=True)(
        *[xs[i] for i in live])
    res = [None] * len(arrays)
    for i, g in zip(live, gs):
        res[i] = g
    return out, res


def _check_op(port_fn, jax_fn, arrays, port_dtypes, jax_dtypes, out_dtype, tol):
    """Forward and every gradient of the port (plain version) against JAX:
    each output and gradient in its contract's dtype, then within `tol`
    (each gradient's atol scaled by its largest entry: a sum over many rows
    carries its terms' rounding)."""
    cot = np.random.default_rng(99).standard_normal(
        np.shape(jax_fn(*[None if a is None else jnp.asarray(a, d)
                          for a, d in zip(arrays, jax_dtypes)]))).astype(np.float32)
    y, g = _grads_port(port_fn, arrays, port_dtypes, cot)
    yj, gj = _grads_jax(jax_fn, arrays, jax_dtypes, cot)
    assert y.dtype == out_dtype and yj.dtype == {BF: JBF, torch.float32: jnp.float32}[out_dtype]
    _close(y.detach().float().numpy(), np.asarray(yj, np.float32), **tol)
    for a, gp, gjx, d in zip(arrays, g, gj, port_dtypes):
        if a is None:
            continue
        assert gp.dtype == d
        want = np.asarray(gjx, np.float32)
        _close(gp.float().numpy(), want, rtol=tol["rtol"],
               atol=tol["atol"] * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("gate_act", ["none", "silu", "silu_sum", "raw"])
def test_layer_norm_bf16_matches_pallas(gate_act):
    """x, the gate, y and their gradients bf16; scale and bias bf16 (as the
    step's cast makes them), read as fp32, their gradients bf16."""
    rng = np.random.default_rng(1)
    x = _bf(rng.standard_normal((4, 16, 96)) * 2 + 0.5)
    s, b = _bf(1 + 0.2 * rng.standard_normal(96)), _bf(0.2 * rng.standard_normal(96))
    gate = None if gate_act == "none" else _bf(rng.standard_normal((4, 16, 96)))
    act = "none" if gate_act == "raw" else gate_act
    _check_op(lambda *a: layer_norm.layer_norm_fused(*a, eps=1e-6, gate_act=act),
              lambda *a: ln_pallas.layer_norm_fused(*a, eps=1e-6, impl="pallas",
                                                    interpret=True, gate_act=act),
              [x, s, b, gate], [BF] * 4, [JBF] * 4, BF, dict(rtol=3e-2, atol=3e-2))


def test_ln_spatial_mean_bf16_matches_pallas():
    """x bf16; the (B, C) mean fp32 (LN(x) never rounded); dx bf16, the
    parameters' gradients in their dtype."""
    rng = np.random.default_rng(2)
    x = _bf(rng.standard_normal((3, 8, 8, 96)) * 2 + 0.5)
    s, b = _bf(1 + 0.2 * rng.standard_normal(96)), _bf(0.2 * rng.standard_normal(96))
    _check_op(lambda *a: layer_norm.ln_spatial_mean(*a, eps=1e-5),
              lambda *a: ln_pallas.ln_spatial_mean(*a, eps=1e-5, impl="pallas", interpret=True),
              [x, s, b], [BF] * 3, [JBF] * 3, torch.float32, dict(rtol=3e-2, atol=3e-2))


@pytest.mark.parametrize("act", ["none", "silu"])
def test_dwconv_bf16_matches_pallas(act):
    """x, out, dx bf16; w and bias bf16 parameters read as fp32, their
    gradients summed in fp32 and returned in bf16."""
    rng = np.random.default_rng(3)
    x = _bf(rng.standard_normal((2, 9, 11, 32)))
    w, b = _bf(0.3 * rng.standard_normal((3, 3, 32))), _bf(0.1 * rng.standard_normal(32))
    _check_op(lambda *a: dwconv.depthwise_conv3x3(*a, act=act),
              lambda *a: dwconv_pallas.depthwise_conv3x3(*a, impl="pallas", interpret=True,
                                                         act=act),
              [x, w, b], [BF] * 3, [JBF] * 3, BF, dict(rtol=3e-2, atol=3e-2))


def test_mlp_bf16_matches_pallas():
    """Everything bf16, the hidden rounded to bf16 before fc2 and dL/dh
    before its products, fp32 sums: the port's plain version against the
    Pallas kernel, which rounds at the same places."""
    rng = np.random.default_rng(4)
    x = _bf(rng.standard_normal((40, 32)))
    w1, b1 = _bf(rng.standard_normal((32, 128)) / 32 ** 0.5), _bf(0.1 * rng.standard_normal(128))
    w2, b2 = _bf(rng.standard_normal((128, 32)) / 128 ** 0.5), _bf(0.1 * rng.standard_normal(32))
    _check_op(mlp.fused_mlp, lambda *a: mlp_pallas.fused_mlp(*a, interpret=True),
              [x, w1, b1, w2, b2], [BF] * 5, [JBF] * 5, BF, dict(rtol=3e-2, atol=3e-2))


@pytest.mark.parametrize("L", [16, 64])
def test_scan_bf16_matches_jax_assoc(L):
    """u, the low-rank dt, its weight, B, C, y and their gradients bf16; A, D
    and the bias fp32 with fp32 gradients. The port expands dt with fp32
    sums (as the Pallas kernel does), JAX's assoc path rounds the expanded
    dt to bf16: the reference's bf16 gate (rtol 3e-2, atol 5e-2) holds
    both."""
    rng = np.random.default_rng(L)
    K, D, N, R = 4, 16, 8, 3
    u = _bf(rng.standard_normal((2, K, L, D)))
    dt = _bf(0.5 * rng.standard_normal((2, K, L, R)))
    W = _bf(rng.uniform(-R ** -0.5, R ** -0.5, (K, D, R)))
    A = (-np.exp(rng.uniform(0.0, 1.5, (K, D, N)))).astype(np.float32)
    Bm, Cm = _bf(rng.standard_normal((2, K, L, N))), _bf(rng.standard_normal((2, K, L, N)))
    Dp = rng.standard_normal((K, D)).astype(np.float32)
    bias = (rng.standard_normal((K, D)) - 1.0).astype(np.float32)
    f32 = torch.float32
    _check_op(lambda u, dt, A, Bm, Cm, Dp, bias, W: selective_scan(
                  u, dt, A, Bm, Cm, Dp, bias, delta_softplus=True, dt_lowrank_weight=W),
              lambda u, dt, A, Bm, Cm, Dp, bias, W: jax_selective_scan(
                  u, dt, A, Bm, Cm, Dp, bias, delta_softplus=True, impl="assoc",
                  dt_lowrank_weight=W),
              [u, dt, A, Bm, Cm, Dp, bias, W], [BF, BF, f32, BF, BF, f32, f32, BF],
              [JBF, JBF, jnp.float32, JBF, JBF, jnp.float32, jnp.float32, JBF], BF,
              dict(rtol=3e-2, atol=5e-2))
