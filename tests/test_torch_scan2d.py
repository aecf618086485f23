"""The full-resolution cross scan of the port (plain versions, CPU) against the
JAX package: `cross_scan`/`cross_merge`, and `SS2D(scan_variant="fullres")`
through the bridged weights, forward and every parameter's gradient.

The layouts are reshapes, transposes and flips, so they must agree bit for
bit. SS2D sums in another order on each side (float32): its output is held
to 1e-5 absolute and relative, as the other modules in
`tests/test_torch_model.py`, and each gradient to 1e-5 relative plus 1e-5
of its largest entry (sums over every position of both signs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch.checkpoints import from_jax
from fusionmamba_torch.nn import ss2d as ss2d_mod
from fusionmamba_torch.nn import SS2D, SS2DCross
from fusionmamba_torch.ops import cross_merge, cross_scan
from fusionmamba_tpu.nn import ss2d as jss2d
from fusionmamba_tpu.ops import scan2d as jscan2d

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = GRAD_SCALED_ATOL = 1e-5


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 8, 8, 4), (2, 6, 4, 16), (1, 1, 9, 2)])
def test_cross_scan_and_merge_are_bit_exact(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    B, H, W, C = shape
    ys = rng.standard_normal((B, 4, H * W, C)).astype(np.float32)
    np.testing.assert_array_equal(cross_scan(torch.from_numpy(x)).numpy(),
                                  np.asarray(jscan2d.cross_scan(jnp.asarray(x))))
    np.testing.assert_array_equal(cross_merge(torch.from_numpy(ys), H, W).numpy(),
                                  np.asarray(jscan2d.cross_merge(jnp.asarray(ys), H, W)))


def test_cross_merge_is_the_adjoint_of_cross_scan():
    """<cross_scan(x), y> = <x, cross_merge(y)>: merge sums the four
    orderings back onto the positions scan read them from, so autograd of
    either is the other."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, 3))).double()
    y = torch.from_numpy(rng.standard_normal((2, 4, 30, 3))).double()
    assert torch.allclose((cross_scan(x) * y).sum(), (x * cross_merge(y, 5, 6)).sum(),
                          rtol=1e-12, atol=0)


def _jax_params(module, x_shapes, seed):
    """The JAX module's params, perturbed with seeded noise so that every
    transposed or reshaped tensor shows in the output."""
    xs = [jnp.zeros(s, jnp.float32) for s in x_shapes]
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *xs)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(np.shape(p))).astype(np.float32),
        params)


def _state_dict(tree, key_map):
    """A module's flax tree in the port's layout, by the bridge's own map."""
    sd = from_jax._from_map({"m": tree}, key_map("m", ("m",)))
    return {k[2:]: v for k, v in sd.items()}


_CASES = {
    "ss2d": (lambda: jss2d.SS2D(d_model=16, d_state=4, scan_impl="assoc", scan_variant="fullres"),
             lambda: SS2D(16, 4, scan_variant="fullres"), from_jax._ss2d, 1),
    "ss2d_cross": (lambda: jss2d.SS2DCross(d_model=16, d_state=4, scan_impl="assoc",
                                           scan_variant="fullres"),
                   lambda: SS2DCross(16, 4, scan_variant="fullres"), from_jax._ss2d_cross, 2),
}


@pytest.mark.parametrize("hw", [(8, 8), (5, 6)])
@pytest.mark.parametrize("name", list(_CASES))
def test_fullres_ss2d_forward_and_grads_match_jax(name, hw):
    """The forward at L = H*W and the gradient of every parameter and input
    for a seeded cotangent."""
    make_jax, make_port, key_map, n_in = _CASES[name]
    shape = (2, *hw, 16)
    jmod = make_jax()
    params = _jax_params(jmod, [shape] * n_in, seed=hw[0])
    port = make_port()
    port.load_state_dict(_state_dict(params, key_map))
    rng = np.random.default_rng(hw[1])
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n_in)]
    cot = rng.standard_normal(shape).astype(np.float32)

    @jax.jit
    def run(p, c, *v):
        out, vjp = jax.vjp(lambda p, *v: jmod.apply({"params": p}, *v), p, *v)
        return out, vjp(c)

    want, want_grads = run(params, jnp.asarray(cot), *[jnp.asarray(x) for x in xs])
    txs = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    got = port(*txs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MODULE_TOL)
    got.backward(torch.from_numpy(cot))

    jax_param_grads = _state_dict(jax.tree_util.tree_map(np.asarray, want_grads[0]), key_map)
    pairs = [(f"param {k}", p.grad, jax_param_grads[k]) for k, p in port.named_parameters()
             if k in jax_param_grads]
    pairs += [(f"input {i}", t.grad, torch.from_numpy(np.asarray(g)))
              for i, (t, g) in enumerate(zip(txs, want_grads[1:]))]
    # every parameter the module reads has a gradient on both sides; in_proj2's
    # second half is never read (the reference's z2), so its gradient is zero
    assert len(pairs) == len(list(port.parameters())) + n_in
    for what, g, w in pairs:
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALED_ATOL * float(np.abs(w).max()), err_msg=what)


def test_fullres_runs_the_scan_at_full_length(monkeypatch):
    """The fullres variant scans H*W positions a direction (efficient: a
    quarter), and gives another output than the efficient one from the same
    parameters."""
    seen = []
    real = ss2d_mod.selective_scan

    def spy(u, *args, **kwargs):
        seen.append(tuple(u.shape))
        return real(u, *args, **kwargs)

    monkeypatch.setattr(ss2d_mod, "selective_scan", spy)
    full, eff = SS2D(16, 4, scan_variant="fullres"), SS2D(16, 4)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in full.parameters():
            p.normal_(std=0.2, generator=gen)
    eff.load_state_dict(full.state_dict())
    x = torch.randn(2, 8, 6, 16, generator=gen)
    with torch.no_grad():
        a, b = full(x), eff(x)
    assert seen == [(2, 4, 48, 32), (2, 4, 12, 32)]
    assert float((a - b).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="scan_variant"):
        SS2D(16, 4, scan_variant="other")
