"""Rematerialisation (`remat`: each VSSBlock recomputed in the backward;
`remat_light`: only its ECA, BiAttn and Mlp) on the CPU: the same loss and
gradients as without it, the same gradients as the JAX model with the same
flag, and the forward calls the backward repeats equal to those
`chip_smoke.train_calls` derives, which the card's launch counters are held
to.

Tolerances: with and without remat the port runs the same fp32 operations
in the same order, so they agree to 1e-6 (bit for bit in practice); against
JAX the model tolerance of tests/test_torch_model.py (5e-5) on the output,
and 1e-4 of each gradient's largest entry (sums over the batch and the
positions in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_dist_workers as workers
from fusionmamba_torch import config as tcfg
from fusionmamba_torch import train as ttrain
from fusionmamba_torch.checkpoints import state_dict_from_jax
from fusionmamba_torch.models import VSSMFusion
from fusionmamba_torch.nn import init_weights
from fusionmamba_tpu import config as jcfg
from fusionmamba_tpu.models import VSSMFusion as JaxVSSMFusion

FLAGS = {"none": {}, "remat": {"remat": True}, "remat_light": {"remat_light": True}}


def _images(seed, batch=2, size=32):
    rng = np.random.default_rng(seed)
    return (0.05 + 0.3 * rng.uniform(0, 1, (batch, size, size, 1))).astype(np.float32)


def _grads(flag, dp_rate=0.3):
    """Loss and gradients of one training forward with one injected DropPath
    table (drop_path_rate `dp_rate`)."""
    net = init_weights(VSSMFusion(tcfg.test_config(drop_path_rate=dp_rate, **FLAGS[flag])),
                       seed=0).train()
    x1, x2 = torch.from_numpy(_images(1)), torch.from_numpy(_images(2))
    table = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, net.dp_table_shape(2)).astype(np.float32))
    out = net(x1, x2, dp_uni=table)
    loss = (out * torch.from_numpy(_images(4))).sum()
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in net.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("flag", ["remat", "remat_light"])
def test_remat_keeps_loss_and_gradients(flag):
    loss0, g0 = _grads("none")
    loss, g = _grads(flag)
    assert loss == pytest.approx(loss0, rel=1e-6)
    assert set(g) == set(g0)
    for k in g0:
        torch.testing.assert_close(g[k], g0[k], rtol=1e-6, atol=1e-6 * float(g0[k].abs().max()))


@pytest.mark.parametrize("flag", ["remat", "remat_light"])
def test_remat_gradients_match_jax_with_the_same_flag(flag):
    cfg = jcfg.test_config(scan_impl="assoc", **FLAGS[flag])
    model = JaxVSSMFusion(cfg)
    x1, x2, cot = _images(1), _images(2), _images(4)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2))["params"]

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(x1), jnp.asarray(x2), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out * cot)

    want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want), cfg.depths,
                               cfg.depths_decoder)
    net = VSSMFusion(tcfg.test_config(**FLAGS[flag])).train()
    net.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                            cfg.depths, cfg.depths_decoder))
    out = net(torch.from_numpy(x1), torch.from_numpy(x2))
    got_loss = (out * torch.from_numpy(cot)).sum()
    got_loss.backward()
    assert float(got_loss) == pytest.approx(float(want_loss), rel=5e-5)
    for k, p in net.named_parameters():
        if p.grad is None:          # the finest VSSBlockCross: no gradient in either
            assert not np.any(want[k].numpy())
            continue
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("flag", list(FLAGS))
def test_remat_forward_calls_match_the_derived_launch_counts(flag):
    cfg = tcfg.test_config(drop_path_rate=0.3, **FLAGS[flag])
    net = init_weights(VSSMFusion(cfg), seed=0)
    opt = ttrain.make_fusion_optimizer(net.parameters())
    with workers.count_plain_calls() as counts:
        ttrain.fusion_train_step(net, opt, torch.from_numpy(_images(1)),
                                 torch.from_numpy(_images(2)), torch.Generator().manual_seed(0))
    want = chip_smoke.train_calls(cfg, 2, 32)
    for k in chip_smoke.OPS:
        assert counts[k] == want[k], (k, counts[k], want[k])
