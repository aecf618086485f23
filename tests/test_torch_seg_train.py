"""The port's segmentation training step (plain versions, CPU) against the
JAX package's `make_seg_train_step`: a 3-step trajectory.

The JAX model is `VSSMFusionSeg(test_config(scan_impl="assoc",
num_seg_classes=5))`, its params perturbed with seeded noise; batches come
from seeded numpy generators and cross as numpy arrays. Most of this file's
time is XLA compiling the JAX training step (about 25 s on one core).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch import config as tcfg
from fusionmamba_torch import train as ttrain
from fusionmamba_torch.checkpoints import seg_state_dict_from_jax
from fusionmamba_torch.models import VSSMFusionSeg
from fusionmamba_tpu import config as jcfg
from fusionmamba_tpu import losses as jlosses
from fusionmamba_tpu import train as jtrain
from fusionmamba_tpu.models import VSSMFusionSeg as JaxVSSMFusionSeg

CLASSES, SIZE = 5, 32


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX model, its perturbed numpy variables)."""
    cfg = jcfg.test_config(scan_impl="assoc", num_seg_classes=CLASSES)
    model = JaxVSSMFusionSeg(cfg)
    x = jnp.zeros((1, SIZE, SIZE, 1), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(np.shape(p))).astype(np.float32),
        variables["params"])
    return cfg, model, {"params": params,
                        "batch_stats": jax.tree_util.tree_map(np.asarray, variables["batch_stats"])}


def _images(seed, batch=2, size=SIZE):
    rng = np.random.default_rng(seed)
    coarse = np.kron(rng.uniform(0, 1, (batch, size // 8, size // 8)), np.ones((1, 8, 8)))
    return (0.1 + 0.7 * coarse + 0.2 * rng.uniform(0, 1, (batch, size, size)))[..., None].astype(
        np.float32)


def test_seg_train_trajectory_matches_jax(pair, monkeypatch):
    """Mode both with the improved PST900 loss and data-driven class weights,
    AdamW with the global-norm clip, 3 steps from the same weights and
    batches, fp32. The head's dropout keep-mask is one seeded numpy mask,
    given to the port as `drop_mask` and to flax by replacing its one
    Bernoulli draw (the step is traced once, so every step reads it). Gate as
    tests/test_optimizer_trajectory.py: each step's loss within 1e-3
    relative."""
    cfg, model, variables = pair
    B = 2
    rng = np.random.default_rng(12)
    mask = rng.uniform(0, 1, (B, SIZE, SIZE, 8)) < 0.7
    bernoulli = jax.random.bernoulli

    def fake(key, p=0.5, shape=None, *args, **kwargs):
        if shape is not None and tuple(shape) == mask.shape:
            return jnp.asarray(mask)
        return bernoulli(key, p, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "bernoulli", fake)
    batches = [(_images(20 + i), _images(30 + i),
                rng.integers(0, CLASSES, (B, SIZE, SIZE)).astype(np.int32)) for i in range(3)]
    weights = np.asarray(jlosses.compute_class_weights(jnp.asarray([9e3, 3e2, 1e3, 2e2, 4e3])))

    state = jtrain.SegTrainState.create(
        apply_fn=model.apply, params=jax.tree_util.tree_map(jnp.array, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.array, variables["batch_stats"]),
        tx=jtrain.make_seg_optimizer(lr=5e-5, flatten=False))
    step = jtrain.make_seg_train_step(model, CLASSES, mode="both", class_weights=jnp.asarray(
        weights), improved=True, compute_dtype=jnp.float32)

    net = VSSMFusionSeg(tcfg.test_config(num_seg_classes=CLASSES))
    net.load_state_dict(seg_state_dict_from_jax(variables, cfg.depths, cfg.depths_decoder))
    opt = ttrain.make_seg_optimizer(net.parameters(), lr=5e-5)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    got, want = [], []
    for vis_y, ir, lbl in batches:
        m = ttrain.seg_train_step(net, opt, *map(torch.from_numpy, (vis_y, ir, lbl)),
                                  num_classes=CLASSES, mode="both",
                                  class_weights=torch.from_numpy(weights), improved=True,
                                  drop_mask=torch.from_numpy(mask))
        got.append({k: float(v) for k, v in m.items()})
        state, jm = step(state, jnp.asarray(vis_y), jnp.asarray(ir), jnp.asarray(lbl),
                         jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in jm.items()})
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["fusion_total", "seg_total", "total"]
        for k in w:
            assert abs(g[k] - w[k]) / abs(w[k]) < 1e-3, (k, got, want)
    # the step moved the weights and the head's running statistics, and
    # decayed the finest cross block (never read, so a zero gradient) as
    # optax's adamw does
    now = net.state_dict()
    moved = [k for k in start if not torch.equal(start[k], now[k])]
    assert "segmentation_head.bn1.running_var" in moved
    key = "fusion_model.Cross_block.0.self_attention_cross.out_proj.weight"
    np.testing.assert_allclose(now[key].numpy(), start[key].numpy() * (1 - 5e-5 * 0.01) ** 3,
                               rtol=1e-6)
    final = seg_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, state.params),
                                     "batch_stats": jax.tree_util.tree_map(
                                         np.asarray, state.batch_stats)},
                                    cfg.depths, cfg.depths_decoder)
    np.testing.assert_allclose(now[key].numpy(), final[key].numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        ttrain.seg_train_step(net, opt, *map(torch.from_numpy, batches[0]),
                              num_classes=CLASSES, mode="other")
