"""The port's segmentation slice (plain versions, CPU) against the JAX
package: the segmentation head, VSSMFusionSeg, the losses, the lr schedule
and class weights, the metrics and the weight bridge; and the fusion output,
unchanged by the split of VSSMFusion's forward into its features and its
head. The training trajectory is in `tests/test_torch_seg_train.py`.

The JAX model is `VSSMFusionSeg(test_config(scan_impl="assoc",
num_seg_classes=5))` (the scan the JAX package's own seg-step test uses);
its params and BatchNorm statistics are perturbed with seeded noise, so that
every transposed tensor shows. Inputs come from seeded numpy generators and
cross as numpy arrays. Tolerances, stated per test: both sides compute in
float32 with sums in another order: 1e-5 for a module, 5e-5 for the whole
network (as `tests/test_torch_model.py`), 1e-12 for the float64 metrics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch import config as tcfg
from fusionmamba_torch import eval as teval
from fusionmamba_torch import losses as tlosses
from fusionmamba_torch import train as ttrain
from fusionmamba_torch.checkpoints import (load_reference_checkpoint, seg_state_dict_from_jax,
                                           state_dict_from_jax)
from fusionmamba_torch.models import VSSMFusion, VSSMFusionSeg
from fusionmamba_torch.nn import SegmentationHead, init_weights
from fusionmamba_tpu import config as jcfg
from fusionmamba_tpu import eval as jeval
from fusionmamba_tpu import losses as jlosses
from fusionmamba_tpu import train as jtrain
from fusionmamba_tpu.checkpoints import torch_import
from fusionmamba_tpu.models import VSSMFusionSeg as JaxVSSMFusionSeg
from fusionmamba_tpu.nn.layers import SegmentationHead as JaxSegmentationHead

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=5e-5, atol=5e-5)
CLASSES, SIZE = 5, 32


def _perturb(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + scale * rng.standard_normal(np.shape(p))).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX model, perturbed numpy variables, port model loaded with
    them, in eval mode)."""
    cfg = jcfg.test_config(scan_impl="assoc", num_seg_classes=CLASSES)
    model = JaxVSSMFusionSeg(cfg)
    x = jnp.zeros((1, SIZE, SIZE, 1), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for bn in stats["segmentation_head"].values():
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    variables = {"params": _perturb(variables["params"], rng), "batch_stats": stats}
    port = VSSMFusionSeg(tcfg.test_config(num_seg_classes=CLASSES))
    port.load_state_dict(seg_state_dict_from_jax(variables, cfg.depths, cfg.depths_decoder))
    return cfg, model, variables, port.eval()


def _images(seed, batch=2, size=SIZE):
    rng = np.random.default_rng(seed)
    coarse = np.kron(rng.uniform(0, 1, (batch, size // 8, size // 8)), np.ones((1, 8, 8)))
    return (0.1 + 0.7 * coarse + 0.2 * rng.uniform(0, 1, (batch, size, size)))[..., None].astype(
        np.float32)


def _head_case(variables, seed):
    """The JAX head, its variables (from the fixture's), and a seeded input."""
    head_vars = {"params": variables["params"]["segmentation_head"],
                 "batch_stats": variables["batch_stats"]["segmentation_head"]}
    x = np.random.default_rng(seed).standard_normal((2, 12, 10, 4)).astype(np.float32)
    return JaxSegmentationHead(in_channels=4, num_classes=CLASSES), head_vars, x


def test_segmentation_head_eval_matches_jax(pair):
    _, _, variables, port = pair
    jhead, head_vars, x = _head_case(variables, 1)
    want = jax.jit(lambda v, a: jhead.apply(v, a))(head_vars, jnp.asarray(x))
    with torch.no_grad():
        got = port.segmentation_head(torch.from_numpy(x))
    assert got.shape == (2, 12, 10, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def test_segmentation_head_train_matches_jax(pair):
    """Training mode: BatchNorm on the batch's statistics, and flax's dropout
    keep-mask, recovered from the captured `Dropout_0` output (non-zero
    exactly where it kept a non-zero input; where the input is zero either
    choice gives zero), injected into the port. Logits to 1e-5. After the
    one update the running mean agrees to 1e-6; the running variance differs
    by the batch variance's n / (n - 1), n = B*H*W = 240: torch updates with
    the unbiased variance, flax with the biased one, so the port's variance
    is held to 1e-6 of flax's with that factor put in."""
    _, _, variables, port = pair
    jhead, head_vars, x = _head_case(variables, 2)
    out, upd = jhead.apply(head_vars, jnp.asarray(x), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(3)},
                           mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    dropped = np.asarray(upd["intermediates"]["Dropout_0"]["__call__"][0])
    mask = dropped != 0
    # 70% kept of the roughly half of the inputs the ReLU leaves non-zero
    assert 0.2 < mask.mean() < 0.5
    head = SegmentationHead(4, CLASSES)
    head.load_state_dict(port.segmentation_head.state_dict())
    head.train()
    with torch.no_grad():
        got = head(torch.from_numpy(x), drop_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **MODULE_TOL)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    for bn in ("bn1", "bn2"):
        before = head_vars["batch_stats"][bn]
        after = upd["batch_stats"][bn]
        mod = getattr(head, bn)
        np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(after["mean"]),
                                   rtol=1e-6, atol=1e-6)
        biased = (np.asarray(after["var"]) - 0.99 * before["var"]) / 0.01
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   0.99 * before["var"] + 0.01 * biased * n / (n - 1),
                                   rtol=1e-6, atol=1e-6)
        assert int(mod.num_batches_tracked) == 1
    # without a mask the head draws one from the generator: seeded, repeatable
    with torch.no_grad():
        a = head(torch.from_numpy(x), torch.Generator().manual_seed(5))
        b = head(torch.from_numpy(x), torch.Generator().manual_seed(5))
        c = head(torch.from_numpy(x), torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="drop_mask"):
        head(torch.from_numpy(x), drop_mask=torch.ones(2, 12, 10, 3, dtype=torch.bool))


def test_seg_model_matches_jax(pair):
    """Eval-mode logits and fusion output of the whole network (5e-5)."""
    _, model, variables, port = pair
    x1, x2 = _images(4), _images(5)
    want = jax.jit(lambda v, a, b: model.apply(v, a, b))(variables, jnp.asarray(x1),
                                                          jnp.asarray(x2))
    with torch.no_grad():
        got = port(torch.from_numpy(x1), torch.from_numpy(x2))
        only_seg = port(torch.from_numpy(x1), torch.from_numpy(x2), return_fusion=False)
    assert got["segmentation"].shape == (2, SIZE, SIZE, CLASSES)
    assert got["fusion"].shape == (2, SIZE, SIZE, 1)
    for k in ("segmentation", "fusion"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **MODEL_TOL)
    assert list(only_seg) == ["segmentation"]
    assert torch.equal(only_seg["segmentation"], got["segmentation"])


def test_fusion_output_unchanged_by_the_features_split(pair):
    """VSSMFusion's output is its final_conv on `features` plus the residual,
    bit for bit, equal to VSSMFusionSeg's fusion output from the same
    weights, and within 5e-5 of the JAX VSSMFusion's."""
    cfg, model, variables, port = pair
    fusion = VSSMFusion(tcfg.test_config())
    fusion.load_state_dict(state_dict_from_jax(variables["params"]["fusion_model"],
                                               cfg.depths, cfg.depths_decoder))
    fusion.eval()
    x1, x2 = (torch.from_numpy(_images(s)) for s in (6, 7))
    with torch.no_grad():
        out = fusion(x1, x2)
        by_parts = fusion.final_conv(fusion.features(x1, x2)) + 2.0 * x1 + 2.0 * x2
        from_seg = port(x1, x2)["fusion"]
    assert torch.equal(out, by_parts) and torch.equal(out, from_seg)
    want = jax.jit(lambda v, a, b: model.apply(v, a, b, return_segmentation=False))(
        variables, jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()))["fusion"]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **MODEL_TOL)


def test_seg_head_init_follows_the_jax_package():
    """He-normal conv weights (flax's: truncated at 2 sigma, variance
    2 / fan_in), zero biases, BatchNorm at its identity; the weights drawn
    from the seed, so the same seed repeats them."""
    a = init_weights(VSSMFusionSeg(tcfg.test_config(num_seg_classes=CLASSES)), seed=3)
    b = init_weights(VSSMFusionSeg(tcfg.test_config(num_seg_classes=CLASSES)), seed=3)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    head = a.segmentation_head
    for conv in (head.conv1, head.conv2, head.attention[0], head.final_conv):
        fan_in = conv.weight[0].numel()
        std = (2.0 / fan_in) ** 0.5
        assert float(conv.weight.detach().abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        assert not bool((conv.bias != 0).any())
    # the variance is 2 / fan_in: over 147k weights, within 2%
    w = init_weights(SegmentationHead(64, 3), seed=0).conv2.weight
    want_std = (2.0 / w[0].numel()) ** 0.5
    assert abs(float(w.std()) - want_std) < 0.02 * want_std
    for bn in (head.bn1, head.bn2):
        assert bool((bn.weight == 1).all()) and not bool(bn.bias.any())
        assert bool((bn.running_var == 1).all()) and not bool(bn.running_mean.any())
        assert bn.momentum == 0.01 and bn.eps == 1e-5


# ---------------------------------------------------------------------------
# losses: value and gradient with respect to the logits. Sums over at most
# 2*32*32 pixels: 1e-5 relative (and of each gradient's largest entry).
# ---------------------------------------------------------------------------

def _loss_inputs(seed, classes=CLASSES):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((2, 16, 16, classes))).astype(np.float32)
    target = rng.integers(0, classes, (2, 16, 16)).astype(np.int32)
    target[0, :2] = -100                               # ignored
    target[1, 0, :3] = classes + 2                     # out of range: clipped
    weight = rng.uniform(0.5, 3.0, classes).astype(np.float32)
    return logits, target, weight


_LOSSES = {
    "cross_entropy": (lambda lg, t, w: tlosses.cross_entropy(lg, t),
                      lambda lg, t, w: jlosses.cross_entropy(lg, t)),
    "cross_entropy_weighted": (lambda lg, t, w: tlosses.cross_entropy(lg, t, w),
                               lambda lg, t, w: jlosses.cross_entropy(lg, t, w)),
    "focal": (lambda lg, t, w: tlosses.focal_loss(lg, t),
              lambda lg, t, w: jlosses.focal_loss(lg, t)),
    "dice_foreground": (lambda lg, t, w: tlosses.dice_loss_foreground(lg, t, CLASSES),
                        lambda lg, t, w: jlosses.dice_loss_foreground(lg, t, CLASSES)),
    "segmentation_pst900_weights": (
        lambda lg, t, w: torch.stack(list(tlosses.segmentation_loss(lg, t, CLASSES))),
        lambda lg, t, w: jnp.stack(list(jlosses.segmentation_loss(lg, t, CLASSES)))),
    "segmentation_weighted": (
        lambda lg, t, w: torch.stack(list(tlosses.segmentation_loss(lg, t, CLASSES, w))),
        lambda lg, t, w: jnp.stack(list(jlosses.segmentation_loss(lg, t, CLASSES, w)))),
    "improved_pst900": (
        lambda lg, t, w: torch.stack(list(tlosses.improved_pst900_loss(lg, t, CLASSES, w))),
        lambda lg, t, w: jnp.stack(list(jlosses.improved_pst900_loss(lg, t, CLASSES, w)))),
}


@pytest.mark.parametrize("name", list(_LOSSES))
def test_seg_loss_values_and_grads_match_jax(name):
    port_fn, jax_fn = _LOSSES[name]
    logits, target, weight = _loss_inputs(sum(map(ord, name)))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = port_fn(lt, torch.from_numpy(target), torch.from_numpy(weight))
    cot = np.random.default_rng(4).standard_normal(got.shape).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(jax_fn), jnp.asarray(logits), jnp.asarray(target),
                        jnp.asarray(weight))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got.backward(torch.from_numpy(cot))
    want_g = np.asarray(vjp(jnp.asarray(cot))[0])
    np.testing.assert_allclose(lt.grad.numpy(), want_g, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_g).max()))


def test_combined_loss_matches_jax():
    """Fusion and segmentation terms, their weighted total (1e-5)."""
    logits, target, _ = _loss_inputs(9)
    y, ir, gen = _images(10, size=16), _images(11, size=16), _images(12, size=16)
    got = tlosses.combined_fusion_segmentation_loss(
        *map(torch.from_numpy, (y, ir, target, gen, logits)), CLASSES, 0.7, 1.3)
    want = jax.jit(lambda *a: jlosses.combined_fusion_segmentation_loss(*a, CLASSES, 0.7, 1.3))(
        *map(jnp.asarray, (y, ir, target, gen, logits)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_class_weights_and_poly_lr_match_jax():
    counts = np.array([5e6, 3e3, 4e4, 0.0, 9e4])
    np.testing.assert_allclose(tlosses.compute_class_weights(counts).numpy(),
                               np.asarray(jlosses.compute_class_weights(jnp.asarray(counts))),
                               rtol=1e-6)
    for step in (0, 1, 17, 99):
        assert ttrain.poly_lr(5e-5, step, 100) == jtrain.poly_lr(5e-5, step, 100)


# ---------------------------------------------------------------------------
# metrics: float64 numpy on both sides, to 1e-12
# ---------------------------------------------------------------------------

def test_seg_metrics_match_jax():
    rng = np.random.default_rng(13)
    target = rng.integers(0, 6, (3, 20, 24))
    target[0, :4] = 255                                  # outside the classes: not counted
    pred = np.where(rng.uniform(size=target.shape) < 0.6, target, rng.integers(0, 6, target.shape))
    port, ref = teval.RunningScore(6), jeval.RunningScore(6)
    for rs in (port, ref):
        rs.update(target[:2], pred[:2])
        rs.update(target[2:], pred[2:])
    got, want = port.get_scores(), ref.get_scores()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)
    for p, t in zip(pred, target):
        g, w = teval.present_classes_metrics(p, t, 6), jeval.present_classes_metrics(p, t, 6)
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-12
    assert teval.present_classes_metrics(pred[0], np.full_like(target[0], 9), 6) is None


@pytest.mark.parametrize("fn", ["s_measure", "f_measure_sod", "e_measure", "mae"])
def test_sod_metrics_match_jax(fn):
    rng = np.random.default_rng(14)
    gt = (np.kron(rng.uniform(size=(4, 5)), np.ones((8, 8))) > 0.6).astype(np.int32)
    prob = np.clip(0.7 * gt + 0.4 * rng.uniform(size=gt.shape), 0, 1).astype(np.float32)
    for p, t in ((prob, gt), (prob, np.zeros_like(gt)), (np.full_like(prob, 0.3), gt)):
        got, want = getattr(teval, fn)(p, t), getattr(jeval, fn)(p, t)
        assert abs(got - want) <= 1e-12, (fn, got, want)


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------

def test_seg_bridge_round_trips_through_the_jax_importer(pair):
    """The port's state dict, read back by the JAX package's own
    `convert_seg_state_dict`, gives the variables it was made from (the
    layout is the reference's)."""
    cfg, _, variables, port = pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = torch_import.convert_seg_state_dict(sd, cfg.depths, cfg.depths_decoder)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path], err_msg=str(path))


def test_reference_seg_checkpoint_loads_strictly(pair, tmp_path):
    """A reference-layout `VSSM_Fusion_Segmentation` .pth (the fusion keys
    from the JAX package's exporter under `fusion_model.`, the head's convs
    OIHW, its BatchNorms with running statistics and a batch count, and the
    unused `lastconv` keys) loads into VSSMFusionSeg with only `lastconv`
    dropped; any other stray key fails."""
    cfg, _, variables, port = pair
    params, stats = variables["params"], variables["batch_stats"]["segmentation_head"]
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          torch_import.export_torch_state_dict(params["fusion_model"], cfg.depths,
                                               cfg.depths_decoder,
                                               prefix="fusion_model.").items()}
    head = params["segmentation_head"]
    for name, flax_name in (("conv1", "conv1"), ("conv2", "conv2"),
                            ("attention.0", "attention"), ("final_conv", "final_conv")):
        sd[f"segmentation_head.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(head[flax_name]["kernel"].transpose(3, 2, 0, 1)))
        sd[f"segmentation_head.{name}.bias"] = torch.from_numpy(head[flax_name]["bias"])
    for bn in ("bn1", "bn2"):
        sd[f"segmentation_head.{bn}.weight"] = torch.from_numpy(head[bn]["scale"])
        sd[f"segmentation_head.{bn}.bias"] = torch.from_numpy(head[bn]["bias"])
        sd[f"segmentation_head.{bn}.running_mean"] = torch.from_numpy(stats[bn]["mean"])
        sd[f"segmentation_head.{bn}.running_var"] = torch.from_numpy(stats[bn]["var"])
        sd[f"segmentation_head.{bn}.num_batches_tracked"] = torch.tensor(0)
    sd["fusion_model.Cross_block.0.Cross_layer.Diff_enhance.lastconv.weight"] = torch.zeros(
        16, 16, 1, 1)
    path = tmp_path / "seg.pth"
    torch.save({"state_dict": sd}, path)
    fresh = VSSMFusionSeg(tcfg.test_config(num_seg_classes=CLASSES))
    load_reference_checkpoint(fresh, str(path))
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    sd["fusion_model.stray.weight"] = torch.zeros(1)
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="stray"):
        load_reference_checkpoint(fresh, str(path))
