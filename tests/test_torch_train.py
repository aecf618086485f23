"""The port's training slice on the CPU (plain versions) against the JAX
package: the losses, the lr schedule, DropPath and its per-step table, the
data, a 20-step training trajectory, and the training CLI.

Inputs come from seeded numpy generators and cross between the frameworks as
numpy arrays. Tolerances are stated per test: both sides compute in float32
with sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch import config as tcfg
from fusionmamba_torch import data as tdata
from fusionmamba_torch import losses as tlosses
from fusionmamba_torch import train as ttrain
from fusionmamba_torch.checkpoints import load_reference_checkpoint, state_dict_from_jax
from fusionmamba_torch.models import VSSMFusion
from fusionmamba_torch.nn import DropPath, init_weights
from fusionmamba_tpu import config as jcfg
from fusionmamba_tpu import data as jdata
from fusionmamba_tpu import losses as jlosses
from fusionmamba_tpu import train as jtrain
from fusionmamba_tpu.models import VSSMFusion as JaxVSSMFusion
from fusionmamba_tpu.nn.layers import DropPath as JaxDropPath


def _images(seed, batch=2, size=64):
    """Images in [0.1, 1]: coarse noise upsampled plus fine noise, with no
    flat patches (where |sobel| would sit at its kink, 0, and the two
    frameworks' rounding picks different sides)."""
    rng = np.random.default_rng(seed)
    coarse = np.kron(rng.uniform(0, 1, (batch, size // 8, size // 8)), np.ones((1, 8, 8)))
    img = 0.1 + 0.7 * coarse + 0.2 * rng.uniform(0, 1, (batch, size, size))
    return img[..., None].astype(np.float32)


# ---------------------------------------------------------------------------
# losses: values and the gradient with respect to the generated image. The
# pyramid's sums run over at most 64^2 terms per level, so 1e-5 (relative,
# and of each gradient's largest entry) bounds the float32 reordering.
# ---------------------------------------------------------------------------

_LOSSES = {
    "msssim": (lambda g, y, ir: tlosses.msssim(torch.cat([g, g]), torch.cat([y, ir]),
                                               normalize=True, splits=2),
               lambda g, y, ir: jlosses.msssim(jnp.concatenate([g, g]), jnp.concatenate([y, ir]),
                                               normalize=True, splits=2)),
    "sobel_xy": (lambda g, y, ir: tlosses.sobel_xy(g), lambda g, y, ir: jlosses.sobel_xy(g)),
    "fusion_loss": (lambda g, y, ir: torch.stack(list(tlosses.fusion_loss(y, ir, g))),
                    lambda g, y, ir: jnp.stack(list(jlosses.fusion_loss(y, ir, g)))),
}


@pytest.mark.parametrize("name", list(_LOSSES))
def test_loss_values_and_grads_match_jax(name):
    port_fn, jax_fn = _LOSSES[name]
    gen, y, ir = _images(1), _images(2), _images(3)
    gt = torch.from_numpy(gen).requires_grad_(True)
    got = port_fn(gt, torch.from_numpy(y), torch.from_numpy(ir))
    want = jax.jit(jax_fn)(jnp.asarray(gen), jnp.asarray(y), jnp.asarray(ir))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    cot = np.random.default_rng(4).standard_normal(got.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    want_g = np.asarray(jax.jit(jax.grad(
        lambda g: jnp.sum(jax_fn(g, jnp.asarray(y), jnp.asarray(ir)) * cot)))(jnp.asarray(gen)))
    np.testing.assert_allclose(gt.grad.numpy(), want_g, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_g).max()))


def test_reference_fusion_lr_matches_jax():
    for epoch in range(1, 6):
        assert ttrain.reference_fusion_lr(epoch) == jtrain.reference_fusion_lr(epoch)
    assert ttrain.reference_fusion_lr(1) == pytest.approx(1e-4 / 0.75)


def test_synthetic_data_matches_jax():
    size = (32, 48)
    port, ref = tdata.SyntheticFusionDataset(5, size), jdata.SyntheticFusionDataset(5, size)
    for a, b in zip(tdata.batch_iterator(port, 2, seed=3, epochs=2),
                    jdata.batch_iterator(ref, 2, seed=3, epochs=2)):
        for x, z in zip(a, b):
            np.testing.assert_array_equal(x, z)


# ---------------------------------------------------------------------------
# DropPath: the same numpy uniforms in both frameworks give the same masks
# ---------------------------------------------------------------------------

def test_droppath_with_injected_row_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 3, 3, 4)).astype(np.float32)
    uni = rng.uniform(0, 1, 12).astype(np.float32)   # 2B wide, as the model's rows
    want = JaxDropPath(0.4).apply({}, jnp.asarray(x), deterministic=False, uni=jnp.asarray(uni))
    dp = DropPath(0.4).train()
    got = dp(torch.from_numpy(x), torch.from_numpy(uni))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    kept = (uni[:6] < 0.6)
    assert 0 < kept.sum() < 6                          # the row drops some, keeps some
    assert torch.equal(dp.eval()(torch.from_numpy(x)), torch.from_numpy(x))


@pytest.fixture(scope="module")
def dp_pair():
    """(JAX model, its numpy params, the port model loaded with them), at
    test_config with drop_path_rate 0.5, so that one block of each stage
    drops samples."""
    cfg = jcfg.test_config(scan_impl="assoc", drop_path_rate=0.5)
    model = JaxVSSMFusion(cfg)
    x = jnp.zeros((1, 16, 16, 1), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x, x)["params"])
    port = VSSMFusion(tcfg.test_config(drop_path_rate=0.5))
    port.load_state_dict(state_dict_from_jax(params, cfg.depths, cfg.depths_decoder))
    return model, params, port


def _inject_table(monkeypatch, table):
    """Make the JAX model's one uniform draw of a table of this shape return
    `table` (other draws, e.g. flax's shape checks of initializers, as they
    were)."""
    uniform = jax.random.uniform

    def fake(key, shape=(), *args, **kwargs):
        if tuple(shape) == table.shape:
            return jnp.asarray(table)
        return uniform(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", fake)


def _jax_dp_tables(model, params, width, table, monkeypatch):
    """The JAX model's own slicing of `table`: `_dp_tables` with its one
    uniform draw replaced by the numpy table."""
    _inject_table(monkeypatch, table)
    return model.apply({"params": params}, width, False,
                       method=lambda m, w, d: m._dp_tables(w, d), rngs={"dropout": jax.random.PRNGKey(0)})


@pytest.mark.parametrize("stage", ["encoder", "decoder"])
def test_dp_table_slices_match_jax_stage(dp_pair, stage, monkeypatch):
    """One numpy table, sliced by the port's `dp_tables` and by the JAX
    model's `_dp_tables`, gives the same per-stage slices, and the slice fed
    through the JAX VSSStage and the port's stage gives the same output: the
    encoder's last stage (its block's rate is 0.5) at batch 2B and the
    decoder's first (rate 0.5) at batch B, which reads the first B entries."""
    model, params, port = dp_pair
    B = 3
    rows, width = port.dp_table_shape(B)
    table = np.random.default_rng(6).uniform(0, 1, (rows, width)).astype(np.float32)
    j_enc, j_dec = _jax_dp_tables(model, params, width, table, monkeypatch)
    p_enc, p_dec = port.dp_tables(torch.from_numpy(table))
    for a, b in zip(p_enc + p_dec, list(j_enc) + list(j_dec)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx = 1 if stage == "encoder" else 0
    batch = 2 * B if stage == "encoder" else B
    x = np.random.default_rng(7).standard_normal((batch, 2, 2, 32)).astype(np.float32)
    j_slice = (j_enc if stage == "encoder" else j_dec)[idx]
    assert bool((np.asarray(j_slice)[0, :, :batch] >= 0.5).any())   # something is dropped
    want = jax.jit(lambda p, v: model.apply(
        {"params": p}, v, method=lambda m, v: (m.layers if stage == "encoder" else m.layers_up)[
            idx](v, deterministic=False, dp_uni=j_slice)))(params, jnp.asarray(x))
    mod = (port.layers if stage == "encoder" else port.layers_up)[idx].train()
    with torch.no_grad():
        got = mod(torch.from_numpy(x), (p_enc if stage == "encoder" else p_dec)[idx])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_training_forward_with_table_matches_jax(dp_pair, monkeypatch):
    """The whole model in training mode with one injected table against the
    JAX model whose one uniform draw returns the same table (model
    tolerance as in test_torch_model.py)."""
    model, params, port = dp_pair
    B = 2
    table = np.random.default_rng(8).uniform(0, 1, port.dp_table_shape(B)).astype(np.float32)
    x1, x2 = _images(9, B, 16), _images(10, B, 16)
    _inject_table(monkeypatch, table)
    want = jax.jit(lambda p, a, b: model.apply(
        {"params": p}, a, b, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x1), torch.from_numpy(x2),
                           dp_uni=torch.from_numpy(table))
        plain = port.eval()(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5, atol=5e-5)
    assert float((got - plain).abs().max()) > 1e-3    # the table did drop paths


# ---------------------------------------------------------------------------
# the training step: a 20-step trajectory against make_fusion_train_step
# ---------------------------------------------------------------------------

EPOCHS, STEPS, BATCH, SIZE = 2, 10, 2, 32


def _stream():
    rng = np.random.default_rng(101)
    for _ in range(EPOCHS * STEPS):
        yield (rng.uniform(0, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32),
               rng.uniform(0, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32))


def test_train_trajectory_matches_jax():
    """20 Adam steps over two epochs of the reference lr schedule, fp32, from
    the same weights and batches. Gates as tests/test_optimizer_trajectory.py:
    relative loss error < 1e-3 at every step, and every final parameter within
    2e-3 of the JAX one by norm, or, for leaves whose gradients are near zero
    (where Adam's eps amplifies float32 noise), an rms drift below a quarter
    of the total lr budget."""
    cfg = jcfg.FusionModelConfig(depths=(1, 1), depths_decoder=(1, 1), dims=(16, 32),
                                 d_state=16, drop_path_rate=0.0, scan_impl="ref")
    model = JaxVSSMFusion(cfg)
    x0 = jnp.zeros((1, SIZE, SIZE, 1), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x0, x0)["params"]
    np_params = jax.tree_util.tree_map(np.asarray, params)

    port = VSSMFusion(tcfg.FusionModelConfig(depths=(1, 1), depths_decoder=(1, 1),
                                             dims=(16, 32), d_state=16, drop_path_rate=0.0))
    port.load_state_dict(state_dict_from_jax(np_params, cfg.depths, cfg.depths_decoder))
    opt = ttrain.make_fusion_optimizer(port.parameters())

    state = jtrain.TrainState.create(apply_fn=model.apply, params=jax.tree_util.tree_map(
        jnp.array, np_params), tx=jtrain.make_fusion_optimizer(1e-4))
    step = jtrain.make_fusion_train_step(model, compute_dtype=jnp.float32)

    got, want = [], []
    stream = _stream()
    for epoch in range(1, EPOCHS + 1):
        ttrain.set_learning_rate(opt, ttrain.reference_fusion_lr(epoch))
        state = jtrain.set_learning_rate(state, jtrain.reference_fusion_lr(epoch))
        for _ in range(STEPS):
            vis_y, ir = next(stream)
            m = ttrain.fusion_train_step(port, opt, torch.from_numpy(vis_y), torch.from_numpy(ir))
            got.append(float(m["loss_total"]))
            state, jm = step(state, jnp.asarray(vis_y), jnp.asarray(ir), jax.random.PRNGKey(0))
            want.append(float(jm["loss_total"]))
    rels = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    assert max(rels) < 1e-3, rels

    final = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                                cfg.depths, cfg.depths_decoder)
    lr_budget = 1e-4 / 0.75 * len(got)
    moved = 0.0
    for k, p in port.state_dict().items():
        if k.endswith("base_mask"):
            continue
        w, g = final[k].double().numpy(), p.double().numpy()
        rel = np.linalg.norm(w - g) / (np.linalg.norm(w) + 1e-12)
        rms = np.linalg.norm(w - g) / np.sqrt(w.size)
        assert rel < 2e-3 or rms < 0.25 * lr_budget, (k, rel, rms)
        moved = max(moved, float(np.abs(g - state_dict_from_jax(
            np_params, cfg.depths, cfg.depths_decoder)[k].numpy()).max()))
    assert moved > 1e-5, "parameters did not move"


def test_train_step_draws_droppath_from_generator():
    """With drop_path_rate > 0 the step draws its table from the generator:
    the same seed repeats the losses, another seed changes them."""
    x1, x2 = torch.from_numpy(_images(11, 2, 32)), torch.from_numpy(_images(12, 2, 32))

    def losses(seed):
        net = init_weights(VSSMFusion(tcfg.test_config(drop_path_rate=0.5)), seed=0)
        opt = ttrain.make_fusion_optimizer(net.parameters())
        gen = torch.Generator().manual_seed(seed)
        return [float(ttrain.fusion_train_step(net, opt, x1, x2, gen)["loss_total"])
                for _ in range(3)]

    a, b, c = losses(1), losses(1), losses(2)
    assert a == b and a != c
    assert all(np.isfinite(a))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_trains_on_cpu_and_saves(tmp_path):
    argv = ["--synthetic", "4", "-B", "2", "--model", "test", "--image_size", "32",
            "--device", "cpu", "--ckpt_dir", str(tmp_path)]
    stats = ttrain.main(argv)
    assert stats["steps"] == 4 and len(stats["step_seconds"]) == 4     # 2 epochs of 2
    assert len(stats["losses"]) == 4 and all(np.isfinite(stats["losses"]))
    assert stats["seconds"] > 0
    path = tmp_path / "fusion_model_pst900.pth"
    fresh = VSSMFusion(tcfg.test_config())
    load_reference_checkpoint(fresh, str(path))       # strict, all keys
    saved = torch.load(path, weights_only=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved[k])
    # a second run warm-starts from the saved weights
    again = ttrain.main(argv + ["-E", "1"])
    assert again["steps"] == 2 and again["losses"][0] != stats["losses"][0]


def test_cli_without_a_card_fails_clearly(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--synthetic", "4", "-B", "2", "--ckpt_dir", str(tmp_path)])
    assert exc.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_without_synthetic_fails_clearly(tmp_path, capsys, monkeypatch):
    """Without --synthetic the CLI trains on the dataset under
    FUSIONMAMBA_DATA_ROOT; where there is none it says so."""
    monkeypatch.setenv("FUSIONMAMBA_DATA_ROOT", str(tmp_path))
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu", "--ckpt_dir", str(tmp_path)])
    err = capsys.readouterr().err
    assert "no dataset on disk" in err and "--synthetic" in err
