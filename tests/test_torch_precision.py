"""Mixed precision in the port (`--precision`, the bf16 I/O of the kernels'
plain versions) on the CPU, against the JAX package.

  * `resolve_compute_dtype`'s table and `cast_compute`'s casts;
  * one fusion step and one segmentation step (mode both) in bf16 against
    `make_fusion_train_step` / `make_seg_train_step` with jnp.bfloat16;
  * 12 steps bf16 against fp32 in both packages: the port's gap is held to
    the JAX package's own;
  * the two training CLIs with `--precision bf16` (fp32 checkpoints), and
    the multi-process steps under bf16 on gloo;
  * the fusion loss's band matrices, cached once per device.

The ops in bf16 are held against the JAX package in test_torch_bf16_ops.py.
Inputs come from seeded numpy generators and cross as numpy arrays.
Tolerances are stated where they are checked.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch import config as tcfg
from fusionmamba_torch import losses as tlosses
from fusionmamba_torch import train as ttrain
from fusionmamba_torch.checkpoints import seg_state_dict_from_jax, state_dict_from_jax
from fusionmamba_torch.models import VSSMFusion, VSSMFusionSeg
from fusionmamba_torch.nn import init_weights
from fusionmamba_tpu import config as jcfg
from fusionmamba_tpu import losses as jlosses
from fusionmamba_tpu import train as jtrain
from fusionmamba_tpu.models import VSSMFusion as JaxVSSMFusion
from fusionmamba_tpu.models import VSSMFusionSeg as JaxVSSMFusionSeg

BF = torch.bfloat16
JBF = jnp.bfloat16
# the module (the package's `ssim` is the function of that name)
tssim = importlib.import_module("fusionmamba_torch.losses.ssim")


# ---------------------------------------------------------------------------
# the precision table and the casts
# ---------------------------------------------------------------------------

def test_resolve_compute_dtype_table():
    """bf16 and fp32 as named; auto is fp32 (the JAX package's auto is bf16
    on a TPU only); anything else raises."""
    assert ttrain.resolve_compute_dtype("bf16") == torch.bfloat16
    assert ttrain.resolve_compute_dtype("fp32") == torch.float32
    assert ttrain.resolve_compute_dtype("auto") == torch.float32
    assert jtrain.resolve_compute_dtype("auto") == jnp.float32     # the same on a CPU
    assert ttrain.PRECISIONS == ("auto", "bf16", "fp32")
    for bad in ("fp16", "bfloat16", ""):
        with pytest.raises(ValueError, match="precision"):
            ttrain.resolve_compute_dtype(bad)


def test_cast_compute_casts_parameters_not_buffers():
    """Inside the block every floating parameter reads as its bf16 cast (a
    shared parameter as one cast), buffers keep their dtype; after it the
    masters are back, and their gradients are fp32."""
    net = VSSMFusionSeg(tcfg.test_config(num_seg_classes=3))
    shared = torch.nn.Linear(4, 4)
    net.a, net.b = shared, torch.nn.Sequential(shared)
    masters = {n: p for n, p in net.named_parameters()}
    with ttrain.cast_compute(net, BF):
        assert all(p.dtype == BF for _, p in net.named_parameters(remove_duplicate=False))
        assert net.a.weight is net.b[0].weight
        assert net.segmentation_head.bn1.running_mean.dtype == torch.float32
        net.a.weight.float().sum().backward()
    assert all(p is masters[n] and p.dtype == torch.float32 for n, p in net.named_parameters())
    assert shared.weight.grad.dtype == torch.float32
    assert torch.equal(shared.weight.grad, torch.ones(4, 4))
    with ttrain.cast_compute(net, torch.float32):
        assert all(p is masters[n] for n, p in net.named_parameters())


# ---------------------------------------------------------------------------
# the training steps in bf16 against the JAX package's
# ---------------------------------------------------------------------------

SIZE, BATCH, STEPS = 32, 2, 12


def _batches(n, seed=7):
    """Images in [0.02, 0.22]: the output 2*x1 + 2*x2 + ... stays inside the
    loss's [0, 1] clamp, where a bf16 rounding cannot flip a pixel across
    its edge (and with it that pixel's whole gradient)."""
    rng = np.random.default_rng(seed)
    return [tuple((0.02 + 0.2 * rng.uniform(0, 1, (BATCH, SIZE, SIZE, 1))).astype(np.float32)
                  for _ in range(2)) for _ in range(n)]


@pytest.fixture(scope="module")
def fusion_pair():
    """(JAX model, its numpy params, {dtype name: jitted JAX step}) at
    test_config with drop path 0 and the assoc scan (the JAX package's CPU
    path; never the TPU's cumsum rounding)."""
    cfg = jcfg.test_config(scan_impl="assoc", drop_path_rate=0.0)
    model = JaxVSSMFusion(cfg)
    x = jnp.zeros((1, SIZE, SIZE, 1), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), x, x)["params"])
    steps = {"bf16": jtrain.make_fusion_train_step(model, compute_dtype=JBF),
             "fp32": jtrain.make_fusion_train_step(model, compute_dtype=jnp.float32)}
    return cfg, model, params, steps


def _run_fusion(fusion_pair, precision, n):
    """n Adam steps of both packages from the same weights and batches at
    `precision`: (port losses {term: [...]}, JAX losses, port model, JAX
    params)."""
    cfg, model, params, steps = fusion_pair
    port = VSSMFusion(tcfg.test_config(drop_path_rate=0.0))
    port.load_state_dict(state_dict_from_jax(params, cfg.depths, cfg.depths_decoder))
    opt = ttrain.make_fusion_optimizer(port.parameters())
    state = jtrain.TrainState.create(apply_fn=model.apply, params=jax.tree_util.tree_map(
        jnp.array, params), tx=jtrain.make_fusion_optimizer(1e-4))
    dtype = ttrain.resolve_compute_dtype(precision)
    got, want = [], []
    for vis, ir in _batches(n):
        m = ttrain.fusion_train_step(port, opt, torch.from_numpy(vis), torch.from_numpy(ir),
                                     compute_dtype=dtype)
        got.append({k: float(v) for k, v in m.items()})
        state, jm = steps[precision](state, jnp.asarray(vis), jnp.asarray(ir),
                                     jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in jm.items()})
    return got, want, port, state.params


def test_fusion_step_bf16_matches_jax(fusion_pair):
    """One bf16 step against `make_fusion_train_step(model, jnp.bfloat16)`:
    every loss term within 1e-2 relative (the two packages round to bf16 at
    different places: JAX's CPU path rounds every XLA op's output, the port
    follows the kernels' contract), and the step's parameter update: Adam's
    first step moves each weight by about lr * sign(gradient), so the two
    updates, over all parameters, point the same way (cosine > 0.95; a
    near-zero gradient's sign may differ). The master parameters and their
    gradients are fp32."""
    cfg, _, params, _ = fusion_pair
    got, want, port, jparams = _run_fusion(fusion_pair, "bf16", 1)
    for k in want[0]:
        assert abs(got[0][k] - want[0][k]) / abs(want[0][k]) < 1e-2, (k, got, want)
    start = state_dict_from_jax(params, cfg.depths, cfg.depths_decoder)
    final = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg.depths,
                                cfg.depths_decoder)
    dp, dj = [], []
    for k, p in port.named_parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
        dp.append((p.detach() - start[k]).reshape(-1))
        dj.append((final[k] - start[k]).reshape(-1))
    dp, dj = torch.cat(dp).double(), torch.cat(dj).double()
    cos = float(dp @ dj / (dp.norm() * dj.norm()))
    assert cos > 0.95, cos
    assert float(dp.abs().max()) > 1e-5, "parameters did not move"


def test_bf16_gap_to_fp32_no_more_than_jax(fusion_pair):
    """12 steps in bf16 and in fp32 in both packages: the port's largest
    relative loss gap between its two precisions is no more than twice the
    JAX package's own plus 1e-3 (its docstring's "the fp32 loss trajectory
    matches to 3 decimals over 12 steps", made measurable)."""
    gaps = {}
    runs = {p: _run_fusion(fusion_pair, p, STEPS) for p in ("bf16", "fp32")}
    for side in (0, 1):
        lo, hi = runs["bf16"][side], runs["fp32"][side]
        gaps[side] = max(abs(a["loss_total"] - b["loss_total"]) / abs(b["loss_total"])
                         for a, b in zip(lo, hi))
    assert gaps[0] <= 2 * gaps[1] + 1e-3, gaps


def test_seg_step_bf16_matches_jax(monkeypatch):
    """One bf16 step of the segmentation model in mode both (the improved
    loss with class weights, AdamW with the clip) against
    `make_seg_train_step(..., compute_dtype=jnp.bfloat16)`, from the same
    perturbed weights, batch and dropout keep-mask (injected into flax's one
    Bernoulli draw): each loss within 1e-2 relative (bf16 rounds at other
    places in the two packages). The BatchNorm running statistics stay fp32
    and their means move as flax's do (within 1e-2 of the move's largest
    entry: batch means of bf16 activations); the masters stay fp32."""
    classes = 5
    cfg = jcfg.test_config(scan_impl="assoc", num_seg_classes=classes)
    model = JaxVSSMFusionSeg(cfg)
    x = jnp.zeros((1, SIZE, SIZE, 1), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(np.shape(p))).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    mask = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 8)) < 0.7
    bernoulli = jax.random.bernoulli

    def fake(key, p=0.5, shape=None, *args, **kwargs):
        if shape is not None and tuple(shape) == mask.shape:
            return jnp.asarray(mask)
        return bernoulli(key, p, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "bernoulli", fake)
    vis, ir = _batches(1, seed=8)[0]
    lbl = rng.integers(0, classes, (BATCH, SIZE, SIZE)).astype(np.int32)
    weights = np.asarray(jlosses.compute_class_weights(jnp.asarray([9e3, 3e2, 1e3, 2e2, 4e3])))
    state = jtrain.SegTrainState.create(
        apply_fn=model.apply, params=jax.tree_util.tree_map(jnp.array, params),
        batch_stats=jax.tree_util.tree_map(jnp.array, stats),
        tx=jtrain.make_seg_optimizer(lr=5e-5, flatten=False))
    step = jtrain.make_seg_train_step(model, classes, mode="both",
                                      class_weights=jnp.asarray(weights), improved=True,
                                      compute_dtype=JBF)
    state, jm = step(state, jnp.asarray(vis), jnp.asarray(ir), jnp.asarray(lbl),
                     jax.random.PRNGKey(0))

    net = VSSMFusionSeg(tcfg.test_config(num_seg_classes=classes))
    variables = {"params": params, "batch_stats": stats}
    net.load_state_dict(seg_state_dict_from_jax(variables, cfg.depths, cfg.depths_decoder))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = ttrain.make_seg_optimizer(net.parameters(), lr=5e-5)
    m = ttrain.seg_train_step(net, opt, *map(torch.from_numpy, (vis, ir, lbl)),
                              num_classes=classes, mode="both",
                              class_weights=torch.from_numpy(weights), improved=True,
                              drop_mask=torch.from_numpy(mask), compute_dtype=BF)
    for k in ("fusion_total", "seg_total", "total"):
        assert abs(float(m[k]) - float(jm[k])) / abs(float(jm[k])) < 1e-2, (k, m, jm)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    after = net.state_dict()
    jstats = jax.tree_util.tree_map(np.asarray, state.batch_stats)["segmentation_head"]
    for bn in ("bn1", "bn2"):
        assert after[f"segmentation_head.{bn}.running_var"].dtype == torch.float32
        mean = after[f"segmentation_head.{bn}.running_mean"]
        assert mean.dtype == torch.float32
        moved = (jstats[bn]["mean"] - before[f"segmentation_head.{bn}.running_mean"].numpy())
        assert float(np.abs(moved).max()) > 0
        np.testing.assert_allclose(mean.numpy(), jstats[bn]["mean"], rtol=0,
                                   atol=1e-2 * float(np.abs(moved).max()))


# ---------------------------------------------------------------------------
# the CLIs and the multi-process steps under bf16
# ---------------------------------------------------------------------------

def _fp32_and_loads(path, net):
    sd = torch.load(path, weights_only=True)
    assert sd and all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    net.load_state_dict(sd, strict=True)


def test_train_cli_bf16_saves_fp32(tmp_path):
    """`python -m fusionmamba_torch.train --precision bf16` on the CPU: finite
    losses, an fp32 checkpoint that loads strictly; fp32 is another run."""
    argv = ["--synthetic", "4", "-B", "2", "-E", "1", "--model", "test", "--image_size", "32",
            "--device", "cpu", "-j", "0", "--ckpt_dir", str(tmp_path)]
    got = ttrain.main(argv + ["--precision", "bf16"])
    assert got["steps"] == 2 and all(np.isfinite(got["losses"]))
    _fp32_and_loads(tmp_path / "fusion_model_pst900.pth", VSSMFusion(tcfg.test_config()))
    fp32 = ttrain.main(argv + ["--precision", "fp32"])
    assert fp32["losses"] != got["losses"]
    with pytest.raises(SystemExit):
        ttrain.main(argv + ["--precision", "fp16"])


def test_train_segmentation_cli_bf16_saves_fp32(tmp_path):
    """`train_segmentation --precision bf16` (mode both) and
    `train_pst900_improved`, which passes the flag through: finite losses,
    fp32 checkpoints that load strictly."""
    from fusionmamba_torch import train_pst900_improved, train_segmentation

    argv = ["--synthetic", "4", "-B", "2", "-E", "1", "--model", "test", "--image_size", "32",
            "--device", "cpu", "-j", "0", "--precision", "bf16"]
    got = train_segmentation.main(argv + ["--mode", "both", "--ckpt_dir", str(tmp_path / "a")])
    assert got["steps"] == 2 and all(np.isfinite(got["losses"]))
    _fp32_and_loads(tmp_path / "a" / "segmentation_model_mfnet.pth",
                    VSSMFusionSeg(tcfg.test_config(num_seg_classes=9)))
    pst = train_pst900_improved.main(argv + ["--ckpt_dir", str(tmp_path / "b")])
    assert pst["steps"] == 2 and all(np.isfinite(pst["losses"]))
    _fp32_and_loads(tmp_path / "b" / "segmentation_model_pst900.pth",
                    VSSMFusionSeg(tcfg.test_config(num_seg_classes=5)))


# name: (config overrides, mesh, ranks): data parallel and tensor parallel at
# widths whose projections cross 128 (every one sharded), the
# sequence-parallel scan at test_config
MESH_CASES = {"dp_2x1": (dict(drop_path_rate=0.3), (2, 1), 2),
              "tp_1x2": (dict(drop_path_rate=0.3, dims=(64, 128)), (1, 2), 2),
              "sp_1x2": (dict(drop_path_rate=0.3, scan_impl="sp"), (1, 2), 2)}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_multi_rank_bf16_steps_match_one_process(case, tmp_path):
    """Two bf16 steps on two gloo ranks against one process's two bf16 steps
    on the global batch: each loss within 1e-3 relative (the trajectory
    gate of tests/test_optimizer_trajectory.py). The ranks round to bf16 at
    other places than one process (a row-parallel product's partial sums,
    each rounded, summed in fp32 and rounded again), so bf16's own gate, not
    fp32's, holds them."""
    import torch_dist_workers as workers

    cfg, mesh_shape, world = MESH_CASES[case]
    rng = np.random.default_rng(3)
    batches = [tuple((0.02 + 0.2 * rng.uniform(0, 1, (4, 32, 32, 1))).astype(np.float32)
                     for _ in range(2)) for _ in range(2)]
    torch.set_num_threads(2)
    want = workers.train_case(cfg, (1, 1), batches, 2, "bf16")
    got = workers.spawn(workers.train_case, world, str(tmp_path), cfg, mesh_shape, batches, 2,
                        "bf16")
    for r in got:
        for a, b in zip(r["losses"], want["losses"]):
            assert abs(a - b) / abs(b) < 1e-3, (case, r["losses"], want["losses"])
        assert all(v.dtype == torch.float32 for v in r["state"].values()
                   if v.is_floating_point())


# ---------------------------------------------------------------------------
# the fusion loss copies no matrix to the device in a step
# ---------------------------------------------------------------------------

def test_band_matrices_are_cached_per_device():
    """The separable filters' band matrices and the PST900 class weights are
    made once per (taps, length, padding, device) and handed out again, and
    the losses are bit-identical to the uncached form (a fresh tensor from
    the numpy matrix each call)."""
    win = tssim.gaussian_taps(11)
    a = tssim.band_tensor(win, 32, False, torch.device("cpu"))
    assert tssim.band_tensor(win, 32, False, torch.device("cpu")) is a
    assert tssim.band_tensor(win, 32, True, torch.device("cpu")) is not a
    from fusionmamba_torch.losses import segmentation as tseg
    assert tseg.pst900_class_weights(torch.device("cpu")) is tseg.pst900_class_weights(
        torch.device("cpu"))

    rng = np.random.default_rng(11)
    y, ir, gen = (torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32))
                  for _ in range(3))
    cached = tlosses.fusion_loss(y, ir, gen)

    def fresh(taps, L, same, device):
        return torch.from_numpy(tssim.band_matrix(taps, L, same)).to(device)

    orig = tssim.band_tensor
    tssim.band_tensor = fresh
    try:
        uncached = tlosses.fusion_loss(y, ir, gen)
    finally:
        tssim.band_tensor = orig
    for c, u in zip(cached, uncached):
        assert torch.equal(c, u)
    logits = torch.from_numpy(rng.standard_normal((2, 8, 8, 5)).astype(np.float32))
    lbl = torch.from_numpy(rng.integers(0, 5, (2, 8, 8)))
    got = tlosses.segmentation_loss(logits, lbl, 5)
    want = tlosses.segmentation_loss(logits, lbl, 5,
                                     weight=torch.tensor(tlosses.PST900_CLASS_WEIGHTS))
    assert torch.equal(got.total, want.total)


@pytest.mark.parametrize("flag", ["remat", "remat_light"])
def test_remat_bf16_matches_no_remat(flag):
    """A bf16 step with remat recomputes its forwards inside the same casts
    (`cast_compute` holds over the backward): the loss equals the step's
    without remat (the same bf16 operations in the same order, 1e-6), every
    master gradient is fp32 and within 8e-3 of its largest entry (a cast
    parameter read twice sums its two bf16 gradients in another order), and
    the ops' calls equal those `chip_smoke.train_calls` derives (the card's
    launch counts under bf16)."""
    import chip_smoke
    import torch_dist_workers as workers

    vis, ir = (torch.from_numpy(a) for a in _batches(1, seed=5)[0])
    runs = {}
    for f in ("none", flag):
        cfg = tcfg.test_config(drop_path_rate=0.3, **({} if f == "none" else {f: True}))
        net = init_weights(VSSMFusion(cfg), seed=0)
        opt = ttrain.make_fusion_optimizer(net.parameters())
        with workers.count_plain_calls() as counts:
            m = ttrain.fusion_train_step(net, opt, vis, ir, torch.Generator().manual_seed(0),
                                         compute_dtype=BF)
        want = chip_smoke.train_calls(cfg, BATCH, SIZE)
        for k in chip_smoke.OPS:
            assert counts[k] == want[k], (f, k, counts[k], want[k])
        runs[f] = float(m["loss_total"]), {k: p.grad for k, p in net.named_parameters()
                                           if p.grad is not None}
    (l0, g0), (l1, g1) = runs["none"], runs[flag]
    assert l1 == pytest.approx(l0, rel=1e-6)
    assert set(g0) == set(g1)
    for k in g0:
        assert g1[k].dtype == torch.float32
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=8e-3 * float(g0[k].abs().max()))
