"""The plain reference against the port's plain path on the CPU at a small
size: the same weights and inputs give the same outputs, losses and
gradients, to float32 rounding."""
import dataclasses

import pytest
import torch

from fusionmamba_torch.config import test_config as small_config
from fusionmamba_torch.losses import fusion_loss
from fusionmamba_torch.models import VSSMFusion
from fusionmamba_torch.models.mamba_lm import MambaLMHeadModel
from portbench import compare
from portbench.reference import fusion as ref_fusion
from portbench.reference import mamba_lm as ref_lm
from portbench.reference import scan, weights


def _cfg():
    c = small_config(drop_path_rate=0.1, depths=(2, 2), depths_decoder=(2, 2))
    return c, {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(c).items()}


@pytest.mark.parametrize("length", [1, 5, 16, 37, 64])
def test_recurrence_and_its_gradient(length):
    gen = torch.Generator().manual_seed(length)
    a = torch.rand(3, length, 4, 2, dtype=torch.float64, generator=gen, requires_grad=True)
    b = torch.randn(3, length, 4, 2, dtype=torch.float64, generator=gen, requires_grad=True)
    h, hs = torch.zeros(3, 4, 2, dtype=torch.float64), []
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    torch.testing.assert_close(scan.recurrence(a.detach(), b.detach()), torch.stack(hs, 1).detach())
    assert torch.autograd.gradcheck(scan.linear_recurrence, (a, b))


def test_fusion_forward_loss_and_gradients_match_the_port():
    torch.manual_seed(0)
    c, cfg = _cfg()
    w = weights.fusion_weights(cfg, 2 ** 31 + 7, "cpu")
    prog, ref = VSSMFusion(c), ref_fusion.FusionNet(cfg)
    weights.load(prog, w)
    weights.load(ref, w)
    x1, x2 = torch.rand(3, 32, 32, 1), torch.rand(3, 32, 32, 1)
    with torch.no_grad():
        torch.testing.assert_close(prog.eval()(x1, x2), ref(x1, x2), rtol=1e-5, atol=1e-5)
    table = torch.rand(prog.dp_table_shape(3), generator=torch.Generator().manual_seed(5))
    assert table.shape[0] == ref.dp_rows()
    out = prog.train()(x1, x2, dp_uni=table)
    loss = fusion_loss(x1, x2, out.clamp(0, 1)).total
    loss.backward()
    ref_loss, ref_out = ref_fusion.train_step(ref, x1, x2, table, 2)
    torch.testing.assert_close(ref_out, out.detach(), rtol=1e-5, atol=1e-5)
    assert compare.rel_gap([float(loss.detach())], [float(ref_loss)]) < 1e-4
    names = sorted(n for n, _ in ref.named_parameters())
    pg, rg = dict(prog.named_parameters()), dict(ref.named_parameters())

    def norms(params):
        return torch.stack([p.grad.norm() if p.grad is not None else torch.zeros(())
                            for p in (params[n] for n in names)])
    assert compare.leaf_gaps(norms(pg), norms(rg)).max() < 1e-3


def test_adam_matches_torch():
    p = torch.nn.Parameter(torch.randn(50))
    q = torch.nn.Parameter(p.detach().clone())
    opt, ref = torch.optim.Adam([p], lr=1e-3), ref_fusion.Adam([q], lr=1e-3)
    for _ in range(3):
        g = torch.randn(50)
        p.grad, q.grad = g.clone(), g.clone()
        opt.step()
        ref.step()
    torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)


def test_lm_matches_the_port():
    cfg = dict(vocab_size=64, d_model=32, n_layer=2, d_state=16, d_conv=4, expand=2,
               norm_eps=1e-5)
    w = weights.lm_weights(cfg, 11, "cpu")
    prog, ref = MambaLMHeadModel(64, 32, 2, rms_norm=True), ref_lm.MambaLM(cfg)
    weights.load(prog, w)
    weights.load(ref, w)
    tokens = torch.randint(0, 64, (2, 40), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        torch.testing.assert_close(prog(tokens)[0], ref(tokens), rtol=1e-5, atol=1e-5)


def test_weights_repeat_from_the_seed_and_differ_across_seeds():
    _, cfg = _cfg()
    a, b = weights.fusion_weights(cfg, 5, "cpu"), weights.fusion_weights(cfg, 5, "cpu")
    c = weights.fusion_weights(cfg, 6, "cpu")
    name = "layers.0.blocks.0.op.x_proj_weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
    assert torch.equal(a["layers.0.blocks.0.op.Ds"], torch.ones_like(a["layers.0.blocks.0.op.Ds"]))

