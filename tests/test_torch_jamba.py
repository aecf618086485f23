"""The port's Jamba (`models/jamba.py`, `MambaBlock`'s inner norms, the
importer's dispatch) against `tests/plain_jamba.py` on the CPU, at a tiny
size: a whole period of 8 layers (7 Mamba : 1 attention, 4 expert : 4 dense),
hidden 64, 4 heads over 2 key-value heads, 8 routed experts (top 2) of which
4 are held, d_state 16, 40 tokens."""
import zlib

import pytest
import torch

from fusionmamba_torch.checkpoints import hf_import
from fusionmamba_torch.models import jamba
from fusionmamba_torch.models.mamba_lm import MambaBlock, MambaLMHeadModel
from fusionmamba_torch.utils import tracing

import plain_jamba

CFG = dict(model_type="jamba", hidden_size=64, intermediate_size=96, num_hidden_layers=8,
           num_attention_heads=4, num_key_value_heads=2, num_experts=8, num_experts_per_tok=2,
           vocab_size=61, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2, mamba_dt_rank=8,
           rms_norm_eps=1e-6, attn_layer_offset=4, attn_layer_period=8, expert_layer_offset=1,
           expert_layer_period=2, tie_word_embeddings=False)
# float32 sums taken in another order (SDPA against the plain softmax, the
# port's scan against the plain step loop, the scatter-add), through 8
# layers to logits of up to 4.6: 1.8e-5 to 2.6e-5 apart over three seeds
# and three shares of experts. 1e-4 leaves four times that; a route flipped
# or an inner norm's weight left out moves them by 1e-2 or more
TOL = dict(rtol=1e-4, atol=1e-4)


def _fill(module: torch.nn.Module, seed: int) -> None:
    """Every parameter from a generator of its own name, so that a module
    holding a share of the experts gets the same tensors: products
    N(0, 1/fan_in); norm weights and D near 1; biases small; S4D-real A_log
    jittered."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            gen = torch.Generator().manual_seed(seed * 1000003 + zlib.crc32(name.encode()))
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("layernorm.weight") or name.endswith(".D"):
                p.copy_(1.0 + 0.2 * noise)
            elif name.endswith("A_log"):
                p.copy_(torch.log(torch.arange(1.0, p.shape[-1] + 1)) + 0.1 * noise)
            elif name.endswith(".bias"):
                p.copy_(0.1 * noise)
            else:
                fan_in = p[0].numel() if name != "model.embed_tokens.weight" else 1
                p.copy_(noise * fan_in ** -0.5)


def _plain(held=None, seed=0):
    ref = plain_jamba.JambaForCausalLM(jamba.full_config(CFG), held)
    _fill(ref, seed)
    return ref


def _tokens(seed=3, batch=2, length=40):
    return torch.randint(0, CFG["vocab_size"], (batch, length),
                         generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("held", [None, range(0, 4), range(4, 8)], ids=["all", "0-3", "4-7"])
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_the_plain_reference(held, seed):
    ref = _plain(held, seed)
    port = hf_import.model_from_config(CFG, held).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    tokens = _tokens(seed + 3)
    with torch.no_grad():
        logits, router_logits = port(tokens)
        torch.testing.assert_close(logits, ref(tokens), **TOL)
    assert len(router_logits) == 4 and router_logits[0].shape == (80, 8)


def _moe_pair(seed=5):
    plain = plain_jamba.SparseMoe(64, 96, 8, 2)
    _fill(plain, seed)
    return plain, plain.state_dict()


def _share(sd, held):
    block = jamba.JambaSparseMoeBlock(64, 96, 8, 2, held)
    keep = {k: v for k, v in sd.items()
            if not k.startswith("experts.") or int(k.split(".")[1]) in held}
    block.load_state_dict(keep, strict=True)
    return block


def test_the_two_shares_add_up_to_the_uncut_layer():
    plain, sd = _moe_pair()
    x = torch.randn(3, 40, 64, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        whole, logits = plain(x)
        parts = [_share(sd, range(a, a + 4))(x) for a in (0, 4)]
    # the router is what both chips compute alike: the same logits from each
    for _, r in parts:
        torch.testing.assert_close(r, logits, rtol=0, atol=0)
    torch.testing.assert_close(parts[0][0] + parts[1][0], whole, rtol=1e-6, atol=1e-6)
    # and each share is the uncut layer's part from its own experts
    half = plain_jamba.SparseMoe(64, 96, 8, 2, held=range(4))
    half.load_state_dict({k: v for k, v in sd.items()
                          if not k.startswith("experts.") or int(k.split(".")[1]) < 4})
    with torch.no_grad():
        torch.testing.assert_close(parts[0][0], half(x)[0], rtol=1e-6, atol=1e-6)


def test_a_held_expert_that_receives_no_rows():
    plain, sd = _moe_pair()
    # positive inputs against a router row of -1s: expert 2 is never in the top 2
    sd["router.weight"] = sd["router.weight"].abs()
    sd["router.weight"][2] = -1.0
    plain.load_state_dict(sd)
    block = _share(sd, range(0, 4))
    x = torch.rand(2, 40, 64, generator=torch.Generator().manual_seed(4)) + 0.5
    before = tracing.counts.copy()
    with torch.no_grad():
        out, logits = block(x)
        chosen = jamba.route(logits, 2)[1]
        assert not (chosen == 2).any()
        half = plain_jamba.SparseMoe(64, 96, 8, 2, held=range(4))
        half.load_state_dict({k: v for k, v in sd.items()
                              if not k.startswith("experts.") or int(k.split(".")[1]) < 4})
        torch.testing.assert_close(out, half(x)[0], rtol=1e-6, atol=1e-6)
    held_rows = int((chosen < 4).sum())
    assert tracing.counts["moe_rows:held"] - before["moe_rows:held"] == held_rows
    # one gather, and one scatter for each held expert that has rows
    scatters = len({int(e) for e in chosen[chosen < 4]})
    assert scatters < 4
    assert tracing.counts["copies:jamba.moe"] - before["copies:jamba.moe"] == 1 + scatters


def _mixer_pair(inner_norms, seed=7):
    plain = plain_jamba.MambaMixer(16, 16, 4, 2, 4, 1e-6, inner_norms=inner_norms)
    _fill(plain, seed)
    block = MambaBlock(16, 16, 4, 2, 4, inner_norm_eps=1e-6 if inner_norms else None)
    block.load_state_dict(plain.state_dict(), strict=True)
    return plain, block


@pytest.mark.parametrize("inner_norms", [True, False], ids=["jamba", "mamba_ssm"])
def test_mamba_block_matches_the_plain_mixer(inner_norms):
    """With its inner norms, Jamba's mixer; without, mamba_ssm's, as before
    (no norm built, none applied)."""
    plain, block = _mixer_pair(inner_norms)
    x = torch.randn(2, 12, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(block(x)[0], plain(x), rtol=1e-5, atol=1e-6)
    norms = {n for n, _ in block.named_parameters() if "layernorm" in n}
    assert norms == ({"dt_layernorm.weight", "b_layernorm.weight", "c_layernorm.weight"}
                     if inner_norms else set())


def test_mamba_block_with_inner_norms_decodes_as_it_scans():
    _, block = _mixer_pair(True)
    x = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(2))
    cache = block.init_cache(2)
    with torch.no_grad():
        full = block(x)[0]
        steps = torch.cat([block(x[:, t:t + 1], cache)[0] for t in range(9)], dim=1)
    torch.testing.assert_close(steps, full, rtol=1e-5, atol=1e-6)


def test_model_from_config_builds_jamba_with_transformers_names():
    model = hf_import.model_from_config(CFG, range(4, 8))
    assert isinstance(model, jamba.JambaForCausalLM)
    kinds = jamba.layer_kinds(model.config)
    assert [m for m, _ in kinds] == ["mamba"] * 4 + ["attention"] + ["mamba"] * 3
    assert [f for _, f in kinds] == ["mlp", "moe"] * 4
    names = {n for n, _ in model.named_parameters()}
    assert names == {n for n, _ in _plain(range(4, 8)).named_parameters()}
    assert "model.layers.1.feed_forward.experts.5.down_proj.weight" in names
    assert not any(".experts.3." in n for n in names)
    assert model.model.layers[1].feed_forward.router.weight.shape == (8, 64)
    assert model.model.layers[0].mamba.dt_layernorm.weight.shape == (8,)
    assert model.lm_head.weight is not model.model.embed_tokens.weight


def test_model_from_config_refuses_what_it_does_not_build():
    with pytest.raises(ValueError, match="sliding_window"):
        hf_import.model_from_config({**CFG, "sliding_window": 4096})
    with pytest.raises(ValueError, match="experts"):
        hf_import.model_from_config(CFG, range(6, 10))
    with pytest.raises(ValueError, match="Jamba config only"):
        hf_import.model_from_config({"d_model": 64, "n_layer": 2, "vocab_size": 100}, range(2))


def test_model_from_config_builds_mamba_ssm_configs_as_before():
    cfg = {"d_model": 64, "n_layer": 2, "vocab_size": 100, "ssm_cfg": {}, "rms_norm": True,
           "pad_vocab_size_multiple": 8}
    model = hf_import.model_from_config(cfg)
    want = MambaLMHeadModel(104, 64, 2, rms_norm=True)
    assert type(model) is MambaLMHeadModel
    assert {n: p.shape for n, p in model.named_parameters()} == \
        {n: p.shape for n, p in want.named_parameters()}
    assert not any("layernorm" in n for n, _ in model.named_parameters())


def test_moe_rows_and_copies_are_counted():
    ref = _plain(range(0, 4))
    port = hf_import.model_from_config(CFG, range(0, 4)).eval()
    port.load_state_dict(ref.state_dict())
    tokens = _tokens()
    before = tracing.counts.copy()
    with torch.no_grad():
        _, router_logits = port(tokens)
    moved = {k: tracing.counts[k] - before.get(k, 0) for k in tracing.counts}
    chosen = [jamba.route(r, 2)[1] for r in router_logits]
    assert moved["moe_rows:routed"] == 4 * 2 * tokens.numel()
    assert moved["moe_rows:held"] == sum(int((c < 4).sum()) for c in chosen)
    gathers_and_scatters = sum(1 + len({int(e) for e in c[c < 4]}) for c in chosen)
    assert moved["copies:jamba.moe"] == gathers_and_scatters
    # the gather and the scatters write the held rows' bytes twice
    assert moved["copy_bytes:jamba.moe"] == 2 * moved["moe_rows:held"] * 64 * 4
    # k and v expanded from 2 to 4 heads in the one attention layer
    assert moved["copies:jamba.attention"] == 2
    assert moved["copy_bytes:jamba.attention"] == 2 * tokens.numel() * 64 * 4
