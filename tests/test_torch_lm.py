"""The port's Mamba LM (plain versions, CPU) against the JAX package's
`models/mamba_lm.py` and `checkpoints/hf_import.py`: the block, the cached
decode, the whole LM in both norm flavours, greedy generation, the sampling
filters and the repetition penalty, the checkpoint import, and the seeded
initialiser.

The JAX side runs with `scan_impl="assoc"`, as `tests/test_mamba_lm.py`
runs it; its parameters are perturbed with seeded noise so that every
transposed or misplaced tensor shows, and cross to the port through
`lm_state_dict_from_jax`. Tolerances, stated per test: both sides compute in
float32 with sums in another order: 1e-5 for a block, 1e-4 for the LM's
logits (two blocks, the norms and the tied head over the vocabulary); the
filters and the penalty select or scale logits without arithmetic of their
own order, so they are held bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch.checkpoints import hf_import, lm_state_dict_from_jax
from fusionmamba_torch.models import mamba_lm as tlm
from fusionmamba_torch.nn import init_lm_weights
from fusionmamba_tpu.checkpoints import hf_import as jhf
from fusionmamba_tpu.models import mamba_lm as jlm

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(variables, seed, scale=0.05):
    """Every leaf plus seeded noise (A_log and D start constant)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + scale * rng.standard_normal(np.shape(x)).astype(np.float32), variables)


def _jax_lm(vocab, d_model, n_layer=2, d_state=4, rms_norm=False, seed=0, L=12):
    model = jlm.MambaLMHeadModel(vocab_size=vocab, d_model=d_model, n_layer=n_layer,
                                 d_state=d_state, scan_impl="assoc", rms_norm=rms_norm)
    tokens = jnp.zeros((1, L), jnp.int32)
    return model, _perturb(model.init(jax.random.PRNGKey(seed), tokens), seed + 1)


def _port_lm(jmodel, variables):
    model = tlm.MambaLMHeadModel(jmodel.vocab_size, jmodel.d_model, jmodel.n_layer,
                                 jmodel.d_state, rms_norm=jmodel.rms_norm)
    model.load_state_dict(lm_state_dict_from_jax(variables, jmodel.n_layer))
    return model.eval()


def _tokens(seed, B, L, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).astype(np.int32)


@pytest.mark.parametrize("d_model,d_state", [(16, 4), (32, 16)])
def test_block_matches_jax(d_model, d_state):
    """MambaBlock's full forward (the scan at K = 1 with a full-rank dt)
    against the JAX block, 1e-5."""
    jblock = jlm.MambaBlock(d_model=d_model, d_state=d_state, scan_impl="assoc")
    x = np.random.default_rng(2).standard_normal((2, 9, d_model)).astype(np.float32)
    variables = _perturb(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    want, _ = jblock.apply(variables, jnp.asarray(x))
    tree = {"params": {"embedding": {"embedding": np.zeros((1, d_model), np.float32)},
                       "blocks_0": {"norm": {"scale": np.ones(d_model, np.float32)},
                                    "mixer": variables["params"]},
                       "norm_f": {"scale": np.ones(d_model, np.float32)}}}
    prefix = "backbone.layers.0.mixer."
    block = tlm.MambaBlock(d_model, d_state)
    block.load_state_dict({k[len(prefix):]: v for k, v in lm_state_dict_from_jax(tree, 1).items()
                           if k.startswith(prefix)})
    with torch.no_grad():
        got, cache = block(torch.from_numpy(x))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_block_decode_matches_full_forward():
    """The cached single-token step, token by token, against the full
    forward within the port (the counterpart of the JAX package's
    `test_block_decode_matches_parallel`), 1e-5; the caches update in place."""
    block = init_lm_weights(tlm.MambaLMHeadModel(8, 16, 1, 4), seed=5).backbone.layers[0].mixer
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 7, 16)).astype(np.float32))
    cache = block.init_cache(2)
    states = cache["ssm_state"]
    with torch.no_grad():
        full, _ = block(x)
        steps = []
        for i in range(x.shape[1]):
            y, same = block(x[:, i:i + 1], cache)
            assert same is cache and cache["ssm_state"] is states
            steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), full, **BLOCK_TOL)
    with pytest.raises(ValueError):
        block.step(x[:, :2], cache)


@pytest.mark.parametrize("d_model", [16, 64])
@pytest.mark.parametrize("rms_norm", [False, True])
def test_lm_logits_match_jax(d_model, rms_norm):
    """The LM's logits (2 layers, LayerNorm or RMSNorm) against the JAX
    LM's, 1e-4; and its cached decode against its own full forward."""
    jmodel, variables = _jax_lm(40, d_model, rms_norm=rms_norm, seed=d_model)
    tokens = _tokens(d_model, 2, 12, 40)
    want, _ = jmodel.apply(variables, jnp.asarray(tokens))
    model = _port_lm(jmodel, variables)
    assert "backbone.norm_f.bias" in model.state_dict() or rms_norm
    with torch.no_grad():
        got, caches = model(torch.from_numpy(tokens).long())
        assert caches is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
        caches = model.init_caches(2)
        steps = [model(torch.from_numpy(tokens[:, i:i + 1]).long(), caches)[0]
                 for i in range(tokens.shape[1])]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), got.numpy(), **LM_TOL)


def test_greedy_generate_matches_jax():
    """Greedy tokens equal the JAX package's `compiled=False` loop; the
    port's `compiled=True` (on the CPU, the same loop) equals its
    `compiled=False`, greedy and sampled from one generator seed."""
    jmodel, variables = _jax_lm(32, 16, d_state=4, seed=7)
    prompt = _tokens(8, 2, 3, 32)
    want = jlm.generate(jmodel, variables, jnp.asarray(prompt), max_new_tokens=6,
                        temperature=0.0, compiled=False)
    model = _port_lm(jmodel, variables)
    got = tlm.generate(model, torch.from_numpy(prompt), 6, temperature=0.0, compiled=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tlm.generate(model, torch.from_numpy(prompt), 6, temperature=0.0), got)
    kw = dict(temperature=0.8, top_p=0.9, repetition_penalty=1.3)
    runs = [tlm.generate(model, torch.from_numpy(prompt), 6, compiled=compiled,
                         generator=torch.Generator().manual_seed(3), **kw)
            for compiled in (False, True)]
    assert torch.equal(*runs)
    assert runs[0].shape == (2, 9) and bool((runs[0] >= 0).all() and (runs[0] < 32).all())


def test_generate_rejects_an_empty_prompt():
    model = tlm.MambaLMHeadModel(8, 8, 1, 4)
    with pytest.raises(ValueError, match="prompt"):
        tlm.generate(model, torch.zeros(1, 0, dtype=torch.long), 3)
    with pytest.raises(ValueError, match="prompt"):
        tlm.generate(model, torch.zeros(3, dtype=torch.long), 3)


def _logits(seed, B=3, V=50):
    """Seeded logits rounded to 0.25, so that many values tie."""
    rng = np.random.default_rng(seed)
    return np.round(4 * rng.standard_normal((B, V))).astype(np.float32) / 4


@pytest.mark.parametrize("top_p", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_top_p_filter_bit_equal(top_p):
    x = _logits(10)
    want = np.asarray(jlm.top_p_filter(jnp.asarray(x), top_p))
    np.testing.assert_array_equal(tlm.top_p_filter(torch.from_numpy(x), top_p).numpy(), want)


@pytest.mark.parametrize("min_p", [0.0, 0.05, 0.3, 0.9])
def test_min_p_filter_bit_equal(min_p):
    x = _logits(11)
    want = np.asarray(jlm.min_p_filter(jnp.asarray(x), min_p))
    np.testing.assert_array_equal(tlm.min_p_filter(torch.from_numpy(x), min_p).numpy(), want)


@pytest.mark.parametrize("penalty", [1.0, 1.2, 2.0])
def test_repetition_penalty_bit_equal(penalty):
    """The seen mask and both forms of the penalty, with repeated tokens."""
    x = _logits(12)
    prev = np.random.default_rng(13).integers(0, 50, (3, 9)).astype(np.int32)
    want = np.asarray(jlm.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(prev), penalty))
    got = tlm.apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(prev), penalty)
    np.testing.assert_array_equal(got.numpy(), want)
    seen = tlm.seen_mask(torch.from_numpy(prev), 50)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jlm.seen_mask(jnp.asarray(prev), 50)))
    np.testing.assert_array_equal(
        tlm.apply_repetition_penalty_mask(torch.from_numpy(x), seen, penalty).numpy(), want)


def test_greedy_sampling_bit_equal_with_ties():
    """top_k == 1 and temperature 0 take the first of tied maxima, as
    jnp.argmax does."""
    x = _logits(14)
    x[:, 7] = x[:, 30] = x.max() + 1.0
    want = np.asarray(jlm.sample_logits(jnp.asarray(x), jax.random.PRNGKey(0), top_k=1))
    for kw in (dict(top_k=1, temperature=5.0), dict(temperature=0.0)):
        got = tlm.sample_logits(torch.from_numpy(x), torch.Generator().manual_seed(0), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got == 7).all()


@pytest.mark.parametrize("kw", [dict(top_k=5), dict(top_k=5, top_p=0.5, temperature=0.7),
                                dict(min_p=0.2, temperature=1.3), dict(top_p=0.6),
                                dict(temperature=0.5)])
def test_sampled_tokens_lie_in_the_filtered_support(kw):
    """200 draws a row from one generator; each lies where the filters,
    as the JAX package composes them, leave a finite logit."""
    x = _logits(15)
    xj = jnp.asarray(x)
    temp, k = kw.get("temperature", 1.0), kw.get("top_k", 0)
    if k:
        kth = np.sort(x, -1)[:, -k][:, None]
        xj = jnp.where(xj < kth, -jnp.inf, xj) / temp
        support = jlm.top_p_filter(xj, kw.get("top_p", 0.0))
    elif kw.get("min_p"):
        support = jlm.min_p_filter(xj, kw["min_p"]) / temp
    else:
        support = jlm.top_p_filter(xj / temp, kw.get("top_p", 0.0))
    allowed = np.isfinite(np.asarray(support))
    gen = torch.Generator().manual_seed(16)
    draws = torch.stack([tlm.sample_logits(torch.from_numpy(x), gen, **kw) for _ in range(200)])
    rows = np.arange(3)[None].repeat(200, 0)
    assert allowed[rows, draws.numpy()].all()
    if kw.get("temperature") == 0.5 and len(kw) == 1:
        assert len(np.unique(draws.numpy()[:, 0])) > 1   # it does sample
    with pytest.raises(ValueError, match="Generator"):
        tlm.sample_logits(torch.from_numpy(x), None, **kw)


def _mamba_ssm_state_dict(seed, vocab, d_model, n_layer, d_state, rms_norm, dt_rank=None,
                          d_conv=4, expand=2):
    """A synthetic state dict in mamba_ssm's names and layouts, the tied
    head included."""
    rng = np.random.default_rng(seed)
    d_in = expand * d_model
    R = dt_rank or -(-d_model // 16)

    def r(*shape, scale=0.3):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    sd = {"backbone.embedding.weight": r(vocab, d_model)}
    for i in range(n_layer):
        p = f"backbone.layers.{i}."
        sd[p + "norm.weight"] = 1 + r(d_model, scale=0.1)
        if not rms_norm:
            sd[p + "norm.bias"] = r(d_model, scale=0.1)
        sd.update({p + "mixer.in_proj.weight": r(2 * d_in, d_model),
                   p + "mixer.conv1d.weight": r(d_in, 1, d_conv),
                   p + "mixer.conv1d.bias": r(d_in),
                   p + "mixer.x_proj.weight": r(R + 2 * d_state, d_in),
                   p + "mixer.dt_proj.weight": r(d_in, R),
                   p + "mixer.dt_proj.bias": r(d_in, scale=1.0) - 3.0,
                   p + "mixer.A_log": torch.log(torch.arange(1.0, d_state + 1)).repeat(d_in, 1)
                   + r(d_in, d_state, scale=0.1),
                   p + "mixer.D": 1 + r(d_in, scale=0.1),
                   p + "mixer.out_proj.weight": r(d_model, d_in)})
    sd["backbone.norm_f.weight"] = 1 + r(d_model, scale=0.1)
    if not rms_norm:
        sd["backbone.norm_f.bias"] = r(d_model, scale=0.1)
    sd["lm_head.weight"] = sd["backbone.embedding.weight"]
    return sd


@pytest.mark.parametrize("rms_norm", [True, False])
def test_hf_import_matches_jax(rms_norm, tmp_path):
    """One synthetic mamba_ssm checkpoint through the JAX importer and
    through the port's (from a directory and from the .bin): logits within
    1e-4; the port's export gives back the state dict exactly."""
    cfg = {"d_model": 16, "n_layer": 2, "vocab_size": 30, "rms_norm": rms_norm,
           "pad_vocab_size_multiple": 8, "ssm_cfg": {"d_state": 4}}
    sd = _mamba_ssm_state_dict(21, 32, 16, 2, 4, rms_norm)
    jmodel = jhf.model_from_config(cfg).clone(scan_impl="assoc")
    tokens = _tokens(22, 2, 10, 32)
    want, _ = jmodel.apply(jhf.convert_mamba_state_dict(sd, 2), jnp.asarray(tokens))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    for source in (tmp_path, tmp_path / "pytorch_model.bin"):
        model = hf_import.load_mamba_hf(str(source)).eval()
        with torch.no_grad():
            got, _ = model(torch.from_numpy(tokens).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LM_TOL)
    back = hf_import.export_mamba_state_dict(model)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_hf_import_rejects_what_it_cannot_load(tmp_path):
    sd = _mamba_ssm_state_dict(23, 16, 16, 2, 4, True)
    with pytest.raises(KeyError, match="missing"):
        hf_import.convert_mamba_state_dict({k: v for k, v in sd.items() if "A_log" not in k}, 2)
    with pytest.raises(KeyError, match="unexpected"):
        hf_import.convert_mamba_state_dict(sd, 1)
    assert "lm_head.weight" not in hf_import.convert_mamba_state_dict(sd, 2)
    with pytest.raises(FileNotFoundError, match="local path"):
        hf_import.load_mamba_hf("state-spaces/mamba-130m")
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        hf_import.load_mamba_hf(str(tmp_path))


@pytest.mark.parametrize("cfg", [
    {"d_model": 16, "n_layer": 2, "vocab_size": 30, "rms_norm": True,
     "pad_vocab_size_multiple": 8, "ssm_cfg": {"d_state": 4}},
    {"d_model": 16, "n_layer": 1, "vocab_size": 32,
     "ssm_cfg": {"d_state": 8, "d_conv": 3, "expand": 3, "dt_rank": 5}},
    {"d_model": 768, "n_layer": 24, "vocab_size": 50277, "rms_norm": True, "ssm_cfg": {}},
    {"d_model": 24, "n_layer": 1, "vocab_size": 33, "pad_vocab_size_multiple": 16,
     "rms_norm": False, "ssm_cfg": {"dt_rank": "auto"}}])
def test_model_from_config_matches_jax(cfg):
    """The vocabulary padding and every honoured field as the JAX
    importer's; the parameter shapes follow (mamba-130m: 50277 -> 50280)."""
    j, t = jhf.model_from_config(cfg), hf_import.model_from_config(cfg)
    for f in ("vocab_size", "d_model", "n_layer", "d_state", "d_conv", "expand", "dt_rank",
              "rms_norm"):
        assert getattr(t, f) == getattr(j, f), f
    mixer = t.backbone.layers[0].mixer
    assert mixer.conv1d.weight.shape == (t.expand * t.d_model, 1, t.d_conv)
    assert mixer.dt_proj.weight.shape == (t.expand * t.d_model, mixer.dt_rank)
    assert t.backbone.embedding.weight.shape == (j.vocab_size, j.d_model)


def test_model_from_config_rejects_other_mixers():
    cfg = {"d_model": 16, "n_layer": 1, "vocab_size": 32, "ssm_cfg": {"layer": "Mamba2"}}
    for fn in (jhf.model_from_config, hf_import.model_from_config):
        with pytest.raises(ValueError, match="ssm_cfg"):
            fn(cfg)


def test_init_lm_weights_follows_the_jax_init():
    """Seeded and repeatable; each parameter drawn from the JAX package's
    distribution (std, bounds and constants of `models/mamba_lm.py`'s
    initialisers; draws cannot match across frameworks): the stds within
    10% (a wrong fan-in or truncation moves one by 14% or more), the means
    within a quarter of the std."""
    model = init_lm_weights(tlm.MambaLMHeadModel(512, 128, 2, 16), seed=3)
    again = init_lm_weights(tlm.MambaLMHeadModel(512, 128, 2, 16), seed=3)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    jmodel = jlm.MambaLMHeadModel(vocab_size=512, d_model=128, n_layer=2, d_state=16)
    jp = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))["params"]
    sd = lm_state_dict_from_jax({"params": jp}, 2)
    for k, v in model.state_dict().items():
        want = sd[k]
        assert v.shape == want.shape, k
        if want.std() == 0:
            assert torch.equal(v, want), k
            continue
        np.testing.assert_allclose(float(v.std()), float(want.std()), rtol=0.1, err_msg=k)
        assert float(v.abs().max()) <= 1.05 * float(want.abs().max()) + 1e-6 or "embedding" in k, k
        np.testing.assert_allclose(float(v.mean()), float(want.mean()),
                                   atol=0.25 * float(want.std()), err_msg=k)
