"""The bf16 dwconv forward's layout and arithmetic, and the parameter-dtype
rule of the LN, LN-mean and dwconv kernels, on the CPU.

The bf16 forward kernel (`fusionmamba_torch/csrc/dwconv3x3_fwd.cu::
dwconv3x3_fwd_kernel_bf16`) runs only on the card, where
tests/test_torch_kernels.py holds it against its plain version. Its layout
comes from `dwconv.fwd_plan(..., io=bf16)`, checked here at every serving,
training and segmentation shape of the full config and at ragged ones: the
tiles cover every output exactly once within the kernel's thread and
shared-memory limits, and each plan names an instance the source compiles.
A plain-PyTorch replay of the kernel's bf16 staging (x as bf16 quads of
channels, zeros outside the image and past C) and of its walk (each staged
row widened to fp32 as it is read, the taps of the halo rows' outputs
skipped), is held against the plain version and against the JAX package's
Pallas kernel in interpret mode, as its own tests run it. Inputs come from
numpy seeds.

Tolerances. The replay adds the same fp32 products in the same order as
`depthwise_conv3x3_plain` (taps row by row, then the bias, then the SiLU
over the whole tensor), on the same values (a bf16 value widened to fp32 is
exact), so the two agree bit for bit once rounded to bf16; against the
Pallas kernel (another order, its own bf16 rounding) to the JAX package's
bf16 tolerance, 3e-2 relative and 3e-2 of the largest entry.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fusionmamba_torch.ops import cuda_lib, dwconv
from fusionmamba_tpu.ops import dwconv_pallas
from test_torch_dwconv_ln_plans import _DW_RAGGED, SMEM_PER_BLOCK, _model_shapes

CSRC = Path(dwconv.__file__).resolve().parent.parent / "csrc"
BF = torch.bfloat16
# the channel quads a block (cq) of the bf16 kernel's instances
_BF16_CQ = {int(cq) for cq in re.findall(r"case (\d+): return launch_bf16<\1>",
                                         (CSRC / "dwconv3x3_fwd.cu").read_text())}


def _tiles(plan, B, H, W, C):
    """(b, h slice, w slice, c slice) of the outputs each block writes."""
    gx, gy, gz = plan.grid
    h_tiles, cb = gz // B, 4 * plan.cq
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                b, ht = divmod(bz, h_tiles)
                yield (b, slice(ht * plan.th, min(H, (ht + 1) * plan.th)),
                       slice(by * plan.tw, min(W, (by + 1) * plan.tw)),
                       slice(cb * bx, min(C, cb * (bx + 1))))


def test_bf16_instances_parsed():
    assert _BF16_CQ == {1, 2, 4, 8, 16}


@pytest.mark.parametrize("rows", [8, 16, 32])
@pytest.mark.parametrize("shape", _model_shapes("dwconv") + _DW_RAGGED)
def test_dwconv_fwd_bf16_plan_covers_each_output_once(shape, rows, monkeypatch):
    """At the plan's rows of a tile and at others (the sweep's): every
    output once, within a block's threads and the kernel's shared memory
    (8 bytes a staged quad of channels), and an instance the source
    compiles."""
    B, H, W, C = shape
    monkeypatch.setattr(dwconv, "BF16_FWD_MAX_ROWS", rows)
    for sms in (132, 1):
        plan = dwconv.fwd_plan(B, H, W, C, sms=sms, io=BF)
        assert plan.cq in _BF16_CQ
        assert plan.threads == plan.cq * plan.tw <= dwconv.FWD_MAX_THREADS
        assert 1 <= plan.th <= rows
        assert plan.smem_bytes == (plan.th + 2) * (plan.tw + 2) * plan.cq * 8
        assert plan.smem_bytes <= min(dwconv.FWD_MAX_SMEM, SMEM_PER_BLOCK)
        assert plan.grid[2] % B == 0 and max(plan.grid[1:]) <= 65535
        count = np.zeros(shape, np.int8)
        for b, hs, ws, cs in _tiles(plan, *shape):
            count[b, hs, ws, cs] += 1
        assert (count == 1).all(), (shape, sms, plan)


def test_dwconv_fwd_bf16_plan_at_model_shapes():
    """At every model shape a thread moves whole quads (8 bytes, no masked
    staging), the grid gives each of 132 SMs at least one block and th /
    BF16_FWD_ROWS_PER_BLOCK (the rule's tiles of 2 to 16 rows), tiles are
    at least as tall as fp32's, and the fp32 plan keeps 16 bytes a quad."""
    for shape in _model_shapes("dwconv"):
        plan, f32 = dwconv.fwd_plan(*shape, io=BF), dwconv.fwd_plan(*shape)
        assert shape[-1] % (4 * plan.cq) == 0, shape
        assert 2 <= plan.th <= dwconv.BF16_FWD_MAX_ROWS, (shape, plan)
        blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
        assert blocks >= max(1, plan.th / dwconv.BF16_FWD_ROWS_PER_BLOCK) * 132, (shape, plan)
        assert (plan.cq, plan.tw) == (f32.cq, f32.tw) and plan.th >= f32.th, (plan, f32)
        assert f32.smem_bytes == (f32.th + 2) * (f32.tw + 2) * f32.cq * 16


def _staged_bf16(x, b, h0, w0, c0, plan):
    """The block's staged tile as the kernel writes it: bf16 quads of
    channels, zero outside the image and past C, as (th+2, tw+2, channels)
    bf16."""
    B, H, W, C = x.shape
    cb = 4 * plan.cq
    tile = torch.zeros(plan.th + 2, plan.tw + 2, cb, dtype=BF)
    for k in range(plan.th + 2):
        hh = h0 - 1 + k
        if 0 <= hh < H:
            lo, hi = max(w0 - 1, 0), min(w0 + plan.tw + 1, W)
            cs = slice(c0, min(C, c0 + cb))
            tile[k, lo - (w0 - 1):hi - (w0 - 1), :cs.stop - c0] = x[b, hh, lo:hi, cs]
    return tile


def _dwconv_bf16_replay(x, w, bias, plan):
    """The bf16 kernel's arithmetic in plain PyTorch, up to the activation, in
    fp32: each block stages its bf16 tile, then walks down it, widening each
    staged row k to fp32 as it reads it and feeding the three output rows it
    touches (weight row 0 of output k, 1 of k - 1, 2 of k - 2), only those
    of the tile's outputs 0 .. th - 1; w and bias widened from their dtype
    as they are loaded."""
    B, H, W, C = x.shape
    out = torch.full(x.shape, float("nan"))
    cb = 4 * plan.cq
    for b, hs, ws, cs in _tiles(plan, B, H, W, C):
        h0, w0, c0 = hs.start, ws.start, cs.start
        tile = _staged_bf16(x, b, h0, w0, c0, plan)
        wt = torch.zeros(3, 3, cb)
        wt[:, :, :cs.stop - c0] = w[:, :, cs].float()
        bv = torch.zeros(cb)
        if bias is not None:
            bv[:cs.stop - c0] = bias[cs].float()
        acc = [torch.zeros(plan.tw, cb), torch.zeros(plan.tw, cb)]   # outputs k-2, k-1
        for k in range(plan.th + 2):
            v = [tile[k, j:j + plan.tw].float() for j in range(3)]
            new = torch.zeros(plan.tw, cb)
            for i, a, o in ((0, new, k), (1, acc[1], k - 1), (2, acc[0], k - 2)):
                if 0 <= o < plan.th:
                    for j in range(3):
                        a += v[j] * wt[i, j]
            if k >= 2 and h0 + k - 2 < H:
                y = acc[0] + bv
                out[b, h0 + k - 2, ws, cs] = y[:ws.stop - w0, :cs.stop - c0]
            acc = [acc[1], new]
    return out


@pytest.mark.parametrize("rows", [1, 16])
@pytest.mark.parametrize("params", [BF, torch.float32])
@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
@pytest.mark.parametrize("shape,sms", [((2, 5, 7, 3), 132), ((3, 9, 13, 6), 1),
                                       ((2, 11, 19, 40), 1), ((1, 1, 1, 8), 132),
                                       ((1, 17, 9, 64), 2), ((2, 6, 10, 24), 1)])
def test_dwconv_bf16_replay_matches_plain_and_pallas(shape, sms, act, has_bias, params, rows,
                                                     monkeypatch):
    """bf16 x; w and the bias bf16 (a bf16 step's casts, read as they are)
    or fp32: the replay rounded to bf16 equals the plain version bit for bit
    (before the SiLU and after it), and agrees with the Pallas kernel in
    interpret mode on the same bf16 values."""
    monkeypatch.setattr(dwconv, "BF16_FWD_MAX_ROWS", rows)
    rng = np.random.default_rng(sum(shape) + rows)
    f = np.float32
    C = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(f)).to(BF)
    w = torch.from_numpy((0.3 * rng.standard_normal((3, 3, C))).astype(f)).to(params)
    b = torch.from_numpy(rng.standard_normal(C).astype(f)).to(params) if has_bias else None
    pre = _dwconv_bf16_replay(x, w, b, dwconv.fwd_plan(*shape, sms=sms, io=BF))
    assert not torch.isnan(pre).any()
    # the SiLU over the whole tensor at once, as the plain version takes it
    # (the CPU's vectorised and scalar paths of exp may differ in the last bit)
    got = (F.silu(pre) if act == "silu" else pre).to(BF)
    assert torch.equal(pre.to(BF), dwconv.depthwise_conv3x3_plain(x, w, b, "none"))
    assert torch.equal(got, dwconv.depthwise_conv3x3_plain(x, w, b, act))
    want = dwconv_pallas.depthwise_conv3x3(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w.float().numpy()),
        None if b is None else jnp.asarray(b.float().numpy()), impl="pallas", interpret=True,
        act=act)
    want = np.asarray(want, f)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("io,params,want", [
    (BF, [BF, BF], BF),                       # a bf16 step: read as they are
    (BF, [BF, None], BF),                     # a conv without bias
    (BF, [torch.float32, torch.float32], torch.float32),
    (BF, [BF, torch.float32], torch.float32),  # mixed: both cast to fp32
    (BF, [torch.float32, BF], torch.float32),
    (torch.float32, [BF, BF], torch.float32),  # fp32 activations take fp32 parameters
    (torch.float32, [torch.float32, None], torch.float32),
    (torch.float16, [torch.float16], torch.float32),
])
def test_param_dtype_rule(io, params, want):
    """The one rule of the LN, LN-mean and dwconv ops and wrappers: bf16
    parameters are read as they are only beside bf16 activations, and only
    where every parameter given is bf16."""
    ts = [None if p is None else torch.zeros(3, dtype=p) for p in params]
    assert cuda_lib.param_dtype(io, *ts) == want


def test_param_dtype_rule_is_shared():
    """The ops keep no rule of their own: the LN module's former helper is
    gone, and every wrapper asks cuda_lib."""
    from fusionmamba_torch.ops import layer_norm, ln_triton

    assert not hasattr(layer_norm, "_param_dtype")
    for mod in (layer_norm, ln_triton, dwconv):
        src = Path(mod.__file__).read_text()
        assert "params=[" in src or "param_dtype(" in src, mod.__name__


@pytest.mark.parametrize("argv,match", [
    ([], None), (["--forward"], None), (["--ln"], None), (["--sweep", "."], None),
    (["--forward", "--ln", "."], None), (["."], "no CUDA device"),
    (["--forward", "."], "no CUDA device"), (["--forward", "--sweep", "."], "no CUDA device"),
    (["--ln", "."], "no CUDA device")])
def test_dwconv_ab_exits_without_trees_or_a_card(argv, match):
    """The A/B tool asks for at least one checkout, one mode, and --sweep only
    with --forward; without a card it exits before it starts any process."""
    from fusionmamba_torch.tools import dwconv_bwd_ab

    with pytest.raises(SystemExit, match=match):
        dwconv_bwd_ab.main(argv)


def test_ab_identical_compares_every_output_bit_for_bit(tmp_path):
    """The A/B harness's bit check: a tree is identical to the first only if
    every output, fp32 and not, is equal to the first's; a last-bit change
    (which the relative diff can round away) counts."""
    from fusionmamba_torch.tools import _ab

    ref = {"[1]": [torch.tensor([4.0, -2.0])], "fp32 [1]": [torch.tensor([1.0, 2.0])]}
    bump = torch.tensor([1.0, 2.0]).view(torch.int32).add(1).view(torch.float32)
    outs = {"a": ref, "b": {**ref}, "c": {**ref, "fp32 [1]": [bump]},
            "d": {**ref, "[1]": [torch.tensor([4.0, -2.0], dtype=torch.bfloat16)]}}
    for name, o in outs.items():
        torch.save(o, tmp_path / f"{name}.pt")
    got = _ab.identical({n: tmp_path / f"{n}.pt" for n in outs})
    assert got == {"a": True, "b": True, "c": False, "d": False}
