"""The bf16 designs of the LN-mean forward and backward CUDA kernels, on the CPU.

The kernels (`fusionmamba_torch/csrc/ln_mean_fwd.cu::lnm_fwd_kernel_quads`,
`layer_norm_bwd.cu::lnm_bwd_one_launch`) run only on the card, where
tests/test_torch_kernels.py holds them against their plain versions. Their
layouts come from Python (`layer_norm.lnm_fwd_plan` and `lnm_bwd_plan` with
io=bf16), and here those plans are checked at the LN-mean's shapes of the
full config (serving batch 8; the fusion step's 6 pairs and the segmentation
steps' batches, `chip_smoke.main_path_calls`, `train_calls`) and at ragged
and masked ones: the walks visit every row of a batch row once, a row's quads
hold every channel once, the templates fill their lanes at the model's
widths, each plan names a variant the source compiles (FM_LN_BF16_TEMPLATES,
read from `csrc/ln_common.cuh`) and its constants are the source's, and the
quads are taken only where C is a multiple of 4 and the tensors are on an
8-byte boundary. Plain-PyTorch replays of the two kernels' arithmetic and
order of summation (kept here, not in the package) - the backward's two
tails, which sum the partials into dscale in the same launch, included - are
held against the plain version (its autograd for the backward) and the JAX
package's Pallas LN-mean, run in interpret mode as its own tests run it.
Inputs come from numpy seeds, rounded to bf16 values and passed to every side
as fp32.

Tolerance. The replays sum per lane, per group, per block and over blocks or
slices in other orders than the plain version and the Pallas kernel: float32
sums of at most a few thousand terms of both signs of magnitude about 1, so
the mean is held to 1e-5 absolute and relative and each gradient to 1e-5 of
its own largest entry plus 1e-5 relative, the existing tolerances.
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SEG_PAIRS, main_path_calls, train_calls
from fusionmamba_torch.config import full_config
from fusionmamba_torch.ops import layer_norm
from fusionmamba_tpu.ops import ln_pallas

BF = torch.bfloat16
CSRC = Path(layer_norm.__file__).resolve().parent.parent / "csrc"
_VARIANTS = {(int(q), int(g), m == "true") for q, g, m in re.findall(
    r"Q\((\d+), (\d+), (true|false)\)", (CSRC / "ln_common.cuh").read_text())}
# one row, rows that leave groups idle, masked quads (C = 40, 48, 100, 1000,
# 6144: 32, 128 and 512 lanes), a long batch row of the narrowest width
_RAGGED = [(1, 1, 24), (3, 37, 96), (2, 37, 48), (5, 1, 100), (2, 300, 1000), (1, 37, 100),
           (4, 1, 48), (1, 5000, 24), (2, 9, 40), (2, 3, 6144)]
STATIC_SMEM = 48 * 1024           # a block's static shared memory at most
TOL = dict(rtol=1e-5, atol=1e-5)


def _shapes():
    """The LN-mean's shapes on the serving path (batch 8) and in the fusion
    (batch 6) and segmentation training steps."""
    shapes = set(main_path_calls(full_config(), 8, 256)["ln_mean"])
    for pairs in (6, *SEG_PAIRS):
        shapes |= set(train_calls(full_config(), pairs, 256)["ln_mean"])
    assert len(shapes) == 24
    return sorted(shapes)


def _quad_channels(plan):
    """(lanes, values) channel of each of a lane's values: quad q of lane l
    holds channels 4 (l + q lanes) .. + 3."""
    lane = torch.arange(plan.lanes)[:, None]
    v = torch.arange(plan.values)[None, :]
    return 4 * (lane + v // 4 * plan.lanes) + v % 4


def _fwd_walk(plan, rows):
    """Rows of each (block of the cluster, group) of one batch row, in the
    order the group visits them."""
    chunk = plan.groups * plan.unroll
    for p in range(plan.cluster):
        for g in range(plan.groups):
            yield p, g, [r for base in range(p * chunk, rows, plan.cluster * chunk)
                         for r in range(base + g, base + chunk, plan.groups) if r < rows]


def _bwd_walk(plan, rows):
    """Rows of each (block, group) of one batch row, in the kernel's order."""
    for p in range(plan.blocks):
        for grp in range(plan.rows_per_step):
            yield p, grp, list(range(p * plan.rows_per_step + grp, rows,
                                     plan.blocks * plan.rows_per_step))


def _held_once(plan, C):
    chans = _quad_channels(plan)
    held = np.bincount(chans[chans < C].numpy(), minlength=C)
    return (held == 1).all()


def _consts(name):
    src = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_bf16_plan_constants_are_the_source_s():
    assert _consts("ln_mean_fwd.cu")["kQuadRows"] == layer_norm.FWD_QUAD_ROWS
    assert _consts("layer_norm_bwd.cu")["kOneBlock"] == layer_norm.ONE_BLOCK
    assert len(_VARIANTS) == 9 and layer_norm.BF16_QUADS == 3


@pytest.mark.parametrize("B,rows,C", _shapes() + _RAGGED)
def test_lnm_fwd_bf16_plan_visits_each_row_and_element_once(B, rows, C):
    for sms in (132, 1):
        plan = layer_norm.lnm_fwd_plan(B, rows, C, sms, io=BF)
        assert plan.quads and plan.values == 4 * layer_norm.BF16_QUADS
        assert (plan.values // 4, plan.lanes, plan.masked) in _VARIANTS
        assert plan.masked == (C not in layer_norm.BF16_TEMPLATES)
        assert plan.values * plan.lanes >= C
        assert plan.threads == max(layer_norm.FWD_BLOCK, plan.lanes) <= 1024
        assert plan.groups * plan.lanes == plan.threads
        # rows a group loads at a time: FWD_QUAD_ROWS, halved only while the
        # batch row has fewer chunks than its cluster wants
        want = min(layer_norm.FWD_MAX_CLUSTER,
                   math.ceil(layer_norm.BF16_FWD_BLOCKS_PER_SM * sms / B))
        assert plan.unroll in (1, 2, 4) and plan.unroll <= layer_norm.FWD_QUAD_ROWS
        chunks = math.ceil(rows / (plan.groups * plan.unroll))
        assert plan.unroll == layer_norm.FWD_QUAD_ROWS or chunks < 2 * want
        assert plan.unroll == 1 or chunks >= want
        assert 1 <= plan.cluster <= min(layer_norm.FWD_MAX_CLUSTER, chunks)
        assert plan.cluster & (plan.cluster - 1) == 0 and B <= 65535
        seen = np.zeros(rows, np.int32)
        for _, _, visited in _fwd_walk(plan, rows):
            assert visited == sorted(visited)
            seen[visited] += 1
        assert (seen == 1).all(), (B, rows, C, sms, plan)
        assert _held_once(plan, C), (C, plan)
        # red (two sets of U rows' warp sums where a row spans warps), each
        # group's column sums where a block has several, the block's sums
        T, G, CW = plan.threads, plan.lanes, plan.values * plan.lanes
        smem = (2 * (plan.unroll * T // 32 if G > 32 else 1) * 8
                + (plan.groups * CW * 4 if plan.groups > 1 else 16) + CW * 4)
        assert smem <= STATIC_SMEM


@pytest.mark.parametrize("B,rows,C", _shapes() + _RAGGED)
def test_lnm_bwd_bf16_plan_visits_each_row_and_element_once(B, rows, C):
    for sms in (132, 1):
        plan = layer_norm.lnm_bwd_plan(B, rows, C, sms, io=BF)
        assert plan.quads and plan.values == 4 * layer_norm.BF16_QUADS
        assert (plan.values // 4, plan.lanes, plan.masked) in _VARIANTS
        assert plan.masked == (C not in layer_norm.BF16_TEMPLATES)
        assert plan.threads == max(layer_norm.ONE_BLOCK, plan.lanes) <= 1024
        assert plan.rows_per_step * plan.lanes == plan.threads
        assert 1 <= plan.blocks <= rows and B <= 65535
        seen = np.zeros(rows, np.int32)
        for _, _, visited in _bwd_walk(plan, rows):
            seen[visited] += 1
        assert (seen == 1).all(), (B, rows, C, sms, plan)
        assert _held_once(plan, C), (C, plan)
        # red and, where a block has several groups, w
        T, G, CW = plan.threads, plan.lanes, plan.values * plan.lanes
        smem = 3 * (T // 32) * 8 + (CW * 4 if T // G > 1 else 16)
        assert smem <= STATIC_SMEM


def test_lnm_bf16_plans_fill_lanes_and_the_card():
    """Every model width has a quads template with every lane busy (12 values
    a lane, C / 12 lanes); the forward's clusters put within a factor of two
    of BF16_FWD_BLOCKS_PER_SM blocks an SM on 132 SMs wherever the rows have
    chunks enough; the backward's grid puts a block on each SM wherever the
    rows have steps enough, and no more than its BF16_LNM_BWD_BLOCKS_PER_SM."""
    for B, rows, C in _shapes():
        fwd = layer_norm.lnm_fwd_plan(B, rows, C, io=BF)
        bwd = layer_norm.lnm_bwd_plan(B, rows, C, io=BF)
        for plan in (fwd, bwd):
            assert plan.quads and not plan.masked and plan.values * plan.lanes == C, C
        chunks = math.ceil(rows / (fwd.groups * fwd.unroll))
        most = min(layer_norm.BF16_FWD_BLOCKS_PER_SM * 132, B * chunks,
                   B * layer_norm.FWD_MAX_CLUSTER)
        assert most / 2 < B * fwd.cluster <= max(B, most), (B, rows, C, fwd)
        steps = math.ceil(rows / bwd.rows_per_step)
        assert min(132, B * steps) <= B * bwd.blocks, (B, rows, C, bwd)
        assert bwd.blocks <= math.ceil(layer_norm.BF16_LNM_BWD_BLOCKS_PER_SM * 132 / B)


@pytest.mark.parametrize("C,aligned,quads", [(96, True, True), (96, False, False),
                                             (40, True, True), (30, True, False),
                                             (3, True, False), (1000, False, False)])
def test_lnm_bf16_plans_take_quads_only_on_8_byte_runs(C, aligned, quads):
    """The quads need C a multiple of 4 and x (and dx) on an 8-byte boundary;
    else the strided templates in bf16, the fp32 plans, and fp32 never."""
    fwd = layer_norm.lnm_fwd_plan(3, 64, C, io=BF, aligned=aligned)
    bwd = layer_norm.lnm_bwd_plan(3, 64, C, io=BF, aligned=aligned)
    assert fwd.quads == bwd.quads == quads
    if not quads:
        assert fwd == layer_norm.lnm_fwd_plan(3, 64, C)
        assert bwd == layer_norm.lnm_bwd_plan(3, 64, C)
    assert not layer_norm.lnm_fwd_plan(3, 64, C).quads
    assert not layer_norm.lnm_bwd_plan(3, 64, C).quads


def _group_sum(v, G):
    """The kernels' sums over a group of G lanes of v (n, G): xor butterflies
    inside a warp, then the warps in order; every lane the same bits."""
    off = min(G, 32) // 2
    while off:
        v = v + v[:, torch.arange(G) ^ off]
        off //= 2
    if G > 32:
        total = v[:, 0]
        for i in range(1, G // 32):
            total = total + v[:, 32 * i]
        v = total[:, None].expand(-1, G)
    return v


def _lanes(t, plan, C):
    """t (..., C) as (..., lanes, values) on the quads, zero past C."""
    chans = _quad_channels(plan)
    return t[..., chans.clamp(max=C - 1)] * (chans < C).float()


def _row_sums(xv, G):
    """Per row the sums of x and x^2 over a lane's values in quad order, then
    over the group: xv (B, rows, G, V) -> two (B, rows, 1, 1)."""
    B, rows, _, V = xv.shape
    s1, s2 = torch.zeros(B, rows, G), torch.zeros(B, rows, G)
    for v in range(V):
        s1, s2 = s1 + xv[..., v], s2 + xv[..., v] * xv[..., v]
    return [_group_sum(s.reshape(-1, G), G).reshape(B, rows, G)[..., :1, None]
            for s in (s1, s2)]


def _scatter(t, plan, C):
    """(..., lanes, values) back to (..., C)."""
    chans = _quad_channels(plan)
    live = chans < C
    out = torch.zeros(t.shape[:-2] + (C,))
    out[..., chans[live]] = t[..., live]
    return out


def _slices_sum(part, n):
    """part (P, C) summed as n interleaved slices, each in order, then the
    slices in order."""
    slices = torch.zeros((n,) + part.shape[1:])
    for p in range(part.shape[0]):
        slices[p % n] += part[p]
    total = slices[0]
    for y in range(1, n):
        total = total + slices[y]
    return total


def _fwd_replay(x, scale, bias, eps, plan):
    """lnm_fwd_kernel_quads in plain PyTorch: per row the fast variance from
    the sums of x and x^2 (times 1 / C), xhat summed per group over its rows
    in walk order, per block over its groups in order, over the cluster's
    blocks in rank order; then m = sum / rows * scale + bias, and the mean of
    xhat, sum / rows, which the forward writes for the backward."""
    B, rows, C = x.shape
    xv = _lanes(x, plan, C)
    s1, s2 = _row_sums(xv, plan.lanes)
    inv_c = torch.tensor(1.0 / C, dtype=torch.float32)
    mu = s1 * inv_c
    xh = (xv - mu) * torch.rsqrt(s2 * inv_c - mu * mu + eps) * (_quad_channels(plan) < C)
    out, xmean = torch.empty(B, C), torch.empty(B, C)
    for b in range(B):
        blocks = [None] * plan.cluster
        for p, g, visited in _fwd_walk(plan, rows):
            acc = torch.zeros(plan.lanes, plan.values)
            for r in visited:
                acc = acc + xh[b, r]
            blocks[p] = acc if g == 0 else blocks[p] + acc
        t = blocks[0]
        for p in range(1, plan.cluster):
            t = t + blocks[p]
        out[b] = _scatter(t, plan, C) / rows * scale + bias
        xmean[b] = _scatter(t, plan, C) / rows
    return out, xmean


def _bwd_replay(x, scale, dm, eps, plan, xmean):
    """lnm_bwd_one_launch in plain PyTorch: w = dm * scale / rows and its
    mean; per row dx from the row's sums; dscale the sum over b of dm[b]
    times the forward's mean of xhat `xmean`, dbias the sum of dm over b,
    each in b order."""
    B, rows, C = x.shape
    G, live = plan.lanes, (_quad_channels(plan) < C).float()
    w = _lanes(dm * scale / rows, plan, C)                       # (B, G, V)
    m1 = torch.zeros(B, G)
    for v in range(plan.values):
        m1 = m1 + w[..., v]
    m1 = _group_sum(m1, G)[:, :1, None, None] / C                # (B, 1, 1, 1)
    xv = _lanes(x, plan, C)
    s1, s2 = _row_sums(xv, G)
    mu = s1 / C
    rs = torch.rsqrt(s2 / C - mu * mu + eps)
    xh = (xv - mu) * rs * live
    n = torch.zeros(B, rows, G)
    for v in range(plan.values):
        n = n + w[:, None, :, v] * xh[..., v]
    m2 = _group_sum(n.reshape(-1, G), G).reshape(B, rows, G)[..., :1, None] / C
    dx = _scatter(rs * (w[:, None] - m1 - xh * m2), plan, C)
    ds, db = torch.zeros(C), torch.zeros(C)
    for b in range(B):
        ds = ds + dm[b] * xmean[b]
        db = db + dm[b]
    return dx, ds, db


def _bf16_values(rng, *shape, scale=1.0, shift=0.0):
    """numpy normal values rounded to bf16, as fp32."""
    a = (scale * rng.standard_normal(shape) + shift).astype(np.float32)
    return torch.from_numpy(a).to(BF).float()


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


# a block of one group (1536: 128 lanes; 6144 masked: 512), clusters of 1 to
# 4 blocks, ragged rows, masked widths (40, 100, 1000), one row
@pytest.mark.parametrize("B,rows,C,sms", [(2, 64, 96, 1), (3, 37, 96, 132), (2, 50, 40, 2),
                                          (6, 64, 384, 132), (1, 300, 24, 132), (2, 40, 768, 4),
                                          (2, 64, 1536, 132), (2, 9, 1000, 1), (5, 1, 100, 132),
                                          (1, 3, 6144, 132), (2, 300, 96, 132)])
def test_lnm_fwd_bf16_replay_matches_plain_and_pallas(B, rows, C, sms):
    rng = np.random.default_rng(B * rows + C + 3)
    x = _bf16_values(rng, B, rows, C, scale=2.0, shift=0.5)
    s, b = _bf16_values(rng, C, scale=0.2, shift=1.0), _bf16_values(rng, C, scale=0.2)
    plan = layer_norm.lnm_fwd_plan(B, rows, C, sms, io=BF)
    assert plan.quads
    got, xmean = _fwd_replay(x, s, b, 1e-5, plan)
    got = got.numpy()
    xh = (x - x.mean(2, keepdim=True)) * torch.rsqrt(x.var(2, unbiased=False, keepdim=True) + 1e-5)
    np.testing.assert_allclose(xmean, xh.mean(1), **TOL)
    np.testing.assert_allclose(got, layer_norm.ln_spatial_mean_plain(x, s, b, 1e-5), **TOL)
    want = ln_pallas._lnm_core(jnp.asarray(x.numpy()), jnp.asarray(s.numpy()),
                               jnp.asarray(b.numpy()), 1e-5, True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_lnm_fwd_bf16_replay_at_a_training_shape_with_a_cluster():
    """A full-width training shape's plan (the fusion step's (6, 1024, 192),
    a cluster of several blocks) on two batch rows, against the plain
    version."""
    rng = np.random.default_rng(12)
    x = _bf16_values(rng, 2, 1024, 192, scale=2.0, shift=0.5)
    s, b = _bf16_values(rng, 192, scale=0.2, shift=1.0), _bf16_values(rng, 192, scale=0.2)
    plan = layer_norm.lnm_fwd_plan(6, 1024, 192, io=BF)
    assert plan.cluster > 1
    np.testing.assert_allclose(_fwd_replay(x, s, b, 1e-5, plan)[0],
                               layer_norm.ln_spatial_mean_plain(x, s, b, 1e-5), **TOL)


# one block a batch row and many, ragged rows, masked widths, the fusion
# step's small shapes
_BWD_CASES = [(2, 64, 96, 1), (3, 37, 96, 132), (2, 50, 40, 2), (6, 16, 384, 4), (1, 300, 24, 1),
              (6, 256, 384, 132), (12, 64, 768, 132), (2, 9, 1000, 1), (5, 37, 100, 132),
              (1, 5, 6144, 132), (4, 130, 192, 16), (4, 300, 96, 132)]


@pytest.mark.parametrize("B,rows,C,sms", _BWD_CASES)
def test_lnm_bwd_bf16_replay_matches_autograd_and_pallas(B, rows, C, sms):
    rng = np.random.default_rng(B * rows + C + 4)
    x = _bf16_values(rng, B, rows, C, scale=2.0, shift=0.5)
    s, b = _bf16_values(rng, C, scale=0.2, shift=1.0), _bf16_values(rng, C, scale=0.2)
    dm = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32))
    plan = layer_norm.lnm_bwd_plan(B, rows, C, sms, io=BF)
    assert plan.quads
    _, xmean = _fwd_replay(x, s, b, 1e-5, layer_norm.lnm_fwd_plan(B, rows, C, sms, io=BF))
    got = [g.numpy() for g in _bwd_replay(x, s, dm, 1e-5, plan, xmean)]

    live = [t.clone().requires_grad_(True) for t in (x, s, b)]
    want = torch.autograd.grad(layer_norm.ln_spatial_mean_plain(*live, 1e-5), live, dm)
    _close(got, [w.numpy() for w in want])
    _, vjp = jax.vjp(lambda *a: ln_pallas.ln_spatial_mean(*a, 1e-5, interpret=True),
                     *(jnp.asarray(t.numpy()) for t in (x, s, b)))
    _close(got, vjp(jnp.asarray(dm.numpy())))


def test_lnm_bwd_bf16_replays_walk_one_and_several_row_steps():
    """The replays above run plans whose blocks take one row step of their
    batch row and plans whose blocks walk several (the next row loaded
    ahead)."""
    steps = []
    for B, rows, C, sms in _BWD_CASES:
        plan = layer_norm.lnm_bwd_plan(B, rows, C, sms, io=BF)
        steps.append(math.ceil(rows / (plan.rows_per_step * plan.blocks)))
    assert min(steps) == 1 and max(steps) > 1


def test_lnm_bf16_ab_needs_trees_and_a_card():
    """The A/B timing tool asks for at least one checkout, and without a
    card exits before it starts any process."""
    from fusionmamba_torch.tools import lnm_bf16_ab

    with pytest.raises(SystemExit):
        lnm_bf16_ab.main([])
    with pytest.raises(SystemExit, match="no CUDA device"):
        lnm_bf16_ab.main(["."])
