"""The layouts of the dwconv backward and LN-mean backward CUDA kernels, on the CPU.

The kernels (`fusionmamba_torch/csrc/dwconv3x3_bwd.cu`, `layer_norm_bwd.cu`'s
`lnm_bwd_kernel`) run only on the card, where tests/test_torch_kernels.py
holds them against autograd of their plain versions. Their layouts come from
Python (`dwconv.bwd_plan`, `layer_norm.lnm_bwd_plan`), and here those plans
are checked at every training shape of the full config
(`chip_smoke.train_calls`) and at ragged ones: the dwconv's tile walk covers
every output exactly once within the kernel's limits, the LN-mean's walk
visits every row of every batch row exactly once, and each plan names a
variant the source compiles. Plain-PyTorch replays of the two kernels'
arithmetic and order of summation (kept here, not in the package) are held
against autograd of the plain versions and against the JAX package's Pallas
kernels, run in interpret mode as its own tests run them. Inputs come from
numpy seeds.

Tolerances. Both replays sum dw, dbias and dscale over many positions in
another order than autograd and the Pallas kernels (per tile column or row
group, per block, then interleaved slices of the blocks), sums of many
terms of both signs, so each gradient is held to 1e-5 of its own largest
entry plus 1e-5 relative; dx has few terms and meets the same bound.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import SEG_PAIRS, train_calls
from fusionmamba_torch.config import full_config
from fusionmamba_torch.ops import dwconv, layer_norm
from fusionmamba_tpu.ops import dwconv_pallas, ln_pallas

CSRC = Path(dwconv.__file__).resolve().parent.parent / "csrc"
SMEM_PER_BLOCK = 227 * 1024      # H100: the most a block can use
DW_SLICES = 8                    # the reduce kernels' interleaved slices
LNM_SLICES = 32
GRAD_RTOL = GRAD_SCALED_ATOL = 1e-5


def _train_shapes(kernel, batches=(6,)):
    """The shapes of `kernel` in a training step of each batch: the fusion
    step's 6 by default, with SEG_PAIRS the segmentation steps' too."""
    shapes = set()
    for pairs in batches:
        shapes |= set(train_calls(full_config(), pairs, 256)[kernel])
    assert shapes
    return sorted(shapes)


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALED_ATOL * float(np.abs(w).max()))


def _slices_sum(part, n):
    """The reduce kernels' order: part (P, ...) summed as n interleaved
    slices, each in order, then the slices in order."""
    slices = torch.zeros((n,) + part.shape[1:])
    for p in range(part.shape[0]):
        slices[p % n] += part[p]
    total = slices[0]
    for y in range(1, n):
        total = total + slices[y]
    return total


# ---------------------------------------------------------------------------
# dwconv backward: the tile walk of bwd_plan
# ---------------------------------------------------------------------------

_DW_RAGGED = [(2, 5, 7, 3), (3, 9, 13, 6), (2, 11, 19, 40), (1, 1, 1, 8), (1, 1, 1, 3),
              (2, 3, 70, 192), (1, 17, 9, 64), (5, 33, 31, 200)]
_DW_CQ = tuple(int(n) for n in re.findall(r"case (\d+): err = launch<",
                                          (CSRC / "dwconv3x3_bwd.cu").read_text()))


def _dw_walk(plan, B, H, W):
    """(block y, b, h0, w0) of each tile, in each block's order."""
    h_tiles, w_tiles = -(-H // plan.th), -(-W // plan.tw)
    for py in range(plan.grid[1]):
        for t in range(py, plan.tiles, plan.grid[1]):
            b, rem = divmod(t, h_tiles * w_tiles)
            yield py, b, rem // w_tiles * plan.th, rem % w_tiles * plan.tw


@pytest.mark.parametrize("shape", _train_shapes("dwconv_bwd", (6, *SEG_PAIRS)) + _DW_RAGGED)
def test_dwconv_bwd_plan_covers_each_output_once(shape):
    B, H, W, C = shape
    assert len(_DW_CQ) == 5
    for sms in (132, 1):
        plan = dwconv.bwd_plan(B, H, W, C, sms=sms)
        assert plan.cq in _DW_CQ and plan.threads == plan.cq * plan.tw
        assert plan.threads <= dwconv.BWD_MAX_THREADS and plan.th >= 1
        tile = (plan.th + 4) * (plan.tw + 4) + (plan.th + 2) * (plan.tw + 2)
        assert plan.smem_bytes == 16 * plan.cq * max(tile, 10 * plan.tw)
        assert plan.smem_bytes <= min(dwconv.BWD_MAX_SMEM, SMEM_PER_BLOCK)
        assert plan.grid[0] == -(-C // (4 * plan.cq))
        assert 1 <= plan.grid[1] <= min(plan.tiles, 65535)
        count = np.zeros((B, H, W), np.int8)
        for _, b, h0, w0 in _dw_walk(plan, B, H, W):
            count[b, h0:h0 + plan.th, w0:w0 + plan.tw] += 1
        assert (count == 1).all(), (shape, sms, plan)
        # every block walks ceil or floor of the mean number of tiles
        walks = np.bincount([py for py, *_ in _dw_walk(plan, B, H, W)])
        assert walks.max() - walks.min() <= 1


def test_dwconv_bwd_plan_fills_the_card():
    """At every training shape a thread moves 16 bytes, and the grid puts at
    least one block on each of 132 SMs and no more than fit at once."""
    for shape in _train_shapes("dwconv_bwd"):
        plan = dwconv.bwd_plan(*shape)
        assert shape[-1] % (4 * plan.cq) == 0 and plan.threads == 128, shape
        blocks = plan.grid[0] * plan.grid[1]
        per_sm = dwconv.SMEM_PER_SM // (plan.smem_bytes + 1024)
        assert 132 <= blocks <= per_sm * 132, (shape, plan)


def _stage(img, rows, cols, r0, c0, cs, cb):
    """The zero-filled window of img (H, W, C) at (r0, c0), channels cs."""
    H, W, _ = img.shape
    out = torch.zeros(rows, cols, cb)
    lo_r, hi_r = max(r0, 0), min(r0 + rows, H)
    lo_c, hi_c = max(c0, 0), min(c0 + cols, W)
    if lo_r < hi_r and lo_c < hi_c:
        out[lo_r - r0:hi_r - r0, lo_c - c0:hi_c - c0, :cs.stop - cs.start] = \
            img[lo_r:hi_r, lo_c:hi_c, cs]
    return out


def _taps(acc, v, w):
    return acc + v[0] * w[0] + v[1] * w[1] + v[2] * w[2]


def _dwconv_bwd_replay(x, w, bias, dy, act, plan):
    """The kernel's arithmetic and order in plain PyTorch: per tile, dz over
    the haloed dy tile from pre rows accumulated as the x rows stream by,
    then dx rows and the dw and dbias sums of each column as the dz and x
    rows stream by; each block's sums over its columns in order, then the
    blocks' partials as 8 interleaved slices."""
    B, H, W, C = x.shape
    th, tw, cb = plan.th, plan.tw, 4 * plan.cq
    dx = torch.full_like(x, float("nan"))
    part = torch.zeros(plan.grid[1], 10, C)
    for cx in range(plan.grid[0]):
        cs = slice(cx * cb, min(C, (cx + 1) * cb))
        nc = cs.stop - cs.start
        wt = torch.zeros(3, 3, cb)
        wt[:, :, :nc] = w[:, :, cs]
        bv = torch.zeros(cb)
        if bias is not None:
            bv[:nc] = bias[cs]
        sums = torch.zeros(plan.grid[1], tw, 10, cb)   # each block's columns
        for py, b, h0, w0 in _dw_walk(plan, B, H, W):
            xs = _stage(x[b], th + 4, tw + 4, h0 - 2, w0 - 2, cs, cb)
            zs = _stage(dy[b], th + 2, tw + 2, h0 - 1, w0 - 1, cs, cb)
            if act == "silu":
                a0 = a1 = torch.zeros(tw + 2, cb)
                for k in range(th + 4):
                    v = [xs[k, j:j + tw + 2] for j in range(3)]
                    a2 = _taps(torch.zeros(tw + 2, cb), v, wt[0])
                    a1 = _taps(a1, v, wt[1])
                    a0 = _taps(a0, v, wt[2])
                    if k >= 2:
                        pre = a0 + bv
                        s = 1 / (1 + torch.exp(-pre))
                        zs[k - 2] = zs[k - 2] * s * (1 + pre * (1 - s))
                    a0, a1 = a1, a2
            d0 = d1 = z1 = z2 = torch.zeros(tw, cb)
            s = sums[py]
            for rr in range(th + 3):
                z0 = torch.zeros(tw, cb)
                if rr < th + 2:
                    v = [zs[rr, 2 - j:2 - j + tw] for j in range(3)]   # taps j = 0, 1, 2
                    d2 = _taps(torch.zeros(tw, cb), v, wt[2])
                    d1 = _taps(d1, v, wt[1])
                    d0 = _taps(d0, v, wt[0])
                    t = h0 + rr - 2
                    if rr >= 2 and t < H:
                        n = min(W, w0 + tw) - w0
                        dx[b, t, w0:w0 + n, cs] = d0[:n, :nc]
                    d0, d1 = d1, d2
                    if 1 <= rr <= th:
                        z0 = zs[rr, 1:tw + 1]
                if rr >= 1:
                    u = [xs[rr, j + 1:j + 1 + tw] for j in range(3)]
                    for j in range(3):
                        s[:, j] += z0 * u[j]
                        s[:, 3 + j] += z1 * u[j]
                        s[:, 6 + j] += z2 * u[j]
                    s[:, 9] += z0
                z1, z2 = z0, z1
        for py in range(plan.grid[1]):
            acc = sums[py, 0]
            for i in range(1, tw):
                acc = acc + sums[py, i]
            part[py, :, cs] = acc[:, :nc]
    total = _slices_sum(part, DW_SLICES)
    return dx, total[:9].reshape(3, 3, C), None if bias is None else total[9]


@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
@pytest.mark.parametrize("shape,sms", [((2, 5, 7, 3), 132), ((3, 9, 13, 6), 1),
                                       ((2, 11, 19, 40), 1), ((1, 1, 1, 8), 132),
                                       ((2, 17, 20, 64), 2)])
def test_dwconv_bwd_replay_matches_autograd_and_pallas(shape, sms, act, has_bias):
    rng = np.random.default_rng(sum(shape) + 1)
    f = np.float32
    C = shape[-1]
    x, dy = (rng.standard_normal(shape).astype(f) for _ in range(2))
    w = (0.3 * rng.standard_normal((3, 3, C))).astype(f)
    b = rng.standard_normal(C).astype(f) if has_bias else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = [g for g in _dwconv_bwd_replay(t(x), t(w), t(b), t(dy), act,
                                         dwconv.bwd_plan(*shape, sms=sms)) if g is not None]
    assert not torch.isnan(got[0]).any()

    live = [a.requires_grad_(True) for a in (t(x), t(w), t(b)) if a is not None]
    out = dwconv.depthwise_conv3x3_plain(*live, *([None] if b is None else []), act=act)
    want = torch.autograd.grad(out, live, t(dy))
    jdx, jdw, jdb = dwconv_pallas._bwd_pallas(
        jnp.asarray(x), jnp.asarray(w).reshape(1, 9, 1, C),
        None if b is None else jnp.asarray(b).reshape(1, 1, 1, C), jnp.asarray(dy), act, True)
    jwant = [jdx, np.asarray(jdw).reshape(3, 3, C)] + ([] if b is None else [jdb])
    _close([g.numpy() for g in got], [w_.numpy() for w_ in want])
    _close([g.numpy() for g in got], jwant)


# ---------------------------------------------------------------------------
# LN-mean backward: the walk of lnm_bwd_plan and its fixed-order sums
# ---------------------------------------------------------------------------

_LN_VARIANTS = {(int(v), int(g), m == "true") for v, g, m in re.findall(
    r"X\((\d+), (\d+), (true|false)\)", (CSRC / "ln_common.cuh").read_text())}
_LNM_RAGGED = [(1, 1, 24), (3, 37, 96), (5, 37, 40), (2, 9, 1000), (12, 5, 768), (1, 300, 3)]


def _lnm_walk(plan, rows):
    """Rows of each (block, group) of one batch row, in the kernel's order."""
    for p in range(plan.blocks):
        for grp in range(plan.rows_per_step):
            yield p, grp, list(range(p * plan.rows_per_step + grp, rows,
                                     plan.blocks * plan.rows_per_step))


@pytest.mark.parametrize("B,rows,C", _train_shapes("ln_mean_bwd", (6, *SEG_PAIRS)) + _LNM_RAGGED)
def test_lnm_bwd_plan_visits_each_row_once(B, rows, C):
    for sms in (132, 1):
        plan = layer_norm.lnm_bwd_plan(B, rows, C, sms)
        assert (plan.values, plan.lanes, plan.masked) in _LN_VARIANTS
        assert plan.values * plan.lanes >= C
        assert plan.masked == (C not in layer_norm.TEMPLATES)
        assert plan.rows_per_step * plan.lanes == plan.threads <= 1024
        assert 1 <= plan.blocks <= rows and B <= 65535
        seen = np.zeros(rows, np.int32)
        for _, _, visited in _lnm_walk(plan, rows):
            seen[visited] += 1
        assert (seen == 1).all(), (B, rows, C, sms, plan)


def test_lnm_bwd_plan_fills_lanes_and_the_card():
    """Every training width has a template (no lane masked), and the B batch
    rows together take at least one block an SM where there are rows enough."""
    assert len(_LN_VARIANTS) == 9
    for B, rows, C in _train_shapes("ln_mean_bwd"):
        plan = layer_norm.lnm_bwd_plan(B, rows, C)
        assert not plan.masked and plan.values * plan.lanes == C, C
        steps = -(-rows // plan.rows_per_step)
        assert B * plan.blocks >= min(132, B * steps), (B, rows, C, plan)


def _lnm_bwd_replay(x, scale, dm, eps, plan):
    """The kernel's arithmetic and order in plain PyTorch: w from dm, scale
    and rows; per row dx from the row's sums; the sums of xhat per group over
    its rows in walk order, per block over its groups in order, times dm[b];
    then the B x P partials as 32 interleaved slices, divided by rows; dbias
    the sum of dm over b in order."""
    B, rows, C = x.shape
    w = dm * scale / rows                                   # (B, C)
    mu = x.sum(2, keepdim=True) / C
    rs = torch.rsqrt((x * x).sum(2, keepdim=True) / C - mu * mu + eps)
    xh = (x - mu) * rs
    m1 = w.sum(1)[:, None, None] / C
    m2 = (w[:, None] * xh).sum(2, keepdim=True) / C
    dx = rs * (w[:, None] - m1 - xh * m2)
    part, db = torch.zeros(B, plan.blocks, C), torch.zeros(C)
    for b in range(B):
        for p, grp, visited in _lnm_walk(plan, rows):
            acc = torch.zeros(C)
            for r in visited:
                acc = acc + xh[b, r]
            part[b, p] = acc if grp == 0 else part[b, p] + acc
        part[b] = part[b] * dm[b]
        db = db + dm[b]
    return dx, _slices_sum(part.reshape(-1, C), LNM_SLICES) / rows, db


@pytest.mark.parametrize("B,rows,C,sms", [(2, 64, 96, 1), (3, 37, 96, 132), (2, 50, 40, 2),
                                          (6, 16, 384, 4), (1, 300, 24, 1)])
def test_lnm_bwd_replay_matches_autograd_and_pallas(B, rows, C, sms):
    rng = np.random.default_rng(B * rows + C)
    f = np.float32
    x = (2.0 * rng.standard_normal((B, rows, C)) + 0.5).astype(f)
    s, b = rng.standard_normal(C).astype(f), rng.standard_normal(C).astype(f)
    dm = rng.standard_normal((B, C)).astype(f)
    t = torch.from_numpy
    plan = layer_norm.lnm_bwd_plan(B, rows, C, sms)
    got = [g.numpy() for g in _lnm_bwd_replay(t(x), t(s), t(dm), 1e-5, plan)]

    live = [a.requires_grad_(True) for a in (t(x), t(s), t(b))]
    want = torch.autograd.grad(layer_norm.ln_spatial_mean_plain(*live, 1e-5), live, t(dm))
    _, vjp = jax.vjp(lambda *a: ln_pallas._lnm_core(*a, 1e-5, True),
                     jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    _close(got, [w_.numpy() for w_ in want])
    _close(got, vjp(jnp.asarray(dm)))


def test_lnm_bwd_replay_matches_the_triton_design():
    """The replaced design's result at a training width (dx, then dscale and
    dbias from one xhat sum a batch row), in plain PyTorch: the new order of
    summation changes only rounding."""
    rng = np.random.default_rng(7)
    B, rows, C = 6, 64, 192
    x = torch.from_numpy((2.0 * rng.standard_normal((B, rows, C)) + 0.5).astype(np.float32))
    s, dm = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for n in (C, (B, C)))
    got = _lnm_bwd_replay(x, s, dm, 1e-5, layer_norm.lnm_bwd_plan(B, rows, C))
    xh = F.layer_norm(x, (C,), eps=1e-5)
    _close([g.numpy() for g in got[1:]],
           [((dm * xh.sum(1)).sum(0) / rows).numpy(), dm.sum(0).numpy()])


# ---------------------------------------------------------------------------
# dwconv backward, bf16 design: the tiles of bwd_plan(io=bf16)
# ---------------------------------------------------------------------------

BF = torch.bfloat16


@pytest.mark.parametrize("shape", _train_shapes("dwconv_bwd", (6, *SEG_PAIRS)) + _DW_RAGGED)
def test_dwconv_bwd_bf16_plan_covers_each_output_once(shape):
    """The bf16 plan's walk covers every output once; its shared memory is
    the fp32 dz tile plus bf16 x and dy tiles (at least the block's sums),
    within a block's and, at its blocks an SM, an SM's."""
    B, H, W, C = shape
    for sms in (132, 1):
        plan = dwconv.bwd_plan(B, H, W, C, sms=sms, io=BF)
        assert plan.cq in _DW_CQ and plan.threads == plan.cq * plan.tw
        assert plan.threads <= dwconv.BWD_MAX_THREADS and plan.th >= 1
        staged = (16 * (plan.th + 2) * (plan.tw + 2) + 8 * (
            (plan.th + 4) * (plan.tw + 4) + (plan.th + 2) * (plan.tw + 2))) * plan.cq
        assert plan.smem_bytes == max(staged, 160 * plan.tw * plan.cq)
        assert plan.smem_bytes <= min(dwconv.BWD_MAX_SMEM, SMEM_PER_BLOCK)
        assert plan.grid[0] == -(-C // (4 * plan.cq))
        assert 1 <= plan.grid[1] <= min(plan.tiles, 65535)
        count = np.zeros((B, H, W), np.int8)
        for _, b, h0, w0 in _dw_walk(plan, B, H, W):
            count[b, h0:h0 + plan.th, w0:w0 + plan.tw] += 1
        assert (count == 1).all(), (shape, sms, plan)
        walks = np.bincount([py for py, *_ in _dw_walk(plan, B, H, W)])
        assert walks.max() - walks.min() <= 1


def test_dwconv_bwd_bf16_plan_fills_the_card():
    """At every training shape of the fusion and segmentation steps a
    thread moves 8 bytes (a whole quad of channels), and the grid puts a
    block on each of 132 SMs where the shape has the tiles (channel blocks x
    tiles), and no more blocks than fit at once."""
    for shape in _train_shapes("dwconv_bwd", (6, *SEG_PAIRS)):
        plan = dwconv.bwd_plan(*shape, io=BF)
        assert shape[-1] % (4 * plan.cq) == 0, shape
        blocks = plan.grid[0] * plan.grid[1]
        per_sm = min(dwconv.BWD_BLOCKS_PER_SM, dwconv.SMEM_PER_SM // (plan.smem_bytes + 1024))
        assert min(132, plan.grid[0] * plan.tiles) <= blocks <= per_sm * 132, (shape, plan)


@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
@pytest.mark.parametrize("shape,sms", [((2, 5, 7, 3), 132), ((3, 9, 13, 6), 1),
                                       ((2, 11, 19, 40), 1), ((1, 1, 1, 8), 132),
                                       ((2, 17, 20, 64), 2), ((4, 24, 32, 32), 1)])
def test_dwconv_bwd_bf16_replay_matches_autograd_and_pallas(shape, sms, act, has_bias):
    """The replay on the bf16 plan's tiles and walk, on bf16 x and dy (fp32
    w and bias, as the kernel reads them), dz and every sum fp32, dx rounded
    to bf16: against autograd of the plain version at the bf16 kernels'
    gate, and against the Pallas kernel in interpret mode at the JAX
    package's bf16 tolerance (3e-2, its absolute term scaled by the largest
    entry)."""
    rng = np.random.default_rng(sum(shape) + 2)
    f = np.float32
    C = shape[-1]
    x, dy = (torch.from_numpy(rng.standard_normal(shape).astype(f)).to(BF) for _ in range(2))
    w = torch.from_numpy((0.3 * rng.standard_normal((3, 3, C))).astype(f))
    b = torch.from_numpy(rng.standard_normal(C).astype(f)) if has_bias else None
    plan = dwconv.bwd_plan(*shape, sms=sms, io=BF)
    got = [g for g in _dwconv_bwd_replay(x.float(), w, b, dy.float(), act, plan)
           if g is not None]
    assert not torch.isnan(got[0]).any()
    got[0] = got[0].to(BF)

    live = [a.clone().requires_grad_(True) for a in (x, w, b) if a is not None]
    out = dwconv.depthwise_conv3x3_plain(*live, *([None] if b is None else []), act=act)
    want = torch.autograd.grad(out, live, dy)
    assert want[0].dtype == BF
    for g_, w_ in zip(got, want):
        g_, w_ = g_.float().numpy(), w_.float().numpy()
        assert (np.abs(g_ - w_) <= 8e-3 * np.abs(w_) + 8e-3 * np.abs(w_).max()).all()

    jdx, jdw, jdb = dwconv_pallas._bwd_pallas(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w.numpy()).reshape(1, 9, 1, C),
        None if b is None else jnp.asarray(b.numpy()).reshape(1, 1, 1, C),
        jnp.asarray(dy.float().numpy(), jnp.bfloat16), act, True)
    jwant = [jdx, np.asarray(jdw, f).reshape(3, 3, C)] + ([] if b is None else [jdb])
    for g_, jw in zip(got, jwant):
        jw = np.asarray(jw, f).reshape(g_.shape)
        np.testing.assert_allclose(g_.float().numpy(), jw, rtol=3e-2,
                                   atol=3e-2 * max(1.0, float(np.abs(jw).max())))


def test_dwconv_bwd_ab_needs_trees_and_a_card():
    """The A/B timing tool asks for at least one checkout, and without a
    card exits before it starts any process."""
    from fusionmamba_torch.tools import dwconv_bwd_ab

    with pytest.raises(SystemExit):
        dwconv_bwd_ab.main([])
    with pytest.raises(SystemExit, match="no CUDA device"):
        dwconv_bwd_ab.main(["."])
