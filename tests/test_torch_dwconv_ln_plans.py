"""The layouts of the dwconv forward and LN backward CUDA kernels, on the CPU.

The kernels (`fusionmamba_torch/csrc/dwconv3x3_fwd.cu`, `layer_norm_bwd.cu`)
run only on the card, where tests/test_torch_kernels.py holds them against
their plain versions. Their layouts come from Python (`dwconv.fwd_plan`,
`layer_norm.bwd_plan`), and here those plans are checked at every serving
and training shape of the full config (`chip_smoke.main_path_calls`) and at
ragged ones: the dwconv's tiles cover every output exactly once within the
kernel's limits, the LN backward's grid-stride walk visits every row exactly
once, and each plan names a variant the source compiles. Plain-PyTorch
replays of the two kernels' arithmetic (kept here, not in the package) are
held against the plain versions and against the JAX package's Pallas
kernels, run in interpret mode as its own tests run them. Inputs come from
numpy seeds.

Tolerances. The dwconv replay adds the same products in the same order as
`depthwise_conv3x3_plain` (taps row by row, then the bias, then the SiLU over
the whole tensor), so the two agree bit for bit; against the Pallas kernel (another order) to 1e-5. The LN
replay takes dscale and dbias as the kernel does (per group over its rows,
per block over its groups, then 32 interleaved slices of the blocks), sums
of many terms of both signs in another order than autograd's, so each
gradient is held to 1e-5 of its own largest entry plus 1e-5 relative.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import main_path_calls, train_calls
from fusionmamba_torch.config import full_config
from fusionmamba_torch.ops import dwconv, layer_norm
from fusionmamba_tpu.ops import dwconv_pallas, ln_pallas

CSRC = Path(dwconv.__file__).resolve().parent.parent / "csrc"
SMEM_PER_BLOCK = 227 * 1024      # H100: the most a block can use
GRAD_RTOL = GRAD_SCALED_ATOL = 1e-5


def _model_shapes(op):
    cfg = full_config()
    shapes = set(main_path_calls(cfg, 8, 256)[op]) | set(train_calls(cfg, 6, 256)[op])
    assert shapes
    return sorted(shapes)


# ---------------------------------------------------------------------------
# dwconv forward: the tiles of fwd_plan
# ---------------------------------------------------------------------------

_DW_RAGGED = [(2, 5, 7, 3), (3, 9, 13, 6), (2, 11, 19, 40), (1, 1, 1, 8), (1, 1, 1, 3),
              (2, 3, 70, 192), (1, 17, 9, 64), (5, 33, 31, 200)]


def _tiles(plan, B, H, W, C):
    """(b, h slice, w slice, c slice) of the outputs each block writes."""
    gx, gy, gz = plan.grid
    h_tiles = gz // B
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                b, ht = divmod(bz, h_tiles)
                yield (b, slice(ht * plan.th, min(H, (ht + 1) * plan.th)),
                       slice(by * plan.tw, min(W, (by + 1) * plan.tw)),
                       slice(4 * plan.cq * bx, min(C, 4 * plan.cq * (bx + 1))))


_DW_CQ = tuple(int(n) for n in re.findall(r"case (\d+): return launch<",
                                          (CSRC / "dwconv3x3_fwd.cu").read_text()))


@pytest.mark.parametrize("shape", _model_shapes("dwconv") + _DW_RAGGED)
def test_dwconv_fwd_plan_covers_each_output_once(shape):
    B, H, W, C = shape
    for sms in (132, 1):
        plan = dwconv.fwd_plan(B, H, W, C, sms=sms)
        assert plan.cq in _DW_CQ and plan.threads == plan.cq * plan.tw
        assert plan.threads <= dwconv.FWD_MAX_THREADS and plan.th >= 1
        assert plan.smem_bytes == (plan.th + 2) * (plan.tw + 2) * plan.cq * 16
        assert plan.smem_bytes <= min(dwconv.FWD_MAX_SMEM, SMEM_PER_BLOCK)
        assert plan.grid[2] % B == 0 and max(plan.grid[1:]) <= 65535
        count = np.zeros(shape, np.int8)
        for b, hs, ws, cs in _tiles(plan, *shape):
            count[b, hs, ws, cs] += 1
        assert (count == 1).all(), (shape, sms, plan)


def test_dwconv_fwd_plan_fills_the_card():
    """At every model shape the grid gives each of 132 SMs at least 2 blocks,
    and a thread moves 16 bytes (a whole quad of channels)."""
    for shape in _model_shapes("dwconv"):
        plan = dwconv.fwd_plan(*shape)
        assert shape[-1] % (4 * plan.cq) == 0, shape
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 2 * 132, (shape, plan)


def _dwconv_replay(x, w, bias, plan):
    """The kernel's arithmetic in plain PyTorch, up to the activation: each
    block stages its zero-filled (th+2) x (tw+2) x 4cq tile, then walks down
    it, each staged row feeding the three output rows it touches (weight rows
    0, 1, 2)."""
    B, H, W, C = x.shape
    out = torch.full_like(x, float("nan"))
    cb = 4 * plan.cq
    for b, hs, ws, cs in _tiles(plan, B, H, W, C):
        h0, w0, c0 = hs.start, ws.start, cs.start
        tile = torch.zeros(plan.th + 2, plan.tw + 2, cb)
        for k in range(plan.th + 2):
            hh = h0 - 1 + k
            if 0 <= hh < H:
                lo, hi = max(w0 - 1, 0), min(w0 + plan.tw + 1, W)
                tile[k, lo - (w0 - 1):hi - (w0 - 1), :cs.stop - c0] = x[b, hh, lo:hi, cs]
        wt = torch.zeros(3, 3, cb)
        wt[:, :, :cs.stop - c0] = w[:, :, cs]
        bv = torch.zeros(cb)
        if bias is not None:
            bv[:cs.stop - c0] = bias[cs]
        acc = [torch.zeros(plan.tw, cb), torch.zeros(plan.tw, cb)]   # outputs k-2, k-1
        for k in range(plan.th + 2):
            v = [tile[k, j:j + plan.tw] for j in range(3)]
            new = torch.zeros(plan.tw, cb)
            for i, a in ((0, new), (1, acc[1]), (2, acc[0])):
                for j in range(3):
                    a += v[j] * wt[i, j]
            if k >= 2 and h0 + k - 2 < H:
                y = acc[0] + bv
                out[b, h0 + k - 2, ws, cs] = y[:ws.stop - w0, :cs.stop - c0]
            acc = [acc[1], new]
    return out


@pytest.mark.parametrize("act,has_bias", [("none", True), ("silu", True), ("silu", False)])
@pytest.mark.parametrize("shape,sms", [((2, 5, 7, 3), 132), ((3, 9, 13, 6), 1),
                                       ((2, 11, 19, 40), 1), ((1, 1, 1, 8), 132),
                                       ((1, 17, 9, 64), 2)])
def test_dwconv_tile_replay_matches_plain_and_pallas(shape, sms, act, has_bias):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, shape[-1]))).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32) if has_bias else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = _dwconv_replay(t(x), t(w), t(b), dwconv.fwd_plan(*shape, sms=sms))
    # SiLU over the whole tensor at once, as the plain version takes it (the
    # CPU's vectorised and scalar paths of exp may differ in the last bit)
    got = F.silu(got) if act == "silu" else got
    assert torch.equal(got, dwconv.depthwise_conv3x3_plain(t(x), t(w), t(b), act))
    want = dwconv_pallas.depthwise_conv3x3(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        impl="pallas", interpret=True, act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# LN backward: the walk of bwd_plan and the fixed-order dscale / dbias sums
# ---------------------------------------------------------------------------

_LN_VARIANTS = {(int(v), int(g), m == "true") for v, g, m in re.findall(
    r"X\((\d+), (\d+), (true|false)\)", (CSRC / "ln_common.cuh").read_text())}
_LN_RAGGED = [(1, 24), (5, 40), (1, 1000), (300, 1000), (3, 1536), (7, 3), (2, 6144)]


def _walk(plan, rows):
    """Rows of each (block, group) in the order the kernel visits them."""
    for p in range(plan.blocks):
        for grp in range(plan.rows_per_step):
            yield p, grp, list(range(p * plan.rows_per_step + grp, rows,
                                     plan.blocks * plan.rows_per_step))


@pytest.mark.parametrize("rows,C", sorted({s[:2] for s in _model_shapes("layer_norm")})
                         + _LN_RAGGED)
def test_layer_norm_bwd_plan_visits_each_row_once(rows, C):
    for sms in (132, 1):
        plan = layer_norm.bwd_plan(rows, C, sms)
        assert (plan.values, plan.lanes, plan.masked) in _LN_VARIANTS
        assert plan.values * plan.lanes >= C
        assert plan.masked == (C not in layer_norm.TEMPLATES)
        assert plan.threads == max(layer_norm.BWD_BLOCK, plan.lanes) <= 1024
        assert plan.rows_per_step * plan.lanes == plan.threads
        seen = np.zeros(rows, np.int32)
        for _, _, visited in _walk(plan, rows):
            seen[visited] += 1
        assert (seen == 1).all(), (rows, C, sms, plan)
        assert plan.blocks <= max(4, 4 * sms)


def test_layer_norm_bwd_plan_fills_lanes_at_model_widths():
    """Every width the model normalises has a template: no lane is masked."""
    for rows, C, _ in _model_shapes("layer_norm"):
        plan = layer_norm.bwd_plan(rows, C)
        assert not plan.masked and plan.values * plan.lanes == C, C
        assert plan.values <= 12


def test_layer_norm_bwd_plan_rejects_what_no_variant_takes():
    with pytest.raises(ValueError, match="wider"):
        layer_norm.bwd_plan(4, 6145)


def _ln_bwd_replay(x, scale, bias, gate, dy, eps, gate_act, plan):
    """The kernel's arithmetic in plain PyTorch: per row dx and dgate from
    the row's sums; dscale and dbias summed per group over its rows in walk
    order, per block over its groups in order, then over the blocks as 32
    interleaved slices, each in order, and the slices in order."""
    rows, C = x.shape
    mu = x.sum(1, keepdim=True) / C
    rs = torch.rsqrt((x * x).sum(1, keepdim=True) / C - mu * mu + eps)
    xh = (x - mu) * rs
    u, dg = dy, None
    if gate is not None:
        sg = torch.sigmoid(gate)
        s1 = gate * sg
        dgate, act = sg * (1 + gate * (1 - sg)), s1
        if gate_act == "silu_sum":
            ss = torch.sigmoid(s1)
            act = s1 + s1 * ss
            dgate = (1 + ss * (1 + s1 * (1 - ss))) * dgate
        dg = dy * (xh * scale + bias) * dgate
        u = dy * act
    w = u * scale
    m1, m2 = w.sum(1, keepdim=True) / C, (w * xh).sum(1, keepdim=True) / C
    dx = rs * (w - m1 - xh * m2)
    terms = torch.stack([u * xh, u], 1)                    # (rows, 2, C)
    part = torch.zeros(plan.blocks, 2, C)
    for p, grp, visited in _walk(plan, rows):
        acc = torch.zeros(2, C)
        for r in visited:
            acc = acc + terms[r]
        part[p] = acc if grp == 0 else part[p] + acc
    slices = torch.zeros(layer_norm.BWD_REDUCE_SLICES, 2, C)
    for p in range(plan.blocks):
        slices[p % layer_norm.BWD_REDUCE_SLICES] += part[p]
    total = slices[0]
    for y in range(1, layer_norm.BWD_REDUCE_SLICES):
        total = total + slices[y]
    return dx, dg, total[0], total[1]


@pytest.mark.parametrize("gate_act", ["none", "silu", "silu_sum"])
@pytest.mark.parametrize("rows,C,sms", [(300, 24, 1), (37, 96, 1), (50, 40, 2), (9, 384, 132)])
def test_layer_norm_bwd_replay_matches_autograd_and_pallas(gate_act, rows, C, sms):
    rng = np.random.default_rng(rows + C)
    f = np.float32
    x = (2.0 * rng.standard_normal((rows, C)) + 0.5).astype(f)
    s, b = rng.standard_normal(C).astype(f), rng.standard_normal(C).astype(f)
    gate = None if gate_act == "none" else rng.standard_normal((rows, C)).astype(f)
    dy = rng.standard_normal((rows, C)).astype(f)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    plan = layer_norm.bwd_plan(rows, C, sms)
    dx, dg, ds, db = _ln_bwd_replay(t(x), t(s), t(b), t(gate), t(dy), 1e-6, gate_act, plan)
    got = [dx, ds, db] + ([] if dg is None else [dg])

    live = [a.requires_grad_(True) for a in (t(x), t(s), t(b), t(gate)) if a is not None]
    args = live + [None] * (4 - len(live))
    y = layer_norm.layer_norm_plain(*args, 1e-6, gate_act)
    want = torch.autograd.grad(y, live, t(dy))

    def jfn(*a):
        return jnp.sum(ln_pallas.layer_norm_fused(*a, eps=1e-6, impl="pallas", interpret=True,
                                                  gate_act=gate_act) * jnp.asarray(dy))

    jx = [jnp.asarray(a) for a in (x, s, b, gate) if a is not None]
    if gate is None:
        jwant = jax.grad(lambda x_, s_, b_: jfn(x_, s_, b_, None), argnums=(0, 1, 2))(*jx)
    else:
        jwant = jax.grad(jfn, argnums=(0, 1, 2, 3))(*jx)
    for g_, w_, jw in zip(got, want, jwant):
        w_, jw = w_.numpy(), np.asarray(jw)
        for ref in (w_, jw):
            np.testing.assert_allclose(g_.numpy(), ref, rtol=GRAD_RTOL,
                                       atol=GRAD_SCALED_ATOL * float(np.abs(ref).max()))
