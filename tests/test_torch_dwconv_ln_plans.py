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

from chip_smoke import SEG_PAIRS, main_path_calls, train_calls
from fusionmamba_torch.config import full_config
from fusionmamba_torch.ops import dwconv, layer_norm
from fusionmamba_tpu.ops import dwconv_pallas, ln_pallas

CSRC = Path(dwconv.__file__).resolve().parent.parent / "csrc"
SMEM_PER_BLOCK = 227 * 1024      # H100: the most a block can use
GRAD_RTOL = GRAD_SCALED_ATOL = 1e-5


def _model_shapes(op):
    """Every shape of `op` on the serving path (batch 8), the fusion training
    step (batch 6) and the segmentation steps (batches 2 and 4)."""
    cfg = full_config()
    shapes = set(main_path_calls(cfg, 8, 256)[op])
    for pairs in (6, *SEG_PAIRS):
        shapes |= set(train_calls(cfg, pairs, 256)[op])
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


# ---------------------------------------------------------------------------
# LN backward, bf16 design: the quads layout of bwd_plan(io=bf16)
# ---------------------------------------------------------------------------

BF = torch.bfloat16
_LN_BF16_VARIANTS = {(int(q), int(g), m == "true") for q, g, m in re.findall(
    r"Q\((\d+), (\d+), (true|false)\)", (CSRC / "ln_common.cuh").read_text())}
_LN_BF16_RAGGED = [(1, 24), (5, 40), (1, 1000), (300, 1000), (3, 1536), (37, 100), (2, 6144),
                   (9, 4)]
STATIC_SMEM = 48 * 1024           # a block's static shared memory at most


def _quad_channels(plan):
    """(lanes, values) channel index of each of a lane's values: quad q of
    lane l holds channels 4 (l + q lanes) .. + 3."""
    lane = torch.arange(plan.lanes)[:, None]
    v = torch.arange(plan.values)[None, :]
    return 4 * (lane + v // 4 * plan.lanes) + v % 4


@pytest.mark.parametrize("rows,C", sorted({s[:2] for s in _model_shapes("layer_norm")})
                         + _LN_BF16_RAGGED)
def test_layer_norm_bwd_bf16_plan_covers_each_row_and_element_once(rows, C):
    for sms in (132, 1):
        plan = layer_norm.bwd_plan(rows, C, sms, io=BF)
        assert plan.quads and plan.values == 4 * layer_norm.BF16_QUADS
        assert (plan.values // 4, plan.lanes, plan.masked) in _LN_BF16_VARIANTS
        assert plan.masked == (C not in layer_norm.BF16_TEMPLATES)
        assert plan.threads == max(layer_norm.BWD_BLOCK, plan.lanes) <= 1024
        assert plan.rows_per_step * plan.lanes == plan.threads
        assert 1 <= plan.blocks <= max(2, 2 * sms)
        seen = np.zeros(rows, np.int32)
        for _, _, visited in _walk(plan, rows):
            seen[visited] += 1
        assert (seen == 1).all(), (rows, C, sms, plan)
        chans = _quad_channels(plan)
        held = np.bincount(chans[chans < C].numpy(), minlength=C)
        assert (held == 1).all(), (C, plan)
        # the kernel's static shared memory: two rounds of warp sums, and
        # each group's (2, values x lanes) sums where a block has several
        groups = plan.threads // plan.lanes
        smem = 2 * (plan.threads // 32) * 8 + (groups * 2 * plan.values * plan.lanes * 4
                                               if groups > 1 else 0)
        assert smem <= STATIC_SMEM


def test_layer_norm_bwd_bf16_plan_fills_lanes_and_the_card():
    """Every width the model normalises has a quads template with every lane
    busy (12 values a lane, C / 12 lanes), and the grid puts a block on
    each of 132 SMs wherever the rows make that many row steps, more only
    where each block still walks BF16_MIN_WALK steps."""
    assert len(_LN_BF16_VARIANTS) == 9 and layer_norm.BF16_QUADS == 3
    for rows, C, _ in _model_shapes("layer_norm"):
        plan = layer_norm.bwd_plan(rows, C, io=BF)
        assert plan.quads and not plan.masked and plan.values * plan.lanes == C, C
        steps = -(-rows // plan.rows_per_step)
        assert min(132, steps) <= plan.blocks <= min(264, steps), (rows, C, plan)
        assert plan.blocks <= max(132, -(-steps // layer_norm.BF16_MIN_WALK)), (rows, C, plan)


@pytest.mark.parametrize("C,aligned,quads", [(96, True, True), (96, False, False),
                                             (40, True, True), (30, True, False),
                                             (3, True, False), (1000, False, False)])
def test_layer_norm_bwd_bf16_plan_takes_quads_only_on_8_byte_runs(C, aligned, quads):
    """The quads need C a multiple of 4 and every I/O tensor on an 8-byte
    boundary; else the strided templates in bf16, and fp32 always."""
    plan = layer_norm.bwd_plan(64, C, io=BF, aligned=aligned)
    assert plan.quads == quads
    if not quads:
        assert plan == layer_norm.bwd_plan(64, C)
        assert (plan.values, plan.lanes, plan.masked) in _LN_VARIANTS
    assert not layer_norm.bwd_plan(64, C).quads


def _group_sum(v, G):
    """The kernel's sums over a group of G lanes of v (rows, G): xor
    butterflies inside a warp, then the warps in order; every lane the same
    bits."""
    w = min(G, 32)
    off = w // 2
    while off:
        v = v + v[:, torch.arange(G) ^ off]
        off //= 2
    if G > 32:
        total = v[:, 0]
        for i in range(1, G // 32):
            total = total + v[:, 32 * i]
        v = total[:, None].expand(-1, G)
    return v


def _ln_bwd_quads_replay(x, scale, bias, gate, dy, eps, gate_act, plan):
    """The bf16 kernel's arithmetic and order in plain PyTorch, on the quads
    layout: a lane's values in quad order, the row sums per lane then over
    the group, dx and dgate rounded to bf16 at their stores (NaN where no
    lane writes), dscale and dbias summed as the strided design sums them."""
    rows, C = x.shape
    G, V = plan.lanes, plan.values
    chans = _quad_channels(plan)
    ok = (chans < C).float()
    idx = chans.clamp(max=C - 1)

    def lanes(t):
        return t.float()[:, idx] * ok                 # (rows, G, V)

    xv, d = lanes(x), lanes(dy)
    sc, bi = scale.float()[idx] * ok, bias.float()[idx] * ok
    s1, s2 = torch.zeros(rows, G), torch.zeros(rows, G)
    for v in range(V):
        s1, s2 = s1 + xv[..., v], s2 + xv[..., v] * xv[..., v]
    s1, s2 = _group_sum(s1, G)[..., None], _group_sum(s2, G)[..., None]
    mu = s1 / C
    rs = torch.rsqrt(s2 / C - mu * mu + eps)
    xh = (xv - mu) * rs * ok
    u, dg = d, None
    if gate is not None:
        g = lanes(gate)
        if gate_act == "none":                         # the raw gate
            dg, u = d * (xh * sc + bi), d * g
        else:
            sg = torch.sigmoid(g)
            s1g = g * sg
            dgate, act = sg * (1 + g * (1 - sg)), s1g
            if gate_act == "silu_sum":
                ss = torch.sigmoid(s1g)
                act = s1g + s1g * ss
                dgate = (1 + ss * (1 + s1g * (1 - ss))) * dgate
            dg, u = d * (xh * sc + bi) * dgate, d * act
    wv = u * sc
    m1, m2 = torch.zeros(rows, G), torch.zeros(rows, G)
    for v in range(V):
        m1, m2 = m1 + wv[..., v], m2 + wv[..., v] * xh[..., v]
    m1, m2 = _group_sum(m1, G)[..., None] / C, _group_sum(m2, G)[..., None] / C
    dxl = rs * (wv - m1 - xh * m2)

    live = chans < C

    def store(vals):
        out = torch.full((rows, C), float("nan"), dtype=BF)
        out[:, chans[live]] = vals[:, live].to(BF)
        return out

    terms = torch.zeros(rows, 2, C)
    terms[:, 0, chans[live]] = (u * xh)[:, live]
    terms[:, 1, chans[live]] = u[:, live]
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
    return store(dxl), None if dg is None else store(dg), total[0], total[1]


def _kernel_gate(got, want):
    """The bf16 kernels' gate (chip_smoke's): two bf16 ulps of the value plus
    two of the tensor's largest entry."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert not np.isnan(g).any()
    assert (np.abs(g - w) <= 8e-3 * np.abs(w) + 8e-3 * np.abs(w).max()).all(), \
        float(np.abs(g - w).max())


@pytest.mark.parametrize("gate_act", ["none", "silu", "silu_sum", "raw"])
@pytest.mark.parametrize("rows,C,sms", [(300, 24, 1), (37, 96, 1), (50, 40, 2), (9, 384, 132),
                                        (20, 768, 3), (6, 1536, 2), (12, 100, 1)])
def test_layer_norm_bwd_bf16_replay_matches_autograd_and_pallas(gate_act, rows, C, sms):
    """On bf16 x, gate and dy (fp32 scale and bias, as the kernel reads
    them): against autograd of the plain version at the bf16 kernels' gate,
    and against the Pallas kernel in interpret mode at the JAX package's
    bf16 tolerance (3e-2, its absolute term scaled by the largest entry)."""
    rng = np.random.default_rng(rows + C + 1)
    f = np.float32

    def bf(a):
        return torch.from_numpy(a.astype(f)).to(BF)

    x = bf(2.0 * rng.standard_normal((rows, C)) + 0.5)
    s, b = torch.from_numpy((1 + 0.2 * rng.standard_normal(C)).astype(f)), \
        torch.from_numpy((0.2 * rng.standard_normal(C)).astype(f))
    gate = None if gate_act == "none" else bf(rng.standard_normal((rows, C)))
    dy = bf(rng.standard_normal((rows, C)))
    act = "none" if gate_act == "raw" else gate_act
    plan = layer_norm.bwd_plan(rows, C, sms, io=BF)
    dx, dg, ds, db = _ln_bwd_quads_replay(x, s, b, gate, dy, 1e-6, act, plan)
    got = [dx, ds, db] + ([] if dg is None else [dg])

    live = [t.clone().requires_grad_(True) for t in (x, s, b, gate) if t is not None]
    y = layer_norm.layer_norm_plain(*(live + [None] * (4 - len(live))), 1e-6, act)
    want = torch.autograd.grad(y, live, dy)
    assert want[0].dtype == dx.dtype == BF
    for g_, w_ in zip(got, want):
        _kernel_gate(g_.float().numpy(), w_.float().numpy())

    def jfn(*a):
        out = ln_pallas.layer_norm_fused(*a, eps=1e-6, impl="pallas", interpret=True,
                                         gate_act=act)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dy.float().numpy()))

    jx = [jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(s.numpy()),
          jnp.asarray(b.numpy())]
    if gate is None:
        jwant = jax.grad(lambda x_, s_, b_: jfn(x_, s_, b_, None), argnums=(0, 1, 2))(*jx)
    else:
        jx.append(jnp.asarray(gate.float().numpy(), jnp.bfloat16))
        jwant = jax.grad(jfn, argnums=(0, 1, 2, 3))(*jx)
    for g_, jw in zip(got, jwant):
        jw = np.asarray(jw, np.float32)
        np.testing.assert_allclose(g_.float().numpy(), jw, rtol=3e-2,
                                   atol=3e-2 * max(1.0, float(np.abs(jw).max())))
