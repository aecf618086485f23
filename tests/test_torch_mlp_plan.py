"""The plans of the fused-MLP CUDA kernels, on the CPU: the bf16 kernels'
and the fp32 backward's.

The bf16 kernels (`fusionmamba_torch/csrc/wgmma_bf16.cuh`, the bf16 halves of
`fused_mlp_fwd.cu` and `fused_mlp_bwd.cu`) run only on the card, where
tests/test_torch_kernels.py holds them against the plain versions. Their
layout comes from Python (`mlp.bf16_fused`, `bf16_fwd_plan`,
`bf16_bwd_plan`, gathered by `mlp.bf16_plan`), and here that plan is checked at
every training shape of the full config (`chip_smoke.train_calls`: the fusion
step's batch 6, the segmentation steps' 2 and 4, a tensor-parallel rank's
half hidden) and at ragged ones: the product kernel's block walk (replayed
here from the source's arithmetic) covers every output tile and every depth
slice exactly once, each slice a whole number of the kernels' 64-deep
stages; the reduce launch sums every partial once, in a fixed order; the
hidden launch's bias sums own each column once; every product and hidden
launch of a batch-6 shape has a block for every SM (the fused forward, one
block an SM, for half of them); and the plan's constants are the source's.
A plain-PyTorch replay of the bf16 backward's arithmetic as the plan cuts
it (fp32 partials of each depth slice summed in the reduce order, rounded
to bf16 once) is held against the plain bf16 backward and against the JAX
package's Pallas kernel in interpret mode, as its own tests run it. Inputs
come from numpy seeds.

The fp32 backward (`fused_mlp_bwd.cu`'s `tc` kernels on
`csrc/wgmma_tf32x3.cuh`) takes its slices and its persistent grids from
`mlp.bwd_plan`, checked here at the same shapes and at the benchmark's
batch-64 step: each block's walk (replayed from the source's arithmetic)
takes every item, an output tile and depth slice, exactly once, and
together they cover every tile's depth once in whole 32-deep stages; every
partial is reduced once in a fixed order; each bias column has one owner;
the grids never exceed the SMs and fill them at the step's shapes. A replay
of its sums as the plan cuts them is held against the plain fp32 backward.

Tolerances. The replay and the plain version sum the same fp32 products in
another order and round once to bf16: two bf16 ulps of the value plus two
of the tensor's largest entry (8e-3 each), the card's gate. Against the
Pallas kernel: the JAX package's bf16 gate, 3e-2 relative and absolute,
the absolute term scaled by each gradient's largest entry.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SEG_PAIRS, train_calls
from fusionmamba_torch.config import full_config
from fusionmamba_torch.ops import mlp
from fusionmamba_tpu.ops import mlp_pallas

CSRC = Path(mlp.__file__).resolve().parent.parent / "csrc"
SMS = 132                  # H100 SXM
TILE = 128                 # the kernels' 128-row tiles, 128 x BF16_TILE_N in the products
DEEP = 32                  # mlp_bwd_reduce_kernel: from this many slices on ...
WARPS = 8                  # ... its 8 warps sum interleaved slices


def _shapes(batches=(6,), n_model=1):
    shapes = set()
    for pairs in batches:
        shapes |= set(train_calls(full_config(), pairs, 256, n_model=n_model)["mlp"])
    return sorted(shapes)


_STEP = _shapes()
_TP = _shapes(n_model=2)
_CELL = _shapes((64,))     # the benchmark's training cell
_ALL = sorted(set(_STEP) | set(_TP) | set(_shapes(SEG_PAIRS)))
_RAGGED = [(1, 16, 64), (37, 96, 384), (300, 40, 160), (200, 96, 384), (1000, 192, 768),
           (20000, 96, 384), (3072, 384, 768), (384, 768, 1536)]


def _products(launch):
    """The products of a launch as the kernel takes them: ordered by their
    slices' depth, deepest first (a stable sort, as `launch_products`), each
    with its index in the launch, its tiles across, its tiles and its tiles
    times slices."""
    out = []
    for i, (rows, cols, depth, slice_) in enumerate(launch):
        tiles_n = -(-cols // mlp.BF16_TILE_N)
        tiles = -(-rows // TILE) * tiles_n
        out.append((i, rows, cols, depth, slice_, tiles_n, tiles, tiles * -(-depth // slice_)))
    return sorted(out, key=lambda p: -min(p[3], p[4]))


def _walk(launch):
    """(product, row, column, first k, end k) of each block: the arithmetic
    of `product_kernel` in wgmma_bf16.cuh, product i the launch's index."""
    prods = _products(launch)
    for block in range(sum(p[-1] for p in prods)):
        b, i = block, 0
        while i + 1 < len(prods) and b >= prods[i][-1]:
            b -= prods[i][-1]
            i += 1
        index, rows, cols, depth, slice_, tiles_n, tiles, _ = prods[i]
        s = b // tiles
        k0 = s * slice_
        yield (index, b % tiles // tiles_n * TILE, b % tiles_n * mlp.BF16_TILE_N, k0,
               min(depth, k0 + slice_))


def _launches(M, C, H, sms=SMS):
    return mlp.bf16_plan(M, C, H, C, sms)


@pytest.mark.parametrize("M,C,H", _ALL + _RAGGED)
def test_product_walk_covers_each_tile_and_slice_once(M, C, H):
    for sms in (SMS, 2):
        for name, launch in _launches(M, C, H, sms).items():
            if isinstance(launch, int):
                continue
            seen = {}
            for i, m0, n0, k0, k1 in _walk(launch):
                seen.setdefault((i, m0, n0), []).append((k0, k1))
            for i, (rows, cols, depth, slice_) in enumerate(launch):
                assert slice_ >= depth or slice_ % mlp.BF16_UNIT == 0, (name, slice_)
                for m0 in range(0, rows, TILE):
                    for n0 in range(0, cols, mlp.BF16_TILE_N):
                        spans = sorted(seen.pop((i, m0, n0)))
                        assert spans[0][0] == 0 and spans[-1][1] == depth
                        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
                        assert all(k1 > k0 for k0, k1 in spans)
            assert not seen, (name, sorted(seen)[:3])


def _reduce_order(slices):
    """The order in which `mlp_bwd_reduce_kernel` adds an output's slices:
    all in order below DEEP, else 8 interleaved runs, then the runs in
    order."""
    if slices < DEEP:
        return [[k] for k in range(slices)]
    return [list(range(w, slices, WARPS)) for w in range(WARPS)]


def _sums(M, C, H, sms):
    """(slices, outputs) of every sum of the backward's reduce launch."""
    plan = _launches(M, C, H, sms)
    (_, _, _, s_dx), (_, _, depth_w, s_w), _ = plan["bwd_products"]
    n_dx, n_w = -(-H // s_dx), -(-depth_w // s_w)
    rows_t = -(-M // TILE)
    out = []
    if n_dx > 1:
        out.append((n_dx, M * C))
    if n_w > 1:
        out += [(n_w, H * C), (n_w, C * H)]
    return out + [(rows_t, H), (rows_t, C)]


@pytest.mark.parametrize("M,C,H", _ALL + _RAGGED)
def test_every_partial_is_reduced_once_in_a_fixed_order(M, C, H):
    for sms in (SMS, 2):
        for slices, n in _sums(M, C, H, sms):
            assert n % 4 == 0 or slices >= DEEP     # 16 bytes a thread below DEEP
            order = [k for run in _reduce_order(slices) for k in run]
            assert sorted(order) == list(range(slices))


@pytest.mark.parametrize("M,C,H", _ALL + _RAGGED)
def test_hidden_blocks_own_each_bias_column_once(M, C, H):
    """db1: a hidden block's 64 columns of its row tile; db2: the columns
    n0 + t + q H with t < 64, n0 + t < H, of each hidden block n0."""
    n_h = mlp.BF16_HID_N
    blocks = _launches(M, C, H)["bwd_hidden"]
    assert blocks == -(-H // n_h) * -(-M // TILE)
    db1, db2 = np.zeros(H, np.int32), np.zeros(C, np.int32)
    for n0 in range(0, H, n_h):
        t = np.arange(n_h)
        db1[(n0 + t)[n0 + t < H]] += 1
        for c0 in range(n0, C, H):
            c = c0 + t
            db2[c[(c < C) & (n0 + t < H)]] += 1
    assert (db1 == 1).all() and (db2 == 1).all()


def _blocks(launch):
    return launch if isinstance(launch, int) else sum(p[-1] for p in _products(launch))


@pytest.mark.parametrize("M,C,H", _STEP)
def test_plan_fills_the_card(M, C, H):
    """Every product and hidden launch of a batch-6 training step has a block
    for every SM (they run BF16_BLOCKS_PER_SM an SM); the fused forward (one
    block an SM) is taken where its blocks fill at least half the card,
    which at 96 blocks measured faster than the two passes."""
    for name, launch in _launches(M, C, H).items():
        least = SMS // 2 if name == "fwd_fused" else SMS
        assert _blocks(launch) >= least, (name, _blocks(launch))
    assert mlp.bf16_fused(M, C, C, SMS) == (C <= mlp.BF16_FUSED_MAX_WIDTH
                                            and 2 * -(-M // TILE) >= SMS)


@pytest.mark.parametrize("M,C,H", _TP)
def test_plan_fills_half_the_card_at_a_tensor_parallel_rank(M, C, H):
    """A rank's half hidden: at 384 rows and H = 1536, fc1 (its depth cannot
    be cut) and the backward's hidden launch have 72 tiles each; every
    launch has a block for at least half the SMs."""
    for name, launch in _launches(M, C, H).items():
        assert _blocks(launch) >= SMS // 2, (name, _blocks(launch))


def test_plan_constants_are_the_source_s():
    src = {name: (CSRC / name).read_text()
           for name in ("wgmma_bf16.cuh", "fused_mlp_fwd.cu", "fused_mlp_bwd.cu")}
    consts = {}
    for text in src.values():
        consts.update({k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)})
    assert consts["kBK"] == consts["kBox"] == mlp.BF16_UNIT
    assert consts["kTile"] == TILE
    assert consts["kFusedMaxWidth"] == mlp.BF16_FUSED_MAX_WIDTH
    assert consts["kHidN"] == mlp.BF16_HID_N
    assert consts["kTileN"] == mlp.BF16_TILE_N
    assert consts["kBlocksPerSM"] == mlp.BF16_BLOCKS_PER_SM
    for kernel in ("product_kernel", "hidden_kernel"):
        text = src["wgmma_bf16.cuh"] if kernel == "product_kernel" else src["fused_mlp_bwd.cu"]
        assert re.search(r"__launch_bounds__\(kThreads, kBlocksPerSM\)\s*\n" + kernel, text), kernel
    # the fused forward's two accumulator layouts cover every width it takes
    assert "launch_fused<3, 32>" in src["fused_mlp_fwd.cu"]
    assert "launch_fused<3, 64>" in src["fused_mlp_fwd.cu"]


# ---------------------------------------------------------------------------
# the bf16 backward's arithmetic, as the plan cuts it
# ---------------------------------------------------------------------------

def _bf(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _sliced(a, b, slice_):
    """a (rows, depth) @ b (depth, cols) as fp32 partials of each depth slice,
    summed in the reduce kernel's order."""
    depth = a.shape[1]
    parts = [a[:, k:k + slice_] @ b[k:k + slice_] for k in range(0, depth, slice_)]
    runs = [sum((parts[k] for k in run[1:]), parts[run[0]]) for run in _reduce_order(len(parts))]
    return sum(runs[1:], runs[0])


def _replay_bwd(x, w1, b1, w2, b2, dy, sms):
    """The bf16 backward kernels' roundings and sums, with w1 (C, H), w2 (H, C)."""
    M, C = x.shape
    H = w1.shape[1]
    xf, w1f, w2f, dyf = (t.float() for t in (x, w1, w2, dy))
    h = xf @ w1f + b1.float()
    cdf = 0.5 * (1 + torch.erf(h * 0.7071067811865476))
    a = (h * cdf).to(torch.bfloat16).float()
    g = ((dyf @ w2f.t()) * (cdf + h * torch.exp(-0.5 * h * h) * 0.3989422804014327))
    g = g.to(torch.bfloat16).float()
    (_, _, _, s_dx), (_, _, _, s_w), _ = _launches(M, C, H, sms)["bwd_products"]
    dx = _sliced(g, w1f.t(), s_dx)
    dw1 = _sliced(xf.t(), g, s_w)          # (C, H) = (g^T x)^T
    dw2 = _sliced(a.t(), dyf, s_w)         # (H, C)
    rows = [slice(m, m + TILE) for m in range(0, M, TILE)]
    db1 = _sliced(torch.ones(1, len(rows)), torch.stack([g[r].sum(0) for r in rows]), 1)[0]
    db2 = _sliced(torch.ones(1, len(rows)), torch.stack([dyf[r].sum(0) for r in rows]), 1)[0]
    return [t.to(torch.bfloat16) for t in (dx, dw1, db1, dw2, db2)]


def _case(M, C, H, seed):
    rng = np.random.default_rng(seed)
    return [_bf(rng.standard_normal((M, C))), _bf(rng.standard_normal((C, H)) / C ** 0.5),
            _bf(0.1 * rng.standard_normal(H)), _bf(rng.standard_normal((H, C)) / H ** 0.5),
            _bf(0.1 * rng.standard_normal(C)), _bf(rng.standard_normal((M, C)))]


def _close(got, want, rtol, atol_of_max):
    g, w = got.float(), want.float()
    bound = rtol * w.abs() + atol_of_max * float(w.abs().max())
    assert bool(torch.all((g - w).abs() <= bound)), float((g - w).abs().max())


@pytest.mark.parametrize("M,C,H", [(300, 40, 160), (520, 32, 128), (37, 96, 384),
                                   (8448, 16, 64)])
def test_sliced_backward_matches_plain_and_pallas(M, C, H):
    """Small products that the plan cuts into slices (dx over H, or dW over
    the rows; 8448 rows make 33 slices, the reduce's interleaved runs); the
    replay of the kernels' sums against the plain bf16 backward and the
    Pallas kernel."""
    sms = SMS
    x, w1, b1, w2, b2, dy = _case(M, C, H, M + C + H)
    plan = _launches(M, C, H, sms)["bwd_products"]
    assert plan[0][3] < H or plan[1][3] < M
    got = _replay_bwd(x, w1, b1, w2, b2, dy, sms)
    want = mlp.mlp_bwd_plain(x, w1, b1, w2, b2, dy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        _close(g, w, 8e-3, 8e-3)
    j = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, dy, w1, b1, w2)]
    ref = mlp_pallas._bwd_pallas(*j, interpret=True)
    for g, r in zip(got, ref):
        _close(g, torch.from_numpy(np.array(r, np.float32)).reshape(g.shape), 3e-2, 3e-2)


# ---------------------------------------------------------------------------
# the fp32 backward's persistent plan
# ---------------------------------------------------------------------------

FP32_SMS = (SMS, 7, 1)


def _fp32_products(M, C, H, plan):
    """The product launch's products in the kernel's order (the C entry's
    stable sort: the deepest slices first), each with its tiles across, its
    tiles and its items (tiles x slices)."""
    prods = [(M, C, H, plan.slice_dx), (H, C, M, plan.slice_w), (C, H, M, plan.slice_w)]
    out = []
    for rows, cols, depth, slice_ in sorted(prods, key=lambda p: -min(p[2], p[3])):
        tiles_n = -(-cols // TILE)
        tiles = -(-rows // TILE) * tiles_n
        out.append((rows, cols, depth, slice_, tiles_n, tiles, tiles * -(-depth // slice_)))
    return out


def _fp32_walk(M, C, H, plan):
    """(block, product, row, column, first k, end k) of each item a block of
    `mlp_bwd_tf32x3_products` takes: items b, b + grid, ..., as `item_of`
    finds them."""
    prods = _fp32_products(M, C, H, plan)
    items = sum(p[-1] for p in prods)
    for block in range(plan.product_blocks):
        for item in range(block, items, plan.product_blocks):
            b, i = item, 0
            while i < 2 and b >= prods[i][-1]:
                b -= prods[i][-1]
                i += 1
            rows, cols, depth, slice_, tiles_n, tiles, _ = prods[i]
            k0 = b // tiles * slice_
            yield (block, i, b % tiles // tiles_n * TILE,
                   b % tiles_n * TILE, k0, min(depth, k0 + slice_))


@pytest.mark.parametrize("M,C,H", sorted(set(_ALL + _RAGGED + _CELL)))
def test_fp32_walk_takes_each_tile_and_slice_once(M, C, H):
    """Every output tile's depth is covered once, slice by slice, each slice
    a whole number of 32-deep stages where the depth is cut; the products
    are ordered deepest slices first."""
    for sms in FP32_SMS:
        plan = mlp.bwd_plan(M, C, H, C, sms)
        prods = _fp32_products(M, C, H, plan)
        assert [min(p[2], p[3]) for p in prods] == sorted((min(p[2], p[3]) for p in prods),
                                                          reverse=True)
        seen = {}
        for _, i, m0, n0, k0, k1 in _fp32_walk(M, C, H, plan):
            seen.setdefault((i, m0, n0), []).append((k0, k1))
        for i, (rows, cols, depth, slice_, *_) in enumerate(prods):
            assert slice_ >= depth or slice_ % mlp._SLICE == 0, (i, slice_)
            for m0 in range(0, rows, TILE):
                for n0 in range(0, cols, TILE):
                    spans = sorted(seen.pop((i, m0, n0)))
                    assert spans[0][0] == 0 and spans[-1][1] == depth
                    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
                    assert all(k1 > k0 and k0 % mlp._SLICE == 0 for k0, k1 in spans)
        assert not seen, sorted(seen)[:3]


@pytest.mark.parametrize("M,C,H", sorted(set(_ALL + _RAGGED + _CELL)))
def test_fp32_every_partial_is_reduced_once_in_a_fixed_order(M, C, H):
    for sms in FP32_SMS:
        plan = mlp.bwd_plan(M, C, H, C, sms)
        s_dx, s_w = -(-H // plan.slice_dx), -(-M // plan.slice_w)
        sums = [(s_dx, M * C)] * (s_dx > 1) + [(s_w, H * C), (s_w, C * H)] * (s_w > 1)
        for slices, n in sums + [(-(-M // TILE), H), (-(-M // TILE), C)]:
            assert n % 4 == 0 or slices >= DEEP     # 16 bytes a thread below DEEP
            order = [k for run in _reduce_order(slices) for k in run]
            assert sorted(order) == list(range(slices))


@pytest.mark.parametrize("M,C,H", sorted(set(_ALL + _RAGGED + _CELL)))
def test_fp32_hidden_tiles_own_each_bias_column_once(M, C, H):
    """The hidden launch's tiles, walked b, b + grid, ... by its blocks:
    each (row tile, 128 hidden units) once; db1 a tile's columns of its row
    tile; db2 a share of the row tile's C_out columns, tile tn the columns
    [tn share, (tn + 1) share) in windows of 128 (16-byte quads), share a
    multiple of 4: every column once, every tile at most a share."""
    n_h = TILE
    tiles_n, rows_t = -(-H // n_h), -(-M // TILE)
    for sms in FP32_SMS:
        blocks = mlp.bwd_plan(M, C, H, C, sms).hidden_blocks
        walked = sorted(b for blk in range(blocks) for b in range(blk, tiles_n * rows_t, blocks))
        assert walked == list(range(tiles_n * rows_t))
    db1, db2 = np.zeros(H, np.int32), np.zeros(C, np.int32)
    share = 4 * -(-(-(-C // tiles_n)) // 4)
    for tn in range(tiles_n):
        n0, t = tn * n_h, np.arange(n_h)
        db1[(n0 + t)[n0 + t < H]] += 1
        c_end = min(C, (tn + 1) * share)
        for c0 in range(tn * share, c_end, n_h):
            c = c0 + 4 * np.arange(n_h // 4)
            for e in range(4):
                db2[(c + e)[c < c_end]] += 1
        assert c_end - tn * share <= share
    assert (db1 == 1).all() and (db2 == 1).all()


@pytest.mark.parametrize("M,C,H", sorted(set(_ALL + _RAGGED + _CELL + _TP)))
def test_fp32_grids_never_exceed_the_sms(M, C, H):
    """One block an SM at most, and never more blocks than items."""
    for sms in FP32_SMS:
        plan = mlp.bwd_plan(M, C, H, C, sms)
        items = sum(p[-1] for p in _fp32_products(M, C, H, plan))
        assert 1 <= plan.product_blocks <= min(sms, items)
        assert 1 <= plan.hidden_blocks <= min(sms, -(-H // TILE) * -(-M // TILE))


@pytest.mark.parametrize("M,C,H", _CELL)
def test_fp32_plan_fills_the_card_at_the_cell_s_shapes(M, C, H):
    """At the batch-64 step every SM has a block in both persistent launches,
    and the product launch's busiest block has at most a fifth more work
    than the mean: its 32-deep stages, and two more for each tile it
    stores (an epilogue takes about as long)."""
    plan = mlp.bwd_plan(M, C, H, C, SMS)
    assert plan.hidden_blocks == plan.product_blocks == SMS
    loads = np.zeros(SMS)
    for block, _, _, _, k0, k1 in _fp32_walk(M, C, H, plan):
        loads[block] += -(-(k1 - k0) // mlp._SLICE) + 2
    assert loads.max() <= 1.2 * loads.mean(), (loads.max(), loads.mean())


def test_fp32_plan_constants_are_the_source_s():
    engine = (CSRC / "wgmma_tf32x3.cuh").read_text()
    bwd = (CSRC / "fused_mlp_bwd.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", engine)}
    assert consts["kBK"] == mlp._SLICE
    assert consts["kTile"] == TILE
    for kernel in ("mlp_bwd_tf32x3_hidden", "mlp_bwd_tf32x3_products"):
        assert re.search(r"__launch_bounds__\(kThreads, 1\)\s*\n" + kernel, bwd), kernel
    # the fp32 backward runs no mma.sync engine
    assert "Gemm<" not in bwd and "Engines" not in bwd


def test_fp32_hidden_products_never_split_into_a_set_in_use():
    """The hidden launch's two products run through one ring: h's last
    slice is left in flight (`kDrain` false) while dy W2's first is split.
    `consume` splits slice kt into plane set (set0 + kt) % 2 once only the
    slice before it may be in flight, so the sets of consecutive slices,
    across the two calls too, must differ for every depth of x."""
    bwd = (CSRC / "fused_mlp_bwd.cu").read_text()
    first = re.search(r"consume<0, 0, false>\(hacc, r, pos, planes, n1, at\);", bwd)
    second = re.search(r"consume<0, 1>\(dacc, r, pos, planes, n2, at(?:, ([^)]+))?\);", bwd)
    assert first and second and first.start() < second.start()
    engine = (CSRC / "wgmma_tf32x3.cuh").read_text()
    assert "planes + ((set0 + kt) & 1) * kPlaneSetBytes" in engine
    for n1 in range(1, 26):
        set0 = eval(second.group(1) or "0", {}, {"n1": n1})
        sets = [kt & 1 for kt in range(n1)] + [(set0 + kt) & 1 for kt in range(3)]
        assert all(a != b for a, b in zip(sets, sets[1:])), (n1, sets)


def _replay_fp32_bwd(x, w1, b1, w2, dy, plan):
    """The fp32 backward's sums as the plan cuts them, w1 (C, H), w2 (H, C)."""
    M, C = x.shape
    h = x @ w1 + b1
    cdf = 0.5 * (1 + torch.erf(h * 0.7071067811865476))
    a = h * cdf
    g = (dy @ w2.t()) * (cdf + h * torch.exp(-0.5 * h * h) * 0.3989422804014327)
    dx = _sliced(g, w1.t(), plan.slice_dx)
    dw1 = _sliced(x.t(), g, plan.slice_w)
    dw2 = _sliced(a.t(), dy, plan.slice_w)
    rows = [slice(m, m + TILE) for m in range(0, M, TILE)]
    db1 = _sliced(torch.ones(1, len(rows)), torch.stack([g[r].sum(0) for r in rows]), 1)[0]
    db2 = _sliced(torch.ones(1, len(rows)), torch.stack([dy[r].sum(0) for r in rows]), 1)[0]
    return dx, dw1, db1, dw2, db2


@pytest.mark.parametrize("M,C,H", [(300, 40, 160), (520, 32, 128), (37, 96, 384), (8448, 16, 64),
                                   (1000, 192, 768)])
def test_fp32_sliced_backward_matches_plain(M, C, H):
    """The plan's cuts (dx over H, the weight gradients over the rows; 8448
    rows make 33 slices, the reduce's interleaved runs) and the reduce's
    order give the plain fp32 backward's gradients, to fp32 rounding (the
    card's 1e-4 gradient gate)."""
    rng = np.random.default_rng(M + C + H)
    x, dy = (torch.from_numpy(rng.standard_normal((M, C), np.float32)) for _ in range(2))
    w1 = torch.from_numpy(rng.standard_normal((C, H), np.float32)) / C ** 0.5
    w2 = torch.from_numpy(rng.standard_normal((H, C), np.float32)) / H ** 0.5
    b1 = torch.from_numpy(0.1 * rng.standard_normal(H).astype(np.float32))
    b2 = torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32))
    plan = mlp.bwd_plan(M, C, H, C, SMS)
    assert plan.slice_dx < H or plan.slice_w < M
    got = _replay_fp32_bwd(x, w1, b1, w2, dy, plan)
    want = mlp.mlp_bwd_plain(x, w1, b1, w2, b2, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
