"""The bf16 selective-scan kernels' arithmetic on the CPU.

The bf16 variants of `fusionmamba_torch/csrc/selective_scan_fwd.cu` and
`selective_scan_bwd.cu` differ from the fp32 ones in three pieces
(`csrc/scan_common.cuh`, the bf16_path section):
  * the low-rank expansion x = dt W^T (and, in the backward, d(dt) = dx W and
    dW += dx^T dt) on the tensor cores, warp-level mma.sync.m16n8k16 on
    bf16 operands with fp32 sums, taking its fragments from the staged tiles;
  * the softplus and its slope in MUFU form (ex2, lg2 and rcp, with a
    polynomial for log1p(e) at e < 1/16);
  * dx, which is fp32, entering those products as two bf16 terms
    hi = bf16(dx) and lo = bf16(dx - hi).
Here plain-torch replays of each piece, written with the kernels' own
index arithmetic, are held against the functions they compute, and a replay
of the whole bf16 forward and backward against the JAX package's scan
(`impl="ref"`, the sequential scan; never the TPU's cumsum form). The kernels
themselves run only on the card (tests/test_torch_kernels.py).

Inputs come from numpy seeds, rounded to bf16 values and passed to both
sides as fp32. Tolerances: the softplus and slope within 1e-5 relative of
jax.nn.softplus and jax.nn.sigmoid; the split products within 1e-5 of their
largest entry (the split keeps about 16 of dx's bits); the whole scan
within the bf16 gate of the card's checks, 8e-3 |v| + 8e-3 max |v|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch.ops import scan_cuda
from fusionmamba_torch.ops.selective_scan import selective_scan_plain
from fusionmamba_tpu.ops.selective_scan import selective_scan as jax_selective_scan

LOG2E, LN2, CUT = 1.4426950408889634, 0.6931471805599453, 0.0625
FWD_DB, BWD_DB, T_FWD, T_BWD = 32, 64, 16, 8   # channels a block, steps a tile
BWD_WARPS = 8                                  # warps of a backward block
SMEM_PER_SM, RESERVED_PER_BLOCK = 228 * 1024, 1024   # an H100 SM's shared memory


def _bf16_values(a):
    """numpy fp32 array of the bf16 values nearest to `a`."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# the softplus and its slope in MUFU form

def softplus_slope_mufu(x: torch.Tensor):
    """`softplus_slope` of scan_common.cuh in plain torch fp32: e =
    2^(-|x| log2 e), u = 1 + e, log1p(e) from the polynomial below 1/16 and
    from log2(u) ln 2 above, slope 1/u or e/u."""
    x = x.float()
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    e = torch.exp2(-f(LOG2E) * x.abs())
    u = 1.0 + e
    p = e * f(0.2) - f(0.25)
    p = e * p + f(0.333333343)
    p = e * p - f(0.5)
    p = e * p + 1.0
    lp = torch.where(e < CUT, e * p, torch.log2(u) * f(LN2))
    inv = 1.0 / u
    return torch.clamp_min(x, 0.0) + lp, torch.where(x >= 0, inv, e * inv)


def test_softplus_and_slope_mufu_form_match_jax():
    """Over x in [-80, 80] (and at the cut e = 1/16, x = +-ln 16), within
    1e-5 relative of jax.nn.softplus and jax.nn.sigmoid at every x."""
    x = np.concatenate([np.linspace(-80, 80, 400001), [np.log(16.0), -np.log(16.0), 0.0],
                        np.nextafter(np.float32(np.log(16.0)), np.float32(0)) * np.array([1, -1])])
    x = x.astype(np.float32)
    delta, slope = softplus_slope_mufu(torch.from_numpy(x))
    want_d = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    want_s = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    assert np.all(np.abs(delta.numpy() - want_d) <= 1e-5 * np.abs(want_d))
    assert np.all(np.abs(slope.numpy() - want_s) <= 1e-5 * np.abs(want_s))


def test_softplus_polynomial_is_needed_below_the_cut():
    """Below e = 1/16 the logarithm of u = 1 + e alone would carry u's
    rounding, up to 2^-24 absolutely, a large part of log1p(e) at e near
    1e-6 (and lg2.approx adds about 2^-22 on the card); the polynomial keeps
    1e-5 there."""
    x = torch.linspace(12.0, 16.0, 50)
    delta, _ = softplus_slope_mufu(-x)
    want = np.log1p(np.exp(-x.double().numpy()))
    assert np.all(np.abs(delta.double().numpy() - want) <= 1e-5 * want)
    e = torch.exp(-x)
    via_log = (torch.log2(1.0 + e) * LN2).double().numpy()
    assert np.max(np.abs(via_log - want) / want) > 1e-3


# ---------------------------------------------------------------------------
# the tensor-core tiling: a replay of the kernels' fragments

def mma_m16n8k16(a, b, d):
    """One warp's mma.sync.m16n8k16.row.col: a[lane] = 4 registers of two
    values each, b[lane] = 2 registers, d[lane] = 4 sums (float64). Builds A
    (16 x 16) and B (16 x 8) from the fragments as PTX lays them out,
    checking that every entry comes from exactly one lane, and returns the
    new d."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    seen_a, seen_b = np.zeros((16, 16), int), np.zeros((16, 8), int)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for reg, (row, col) in enumerate([(g, 2 * q), (g + 8, 2 * q), (g, 2 * q + 8),
                                          (g + 8, 2 * q + 8)]):
            A[row, col:col + 2] = a[lane][reg]
            seen_a[row, col:col + 2] += 1
        for reg, k in enumerate([2 * q, 2 * q + 8]):
            B[k:k + 2, g] = b[lane][reg]
            seen_b[k:k + 2, g] += 1
    assert (seen_a == 1).all() and (seen_b == 1).all()
    D = A @ B
    out = []
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        out.append(np.array(d[lane]) + [D[g, 2 * q], D[g, 2 * q + 1], D[g + 8, 2 * q],
                                        D[g + 8, 2 * q + 1]])
    return out


def w16_tile(W, d0, dim, R, DB):
    """`load_w16`: the block's W as [DB][w16_ld(R)], zeros past R and `dim`."""
    ld = scan_cuda.w16_ld(R)
    tile = np.zeros((DB, ld))
    cols = max(0, min(DB, dim - d0))
    tile[:cols, :R] = W[d0:d0 + cols]
    return tile


def pair_of(row, k, n):
    """`pair_of`: elements k, k+1 of a row of n values, zeros past n."""
    return [row[k] if k < n else 0.0, row[k + 1] if k + 1 < n else 0.0]


def delta_products(dt_tile, R, w16, c0, rows):
    """`delta_products<rows>` for the warp of channels c0 .. c0+7: x[t][c]
    for t < rows, from the fragments the kernel loads. dt_tile is the staged
    [t][R] tile as a flat array (rows past the tile's steps included)."""
    d = [[0.0] * 4 for _ in range(32)]
    for k0 in range(0, R, 16):
        a, b = [], []
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            k = k0 + 2 * q
            lo, hi = dt_tile[g * R:(g + 1) * R], dt_tile[(g + 8) * R:(g + 9) * R]
            a.append([pair_of(lo, k, R), pair_of(hi, k, R) if rows == 16 else [0, 0],
                      pair_of(lo, k + 8, R), pair_of(hi, k + 8, R) if rows == 16 else [0, 0]])
            wrow = w16[c0 + g]
            b.append([wrow[k:k + 2], wrow[k + 8:k + 10]])
        d = mma_m16n8k16(a, b, d)
    x = np.full((16, 8), np.nan)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        x[g, 2 * q:2 * q + 2] = d[lane][:2]
        if rows == 16:
            x[g + 8, 2 * q:2 * q + 2] = d[lane][2:]
    return x[:rows]


def dw_products(dt_tile, R, dx, Tc, c0):
    """The backward's dW step for one warp and one tile: dW^T[r][c] = sum over
    t < Tc of dt[t][r] dx[t][c0 + c], k = t, row tiles of 16 r."""
    out = np.zeros((-(-R // 16) * 16, 8))
    bx = [[dx[2 * (l & 3) + j, c0 + (l >> 2)] if 2 * (l & 3) + j < Tc else 0.0
           for j in range(2)] for l in range(32)]
    for m in range(-(-R // 16)):
        def dtv(t, r):
            return dt_tile[t * R + r] if t < Tc and r < R else 0.0
        a = [[[dtv(2 * (l & 3), 16 * m + (l >> 2)), dtv(2 * (l & 3) + 1, 16 * m + (l >> 2))],
              [dtv(2 * (l & 3), 16 * m + (l >> 2) + 8),
               dtv(2 * (l & 3) + 1, 16 * m + (l >> 2) + 8)],
              [0, 0], [0, 0]] for l in range(32)]
        d = mma_m16n8k16(a, [[bx[l], [0, 0]] for l in range(32)], [[0.0] * 4] * 32)
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            out[16 * m + g, 2 * q:2 * q + 2] = d[lane][:2]
            out[16 * m + g + 8, 2 * q:2 * q + 2] = d[lane][2:]
    return out[:R]


def ddt_products(dx, wt, R):
    """The backward's d(dt) step for one tile: d(dt)[t][r] = sum over the
    block's 64 channels of dx[t][d] W[d][r], rows t of the 8-step tile. As in
    the kernel, warp j of the block's BWD_WARPS takes the column groups
    8j, 8j + 64, ... below R; every (t, r) must be written exactly once."""
    out = np.zeros((8, R))
    written = np.zeros((8, R), int)
    for warp in range(BWD_WARPS):
        for cg in range(8 * warp, R, 8 * BWD_WARPS):
            d = [[0.0] * 4 for _ in range(32)]
            for k0 in range(0, BWD_DB, 16):
                a = [[dx[l >> 2, k0 + 2 * (l & 3):k0 + 2 * (l & 3) + 2], [0, 0],
                      dx[l >> 2, k0 + 8 + 2 * (l & 3):k0 + 10 + 2 * (l & 3)], [0, 0]]
                     for l in range(32)]
                b = [[wt[cg + (l >> 2), k0 + 2 * (l & 3):k0 + 2 * (l & 3) + 2],
                      wt[cg + (l >> 2), k0 + 8 + 2 * (l & 3):k0 + 10 + 2 * (l & 3)]]
                     for l in range(32)]
                d = mma_m16n8k16(a, b, d)
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                for j in range(2):
                    if cg + 2 * q + j < R:
                        out[g, cg + 2 * q + j] = d[lane][j]
                        written[g, cg + 2 * q + j] += 1
    assert (written == 1).all(), written
    return out


@pytest.mark.parametrize("R", [0, 5, 6, 12, 24, 48, 72, 128])
@pytest.mark.parametrize("dim", [64, 40])
def test_mma_tiling_covers_every_product_once(R, dim):
    """Integer inputs, so every sum is exact: the fragments of the forward's
    16 x 32 and the backward's 8 x 64 tiles give dt W^T over exactly the
    block's (t, d, r), with k past R zero (odd R through the 16-bit
    loads), channels past `dim` zero (ragged D), and the backward's dW and
    d(dt) steps exactly dt^T dx and dx W; rows past the tile's steps never
    reach a sum. At R = 0 no product runs: the full dt takes the fp32 path."""
    rng = np.random.default_rng(R * 100 + dim)
    W = rng.integers(-4, 5, (dim, R)).astype(float)
    if R == 0:
        assert not range(0, R, 16)      # no k step: the kernels take `delta_phase`
    for DB, rows in ((FWD_DB, T_FWD), (BWD_DB, T_BWD)):
        Tc = rows - 3                   # a ragged last tile: junk in its last rows
        dt = rng.integers(-4, 5, (rows, R)).astype(float)
        dt[Tc:] = np.nan
        tile = dt.ravel()
        for d0 in range(0, dim, DB):
            w16 = w16_tile(W, d0, dim, R, DB)
            for c0 in range(0, DB, 8):
                x = delta_products(tile, R, w16, c0, rows)[:Tc]
                want = dt[:Tc] @ w16[c0:c0 + 8, :R].T if R else np.zeros((Tc, 8))
                np.testing.assert_array_equal(x, want)
                dead = slice(max(0, min(8, dim - d0 - c0)), 8)
                assert (x[:, dead] == 0).all()
    if R == 0:
        return
    Tc = 7
    dt = rng.integers(-4, 5, (T_BWD, R)).astype(float)
    dx = rng.integers(-4, 5, (T_BWD, BWD_DB)).astype(float)
    dt[Tc:], dx[Tc:] = np.nan, np.nan
    tile = dt.ravel()
    for c0 in range(0, BWD_DB, 8):
        np.testing.assert_array_equal(dw_products(tile, R, dx, Tc, c0),
                                      dt[:Tc].T @ dx[:Tc, c0:c0 + 8])
    wt = np.zeros((-(-R // 8) * 8, BWD_DB + 8))
    wt[:R, :min(dim, BWD_DB)] = W[:BWD_DB].T
    got = ddt_products(dx, wt, R)
    np.testing.assert_array_equal(got[:Tc], dx[:Tc] @ wt[:R, :BWD_DB].T)


# ---------------------------------------------------------------------------
# dx in two bf16 terms

def split_hi_lo(v: torch.Tensor):
    """`split2`: hi = bf16(v), lo = bf16(v - hi), as fp32 values."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def test_split_products_keep_dx_to_1e5():
    """d(dt) = dx W and dW = dx^T dt with dx in two bf16 terms and W, dt bf16
    (every product exact, sums in float64): within 1e-5 of the largest entry
    of the fp32 products, where one bf16 term alone misses by far more."""
    rng = np.random.default_rng(0)
    T, DB, R = 8, 64, 48
    dx = torch.from_numpy((rng.standard_normal((T, DB)) * 10.0 ** rng.uniform(-3, 1, (T, DB)))
                          .astype(np.float32))
    W = torch.from_numpy(_bf16_values(rng.standard_normal((DB, R)) / 7))
    dt = torch.from_numpy(_bf16_values(rng.standard_normal((T, R))))
    hi, lo = split_hi_lo(dx)
    for got, one, want in (((hi.double() @ W.double()) + lo.double() @ W.double(),
                            hi.double() @ W.double(), dx.double() @ W.double()),
                           (hi.double().T @ dt.double() + lo.double().T @ dt.double(),
                            hi.double().T @ dt.double(), dx.double().T @ dt.double())):
        scale = float(want.abs().max())
        assert float((got.float().double() - want).abs().max()) <= 1e-5 * scale
        assert float((one - want).abs().max()) > 1e-4 * scale


# ---------------------------------------------------------------------------
# the whole bf16 scan, replayed, against the JAX package

def _case(seed, L, D, R, batch=2, K=4, N=16):
    rng = np.random.default_rng(seed)
    return (_bf16_values(rng.standard_normal((batch, K, L, D))),
            _bf16_values(0.5 * rng.standard_normal((batch, K, L, R))),
            (-np.exp(rng.uniform(0.0, 1.5, (K, D, N)))).astype(np.float32),
            _bf16_values(rng.standard_normal((batch, K, L, N))),
            _bf16_values(rng.standard_normal((batch, K, L, N))),
            rng.standard_normal((K, D)).astype(np.float32),
            (rng.standard_normal((K, D)) - 1.0).astype(np.float32),
            _bf16_values(rng.uniform(-R ** -0.5, R ** -0.5, (K, D, R))),
            _bf16_values(rng.standard_normal((batch, K, L, D))))


def _bf16_gate(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = 8e-3 * np.abs(want) + 8e-3 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound), float((np.abs(got - want) - bound).max())


def bf16_scan_replay(u, dt, A, Bm, Cm, Dp, bias, W, dy):
    """The bf16 kernels' arithmetic in plain torch: x = dt W^T (exact
    products, a float64 sum rounded to fp32) + bias, delta and the slope in
    MUFU form, the scan and its gradients in fp32 through autograd but for
    d(dt) and dW, which take dx in two bf16 terms; every I/O output rounded
    to bf16. Returns y and (du, d(dt), dA, dB, dC, dD, dbias, dW)."""
    t = [torch.from_numpy(a) for a in (u, dt, A, Bm, Cm, Dp, bias, W, dy)]
    u_, dt_, A_, B_, C_, D_, bias_, W_, dy_ = t
    x = (torch.einsum("bklr,kdr->bkld", dt_.double(), W_.double()).float()
         + bias_[None, :, None, :]).requires_grad_(True)
    live = [a.clone().requires_grad_(True) for a in (u_, A_, B_, C_, D_)]
    delta, slope = softplus_slope_mufu(x.detach())
    delta = delta + (x - x.detach())          # its gradient flows into x at slope 1 ...
    y = selective_scan_plain(live[0], delta, live[1], live[2], live[3], live[4])
    gu, gA, gB, gC, gD, gx = torch.autograd.grad(y, live + [x], dy_)
    dx = gx * slope                           # ... and is scaled by the MUFU slope here
    hi, lo = split_hi_lo(dx)
    ddt = (torch.einsum("bkld,kdr->bklr", hi.double(), W_.double())
           + torch.einsum("bkld,kdr->bklr", lo.double(), W_.double())).float()
    dW = (torch.einsum("bkld,bklr->kdr", hi.double(), dt_.double())
          + torch.einsum("bkld,bklr->kdr", lo.double(), dt_.double())).float()
    bf = lambda v: v.to(torch.bfloat16).float().numpy()  # noqa: E731
    return bf(y.detach()), (bf(gu), bf(ddt), gA.numpy(), bf(gB), bf(gC), gD.numpy(),
                            dx.sum((0, 2)).numpy(), bf(dW))


@pytest.mark.parametrize("L,D,R", [(40, 24, 6), (17, 40, 12), (9, 16, 5)])
def test_bf16_scan_replay_matches_jax_ref(L, D, R):
    """The replay's y and every gradient against the JAX package's
    sequential scan (`impl="ref"`) and its autodiff on the same bf16-valued
    inputs in fp32, within the bf16 gate."""
    u, dt, A, Bm, Cm, Dp, bias, W, dy = _case(L * 7 + D + R, L, D, R)
    y, grads = bf16_scan_replay(u, dt, A, Bm, Cm, Dp, bias, W, dy)

    def ref(u, dt, A, Bm, Cm, Dp, bias, W):
        return jax_selective_scan(u, dt, A, Bm, Cm, Dp, bias, delta_softplus=True,
                                  impl="ref", dt_lowrank_weight=W)

    want, vjp = jax.vjp(ref, *map(jnp.asarray, (u, dt, A, Bm, Cm, Dp, bias, W)))
    _bf16_gate(y, want)
    for got, w in zip(grads, vjp(jnp.asarray(dy))):
        _bf16_gate(got, w)


# ---------------------------------------------------------------------------
# shared memory

@pytest.mark.parametrize("N,R", [(16, 6), (16, 12), (16, 24), (16, 48), (16, 0), (16, 5)])
def test_bf16_shared_memory_fits_its_blocks(N, R):
    """The bf16 forward stays under the 48 KB that needs no opt-in (4 blocks
    of 128 threads and more an SM), and the bf16 backward's main pass fits
    the two blocks an SM that its `__launch_bounds__(256, 2)` asks, each
    with the 1 KB the card reserves for it."""
    assert scan_cuda.fwd_smem_bytes(N, R, torch.bfloat16) <= 48 * 1024
    need = scan_cuda.bwd_smem_bytes(N, R, torch.bfloat16) + RESERVED_PER_BLOCK
    assert 2 * need <= SMEM_PER_SM


# ---------------------------------------------------------------------------
# the A/B tool and the subset build it asks for

def test_scan_bf16_ab_needs_trees_and_a_card():
    """The A/B timing tool asks for at least one checkout, and without a
    card exits before it starts any process."""
    from fusionmamba_torch.tools import scan_bf16_ab

    with pytest.raises(SystemExit):
        scan_bf16_ab.main([])
    with pytest.raises(SystemExit, match="no CUDA device"):
        scan_bf16_ab.main(["."])


def test_cuda_lib_builds_the_sources_the_environment_names(monkeypatch):
    """FM_CUDA_SOURCES picks a subset of the sources, in their own order,
    into a build directory of its own; a name that is no source raises."""
    from fusionmamba_torch.ops import cuda_lib

    monkeypatch.delenv(cuda_lib.SOURCES_ENV, raising=False)
    assert cuda_lib.sources() == cuda_lib.SOURCES
    full = cuda_lib._digest(cuda_lib.sources())
    monkeypatch.setenv(cuda_lib.SOURCES_ENV, "selective_scan_bwd.cu,selective_scan_fwd.cu")
    assert cuda_lib.sources() == ("selective_scan_fwd.cu", "selective_scan_bwd.cu")
    assert cuda_lib._digest(cuda_lib.sources()) != full
    monkeypatch.setenv(cuda_lib.SOURCES_ENV, "selective_scan_fwd.cu,nothing.cu")
    with pytest.raises(ValueError, match="nothing.cu"):
        cuda_lib.sources()


def test_ab_step_sums_and_diffs(tmp_path):
    """A step's device ms is its calls a shape times the ms a call, for each
    kind it calls; the diffs are each tree's against the first: relative
    over the largest entry, and absolute for the fp32 outputs."""
    from fusionmamba_torch.tools import _ab

    got = {"[1, 2]": {"fwd": 0.5, "bwd": 2.0}, "[3, 4]": {"fwd": 0.25, "bwd": 1.0}}
    calls = {"train 6": {"fwd": {(1, 2): 2, (3, 4): 4}, "bwd": {(1, 2): 1}},
             "serve 8": {"fwd": {(3, 4): 3}, "bwd": {}}}
    assert _ab.step_sums(got, calls) == {"train 6": {"fwd": 2.0, "bwd": 2.0},
                                         "serve 8": {"fwd": 0.75}}
    ref = {"[1]": [torch.tensor([4.0, -2.0])], "fp32 [1]": [torch.tensor([1.0, 2.0])]}
    other = {"[1]": [torch.tensor([4.0, -1.0])], "fp32 [1]": [torch.tensor([1.0, 2.5])]}
    torch.save(ref, tmp_path / "a.pt")
    torch.save(other, tmp_path / "b.pt")
    rel, abs32 = _ab.diffs({"a": tmp_path / "a.pt", "b": tmp_path / "b.pt"})
    assert rel == {"a": 0.0, "b": 0.25} and abs32 == {"a": 0.0, "b": 0.5}


def test_ab_rel_diff_by_output(tmp_path):
    """Each output's largest difference from the first tree's, over its
    largest entry, fp32 outputs too; the worst of a key's tensors."""
    from fusionmamba_torch.tools import _ab

    ref = {"[1]": [torch.tensor([4.0, -2.0]), torch.tensor([1.0])],
           "fp32 [1]": [torch.tensor([1.0, 2.0])]}
    other = {"[1]": [torch.tensor([4.0, -1.0]), torch.tensor([0.0])],
             "fp32 [1]": [torch.tensor([1.0, 2.5])]}
    torch.save(ref, tmp_path / "a.pt")
    torch.save(other, tmp_path / "b.pt")
    got = _ab.rel_by_output({"a": tmp_path / "a.pt", "b": tmp_path / "b.pt"})
    assert got == {"a": {"[1]": 0.0, "fp32 [1]": 0.0}, "b": {"[1]": 1.0, "fp32 [1]": 0.25}}
