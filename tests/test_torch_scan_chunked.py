"""The chunked selective scan's algebra on the CPU.

The CUDA kernels (`fusionmamba_torch/csrc/selective_scan_fwd.cu`,
`selective_scan_bwd.cu`) cut L into chunks that run in parallel. The
recurrence is linear and diagonal,
    h_l = e_l * h_{l-1} + x_l,   e_l = exp(dt_l * A),  x_l = dt_l * u_l * B_l,
so a chunk maps its start state to `P * h_start + h_local`, with
`P = exp(A * sum of dt over the chunk)` and `h_local` its end state from a zero
start. Nothing is divided by P: where it underflows to 0 that is the right
answer. The adjoint `g_l = C_l * dy_l + e_{l+1} * g_{l+1}` takes the same
treatment in reverse. `chunked_fwd` and `chunked_bwd` below repeat the
kernels' passes in plain PyTorch (local pass, carries, restart; saved states,
recompute, adjoint, per-chunk and per-d-block partials summed in a fixed
order). Here that decomposition is held against the sequential scan
(`selective_scan_plain`) and its autograd, and the forward also against the
JAX package's exact scan (`impl="ref"`, as tests/test_scan.py runs it on the
CPU). Inputs come from a numpy seed. The kernels themselves are held against
the plain version on the card (tests/test_torch_kernels.py).

Tolerances. The chunked form takes the same fp32 sums in another order (a
chunk's start state enters through one multiplication by exp(A * sum dt)
instead of a product of the step factors): y within 1e-5 absolute and
relative; each gradient within 1e-4 of its own largest entry plus 1e-4
relative, as sums of many terms of both signs round with the magnitude
summed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionmamba_torch.ops import scan_cuda
from fusionmamba_torch.ops.selective_scan import (materialize_dt, selective_scan_plain,
                                                  softplus)
from fusionmamba_tpu.ops.selective_scan import selective_scan as jax_selective_scan

Y_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = GRAD_SCALED_ATOL = 1e-4

# (L, D, N, R, chunk, save_every, dt_shift)
CASES = {
    "two_chunks_ragged": (40, 8, 4, 2, 32, 8, 0.0),      # L not a multiple of the chunk
    "one_step": (1, 8, 4, 3, 16, 8, 0.0),                # L = 1
    "shorter_than_chunk": (11, 8, 16, 2, 64, 8, 0.0),    # L shorter than one chunk
    "full_dt": (50, 6, 4, 0, 16, 8, 0.0),                # R = 0
    "ragged_d": (35, 70, 4, 2, 16, 8, 0.0),              # D not a multiple of 64
    "small_state": (33, 8, 2, 2, 16, 4, 0.0),            # N < 16, states saved every 4
    "many_chunks": (100, 8, 16, 5, 16, 16, 0.0),         # 7 chunks, states saved every 16
    "large_dt": (64, 8, 4, 2, 16, 8, 8.0),               # softplus(dt) ~ 8: carries underflow
    "chunk_edges": (65, 8, 4, 2, 32, 8, 0.0),            # one more than a chunk multiple
    "chunk_edges_less": (63, 8, 4, 0, 32, 8, 0.0),       # one less
}


def _inputs(seed, L, D, N, R, dt_shift, batch=2, K=4):
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.standard_normal((batch, K, L, D)).astype(f)
    dt = (0.5 * rng.standard_normal((batch, K, L, R or D))).astype(f)
    W = rng.uniform(-R ** -0.5, R ** -0.5, (K, D, R)).astype(f) if R else None
    A = -np.exp(rng.uniform(0.0, 1.5, (K, D, N))).astype(f)
    Bm = rng.standard_normal((batch, K, L, N)).astype(f)
    Cm = rng.standard_normal((batch, K, L, N)).astype(f)
    Dp = rng.standard_normal((K, D)).astype(f)
    bias = (rng.standard_normal((K, D)) + dt_shift).astype(f)
    return u, dt, A, Bm, Cm, Dp, bias, W


def _factors(u, delta, A, Bmat, delta_bias, delta_softplus, dt_lowrank_weight):
    """x (pre-softplus), dt (B,K,L,D), e and the input term (B,K,L,D,N)."""
    x = materialize_dt(delta.float(), dt_lowrank_weight)
    if delta_bias is not None:
        x = x + delta_bias.float()[None, :, None, :]
    dt = softplus(x) if delta_softplus else x
    e = torch.exp(dt[..., None] * A.float()[None, :, None])
    inp = (dt * u.float())[..., None] * Bmat.float()[:, :, :, None, :]
    return x, dt, e, inp


def chunked_fwd(u, delta, A, Bmat, Cmat, D=None, delta_bias=None, delta_softplus=False,
                     dt_lowrank_weight=None, chunk=64, save_every=None):
    """The forward kernel's three passes. Returns y, or (y, hsave) with
    `save_every`: the states at the start of every `save_every` steps,
    (B, K, ceil(L / save_every), D, N)."""
    L = u.shape[2]
    _, dt, e, inp = _factors(u, delta, A, Bmat, delta_bias, delta_softplus, dt_lowrank_weight)
    bounds = [(s, min(L, s + chunk)) for s in range(0, L, chunk)]
    zero = torch.zeros_like(e[:, :, 0])
    # local pass: every chunk but the last from a zero start
    local, sum_dt = [], []
    for s, t in bounds[:-1]:
        h = zero
        for l in range(s, t):
            h = e[:, :, l] * h + inp[:, :, l]
        local.append(h)
        sum_dt.append(dt[:, :, s:t].sum(2))
    # carries: the true start state of every chunk
    starts = [zero]
    for h_local, sd in zip(local, sum_dt):
        starts.append(torch.exp(A.float()[None] * sd[..., None]) * starts[-1] + h_local)
    # main pass: every chunk restarted from its start state
    ys, saved = [], []
    Cf = Cmat.float()
    for (s, t), h in zip(bounds, starts):
        for l in range(s, t):
            if save_every and l % save_every == 0:
                saved.append(h)
            h = e[:, :, l] * h + inp[:, :, l]
            ys.append((h * Cf[:, :, l, None, :]).sum(-1))
    y = torch.stack(ys, dim=2)
    if D is not None:
        y = y + u.float() * D.float()[None, :, None, :]
    return (y, torch.stack(saved, dim=2)) if save_every else y


def chunked_bwd(u, delta, A, Bmat, Cmat, D, delta_bias, dt_lowrank_weight, hsave, dy,
                     delta_softplus=False, chunk=64, save_every=8, d_block=64):
    """The backward kernel's passes, given the forward's saved states:
    (du, ddelta, dA, dB, dC, dD, dbias, dW), None for an input that was None."""
    batch, K, L, dim = u.shape
    uf, dyf, Af = u.float(), dy.float(), A.float()
    Bf, Cf = Bmat.float(), Cmat.float()
    x, dt, e, inp = _factors(u, delta, A, Bmat, delta_bias, delta_softplus, dt_lowrank_weight)
    slope = torch.sigmoid(x) if delta_softplus else torch.ones_like(x)
    bounds = [(s, min(L, s + chunk)) for s in range(0, L, chunk)]
    zero = torch.zeros_like(e[:, :, 0])
    # local adjoint of every chunk but the first, from a zero start
    local, sum_dt = {}, {}
    for c in range(1, len(bounds)):
        s, t = bounds[c]
        g = zero
        for l in reversed(range(s, t)):
            g = e[:, :, l] * (Cf[:, :, l, None, :] * dyf[:, :, l, :, None] + g)
        local[c], sum_dt[c] = g, dt[:, :, s:t].sum(2)
    # carries, last chunk first: what enters each chunk from its right
    enters = {len(bounds) - 1: zero}
    for c in range(len(bounds) - 1, 0, -1):
        enters[c - 1] = torch.exp(Af[None] * sum_dt[c][..., None]) * enters[c] + local[c]
    # main pass: per chunk, tiles of `save_every` steps in reverse
    du, dx = torch.zeros_like(uf), torch.zeros_like(uf)
    term_b = torch.zeros_like(e)      # g dt u per (l, d, n), summed over d below
    term_c = torch.zeros_like(e)      # dy h_l
    dA_p, dD_p, dbias_p = [], [], []
    for c, (s, t) in enumerate(bounds):
        g_carry = enters[c]
        dA_c = zero
        for s0 in reversed(range(s, t, save_every)):
            t0 = min(t, s0 + save_every)
            hs = [hsave[:, :, s0 // save_every]]         # recompute from the saved state
            for l in range(s0, t0):
                hs.append(e[:, :, l] * hs[-1] + inp[:, :, l])
            for l in reversed(range(s0, t0)):
                h_prev, h_cur = hs[l - s0], hs[l - s0 + 1]
                g = Cf[:, :, l, None, :] * dyf[:, :, l, :, None] + g_carry
                eh = e[:, :, l] * h_prev
                gd = g * dt[:, :, l, :, None]
                ub = uf[:, :, l, :, None] * Bf[:, :, l, None, :]
                ddelta = (g * (Af[None] * eh + ub)).sum(-1)
                dA_c = dA_c + gd * eh
                du[:, :, l] = (gd * Bf[:, :, l, None, :]).sum(-1)
                g_carry = e[:, :, l] * g
                term_b[:, :, l] = gd * uf[:, :, l, :, None]
                term_c[:, :, l] = dyf[:, :, l, :, None] * h_cur
                dx[:, :, l] = ddelta * slope[:, :, l]
        dA_p.append(dA_c)
        dD_p.append((dyf[:, :, s:t] * uf[:, :, s:t]).sum(2))
        dbias_p.append(dx[:, :, s:t].sum(2))
    if D is not None:
        du = du + dyf * D.float()[None, :, None, :]

    def over_chunks_and_batch(parts):
        return torch.stack(parts, 0).sum(0).sum(0)

    def over_d_blocks(term):       # (B,K,L,D,n) -> (B,K,L,n): within a block, then over blocks
        parts = [term[:, :, :, d0:d0 + d_block].sum(3) for d0 in range(0, dim, d_block)]
        return torch.stack(parts, 0).sum(0)

    dW = None
    if dt_lowrank_weight is not None:
        Wf = dt_lowrank_weight.float()
        ddt = over_d_blocks(dx[..., None] * Wf[None, :, None])
        dW_p = [torch.einsum("bkld,bklr->bkdr", dx[:, :, s:t], delta.float()[:, :, s:t])
                for s, t in bounds]
        dW = over_chunks_and_batch(dW_p)
    else:
        ddt = dx
    return (du, ddt, over_chunks_and_batch(dA_p), over_d_blocks(term_b), over_d_blocks(term_c),
            None if D is None else over_chunks_and_batch(dD_p),
            None if delta_bias is None else over_chunks_and_batch(dbias_p), dW)


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_chunked_forward_matches_sequential_and_jax(case):
    L, D, N, R, chunk, save_every, shift = CASES[case]
    arrays = _inputs(L * 13 + D, L, D, N, R, shift)
    t = _torch(arrays)
    got = chunked_fwd(*t[:7], delta_softplus=True, dt_lowrank_weight=t[7],
                                        chunk=chunk)
    want = selective_scan_plain(*t[:7], delta_softplus=True, dt_lowrank_weight=t[7])
    torch.testing.assert_close(got, want, **Y_TOL)
    assert torch.isfinite(got).all()
    ref = jax_selective_scan(*map(jnp.asarray, arrays[:7]), delta_softplus=True, impl="ref",
                             dt_lowrank_weight=None if R == 0 else jnp.asarray(arrays[7]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **Y_TOL)


@pytest.mark.parametrize("case", CASES)
def test_chunked_forward_saves_true_states(case):
    """The saved states are those of the sequential scan, whatever the
    chunks, and one chunk saves the same as many."""
    L, D, N, R, chunk, save_every, shift = CASES[case]
    t = _torch(_inputs(L * 17 + D, L, D, N, R, shift))
    kw = dict(delta_softplus=True, dt_lowrank_weight=t[7], save_every=save_every)
    y, saved = chunked_fwd(*t[:7], chunk=chunk, **kw)
    y1, saved1 = chunked_fwd(*t[:7], chunk=16 * (L // 16 + 1), **kw)
    assert saved.shape == (2, 4, -(-L // save_every), D, N)
    torch.testing.assert_close(saved, saved1, **Y_TOL)
    torch.testing.assert_close(y, y1, **Y_TOL)


@pytest.mark.parametrize("case", CASES)
def test_chunked_backward_matches_autograd(case):
    L, D, N, R, chunk, save_every, shift = CASES[case]
    arrays = _inputs(L * 19 + D, L, D, N, R, shift)
    t = _torch(arrays)
    dy = torch.from_numpy(np.random.default_rng(L).standard_normal(arrays[0].shape)
                          .astype(np.float32))
    _, hsave = chunked_fwd(*t[:7], delta_softplus=True,
                                             dt_lowrank_weight=t[7], chunk=chunk,
                                             save_every=save_every)
    got = chunked_bwd(*t, hsave, dy, delta_softplus=True, chunk=chunk,
                                        save_every=save_every)
    live = [x.clone().requires_grad_(True) for x in t if x is not None]
    args = live + [None] * (8 - len(live))
    out = selective_scan_plain(*args[:7], delta_softplus=True, dt_lowrank_weight=args[7])
    want = torch.autograd.grad(out, live, dy)
    names = ["du", "ddt", "dA", "dB", "dC", "dD", "dbias", "dW"]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        atol = GRAD_SCALED_ATOL * float(w.abs().max()) + 1e-30
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=atol, msg=lambda m: f"{name}: {m}")
    if R == 0:
        assert got[7] is None


def test_chunked_backward_repeats_bit_for_bit():
    """Fixed-order sums: two evaluations agree exactly."""
    L, D, N, R, chunk, save_every, shift = CASES["two_chunks_ragged"]
    t = _torch(_inputs(5, L, D, N, R, shift))
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal(t[0].shape).astype(np.float32))
    _, hsave = chunked_fwd(*t[:7], delta_softplus=True,
                                             dt_lowrank_weight=t[7], chunk=chunk,
                                             save_every=save_every)
    a = chunked_bwd(*t, hsave, dy, delta_softplus=True, chunk=chunk,
                                      save_every=save_every)
    b = chunked_bwd(*t, hsave, dy, delta_softplus=True, chunk=chunk,
                                      save_every=save_every)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_carries_underflow_to_zero_exactly():
    """At softplus(dt) ~ 8 a step a chunk's factor exp(A * sum dt) is 0 in
    fp32: the start state then does not reach the chunk's end, as in the
    sequential scan, and nothing becomes inf or nan."""
    L, D, N, R, chunk, save_every, shift = CASES["large_dt"]
    t = _torch(_inputs(9, L, D, N, R, shift))
    _, dt, _, _ = _factors(t[0], t[1], t[2], t[3], t[6], True, t[7])
    factor = torch.exp(t[2][None] * dt[:, :, :chunk].sum(2)[..., None])
    assert float(factor.max()) == 0.0
    y, saved = chunked_fwd(*t[:7], delta_softplus=True,
                                             dt_lowrank_weight=t[7], chunk=chunk,
                                             save_every=save_every)
    assert torch.isfinite(y).all() and torch.isfinite(saved).all()


# (B, L, D) of every scan call of the full config: fusion training (encoder
# 12, decoder 6), serving (16, 8), segmentation training (batch 2: 4 and 2;
# batch 4: 8 and 4), and the full-resolution scan's L = H*W at each stage
# (the training encoder's 12, and one SS2D at batch 2)
_MAIN_SHAPES = ([(b, L, D) for L, D in ((1024, 192), (256, 384), (64, 768), (16, 1536))
                 for b in (2, 4, 6, 8, 12, 16)]
                + [(b, L, D) for L, D in ((4096, 192), (1024, 384), (256, 768), (64, 1536))
                   for b in (2, 12)])


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("batch,L,D", _MAIN_SHAPES)
def test_chunk_len_fills_the_card(batch, L, D, kernel):
    """At every main-path shape the chosen chunks are multiples of the
    16-step tile, cover L and are at least 64 steps unless L is shorter; one
    chunk where the channels alone give `enough` warps an SM of a 132-SM
    card; else the cut reaches at least 8 warps an SM or cannot go further."""
    enough, target = (scan_cuda.FWD_WARPS_PER_SM if kernel == "fwd"
                      else scan_cuda.BWD_WARPS_PER_SM)
    threads = batch * 4 * D * 4
    chunk = scan_cuda.chunk_len(L, threads, enough * 132 * 32, target * 132 * 32)
    n = -(-L // chunk)
    assert chunk % scan_cuda.TILE == 0 and n * chunk >= L > (n - 1) * chunk
    assert chunk >= min(L, scan_cuda.MIN_CHUNK)
    warps_per_sm = threads / 32 / 132
    if warps_per_sm >= enough:
        assert n == 1
    else:
        assert n * warps_per_sm >= 8 or chunk == scan_cuda.MIN_CHUNK


@pytest.mark.parametrize("N,R", [(16, 6), (16, 12), (16, 24), (16, 48), (4, 0)])
def test_shared_memory_leaves_room_for_two_blocks(N, R):
    """The kernels' dynamic shared memory, as the wrappers reckon it: the
    forward under the 48 KB that needs no opt-in, the backward's main pass
    at most half of an SM's 227 KB, so two blocks (16 warps) fit."""
    assert scan_cuda.fwd_smem_bytes(N, R) <= 48 * 1024
    assert scan_cuda.bwd_smem_bytes(N, R) <= 227 * 1024 // 2
