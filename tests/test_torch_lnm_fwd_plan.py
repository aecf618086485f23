"""The layout of the LN-mean forward CUDA kernel, on the CPU.

The kernel (`fusionmamba_torch/csrc/ln_mean_fwd.cu`) runs only on the card,
where tests/test_torch_kernels.py holds it against its plain version. Its
layout comes from Python (`layer_norm.lnm_fwd_plan`), and here that plan is
checked at every training and serving shape of the full config
(`chip_smoke.train_calls`, `main_path_calls`) and at ragged ones: the walk of
a cluster's blocks and their groups visits every row of a batch row exactly
once, the template fills its lanes at the model's widths, the plan names a
variant the source compiles, and its constants are the source's. A plain
PyTorch replay of the kernel's arithmetic and order of summation (kept here,
not in the package) is held against the plain version and the JAX package's
Pallas kernel, run in interpret mode as its own tests run it. Inputs come from
numpy seeds.

Tolerance. The replay sums xhat per group over its rows, then per block over
its groups, then over the cluster's blocks, and folds scale and bias in once;
the plain version and the Pallas kernel sum LN(x) over the rows in another
order. Both are float32 sums of at most a few hundred terms of both signs of
magnitude about 1, divided by the row count: 1e-5 absolute and relative
bounds their difference with room.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SEG_PAIRS, main_path_calls, train_calls
from fusionmamba_torch.config import full_config
from fusionmamba_torch.ops import layer_norm
from fusionmamba_tpu.ops import ln_pallas

CSRC = Path(layer_norm.__file__).resolve().parent.parent / "csrc"
_VARIANTS = {(int(v), int(g), m == "true") for v, g, m in re.findall(
    r"X\((\d+), (\d+), (true|false)\)", (CSRC / "ln_common.cuh").read_text())}
_RAGGED = [(1, 1, 24), (3, 37, 96), (2, 37, 48), (5, 1, 100), (2, 300, 1000), (1, 37, 100),
           (4, 1, 48), (1, 5000, 24)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _shapes():
    """The LN-mean's shapes on the serving path (batch 8) and in the fusion
    (batch 6) and segmentation (batches 2 and 4) training steps."""
    shapes = set(main_path_calls(full_config(), 8, 256)["ln_mean"])
    for pairs in (6, *SEG_PAIRS):
        shapes |= set(train_calls(full_config(), pairs, 256)["ln_mean"])
    assert len(shapes) == 24
    return sorted(shapes)


def _walk(plan, rows):
    """Rows of each (block of the cluster, group) of one batch row, in the
    order the group visits them."""
    chunk = plan.groups * plan.unroll
    for p in range(plan.cluster):
        for g in range(plan.groups):
            yield p, g, [r for base in range(p * chunk, rows, plan.cluster * chunk)
                         for r in range(base + g, base + chunk, plan.groups) if r < rows]


def test_plan_constants_are_the_source_s():
    src = (CSRC / "ln_mean_fwd.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts == {"kFwdBlock": layer_norm.FWD_BLOCK, "kRowValues": layer_norm.FWD_ROW_VALUES,
                      "kMaxCluster": layer_norm.FWD_MAX_CLUSTER}


@pytest.mark.parametrize("B,rows,C", _shapes() + _RAGGED)
def test_lnm_fwd_plan_visits_each_row_once(B, rows, C):
    for sms in (132, 1):
        plan = layer_norm.lnm_fwd_plan(B, rows, C, sms)
        assert (plan.values, plan.lanes, plan.masked) in _VARIANTS
        assert plan.values * plan.lanes >= C
        assert plan.masked == (C not in layer_norm.TEMPLATES)
        assert plan.threads == max(layer_norm.FWD_BLOCK, plan.lanes) <= 1024
        assert plan.groups * plan.lanes == plan.threads
        assert plan.unroll == max(1, layer_norm.FWD_ROW_VALUES // plan.values)
        chunks = math.ceil(rows / (plan.groups * plan.unroll))
        assert 1 <= plan.cluster <= min(layer_norm.FWD_MAX_CLUSTER, chunks) and B <= 65535
        assert plan.cluster & (plan.cluster - 1) == 0
        seen = np.zeros(rows, np.int32)
        for _, _, visited in _walk(plan, rows):
            assert visited == sorted(visited)
            seen[visited] += 1
        assert (seen == 1).all(), (B, rows, C, sms, plan)


def test_lnm_fwd_plan_fills_lanes_and_the_card():
    """Every model width has a template (no lane masked), and the blocks of
    the B batch rows come within a factor of two of FWD_BLOCKS_PER_SM an SM
    wherever the rows have chunks enough."""
    for B, rows, C in _shapes():
        plan = layer_norm.lnm_fwd_plan(B, rows, C)
        assert not plan.masked and plan.values * plan.lanes == C, C
        chunks = math.ceil(rows / (plan.groups * plan.unroll))
        most = min(layer_norm.FWD_BLOCKS_PER_SM * 132, B * chunks,
                   B * layer_norm.FWD_MAX_CLUSTER)
        assert most / 2 < B * plan.cluster <= max(B, most), (B, rows, C, plan)


def _replay(x, scale, bias, eps, plan):
    """The kernel's arithmetic and order in plain PyTorch: per row the fast
    variance from the sums of x and x^2, xhat summed per group over its rows
    in walk order, per block over its groups in order, over the cluster's
    blocks in rank order; then m = sum / rows * scale + bias."""
    B, rows, C = x.shape
    mu = x.sum(2, keepdim=True) / C
    rs = torch.rsqrt((x * x).sum(2, keepdim=True) / C - mu * mu + eps)
    xh = (x - mu) * rs
    out = torch.empty(B, C)
    for b in range(B):
        blocks = [None] * plan.cluster
        for p, g, visited in _walk(plan, rows):
            acc = torch.zeros(C)
            for r in visited:
                acc = acc + xh[b, r]
            blocks[p] = acc if g == 0 else blocks[p] + acc
        t = blocks[0]
        for p in range(1, plan.cluster):
            t = t + blocks[p]
        out[b] = t / rows * scale + bias
    return out


# clusters of 1, 2 and 4 blocks, ragged rows and masked widths
@pytest.mark.parametrize("B,rows,C,sms", [(2, 64, 96, 1), (3, 37, 96, 132), (2, 50, 40, 2),
                                          (6, 64, 384, 132), (1, 300, 24, 132), (2, 40, 768, 132),
                                          (2, 64, 768, 132), (2, 300, 96, 132), (1, 1100, 24, 132),
                                          (2, 9, 1000, 1)])
def test_lnm_fwd_replay_matches_plain_and_pallas(B, rows, C, sms):
    rng = np.random.default_rng(B * rows + C)
    f = np.float32
    x = (2.0 * rng.standard_normal((B, rows, C)) + 0.5).astype(f)
    s, b = rng.standard_normal(C).astype(f), rng.standard_normal(C).astype(f)
    t = torch.from_numpy
    plan = layer_norm.lnm_fwd_plan(B, rows, C, sms)
    clusters = {(2, 50, 40): 2, (6, 64, 384): 2, (2, 40, 768): 2, (2, 64, 768): 4,
                (2, 300, 96): 2, (1, 1100, 24): 2}
    assert plan.cluster == clusters.get((B, rows, C), 1)
    got = _replay(t(x), t(s), t(b), 1e-5, plan).numpy()
    np.testing.assert_allclose(got, layer_norm.ln_spatial_mean_plain(t(x), t(s), t(b), 1e-5),
                               **TOL)
    want = ln_pallas._lnm_core(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5, True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_lnm_fwd_replay_at_a_training_shape_with_a_cluster():
    """A full-width training shape whose plan takes a cluster of 16 blocks,
    against the plain version."""
    rng = np.random.default_rng(11)
    B, rows, C = 2, 1024, 192
    x = torch.from_numpy((2.0 * rng.standard_normal((B, rows, C)) + 0.5).astype(np.float32))
    s, b = (torch.from_numpy(rng.standard_normal(C).astype(np.float32)) for _ in range(2))
    plan = layer_norm.lnm_fwd_plan(6, rows, C)
    assert plan.cluster == 16
    np.testing.assert_allclose(_replay(x, s, b, 1e-5, plan),
                               layer_norm.ln_spatial_mean_plain(x, s, b, 1e-5), **TOL)
