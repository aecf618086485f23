"""Multi-process training of the port on the CPU: gloo ranks spawned with a
FileStore under tmp_path (`torch_dist_workers.py`), held against the
single-process step on the global batch and against the JAX package.

  * `spec_for` selects the parameters that JAX `param_shardings` shards,
    column and row, on a model whose widths cross the 128 rule;
  * `shard_state_dict` / `unshard_tensor` round-trip the JAX params;
  * the sequence-parallel scan on 2 and 4 ranks against JAX
    `selective_scan_seq_parallel(impl="ref")` on the 8-device CPU mesh,
    output and gradients, shards of 32, 16 and 8 steps (below one 16-step
    tile of the card's kernel);
  (the training steps on several ranks are in test_torch_parallel_train.py).

Tolerances: the ranks reorder float32 sums (the batch split over data ranks,
the scan's carries), so values agree to about 1e-6 relative; each
tolerance is stated where it is checked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from fusionmamba_torch import config as tcfg
from fusionmamba_torch import data as tdata
from fusionmamba_torch.checkpoints import fusion_key_map, state_dict_from_jax
from fusionmamba_torch.data.prefetch import threaded_batches
from fusionmamba_torch.models import VSSMFusion
from fusionmamba_torch.ops.selective_scan import selective_scan
from fusionmamba_torch.parallel import (Axis, Mesh, apply_tensor_parallel, make_mesh,
                                        param_specs, rank_rows, set_mesh, shard_state_dict)
from fusionmamba_torch.parallel.sharding import COL, ROW, shard_layouts, unshard_tensor
from fusionmamba_tpu import config as jcfg
from fusionmamba_tpu.models import VSSMFusion as JaxVSSMFusion
from fusionmamba_tpu.parallel import make_mesh as jax_make_mesh
from fusionmamba_tpu.parallel import param_shardings, selective_scan_seq_parallel


def _jax_params(cfg):
    x = jnp.zeros((1, 16, 16, 1), jnp.float32)
    params = jax.jit(JaxVSSMFusion(cfg).init)(jax.random.PRNGKey(0), x, x)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _flax_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _fake_mesh(index: int, n: int = 2) -> Mesh:
    """A mesh as rank `index` of an n-rank model axis sees it, without a
    process group: enough to shard (no collective runs)."""
    return Mesh(1, n, index, None, Axis("data", None, 1, 0, False),
                Axis("model", None, n, index, False))


# ---------------------------------------------------------------------------
# the sharding rules and the state dicts
# ---------------------------------------------------------------------------

WIDE = dict(dims=(64, 128))    # in_proj, out_proj, fc1, fc2 and expand cross 128


@pytest.mark.parametrize("widths", [{}, WIDE], ids=["test_config", "wide"])
def test_spec_for_matches_jax_param_shardings(widths):
    cfg = jcfg.test_config(**widths)
    params = _jax_params(cfg)
    mesh = jax_make_mesh(1, 2, devices=jax.devices("cpu")[:2])
    jspecs = param_shardings(mesh, params)
    specs = param_specs(VSSMFusion(tcfg.test_config(**widths)))
    # JAX's (in, out) kernels: P(None, "model") is a column shard, ("model", None) here
    to_torch = {(): (), (None, "model"): COL, ("model", None): ROW}
    seen = {(): 0, COL: 0, ROW: 0}
    for tk, fp, _ in fusion_key_map(cfg.depths, cfg.depths_decoder):
        want = to_torch[tuple(_flax_get(jspecs, fp).spec)]
        assert specs[tk] == want, tk
        seen[want] += 1
    assert seen[COL] > 0 and seen[ROW] > 0 and seen[()] > 0


def test_shard_and_gather_state_dict_round_trip_from_jax():
    cfg = jcfg.test_config(**WIDE)
    whole = state_dict_from_jax(_jax_params(cfg), cfg.depths, cfg.depths_decoder)
    ranks = []
    for index in range(2):
        net = VSSMFusion(tcfg.test_config(**WIDE))
        net.load_state_dict(whole)
        n = apply_tensor_parallel(net, _fake_mesh(index))
        assert n > 0
        shards = shard_state_dict(whole, net, _fake_mesh(index))
        # apply_tensor_parallel took the same shards from the loaded weights
        for k, v in net.state_dict().items():
            assert torch.equal(v, shards[k]), k
        net.load_state_dict(shards)               # strict: every key, shard shapes
        ranks.append((shard_layouts(net), shards))
    layouts = ranks[0][0]
    assert {k.rsplit(".", 2)[-2] for k in layouts} >= {"in_proj", "in_proj1", "in_proj2",
                                                       "out_proj", "fc1", "fc2", "expand"}
    for k, v in whole.items():
        got = (unshard_tensor([r[1][k] for r in ranks], *layouts[k]) if k in layouts
               else ranks[0][1][k])
        assert torch.equal(got, v), k


def test_rank_rows_of_one_global_shuffle():
    ds = tdata.SyntheticFusionDataset(8, (16, 16))
    mesh = _fake_mesh(0)
    assert rank_rows(6, mesh) == slice(0, 6)
    whole = list(tdata.batch_iterator(ds, 4, seed=3))
    for it in (lambda rows: tdata.batch_iterator(ds, 4, seed=3, rows=rows),
               lambda rows: threaded_batches(ds, 4, seed=3, num_workers=2, rows=rows)):
        halves = [list(it(slice(0, 2))), list(it(slice(2, 4)))]
        for w, a, b in zip(whole, *halves):
            for x, y, z in zip(w, a, b):
                np.testing.assert_array_equal(x, np.concatenate([y, z]))


def test_mesh_and_sp_scan_need_the_right_world():
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(2, 2)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal((1, 1, 8, 4)).astype(np.float32))
    bc = torch.from_numpy(rng.standard_normal((1, 1, 8, 2)).astype(np.float32))
    A = -torch.ones(1, 4, 2)
    with pytest.raises(ValueError, match="needs a mesh"):
        selective_scan(u, u, A, bc, bc, impl="sp")
    with set_mesh(make_mesh(1, 1)):       # one rank: the scan itself
        torch.testing.assert_close(selective_scan(u, u, A, bc, bc, impl="sp"),
                                   selective_scan(u, u, A, bc, bc), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the sequence-parallel scan against the JAX package's
# ---------------------------------------------------------------------------

def _scan_inputs(seed, B=2, K=2, L=32, D=8, N=4):
    rng = np.random.default_rng(seed)
    inputs = {"u": rng.standard_normal((B, K, L, D)),
              "delta": 0.5 * rng.standard_normal((B, K, L, D)),
              "A": -np.exp(0.5 * rng.standard_normal((K, D, N))),
              "B": rng.standard_normal((B, K, L, N)), "C": rng.standard_normal((B, K, L, N)),
              "D": rng.standard_normal((K, D)), "bias": 0.5 * rng.standard_normal((K, D)) - 1.0}
    cot = rng.standard_normal((B, K, L, D)).astype(np.float32)
    return {k: v.astype(np.float32) for k, v in inputs.items()}, cot


# (ranks, L): shards of 32, 16 and 8 steps
@pytest.mark.parametrize("world,L", [(2, 64), (4, 64), (4, 32)])
def test_sp_scan_matches_jax_sp(world, L, tmp_path):
    inputs, cot = _scan_inputs(world + L, L=L)
    names = ["u", "delta", "A", "B", "C", "D", "bias"]
    mesh = jax_make_mesh(8 // world, world, devices=jax.devices("cpu")[:8])

    def loss(*args):
        y = selective_scan_seq_parallel(*args, delta_softplus=True, mesh=mesh, axis="model",
                                        impl="ref")
        return jnp.sum(y * cot), y

    (_, want_y), want_g = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(7)),
                                                     has_aux=True))(
        *(jnp.asarray(inputs[k]) for k in names))
    got = workers.spawn(workers.sp_scan_case, world, str(tmp_path), world, inputs, cot)
    for r in got:   # every rank holds the whole output and whole gradients
        np.testing.assert_allclose(r["y"], np.asarray(want_y), rtol=1e-4, atol=1e-5)
        for k, w in zip(names, want_g):
            w = np.asarray(w)
            np.testing.assert_allclose(r[k], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
