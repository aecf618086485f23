"""Multi-process training steps of the port on the CPU: gloo ranks spawned
with a FileStore under tmp_path (`torch_dist_workers.py`), each step held
against the same step in one process on the global batch.

  * two training steps on `--mesh 2,1` (data parallel), `1,2` (tensor
    parallel) and `2,2 --scan_impl sp`, DropPath on, and every rank's op
    calls against those `chip_smoke.train_calls` derives for a rank;
  * the training CLI on 2 ranks, its checkpoint loading into a
    single-process model; a `--mesh` that the world does not fill raises.

The ranks reorder float32 sums (the batch split over data ranks, the
contractions split over model ranks, the scan's carries); each tolerance is
stated where it is checked.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
import torch_dist_workers as workers
from fusionmamba_torch import config as tcfg
from fusionmamba_torch import train as ttrain
from fusionmamba_torch.checkpoints import load_reference_checkpoint
from fusionmamba_torch.models import VSSMFusion

WIDE = dict(dims=(64, 128))    # in_proj, out_proj, fc1, fc2 and expand cross 128


def test_bad_mesh_raises_in_the_cli(tmp_path):
    with pytest.raises(ValueError, match="needs 2 ranks"):
        ttrain.main(["--synthetic", "4", "-B", "2", "--model", "test", "--image_size", "32",
                     "--device", "cpu", "--ckpt_dir", str(tmp_path), "--mesh", "2,1"])


# ---------------------------------------------------------------------------
# training steps on several ranks against one process on the global batch
# ---------------------------------------------------------------------------

def _batches(n=2, B=4, size=32, seed=3):
    """Images in [0.02, 0.22]: the output 2*x1 + 2*x2 + ... stays inside the
    [0, 1] clamp, where a 1e-6 change cannot flip a pixel across its edge
    and the gradient stays a smooth function of the float32 rounding."""
    rng = np.random.default_rng(seed)
    return [tuple((0.02 + 0.2 * rng.uniform(0, 1, (B, size, size, 1))).astype(np.float32)
                  for _ in range(2)) for _ in range(n)]


# name: (config overrides, mesh, ranks). 2,1 at test_config; 1,2 at widths
# crossing 128 (every projection sharded, out_proj row-parallel, expand
# column-parallel); 2,2 sp at test_config: the 16-wide blocks scan whole
# with L split, the 32-wide ones are tensor-parallel (out_proj whole) with
# their channels gathered before the split scan, their MLPs sharded
CASES = {"dp_2x1": (dict(drop_path_rate=0.3), (2, 1), 2),
         "tp_1x2": (dict(drop_path_rate=0.3, **WIDE), (1, 2), 2),
         "sp_2x2": (dict(drop_path_rate=0.3, scan_impl="sp"), (2, 2), 4)}


@pytest.mark.parametrize("case", list(CASES))
def test_multi_rank_steps_match_one_process(case, tmp_path):
    """Losses within 1e-5 relative; the first step's gradients within 1e-4
    of the whole gradient's norm, and each parameter's within 2e-3 of its
    own (the gate of tests/test_optimizer_trajectory.py; a few scalar
    parameters' gradients are sums that cancel to 1e-5 of their terms);
    parameters after the two Adam steps by that test's gate: within 2e-3
    by norm, or an rms drift below a quarter of the lr budget (Adam turns
    the sign of a near-zero gradient into a full lr step)."""
    cfg, mesh_shape, world = CASES[case]
    batches = _batches()
    torch.set_num_threads(2)
    want = workers.train_case(cfg, (1, 1), batches, 2)
    got = workers.spawn(workers.train_case, world, str(tmp_path), cfg, mesh_shape, batches, 2)
    assert (got[0]["sharded"] > 0) == (mesh_shape[1] > 1)
    # every rank's calls equal what chip_smoke derives for one rank (the
    # card's launch counts are held to these)
    n_data, n_model = mesh_shape
    derived = chip_smoke.train_calls(tcfg.test_config(**cfg), 4 // n_data, 32, n_model)
    for r in got:
        for op in chip_smoke.OPS:
            assert r["calls"][op] == {k: 2 * v for k, v in derived[op].items()}, op
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
    g, w = got[0]["grads"], want["grads"]
    assert {k for k, v in g.items() if v is None} == {k for k, v in w.items() if v is None}
    live = [k for k, v in w.items() if v is not None]
    assert any(k.startswith("Cross_block.0.") for k in w if w[k] is None)
    diff = torch.cat([(g[k] - w[k]).flatten() for k in live]).norm()
    total = torch.cat([w[k].flatten() for k in live]).norm()
    assert diff <= 1e-4 * total
    for k in live:
        assert (g[k] - w[k]).norm() <= 2e-3 * w[k].norm() + 1e-6 * total, k
    lr_budget = 1e-4 / 0.75 * 2
    assert set(got[0]["state"]) == set(want["state"])
    for k, v in want["state"].items():
        a, b = got[0]["state"][k].double(), v.double()
        assert a.shape == b.shape, k
        rel = (a - b).norm() / (b.norm() + 1e-12)
        rms = (a - b).norm() / np.sqrt(b.numel())
        assert rel < 2e-3 or rms < 0.25 * lr_budget, (k, float(rel), float(rms))


def test_cli_on_two_ranks_saves_a_single_process_checkpoint(tmp_path):
    """`--synthetic 8 --mesh 2,1 --image_size 32` on 2 ranks (the
    counterpart of tests/test_train.py::test_train_cli_mesh_flag): one epoch,
    the losses of the same CLI in one process within 1e-5, a checkpoint that
    loads strictly into a single-process model."""
    argv = ["--synthetic", "8", "-B", "4", "-E", "1", "--model", "test", "--image_size", "32",
            "-j", "0", "--device", "cpu"]
    got = workers.spawn(workers.cli_case, 2, str(tmp_path),
                        argv + ["--mesh", "2,1", "--ckpt_dir", str(tmp_path / "two")])
    one = ttrain.main(argv + ["--ckpt_dir", str(tmp_path / "one")])
    for r in got:
        assert r["world"] == 2 and r["mesh"] == [2, 1] and r["backend"] == "gloo"
        assert r["steps"] == one["steps"] == 2 and r["peak_memory_bytes"] == [None, None]
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
    assert one["world"] == 1 and one["mesh"] == [1, 1]
    fresh = VSSMFusion(tcfg.test_config())
    load_reference_checkpoint(fresh, os.path.join(tmp_path, "two", "fusion_model_pst900.pth"))
    ref = torch.load(tmp_path / "one" / "fusion_model_pst900.pth", weights_only=True)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=2e-3, atol=1e-4)
