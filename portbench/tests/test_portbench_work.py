"""The frozen yardstick: kernel call counts, each kernel's work, the model
FLOPs and parameter counts in the configuration files."""
import pytest

import chip_smoke
from fusionmamba_torch.config import full_config
from fusionmamba_torch.config import test_config as small_config
from portbench import build, calls, flops, harness, readers
from portbench import trace as tr
from portbench.reference import fusion as ref_fusion
from portbench.reference import mamba_lm as ref_lm


def _as_dict(cfg):
    return {"dims": list(cfg.dims), "depths": list(cfg.depths),
            "depths_decoder": list(cfg.depths_decoder), "patch_size": cfg.patch_size,
            "ssm_ratio": cfg.ssm_ratio, "mlp_ratio": cfg.mlp_ratio}


@pytest.mark.parametrize("make", [small_config, full_config], ids=["test", "full"])
@pytest.mark.parametrize("pairs,size", [(2, 32), (6, 256), (32, 256)])
def test_calls_match_the_launch_counts_of_chip_smoke(make, pairs, size):
    cfg = make()
    if make is small_config and size > 64:
        pytest.skip("the small config runs at small sizes only")
    for part in ("forward", "backward"):
        assert calls.main_path_calls(_as_dict(cfg), pairs, size, part) == \
            chip_smoke.main_path_calls(cfg, pairs, size, part)
    assert calls.train_calls(_as_dict(cfg), pairs, size) == chip_smoke.train_calls(cfg, pairs, size)


def test_work_matches_bytes_and_ops():
    cfg = full_config()
    by_kernel = chip_smoke.train_calls(cfg, 32, 256)
    by_kernel["scan"][(8, 1, 2048, 1536, 0)] += 24
    for kernel, shapes in by_kernel.items():
        mod = harness.load_module(harness.HERE / "kernels" / f"{kernel}.py")
        for shape in shapes:
            for io in (4, 2):
                assert mod.work(shape, io) == chip_smoke.bytes_and_ops(kernel, shape, io)


def test_kernel_table_maps_event_names():
    table = tr.kernel_table()
    assert tr.function_of("void dwconv3x3_fwd_kernel<float>(...)", table) == "dwconv"
    assert tr.function_of("selective_scan_fwd_kernel<1>", table) == "scan"
    assert tr.function_of("carry_kernel", table) == "scan"
    assert tr.function_of("ln_fwd_0d1d2d", table) == "layer_norm"
    assert tr.function_of("sm90_xmma_gemm_f32f32", table) == "library_matmul"
    assert tr.function_of("cudnn::winograd_nonfused::winogradForwardData", table) == \
        "library_conv"
    assert tr.function_of("void at::native::multi_tensor_apply_kernel<Adam>", table) == \
        "optimizer"
    assert tr.function_of("elementwise_kernel", table) == "other"
    functions = {f for f, _, work in table if work is not None}
    assert functions == {"scan", "scan_bwd", "layer_norm", "layer_norm_bwd", "ln_mean",
                         "ln_mean_bwd", "dwconv", "dwconv_bwd", "mlp", "mlp_bwd"}


def test_bound_is_the_largest_of_three_terms():
    p = readers.peaks()
    shape = (8, 1, 2048, 1536, 0)
    nbytes, ops, sfu = chip_smoke.bytes_and_ops("scan", shape, 4)
    want = max(nbytes / p["hbm_bytes_per_s"], ops / p["fp32"], sfu / p["sfu_calls_per_s"])
    assert readers.bound_s({"scan": {shape: 3}}, 4) == pytest.approx(3 * want)


def test_fusion_config_flops_and_parameters():
    cfg = harness.load_json(harness.HERE / "configs" / "fusion_full.json")
    assert flops.parameters(ref_fusion.FusionNet, cfg) == cfg["parameters"] == 164146245
    # 90.0 GFLOP through the port's plain path counts the finest cross block
    # too, which the decoder never reads; the reference leaves it out
    assert flops.fusion_forward_flops(cfg) == cfg["forward_flops_per_item"]
    assert 88.6e9 < cfg["forward_flops_per_item"] < 90.0e9


def test_lm_config_flops_and_parameters():
    cfg = harness.load_json(harness.HERE / "configs" / "mamba_130m.json")
    ref = {**cfg, "vocab_size": build.maker(cfg).padded_vocab(cfg)}
    assert ref["vocab_size"] == 50280
    assert flops.parameters(ref_lm.MambaLM, ref) == cfg["parameters"]
    assert flops.lm_forward_flops(ref, 2048) == 2048 * cfg["forward_flops_per_item"]
    # the tied head alone is 2 * 768 * 50280 a token
    assert cfg["forward_flops_per_item"] > 2 * 768 * 50280
