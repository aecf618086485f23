"""`fusionmamba_torch/utils/tracing.py` on the CPU: spans that cost one check
without a profiler and nest under a user-scope recording (no operator
recorded); the copy counts and their bytes against each site's shapes,
worked out by hand at small sizes; kernel launches counted under their C
entry point; and the spans of the training step and of the two models'
forwards, in order."""
import collections
import contextlib
import math
import types

import pytest
import torch

from fusionmamba_torch import config as tcfg
from fusionmamba_torch.models import VSSMFusion, VSSMFusionSeg
from fusionmamba_torch.models.mamba_lm import MambaBlock, MambaLMHeadModel
from fusionmamba_torch.nn.layers import LDC
from fusionmamba_torch.nn.patch import PatchEmbed
from fusionmamba_torch.nn.ss2d import SS2D
from fusionmamba_torch.ops import cuda_lib
from fusionmamba_torch.ops.scan2d import efficient_merge
from fusionmamba_torch.train.loop import fusion_train_step, make_fusion_optimizer
from fusionmamba_torch.utils import tracing

F32 = 4   # bytes of a float32


@contextlib.contextmanager
def counted():
    """Yields a Counter that holds, when the block ends, what the block
    added to `tracing.counts`."""
    before = collections.Counter(tracing.counts)
    out = collections.Counter()
    yield out
    out.update(tracing.counts)
    out.subtract(before)
    for k in [k for k, v in out.items() if v == 0]:
        del out[k]


def _spans(rec):
    """(name, parent name or None) of the program's spans in start order:
    the user-scope events, torch's own `Optimizer.*` annotations left out,
    each parented by the innermost span that contains it on its thread."""
    evs = sorted(((e.start_ns(), -e.end_ns(), e.start_thread_id(), e.name())
                  for e in rec.events if e.is_user_annotation()
                  and not e.name().startswith("Optimizer.")))
    out, open_ = [], []
    for start, neg_end, thread, name in evs:
        while open_ and (open_[-1][0] != thread or open_[-1][1] < start):
            open_.pop()
        out.append((name, open_[-1][2] if open_ else None))
        open_.append((thread, -neg_end, name))
    return out


def test_span_without_a_profiler_is_one_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    assert tracing.span("a") is tracing.span("b") is tracing._OFF
    with tracing.span("a"):
        pass
    with tracing.record() as rec:
        pass
    assert rec.events == []


def test_record_nests_the_spans_and_holds_no_operator():
    a = torch.ones(16, 16, requires_grad=True)
    with tracing.record() as rec:
        with tracing.span("outer"):
            with tracing.span("inner"):
                b = (a @ a).relu().sum()
            with tracing.span("back"):
                b.backward()
    assert _spans(rec) == [("outer", None), ("inner", "outer"), ("back", "outer")]
    assert all(e.is_user_annotation() for e in rec.events)
    assert not any(e.name().startswith("aten::") for e in rec.events)
    assert not torch._C._autograd._profiler_enabled()


def test_contiguous_and_cast_count_only_the_copies_they_make():
    t = torch.ones(3, 5)
    with counted() as c:
        assert tracing.contiguous(t, "s") is t
        assert tracing.cast(t, torch.float32, "s") is t
    assert c == {}
    with counted() as c:
        assert tracing.contiguous(t.t(), "s").is_contiguous()
        assert tracing.cast(t, torch.bfloat16, "s").dtype == torch.bfloat16
    assert c == {"copies:s": 2, "copy_bytes:s": 15 * F32 + 15 * 2}


@pytest.mark.parametrize("ori", [(4, 6), (5, 3)])
def test_scan2d_merge_copies_only_a_cropped_map(ori):
    B, C = 2, 3
    H2, W2 = -(-ori[0] // 2), -(-ori[1] // 2)
    ys = torch.rand(B, 4, H2 * W2, C)
    with counted() as c:
        assert efficient_merge(ys, *ori).is_contiguous()
    cropped = ori != (2 * H2, 2 * W2)
    want = {"copies:scan2d.merge": 1, "copy_bytes:scan2d.merge": B * ori[0] * ori[1] * C * F32}
    assert c == (want if cropped else {})


def test_model_sites_count_their_bytes():
    """SS2D's dt, B and C (B, 4, L, R + 2N) are copied; the patch
    embedding's and LDC's convolutions take an NHWC view and return
    channels-last, so their NHWC outputs need no copy."""
    B, H, W = 2, 8, 6
    ss2d = SS2D(8, d_state=4)
    R, N, L = ss2d.dt_rank, ss2d.d_state, (H // 2) * (W // 2)
    with counted() as c:
        ss2d(torch.rand(B, H, W, 8))
    want = B * 4 * L * (R + 2 * N) * F32
    assert c == {"copies:ss2d.dt_b_c": 3, "copy_bytes:ss2d.dt_b_c": want}
    with counted() as c:
        PatchEmbed(1, 12, 4)(torch.rand(B, H, W, 1))
        LDC(3, 5)(torch.rand(B, H, W, 3))
    assert c == {}


def test_lm_scan_inputs_count_their_bytes():
    """The block's scan takes u (the conv's transposed output: a copy), dt
    (a product, already contiguous: none), and B and C (slices of x_proj's
    product: a copy each), all fp32 already: no cast. Its four projections
    take `F.linear` on the CPU, each counted once."""
    B, L, d_model = 2, 7, 16
    blk = MambaBlock(d_model, d_state=4)
    with counted() as c:
        blk(torch.rand(B, L, d_model))
    want = B * L * (blk.d_inner + 2 * blk.d_state) * F32
    assert c == {"copies:lm.scan_inputs": 3, "copy_bytes:lm.scan_inputs": want,
                 "linear:library": 4}


def _lm_linear_counts(device, rows):
    """What an LM forward of 2 layers at `rows` tokens (2 sequences) adds to
    the counts of `ops.linear`: its kernel's launches, its library calls and
    the operands it copied.
    At d_model 64, x_proj's rows hold dt_rank 4 + 2 x 16 floats, so the dt
    columns it hands dt_proj are rows 144 bytes apart, as the kernel reads
    them."""
    lm = MambaLMHeadModel(64, d_model=64, n_layer=2).eval().to(device)
    with torch.inference_mode(), counted() as c:
        lm(torch.randint(0, 64, (2, rows // 2), device=device))
    return {k: v for k, v in c.items()
            if k == "fm_linear" or k.startswith("linear:") or k.endswith(":linear")}


@pytest.mark.parametrize("rows", [256, 126])
def test_lm_linear_counts_on_the_cpu(rows):
    """On the CPU every product of the LM (four a layer, the head) takes
    F.linear, at any number of rows."""
    assert _lm_linear_counts("cpu", rows) == {"linear:library": 4 * 2 + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,kernel", [(256, True), (126, False)])
def test_lm_linear_counts_on_the_card(rows, kernel):
    """On the card, at 128 rows or more, the kernel takes every product, 4 a
    layer and the head, none the library and no operand copied; below 128
    rows the library takes them all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the linear kernel runs only on the card)")
    got = _lm_linear_counts("cuda", rows)
    if kernel:
        assert got == {"fm_linear": 4 * 2 + 1}
    else:
        assert got == {"linear:library": 4 * 2 + 1}


def test_launch_counts_under_the_entry_point(monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(cuda_lib, "lib", lambda: types.SimpleNamespace(
        fm_dwconv3x3_fwd=entry, fm_dwconv3x3_fwd_bf16=entry))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    dev = torch.device("cuda", 0)
    with counted() as c:
        cuda_lib.launch("fm_dwconv3x3_fwd", 1, 2, device=dev)
        cuda_lib.launch("fm_dwconv3x3_fwd", 3, device=dev)
        cuda_lib.launch(cuda_lib.entry("fm_dwconv3x3_fwd", torch.bfloat16), device=dev)
    assert c == {"fm_dwconv3x3_fwd": 2, "fm_dwconv3x3_fwd_bf16": 1}
    assert calls == [(1, 2, 7), (3, 7), (7,)]


_FUSION = [("fusion.forward", "train.step"), ("fusion.embed", "fusion.forward"),
           ("fusion.encoder", "fusion.forward"), ("fusion.cross", "fusion.forward"),
           ("fusion.decoder", "fusion.forward"), ("fusion.head", "fusion.forward")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fusion_train_step_spans_in_order(dtype):
    """The step's spans in order, `train.cast` only in bf16, whose casts
    are counted: every floating parameter and the two inputs, 2 bytes an
    element."""
    torch.manual_seed(0)
    net = VSSMFusion(tcfg.test_config())
    opt = make_fusion_optimizer(net.parameters())
    x1, x2 = torch.rand(2, 16, 16, 1), torch.rand(2, 16, 16, 1)
    with counted() as c, tracing.record() as rec:
        fusion_train_step(net, opt, x1, x2, torch.Generator().manual_seed(1),
                          compute_dtype=dtype)
    cast = [("train.cast", "train.step")] if dtype == torch.bfloat16 else []
    assert _spans(rec) == [("train.step", None), *cast, *_FUSION, ("train.loss", "train.step"),
                           ("train.backward", "train.step"), ("train.optimizer", "train.step")]
    params = [p for p in net.parameters() if p.is_floating_point()]
    want = {} if dtype == torch.float32 else {
        "copies:train.cast": len(params) + 2,
        "copy_bytes:train.cast": 2 * (sum(p.numel() for p in params) + 2 * x1.numel())}
    assert {k: v for k, v in c.items() if "train.cast" in k} == want


def test_segmentation_model_shares_the_fusion_spans():
    net = VSSMFusionSeg(tcfg.test_config()).eval()
    x = torch.rand(1, 16, 16, 1)
    with torch.no_grad(), tracing.record() as rec:
        net(x, x)
    stages = [(n, None) for n, _ in _FUSION[1:]]
    assert _spans(rec) == stages


def test_lm_forward_spans_in_order():
    lm = MambaLMHeadModel(32, d_model=16, n_layer=2, rms_norm=True).eval()
    with torch.no_grad(), tracing.record() as rec:
        logits = lm(torch.randint(0, 32, (2, 5)))[0]
    assert logits.shape == (2, 5, 32) and math.isfinite(float(logits.sum()))
    assert _spans(rec) == [("lm.forward", None), ("lm.embed", "lm.forward"),
                           ("lm.layers", "lm.forward"), ("lm.head", "lm.forward")]


def test_jamba_forward_spans_in_order():
    """`jamba.forward` holds the embedding, each layer's mixer span and then
    its feed-forward span, by the layer's kinds, and the head."""
    from fusionmamba_torch.models.jamba import JambaForCausalLM, layer_kinds
    cfg = dict(hidden_size=16, intermediate_size=24, num_hidden_layers=8, num_attention_heads=2,
               num_key_value_heads=1, num_experts=4, mamba_dt_rank=2, vocab_size=32)
    net = JambaForCausalLM(cfg, experts_held=range(2)).eval()
    with torch.no_grad(), tracing.record() as rec:
        logits = net(torch.randint(0, 32, (2, 5)))[0]
    assert logits.shape == (2, 5, 32) and math.isfinite(float(logits.sum()))
    layers = [("jamba." + kind, "jamba.forward") for pair in layer_kinds(net.config)
              for kind in pair]
    assert _spans(rec) == [("jamba.forward", None), ("jamba.embed", "jamba.forward"), *layers,
                           ("jamba.head", "jamba.forward")]
