"""The controls of `reference/products.py` on the CPU: the bf16 mix's fp8
control rounds the products of a weight and nothing else, and every control
leaves the process's numerics as it found them."""
import pytest
import torch
import torch.nn.functional as F

from portbench.reference import products


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def test_e4m3_rounds_to_three_mantissa_bits():
    t = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    q = products.e4m3(t)
    # relative rounding of e4m3's normal range is at most 2**-4
    big = t.abs() > t.abs().max() / 2 ** 6
    assert ((q - t).abs()[big] / t.abs()[big]).max() <= 2 ** -4 + 1e-6
    assert 0 < _rel(q, t) < 2 ** -4
    assert products.e4m3(q).equal(q)


def test_fp8_control_rounds_the_products_of_a_weight_only():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(64, 32, generator=gen)
    w = torch.nn.Parameter(torch.randn(16, 32, generator=gen))
    k = torch.nn.Parameter(torch.randn(8, 2, 3, 3, generator=gen))
    img = torch.randn(2, 2, 9, 9, generator=gen)
    exact = (F.linear(x, w), torch.einsum("ld,cd->lc", x, w), F.conv2d(img, k), x @ x.T)
    with products.control("bf16", True):
        fp8 = (F.linear(x, w), torch.einsum("ld,cd->lc", x, w), F.conv2d(img, k), x @ x.T)
        grad = torch.autograd.grad(F.linear(x, w).sum(), w)[0]
    for got, want in zip(fp8[:3], exact[:3]):
        assert 1e-3 < _rel(got, want) < 0.1
    assert fp8[3].equal(exact[3])
    # the gradient passes the rounding as is, onto the rounded operand
    assert torch.allclose(grad, products.e4m3(x).sum(0).expand(16, 32), rtol=1e-6, atol=1e-5)
    with products.control("bf16", False):
        assert F.linear(x, w).equal(exact[0])


@pytest.mark.parametrize("precision,on", [("fp32", True), ("fp32", False), ("bf16", True),
                                          ("bf16", False)])
def test_controls_restore_the_flags(precision, on):
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with products.control(precision, on):
        assert torch.backends.cuda.matmul.allow_tf32 == (on and precision == "fp32")
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


def test_no_control_for_an_unknown_precision():
    with pytest.raises(ValueError):
        with products.control("fp16", True):
            pass
