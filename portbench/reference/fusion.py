"""The fusion network, its loss and Adam in plain PyTorch: the benchmark's
reference for the fusion cells.

Written from the reference repository's definitions (`VSSM_Fusion`,
`models/vmamba_Fusion_efficross.py:753-929`; `VSSBlock_new`,
`VSSBlock_Cross_new`, `SS2D`, `SS2D_cross_new`, `LDC`, `ECALayer`, `BiAttn`,
`Mlp`, `models/cross.py`; `Fusionloss`, `loss.py:15-56`; the vendored
`pytorch_msssim`; Adam as `train.py:108` builds it), NHWC, float32. Parameter
names are the reference's state-dict keys, so one set of tensors made from a
seed (`weights.py`) fills both this model and the program's.

The finest cross block's output is never read by the decoder, so it is not
computed here: it moves neither the output nor any gradient.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .scan import selective_scan

K_DIRS = 4


def _p(*shape, device=None):
    return nn.Parameter(torch.empty(*shape, device=device))


class LayerNorm(nn.Module):
    def __init__(self, dim, eps, device=None):
        super().__init__()
        self.eps = eps
        self.weight, self.bias = _p(dim, device=device), _p(dim, device=device)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class Linear(nn.Module):
    def __init__(self, d_in, d_out, bias=True, device=None):
        super().__init__()
        self.weight = _p(d_out, d_in, device=device)
        self.bias = _p(d_out, device=device) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """Holds a convolution's `weight` and optional `bias`."""

    def __init__(self, *wshape, bias=True, device=None):
        super().__init__()
        self.weight = _p(*wshape, device=device)
        self.bias = _p(wshape[0], device=device) if bias else None


def efficient_scan(x):
    """(B, H, W, C) -> (B, 4, ceil(H/2) ceil(W/2), C): the four stride-2
    sub-grids, (even, even) and (even rows, odd columns) row-major, (odd,
    even) and (odd, odd) column-major (`models/cross.py:139-190`)."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    grids = [x[:, 0::2, 0::2], x[:, 1::2, 0::2].transpose(1, 2),
             x[:, 0::2, 1::2], x[:, 1::2, 1::2].transpose(1, 2)]
    return torch.stack([g.reshape(b, -1, c) for g in grids], 1)


def efficient_merge(ys, h, w):
    """Inverse of `efficient_scan`: (B, 4, L, C) -> (B, h, w, C)."""
    b, _, _, c = ys.shape
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    out = ys.new_zeros(b, 2 * h2, 2 * w2, c)
    out[:, 0::2, 0::2] = ys[:, 0].reshape(b, h2, w2, c)
    out[:, 1::2, 0::2] = ys[:, 1].reshape(b, w2, h2, c).transpose(1, 2)
    out[:, 0::2, 1::2] = ys[:, 2].reshape(b, h2, w2, c)
    out[:, 1::2, 1::2] = ys[:, 3].reshape(b, w2, h2, c).transpose(1, 2)
    return out[:, :h, :w]


def depth_to_space(x, s):
    """(B, H, W, s*s*c) -> (B, s*H, s*W, c): einops
    'b h w (p1 p2 c) -> b (h p1) (w p2) c'."""
    b, h, w, f = x.shape
    c = f // (s * s)
    return x.reshape(b, h, w, s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(b, s * h, s * w, c)


class SSMCore(nn.Module):
    def __init__(self, d_model, d_state, ssm_ratio, device=None):
        super().__init__()
        self.d_inner = d = int(ssm_ratio * d_model)
        self.d_state = n = d_state
        self.dt_rank = r = math.ceil(d_model / 16)
        self.x_proj_weight = _p(K_DIRS, r + 2 * n, d, device=device)
        self.dt_projs_weight = _p(K_DIRS, d, r, device=device)
        self.dt_projs_bias = _p(K_DIRS, d, device=device)
        self.A_logs = _p(K_DIRS * d, n, device=device)
        self.Ds = _p(K_DIRS * d, device=device)
        self.out_norm = LayerNorm(d, 1e-5, device)
        self.conv2d = Conv(d, 1, 3, 3, device=device)

    def dwconv_silu(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.conv2d.weight, self.conv2d.bias, padding=1,
                     groups=self.d_inner)
        return F.silu(y.permute(0, 2, 3, 1))

    def scan(self, x, gate):
        b, h, w, d = x.shape
        n, r = self.d_state, self.dt_rank
        xs = efficient_scan(x)
        x_dbl = torch.einsum("bkld,kcd->bklc", xs, self.x_proj_weight)
        dts, bs, cs = x_dbl.split([r, n, n], dim=-1)
        delta = torch.einsum("bklr,kdr->bkld", dts, self.dt_projs_weight)
        a = -torch.exp(self.A_logs).view(K_DIRS, d, n)
        ys = selective_scan(xs, delta, a, bs, cs, self.Ds.view(K_DIRS, d), self.dt_projs_bias)
        return self.out_norm(efficient_merge(ys, h, w)) * gate


class SS2D(SSMCore):
    def __init__(self, d_model, d_state, ssm_ratio, device=None):
        super().__init__(d_model, d_state, ssm_ratio, device)
        self.in_proj = Linear(d_model, 2 * self.d_inner, bias=False, device=device)
        self.out_proj = Linear(self.d_inner, d_model, bias=False, device=device)

    def forward(self, x):
        xz = self.in_proj(x)
        xp, z = xz[..., :self.d_inner], xz[..., self.d_inner:]
        return self.out_proj(self.scan(self.dwconv_silu(xp), F.silu(z)))


class SS2DCross(SSMCore):
    """One depthwise conv for both inputs, the pre-scan fusion x1*x2 + x1 + x2,
    and the gate silu(z1) + silu(silu(z1)) (`SS2D_cross_new`)."""

    def __init__(self, d_model, d_state, ssm_ratio, device=None):
        super().__init__(d_model, d_state, ssm_ratio, device)
        self.in_proj1 = Linear(d_model, 2 * self.d_inner, bias=False, device=device)
        self.in_proj2 = Linear(d_model, 2 * self.d_inner, bias=False, device=device)
        self.out_proj = Linear(self.d_inner, d_model, bias=False, device=device)

    def forward(self, x1, x2):
        d = self.d_inner
        xz1, xz2 = self.in_proj1(x1), self.in_proj2(x2)
        a, b = self.dwconv_silu(xz1[..., :d]), self.dwconv_silu(xz2[..., :d])
        z1 = F.silu(xz1[..., d:])
        return self.out_proj(self.scan(a * b + a + b, z1 + F.silu(z1)))


class ECA(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.conv = Conv(1, 1, 3, bias=False, device=device)

    def forward(self, x):
        y = F.conv1d(x.mean(dim=(1, 2))[:, None, :], self.conv.weight, padding=1)[:, 0]
        return x * torch.sigmoid(y)[:, None, None, :]


class LDC(nn.Module):
    """Central-difference 3x3 conv: weight W * (1 - theta * M * center * sum W)."""

    def __init__(self, c, device=None):
        super().__init__()
        self.conv = Conv(c, c, 3, 3, bias=False, device=device)
        self.learnable_mask = _p(c, c, device=device)
        self.learnable_theta = _p(1, device=device)

    def forward(self, x):
        w = self.conv.weight
        center = torch.zeros(3, 3, device=w.device, dtype=w.dtype)
        center[1, 1] = 1.0
        eff = w * (1.0 - self.learnable_theta * self.learnable_mask[:, :, None, None] * center
                   * w.sum(dim=(2, 3), keepdim=True))
        return F.conv2d(x.permute(0, 3, 1, 2), eff, padding=1).permute(0, 2, 3, 1)


class BiAttn(nn.Module):
    def __init__(self, c, device=None):
        super().__init__()
        self.norm = LayerNorm(c, 1e-5, device)
        self.global_reduce = Linear(c, int(c * 0.125), device=device)
        self.channel_select = Linear(int(c * 0.125), c, device=device)

    def forward(self, x):
        g = self.norm(x).mean(dim=(1, 2))
        g = F.gelu(self.global_reduce(g))
        return x * torch.sigmoid(self.channel_select(g))[:, None, None, :]


class Mlp(nn.Module):
    def __init__(self, c, hidden, device=None):
        super().__init__()
        self.fc1, self.fc2 = Linear(c, hidden, device=device), Linear(hidden, c, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def drop_path(x, rate, uni):
    """Sample i kept and scaled by 1 / (1 - rate) where uni[i] < 1 - rate."""
    if uni is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = (uni < keep).to(x.dtype).view(-1, *([1] * (x.dim() - 1)))
    return x * mask / keep


class VSSBlock(nn.Module):
    def __init__(self, c, cfg, rate, device=None):
        super().__init__()
        self.rate = rate
        self.norm = LayerNorm(c, cfg["norm_eps"], device)
        self.op = SS2D(c, cfg["d_state"], cfg["ssm_ratio"], device)
        self.self_attention_cross_channel = ECA(device)
        self.conv_branch = LDC(c, device)
        self.se = BiAttn(c, device)
        self.norm2 = LayerNorm(c, cfg["norm_eps"], device)
        self.mlp = Mlp(c, int(c * cfg["mlp_ratio"]), device)

    def forward(self, x, uni):  # uni: (2, rows) or None
        u0, u1 = (None, None) if uni is None else uni
        x_ssm = self.op(self.norm(x))
        x_conv = self.conv_branch(x_ssm + self.self_attention_cross_channel(x_ssm))
        x = x + drop_path(self.se(x_ssm) + self.se(x_conv), self.rate, u0)
        return x + drop_path(self.mlp(self.norm2(x)), self.rate, u1)


class VSSBlockCross(nn.Module):
    def __init__(self, c, cfg, device=None):
        super().__init__()
        self.Cross_layer = nn.Module()
        self.Cross_layer.texture_enhance1 = LDC(c, device)
        self.Cross_layer.texture_enhance2 = LDC(c, device)
        self.ln_1 = LayerNorm(c, cfg["norm_eps"], device)
        self.ln_2 = LayerNorm(c, cfg["norm_eps"], device)
        self.self_attention_cross = SS2DCross(c, cfg["d_state"], cfg["ssm_ratio"], device)
        self.self_attention_cross_spatial = ECA(device)

    def forward(self, x1, x2):
        fuse = x1 + x2
        w12 = torch.sigmoid((x1 - x2).mean(dim=(1, 2), keepdim=True))
        w21 = torch.sigmoid((x2 - x1).mean(dim=(1, 2), keepdim=True))
        f1 = self.Cross_layer.texture_enhance1(x1) + w12 * fuse + x1
        f2 = self.Cross_layer.texture_enhance2(x2) + w21 * fuse + x2
        y = self.self_attention_cross(self.ln_1(f1), self.ln_2(f2))
        return x1 + x2 + y + self.self_attention_cross_spatial(y)


class PatchEmbed(nn.Module):
    def __init__(self, cin, c, p, device=None):
        super().__init__()
        self.p = p
        self.proj = Conv(c, cin, p, p, device=device)
        self.norm = LayerNorm(c, 1e-5, device)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.proj.weight, self.proj.bias, stride=self.p)
        return self.norm(y.permute(0, 2, 3, 1))


class PatchMerging(nn.Module):
    def __init__(self, c, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * c, 1e-5, device)
        self.reduction = Linear(4 * c, 2 * c, bias=False, device=device)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchExpand(nn.Module):
    def __init__(self, c, scale, device=None):
        super().__init__()
        self.scale = scale
        d_in = 2 * c if scale == 2 else c
        self.expand = Linear(d_in, scale * d_in if scale == 4 else 2 * d_in, bias=False,
                             device=device)
        self.norm = LayerNorm(c if scale == 2 else c // scale, 1e-5, device)

    def forward(self, x):
        return self.norm(depth_to_space(self.expand(x), self.scale))


class Stage(nn.Module):
    def __init__(self, c, cfg, rates, down, up, device=None):
        super().__init__()
        self.upsample = PatchExpand(c, 2, device) if up else None
        self.blocks = nn.ModuleList(VSSBlock(c, cfg, r, device) for r in rates)
        self.downsample = PatchMerging(c, device) if down else None

    def forward(self, x, unis):  # unis: (depth, 2, rows) or None
        if self.upsample is not None:
            x = self.upsample(x)
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if unis is None else unis[i])
        return x if self.downsample is None else self.downsample(x)


def _split(values, depths):
    out, i = [], 0
    for d in depths:
        out.append(values[i:i + d])
        i += d
    return out


class FusionNet(nn.Module):
    """`cfg` holds dims, depths, depths_decoder, d_state, ssm_ratio,
    mlp_ratio, drop_path_rate, norm_eps, patch_size, in_chans."""

    def __init__(self, cfg: dict, device=None):
        super().__init__()
        self.cfg = cfg
        dims, depths, dec = cfg["dims"], cfg["depths"], cfg["depths_decoder"]
        nl, rate = len(dims), cfg["drop_path_rate"]
        enc_r = _split(np.linspace(0.0, rate, sum(depths)).tolist(), depths)
        dec_r = _split(np.linspace(0.0, rate, sum(dec)).tolist()[::-1], dec)
        dims_dec = dims[::-1]
        p, cin = cfg["patch_size"], cfg["in_chans"]
        self.patch_embed1 = PatchEmbed(cin, dims[0], p, device)
        self.patch_embed2 = PatchEmbed(cin, dims[0], p, device)
        self.layers = nn.ModuleList(Stage(dims[i], cfg, enc_r[i], i < nl - 1, False, device)
                                    for i in range(nl))
        self.layers_up = nn.ModuleList(Stage(dims_dec[i], cfg, dec_r[i], False, i > 0, device)
                                       for i in range(nl))
        self.Cross_block = nn.ModuleList(VSSBlockCross(dims[i], cfg, device) for i in range(nl))
        self.final_up = PatchExpand(dims_dec[-1], 4, device)
        self.final_conv = Conv(1, dims_dec[-1] // 4, 1, 1, device=device)

    def dp_rows(self):
        """Rows of one step's DropPath table: two a VSSBlock, encoder first."""
        return 2 * (sum(self.cfg["depths"]) + sum(self.cfg["depths_decoder"]))

    def _stage_tables(self, table):
        out, off = [], 0
        for d in list(self.cfg["depths"]) + list(self.cfg["depths_decoder"]):
            out.append(table[off:off + 2 * d].view(d, 2, table.shape[1]))
            off += 2 * d
        k = len(self.cfg["depths"])
        return out[:k], out[k:]

    def forward(self, x1, x2, table=None, rows=None):
        """x1, x2 (b, H, W, 1) are rows `rows` (a slice) of a batch of B; `table`
        the step's (dp_rows, 2B) uniforms, or None (no DropPath). The encoder
        reads columns rows and B + rows, the decoder columns rows."""
        enc = dec = [None] * len(self.layers)
        if table is not None:
            full = table.shape[1] // 2
            enc_cols = torch.cat([table[:, rows], table[:, full + rows.start:full + rows.stop]], 1)
            enc = self._stage_tables(enc_cols)[0]
            dec = self._stage_tables(table[:, rows].contiguous())[1]
        x = torch.cat([self.patch_embed1(x1), self.patch_embed2(x2)], 0)
        skips = []
        for layer, unis in zip(self.layers, enc):
            skips.append(x)
            x = layer(x, unis)
        e1, e2 = x.chunk(2, 0)
        x = e1 + e2
        for i, (layer, unis) in enumerate(zip(self.layers_up, dec)):
            if i > 0:
                k = len(self.layers) - i
                x = x + self.Cross_block[k](*skips[k].chunk(2, 0))
            x = layer(x, unis)
        x = self.final_up(x)
        w = self.final_conv.weight.view(1, -1)
        return F.linear(x, w, self.final_conv.bias) + 2.0 * x1 + 2.0 * x2


# ---- the loss (`loss.py:15-56` with pytorch_msssim) ----

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian(size, like, sigma=1.5):
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-x ** 2 / (2 * sigma ** 2))
    g = (g / g.sum()).to(device=like.device, dtype=like.dtype)
    return (g[:, None] @ g[None, :])[None, None]


def _ssim(img1, img2, window):
    """Mean SSIM and mean contrast-structure of NCHW single-channel images;
    the dynamic range from img1 (`pytorch_msssim.ssim`, val_range None)."""
    max_val = 255.0 if img1.max() > 128 else 1.0
    min_val = -1.0 if img1.min() < -0.5 else 0.0
    rng = max_val - min_val
    size = min(window.shape[-1], img1.shape[-2], img1.shape[-1])
    win = window if size == window.shape[-1] else _gaussian(size, img1)
    mu1, mu2 = F.conv2d(img1, win), F.conv2d(img2, win)
    s11 = F.conv2d(img1 * img1, win) - mu1 * mu1
    s22 = F.conv2d(img2 * img2, win) - mu2 * mu2
    s12 = F.conv2d(img1 * img2, win) - mu1 * mu2
    c1, c2 = (0.01 * rng) ** 2, (0.03 * rng) ** 2
    v1, v2 = 2.0 * s12 + c2, s11 + s22 + c2
    ssim_map = ((2 * mu1 * mu2 + c1) * v1) / ((mu1 * mu1 + mu2 * mu2 + c1) * v2)
    return ssim_map.mean(), (v1 / v2).mean()


def msssim(img1, img2):
    """`pytorch_msssim.msssim(normalize=True)`: prod(pow1[:-1] * pow2[-1])."""
    window = _gaussian(11, img1)
    sims, css = [], []
    for _ in MSSSIM_WEIGHTS:
        s, c = _ssim(img1, img2, window)
        sims.append(s)
        css.append(c)
        img1, img2 = F.avg_pool2d(img1, 2), F.avg_pool2d(img2, 2)
    w = torch.tensor(MSSSIM_WEIGHTS, device=img1.device, dtype=img1.dtype)
    pow1 = ((torch.stack(css) + 1) / 2) ** w
    pow2 = ((torch.stack(sims) + 1) / 2) ** w
    return torch.prod(pow1[:-1] * pow2[-1])


def _sobel(x):
    kx = x.new_tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
    ky = x.new_tensor([[1.0, 2.0, 1.0], [0.0, 0.0, 0.0], [-1.0, -2.0, -1.0]])
    return (F.conv2d(x, kx[None, None], padding=1).abs()
            + F.conv2d(x, ky[None, None], padding=1).abs())


def fusion_loss(vis_y, ir, gen):
    """`Fusionloss`: (B, H, W, 1) NHWC inputs and output in [0, 1]."""
    y, i, g = (t.permute(0, 3, 1, 2) for t in (vis_y, ir, gen))
    ssim_term = 0.5 * (1 - msssim(g, y)) + 0.5 * (1 - msssim(g, i))
    loss_in = F.mse_loss(g, torch.maximum(y, i))
    loss_grad = F.l1_loss(_sobel(g), torch.maximum(_sobel(y), _sobel(i)))
    return 100.0 * ssim_term + 10.0 * loss_in + loss_grad


# ---- training steps ----

def _blocks(batch, rows):
    return [slice(a, min(a + rows, batch)) for a in range(0, batch, rows)]


def train_step(net: FusionNet, vis_y, ir, table, rows: int):
    """One step's loss and the network's output before the clamp, with the
    gradients left in .grad, on the whole batch `rows` rows at a time: a
    forward without autograd gives the batch's output, the loss (which mixes
    the batch: its SSIM means and dynamic range) gives the output's
    gradient, and each block of rows is run again with autograd and
    back-propagated from its share of that gradient."""
    batch = vis_y.shape[0]
    parts = _blocks(batch, rows)
    with torch.no_grad():
        out = torch.cat([net(vis_y[s], ir[s], table, s) for s in parts])
    out.requires_grad_(True)
    loss = fusion_loss(vis_y, ir, out.clamp(0.0, 1.0))
    loss.backward()
    d_out = out.grad
    for s in parts:
        net(vis_y[s], ir[s], table, s).backward(d_out[s])
    return loss.detach(), out.detach()


class Adam:
    """Adam with bias correction (Kingma & Ba; torch.optim.Adam's update): a
    parameter that never had a gradient is left alone and keeps no state."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = list(params), lr, betas, eps
        self.state = {}

    @torch.no_grad()
    def step(self):
        b1, b2 = self.betas
        for p in self.params:
            if p.grad is None:
                continue
            st = self.state.setdefault(p, {"t": 0, "m": torch.zeros_like(p),
                                           "v": torch.zeros_like(p)})
            st["t"] += 1
            st["m"].mul_(b1).add_(p.grad, alpha=1 - b1)
            st["v"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            denom = (st["v"] / (1 - b2 ** st["t"])).sqrt_().add_(self.eps)
            p.addcdiv_(st["m"], denom, value=-self.lr / (1 - b1 ** st["t"]))

    def zero_grad(self):
        for p in self.params:
            p.grad = None
