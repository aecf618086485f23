"""Jamba in plain PyTorch, float32: the reference the port's Jamba is tested
against on the CPU. It imports nothing of the port.

Written from transformers' `models/jamba/modeling_jamba.py`
(`JambaForCausalLM`, its slow paths): `JambaRMSNorm`; `JambaMambaMixer.
slow_forward` (in_proj to (x, z), causal depthwise conv1d and SiLU, x_proj
to (dt, B, C) with their RMSNorms, dt_proj and softplus, the recurrence a
step at a time, the skip D, the z gate, out_proj); `JambaAttention` (causal,
no positional encoding, `repeat_kv`); `JambaSparseMoeBlock` (softmax over
every expert, top-k, not renormalised, a loop over the experts); `JambaMLP`.
Parameter names are transformers'.

Departures: the expert layer holds `held` of the experts, and rows routed to
others add nothing (one chip's part under expert parallelism; all experts by
default); `inner_norms=False` gives mamba_ssm's Mamba mixer, without the
RMSNorms on dt, B and C; no cache, masks, dropout or auxiliary loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _p(*shape):
    return nn.Parameter(torch.empty(*shape))


class Linear(nn.Module):
    def __init__(self, n_in, n_out, bias=False):
        super().__init__()
        self.weight = _p(n_out, n_in)
        self.bias = _p(n_out) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps):
        super().__init__()
        self.eps = eps
        self.weight = _p(dim)

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


class MambaMixer(nn.Module):
    def __init__(self, d, d_state, d_conv, expand, dt_rank, eps, inner_norms=True):
        super().__init__()
        self.d_inner, self.d_state, self.d_conv, self.dt_rank = expand * d, d_state, d_conv, dt_rank
        di = self.d_inner
        self.in_proj = Linear(d, 2 * di)
        self.conv1d = nn.Module()
        self.conv1d.weight = _p(di, 1, d_conv)
        self.conv1d.bias = _p(di)
        self.x_proj = Linear(di, dt_rank + 2 * d_state)
        self.dt_proj = Linear(dt_rank, di, bias=True)
        self.A_log = _p(di, d_state)
        self.D = _p(di)
        self.out_proj = Linear(di, d)
        self.inner_norms = inner_norms
        if inner_norms:
            self.dt_layernorm = RMSNorm(dt_rank, eps)
            self.b_layernorm = RMSNorm(d_state, eps)
            self.c_layernorm = RMSNorm(d_state, eps)

    def forward(self, h):
        length = h.shape[1]
        x, gate = self.in_proj(h).transpose(1, 2).chunk(2, dim=1)           # (B, di, L)
        x = F.silu(F.conv1d(x, self.conv1d.weight, self.conv1d.bias, padding=self.d_conv - 1,
                            groups=self.d_inner)[..., :length])
        params = self.x_proj(x.transpose(1, 2))
        dt, bm, cm = torch.split(params, [self.dt_rank, self.d_state, self.d_state], dim=-1)
        if self.inner_norms:
            dt, bm, cm = self.dt_layernorm(dt), self.b_layernorm(bm), self.c_layernorm(cm)
        dt = F.softplus(self.dt_proj(dt)).transpose(1, 2)                     # (B, di, L)
        a = -torch.exp(self.A_log)                                          # (di, N)
        state = torch.zeros(h.shape[0], self.d_inner, self.d_state)
        ys = []
        for t in range(length):
            da = torch.exp(a[None] * dt[:, :, t, None])
            dbu = dt[:, :, t, None] * bm[:, None, t, :] * x[:, :, t, None]
            state = da * state + dbu
            ys.append((state * cm[:, None, t, :]).sum(-1))
        y = torch.stack(ys, dim=-1) + x * self.D[None, :, None]
        return self.out_proj((y * F.silu(gate)).transpose(1, 2))


class Attention(nn.Module):
    def __init__(self, d, heads, kv_heads):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, d // heads
        self.q_proj = Linear(d, heads * self.head_dim)
        self.k_proj = Linear(d, kv_heads * self.head_dim)
        self.v_proj = Linear(d, kv_heads * self.head_dim)
        self.o_proj = Linear(heads * self.head_dim, d)

    def forward(self, h):
        b, length, _ = h.shape
        hd, rep = self.head_dim, self.heads // self.kv_heads
        q = self.q_proj(h).view(b, length, self.heads, hd).transpose(1, 2)
        k = self.k_proj(h).view(b, length, self.kv_heads, hd).transpose(1, 2)
        v = self.v_proj(h).view(b, length, self.kv_heads, hd).transpose(1, 2)
        # repeat_kv: key-value head i serves query heads i * rep ... (i + 1) * rep - 1
        k, v = (t[:, :, None].expand(b, self.kv_heads, rep, length, hd)
                .reshape(b, self.heads, length, hd) for t in (k, v))
        scores = q @ k.transpose(2, 3) / math.sqrt(hd)
        mask = torch.ones(length, length, dtype=torch.bool).triu(1)
        attn = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
        return self.o_proj((attn @ v).transpose(1, 2).reshape(b, length, self.heads * hd))


class MLP(nn.Module):
    def __init__(self, d, width):
        super().__init__()
        self.gate_proj = Linear(d, width)
        self.up_proj = Linear(d, width)
        self.down_proj = Linear(width, d)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class SparseMoe(nn.Module):
    def __init__(self, d, width, n_experts, top_k, held=None):
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.router = Linear(d, n_experts)
        held = range(n_experts) if held is None else held
        self.experts = nn.ModuleDict({str(e): MLP(d, width) for e in held})

    def forward(self, h):
        b, length, d = h.shape
        x = h.reshape(-1, d)
        router_logits = self.router(x)
        probs = torch.softmax(router_logits, dim=1, dtype=torch.float)
        weights, chosen = torch.topk(probs, self.top_k, dim=-1)
        out = torch.zeros_like(x)
        mask = F.one_hot(chosen, num_classes=self.n_experts).permute(2, 1, 0)   # (E, k, rows)
        for name, expert in self.experts.items():
            slot, rows = torch.where(mask[int(name)])
            out.index_add_(0, rows, expert(x[rows]) * weights[rows, slot, None])
        return out.reshape(b, length, d), router_logits


class Layer(nn.Module):
    def __init__(self, cfg, i, held):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.input_layernorm = RMSNorm(d, eps)
        self.pre_ff_layernorm = RMSNorm(d, eps)
        if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]:
            self.self_attn = Attention(d, cfg["num_attention_heads"], cfg["num_key_value_heads"])
        else:
            r = cfg["mamba_dt_rank"]
            self.mamba = MambaMixer(d, cfg["mamba_d_state"], cfg["mamba_d_conv"],
                                    cfg["mamba_expand"], math.ceil(d / 16) if r == "auto" else r,
                                    eps)
        if i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]:
            self.feed_forward = SparseMoe(d, cfg["intermediate_size"], cfg["num_experts"],
                                          cfg["num_experts_per_tok"], held)
        else:
            self.feed_forward = MLP(d, cfg["intermediate_size"])

    def forward(self, x):
        h = self.input_layernorm(x)
        x = x + (self.self_attn(h) if hasattr(self, "self_attn") else self.mamba(h))
        out = self.feed_forward(self.pre_ff_layernorm(x))
        return x + (out[0] if isinstance(out, tuple) else out)


class JambaForCausalLM(nn.Module):
    """`cfg`: a transformers Jamba config dict with every key set; `held`: the
    experts of each expert layer held (all by default)."""

    def __init__(self, cfg: dict, held=None):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        d = cfg["hidden_size"]
        self.model = nn.Module()
        self.model.embed_tokens = nn.Module()
        self.model.embed_tokens.weight = _p(cfg["vocab_size"], d)
        self.model.layers = nn.ModuleList(Layer(cfg, i, held)
                                          for i in range(cfg["num_hidden_layers"]))
        self.model.final_layernorm = RMSNorm(d, cfg["rms_norm_eps"])
        self.lm_head = Linear(d, cfg["vocab_size"])

    def forward(self, tokens):
        x = self.model.embed_tokens.weight[tokens]
        for layer in self.model.layers:
            x = layer(x)
        return self.lm_head(self.model.final_layernorm(x))
