"""Jamba in plain PyTorch: the benchmark's reference for the Jamba cells, and
the weights both sides take from the seed.

Written from transformers' `models/jamba/modeling_jamba.py`
(`JambaForCausalLM`; Lieber et al., arXiv:2403.19887), in float32 with TF32
off: embedding; layers x + mixer(RMSNorm(x)), then + feed_forward(RMSNorm);
a final RMSNorm and the head. Layer i's mixer is causal GQA attention
without positional encoding where i % attn_layer_period ==
attn_layer_offset, a Mamba-1 mixer otherwise (in_proj to (x, z); a causal
depthwise conv1d and SiLU; x_proj to (dt, B, C), each through its RMSNorm;
dt_proj's weight, its bias inside the softplus; the selective scan; y *
SiLU(z); out_proj). Its feed-forward is the expert layer where i %
expert_layer_period == expert_layer_offset (a router over every expert,
softmax, top-k, not renormalised; each expert down(SiLU(gate(x)) * up(x))),
the same MLP alone otherwise. Parameter names are transformers'.

Departures from `modeling_jamba.py`, none of which changes the result in
exact arithmetic:
- attention is computed a block of queries at a time against the keys up
  to the block's end (`Q_BLOCK`), never the whole (L, L) scores; each
  key-value head serves its heads by a view, not `repeat_kv`'s copy;
- the scan is `scan.py`'s chunked recurrence, a block of channels at a time
  (`SCAN_BLOCK`), not the sequential `slow_forward` loop;
- the expert layer holds `experts_held` of the experts, as the program's
  share does: rows routed elsewhere add nothing (an expert-parallel chip's
  part of the result);
- the route can be told the program's: at rows whose 2nd and 3rd
  probabilities here lie within a tie width, the reference takes the
  program's top-k (`forward`'s `routes`), and counts the other rows where
  the two top-k sets differ;
- no cache, no padding mask, no router auxiliary loss; every position's
  logits (`num_logits_to_keep` is for generation).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import weights
from .scan import selective_scan

# queries a block in attention, channels a block in the scan
Q_BLOCK = 1024
SCAN_BLOCK = 1024
# transformers' `JambaConfig.initializer_range`
INIT_STD = 0.02


def model_config(config: dict) -> dict:
    """The model's dict of a configuration file: the router over the
    published count of experts (`published`), of which the file's
    `num_experts` are held here."""
    return {**config, "num_experts": config["published"]["num_experts"]}


def experts_held(config: dict) -> range:
    """The experts of each expert layer held here: `num_experts` of them from
    `experts_held_from`."""
    return range(config["experts_held_from"], config["experts_held_from"] + config["num_experts"])


def _p(*shape, device=None):
    return nn.Parameter(torch.empty(*shape, device=device))


class _W(nn.Module):
    def __init__(self, out_dim, in_dim, bias=False, device=None):
        super().__init__()
        self.weight = _p(out_dim, in_dim, device=device)
        self.bias = _p(out_dim, device=device) if bias else None


class RMSNorm(nn.Module):
    def __init__(self, dim, eps, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _p(dim, device=device)

    def forward(self, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * self.weight


def _dt_rank(cfg):
    r = cfg["mamba_dt_rank"]
    return math.ceil(cfg["hidden_size"] / 16) if r == "auto" else int(r)


class Mamba(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.d_inner = di = cfg["mamba_expand"] * d
        self.d_state = n = cfg["mamba_d_state"]
        self.d_conv = cfg["mamba_d_conv"]
        self.dt_rank = r = _dt_rank(cfg)
        self.in_proj = _W(2 * di, d, device=device)
        self.conv1d = nn.Module()
        self.conv1d.weight = _p(di, 1, self.d_conv, device=device)
        self.conv1d.bias = _p(di, device=device)
        self.x_proj = _W(r + 2 * n, di, device=device)
        self.dt_proj = _W(di, r, bias=True, device=device)
        self.A_log = _p(di, n, device=device)
        self.D = _p(di, device=device)
        self.out_proj = _W(d, di, device=device)
        self.dt_layernorm = RMSNorm(r, eps, device)
        self.b_layernorm = RMSNorm(n, eps, device)
        self.c_layernorm = RMSNorm(n, eps, device)

    def forward(self, h):
        length, r, n = h.shape[1], self.dt_rank, self.d_state
        x, z = F.linear(h, self.in_proj.weight).chunk(2, dim=-1)
        x = F.conv1d(x.transpose(1, 2), self.conv1d.weight, self.conv1d.bias,
                     padding=self.d_conv - 1, groups=self.d_inner)[..., :length]
        x = F.silu(x.transpose(1, 2))
        dbc = F.linear(x, self.x_proj.weight)
        dt = self.dt_layernorm(dbc[..., :r])
        bm = self.b_layernorm(dbc[..., r:r + n])[:, None]
        cm = self.c_layernorm(dbc[..., r + n:])[:, None]
        delta = F.linear(dt, self.dt_proj.weight)
        a = -torch.exp(self.A_log)
        y = torch.empty_like(x)
        for c in range(0, self.d_inner, SCAN_BLOCK):
            s = slice(c, c + SCAN_BLOCK)
            y[..., s] = selective_scan(x[:, None, :, s], delta[:, None, :, s], a[None, s], bm, cm,
                                       self.D[None, s], self.dt_proj.bias[None, s])[:, 0]
        return F.linear(y * F.silu(z), self.out_proj.weight)


class Attention(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg["hidden_size"]
        self.heads, self.kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.head_dim = hd = d // self.heads
        self.q_proj = _W(self.heads * hd, d, device=device)
        self.k_proj = _W(self.kv_heads * hd, d, device=device)
        self.v_proj = _W(self.kv_heads * hd, d, device=device)
        self.o_proj = _W(d, self.heads * hd, device=device)

    def forward(self, h):
        b, length, _ = h.shape
        hd, g = self.head_dim, self.heads // self.kv_heads
        # (B, kv_heads, group, L, hd): query head j is served by key-value head j // group
        q = F.linear(h, self.q_proj.weight).view(b, length, self.kv_heads, g, hd)
        q = q.permute(0, 2, 3, 1, 4)
        k = F.linear(h, self.k_proj.weight).view(b, length, self.kv_heads, 1, hd)
        k = k.permute(0, 2, 3, 1, 4)
        v = F.linear(h, self.v_proj.weight).view(b, length, self.kv_heads, 1, hd)
        v = v.permute(0, 2, 3, 1, 4)
        out = torch.empty_like(q)
        pos = torch.arange(length, device=h.device)
        for s in range(0, length, Q_BLOCK):
            e = min(length, s + Q_BLOCK)
            scores = torch.matmul(q[..., s:e, :], k[..., :e, :].transpose(-1, -2)) / math.sqrt(hd)
            scores.masked_fill_(pos[None, :e] > pos[s:e, None], float("-inf"))
            out[..., s:e, :] = torch.matmul(torch.softmax(scores, dim=-1), v[..., :e, :])
        out = out.permute(0, 3, 1, 2, 4).reshape(b, length, self.heads * hd)
        return F.linear(out, self.o_proj.weight)


class MLP(nn.Module):
    def __init__(self, d, width, device=None):
        super().__init__()
        self.gate_proj = _W(width, d, device=device)
        self.up_proj = _W(width, d, device=device)
        self.down_proj = _W(d, width, device=device)

    def forward(self, x):
        gated = F.silu(F.linear(x, self.gate_proj.weight)) * F.linear(x, self.up_proj.weight)
        return F.linear(gated, self.down_proj.weight)


class Routes:
    """What the expert layers of one forward record: the route each took
    (probabilities (rows, experts), top-k (rows, k)), and against a route
    it was told, the rows whose top-k sets differ outside the tie width
    (`mismatch`), the rows within it (`ties`), and the largest gap of the
    two routers' probabilities (`prob_gap`)."""

    def __init__(self):
        self.taken: list = []
        self.mismatch = 0
        self.ties = 0
        self.prob_gap = 0.0


class Experts(nn.Module):
    def __init__(self, cfg, held, device=None):
        super().__init__()
        d = cfg["hidden_size"]
        self.top_k = cfg["num_experts_per_tok"]
        self.router = _W(cfg["num_experts"], d, device=device)
        self.experts = nn.ModuleDict({str(e): MLP(d, cfg["intermediate_size"], device)
                                      for e in held})

    def forward(self, h, told, tau, record):
        shape = h.shape
        x = h.reshape(-1, shape[-1])
        probs = torch.softmax(F.linear(x, self.router.weight), dim=-1)
        top = torch.topk(probs, self.top_k + 1, dim=-1)
        chosen = top.indices[:, :self.top_k]
        if told is not None:
            told_probs, told_chosen = told
            tie = top.values[:, self.top_k - 1] - top.values[:, self.top_k] <= tau
            differ = (told_chosen.sort(-1).values != chosen.sort(-1).values).any(-1)
            record.mismatch += int((differ & ~tie).sum())
            record.ties += int(tie.sum())
            record.prob_gap = max(record.prob_gap, float((told_probs - probs).abs().max()))
            chosen = torch.where(tie[:, None], told_chosen, chosen)
        record.taken.append((probs, chosen))
        weight = probs.gather(1, chosen)
        out = torch.zeros_like(x)
        for name, expert in self.experts.items():
            rows, slot = torch.nonzero(chosen == int(name), as_tuple=True)
            out.index_add_(0, rows, expert(x[rows]) * weight[rows, slot, None])
        return out.reshape(shape)


class Layer(nn.Module):
    def __init__(self, cfg, i, held, device=None):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.input_layernorm = RMSNorm(d, eps, device)
        self.pre_ff_layernorm = RMSNorm(d, eps, device)
        if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]:
            self.self_attn = Attention(cfg, device)
        else:
            self.mamba = Mamba(cfg, device)
        if i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]:
            self.feed_forward = Experts(cfg, held, device)
        else:
            self.feed_forward = MLP(d, cfg["intermediate_size"], device)

    def forward(self, x, told, tau, record):
        h = self.input_layernorm(x)
        x = x + (self.self_attn(h) if hasattr(self, "self_attn") else self.mamba(h))
        h = self.pre_ff_layernorm(x)
        if isinstance(self.feed_forward, Experts):
            return x + self.feed_forward(h, told, tau, record)
        return x + self.feed_forward(h)


class JambaLM(nn.Module):
    """`cfg`: a transformers Jamba config dict (`model_config`); `held`: the
    experts of each expert layer held. Sets TF32 off for the process's
    float32 products (a control turns it on within its block)."""

    def __init__(self, cfg: dict, held, device=None):
        super().__init__()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        d, vocab = cfg["hidden_size"], cfg["vocab_size"]
        self.model = nn.Module()
        self.model.embed_tokens = _W(vocab, d, device=device)
        self.model.layers = nn.ModuleList(Layer(cfg, i, held, device)
                                          for i in range(cfg["num_hidden_layers"]))
        self.model.final_layernorm = RMSNorm(d, cfg["rms_norm_eps"], device)
        self.lm_head = _W(vocab, d, device=device)

    def forward(self, tokens, routes=None, tau=0.0):
        """tokens (B, L) -> (logits (B, L, vocab), `Routes`). `routes`, one
        (probabilities, top-k) an expert layer over the B * L rows, is the
        program's route, taken at the rows within the tie width `tau`."""
        record = Routes()
        x = self.model.embed_tokens.weight[tokens]
        told = iter(routes or ())
        for layer in self.model.layers:
            is_moe = isinstance(layer.feed_forward, Experts)
            x = layer(x, next(told, None) if is_moe and routes else None, tau, record)
        return F.linear(self.model.final_layernorm(x), self.lm_head.weight), record


def _group(name: str, n_experts: int) -> int:
    """The draw a parameter belongs to: one for the embedding, one for the
    head and final norm, one for each layer's other tensors and one for
    each of its experts, numbered by layer and expert, so an expert's
    weights do not depend on which experts are held."""
    parts = name.split(".")
    if parts[:2] != ["model", "layers"]:
        return 0 if parts[1] == "embed_tokens" else 1
    i = int(parts[2])
    e = int(parts[parts.index("experts") + 1]) + 1 if "experts" in parts else 0
    return 2 + i * (n_experts + 1) + e


def _rule(plan, name: str):
    if name.endswith("layernorm.weight") or name.endswith(".D"):
        plan.const(name, weights._ones)
    elif name.endswith("A_log"):
        plan.const(name, weights._a_log)
    elif name.endswith(".bias"):
        plan.const(name, weights._zeros)
    else:
        plan.draw(name, "normal", INIT_STD)


def load_weights(module: nn.Module, cfg: dict, seed: int, device) -> None:
    """Fill every parameter of `module` (the program's or the reference's,
    whose names are the same) from the seed, a group at a time
    (`reference/weights.py`'s plan and generator): transformers' Jamba init,
    N(0, 0.02) for every product's weight and the embedding, zero biases,
    unit norms and D, S4D-real A_log. A group is one layer's tensors less
    its experts, or one expert, so its draws never hold more than a few GB."""
    groups: dict = {}
    for name, p in module.named_parameters():
        groups.setdefault(_group(name, cfg["num_experts"]), {})[name] = p
    for g, members in sorted(groups.items()):
        plan = weights._Plan()
        for name in members:
            _rule(plan, name)
        made = plan.make({n: p.shape for n, p in members.items()},
                         int(seed) * 4096 + g, device)
        with torch.no_grad():
            for name, p in members.items():
                p.copy_(made[name])
        del made


def forward_flops_per_token(cfg: dict, held: int, seq_len: int) -> int:
    """Model FLOPs a token of a sequence of `seq_len`, two a multiply-add:
    every product, the conv and the scan's readout, as `flops.py`'s counter
    counts the Mamba LM; attention's scores and values causal, (seq_len + 1)
    / 2 keys a query on average; each expert layer's router, and its held
    experts at their expected load, top-k x held / all experts rows a token;
    the head. Norms, activations and the scan's recurrence are not counted."""
    d, width, vocab = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    di, n, r = cfg["mamba_expand"] * d, cfg["mamba_d_state"], _dt_rank(cfg)
    hd = d // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * hd
    mamba = 2 * (d * 2 * di + cfg["mamba_d_conv"] * di + di * (r + 2 * n) + r * di + di * n
                 + di * d)
    attention = 2 * (d * d + 2 * d * kv + d * d) + 2 * d * (seq_len + 1)
    mlp = 2 * 3 * d * width
    experts = 2 * d * cfg["num_experts"] + mlp * cfg["num_experts_per_tok"] * held \
        // cfg["num_experts"]
    total = 2 * d * vocab
    for i in range(cfg["num_hidden_layers"]):
        total += attention if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"] else mamba
        total += experts if i % cfg["expert_layer_period"] == cfg["expert_layer_offset"] else mlp
    return total
