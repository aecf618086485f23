"""AI21's Jamba: a hybrid decoder of Mamba-1 mixers and GQA attention with a
sparse mixture of experts every other layer (Lieber et al., arXiv:2403.19887;
transformers' `models/jamba/modeling_jamba.py`, `JambaForCausalLM`).

Layer i mixes with causal GQA attention where i % attn_layer_period ==
attn_layer_offset, and with a Mamba-1 mixer (`mamba_lm.MambaBlock` with its
inner RMSNorms on dt, B and C) otherwise. Its feed-forward is a sparse
mixture of experts where i % expert_layer_period == expert_layer_offset, and
a SiLU-gated MLP otherwise. Every layer is pre-norm with RMSNorm; a final
RMSNorm and the head close the model. Attention has no positional encoding.

Parameter names are transformers' (`model.embed_tokens`, `model.layers.{i}.
{input_layernorm, mamba | self_attn, pre_ff_layernorm, feed_forward}`,
`model.final_layernorm`, `lm_head`), so the tensors of a released state dict
load by name, an expert's under `feed_forward.experts.{e}`.

Expert parallelism: the expert layer is told which experts it holds
(`experts_held`: one chip's experts where a layer's experts are divided over
several chips). Its router keeps every expert's output and takes the top-k
over all of them; the layer computes only its held experts' part of the
result, and a row routed to an expert it does not hold adds nothing. With
every expert held it is the whole layer. Nothing here exchanges rows between
chips.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import tracing
from .mamba_lm import MambaBlock, Norm

#: transformers' `JambaConfig` defaults, for the keys a config.json leaves out
DEFAULTS = {"vocab_size": 65536, "tie_word_embeddings": False, "hidden_size": 4096,
            "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
            "num_key_value_heads": 8, "hidden_act": "silu", "rms_norm_eps": 1e-6,
            "sliding_window": None, "num_experts_per_tok": 2, "num_experts": 16,
            "expert_layer_period": 2, "expert_layer_offset": 1, "attn_layer_period": 8,
            "attn_layer_offset": 4, "mamba_d_state": 16, "mamba_d_conv": 4, "mamba_expand": 2,
            "mamba_dt_rank": "auto", "mamba_conv_bias": True, "mamba_proj_bias": False}
MOE_SITE = "jamba.moe"
ATTENTION_SITE = "jamba.attention"


def full_config(config: dict) -> dict:
    """`config` over `DEFAULTS`; raises where it asks for what this model
    does not build."""
    cfg = {**DEFAULTS, **config}
    unsupported = {"hidden_act": (cfg["hidden_act"], "silu"),
                   "sliding_window": (cfg["sliding_window"], None),
                   "mamba_conv_bias": (cfg["mamba_conv_bias"], True),
                   "mamba_proj_bias": (cfg["mamba_proj_bias"], False)}
    for key, (got, want) in unsupported.items():
        if got != want:
            raise ValueError(f"Jamba with {key}={got!r} is not built here (only {want!r})")
    return cfg


def layer_kinds(cfg: dict) -> list:
    """(mixer, feed-forward) of each layer: ("attention" or "mamba", "moe" or
    "mlp"), by the config's offsets and periods."""
    return [("attention" if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"] else "mamba",
             "moe" if i % cfg["expert_layer_period"] == cfg["expert_layer_offset"] else "mlp")
            for i in range(cfg["num_hidden_layers"])]


def route(router_logits: torch.Tensor, top_k: int):
    """(weights, experts), each (rows, top_k): the top-k of the softmax over
    every expert, in fp32, not renormalised (`JambaSparseMoeBlock`)."""
    return torch.topk(torch.softmax(router_logits, dim=-1, dtype=torch.float32), top_k, dim=-1)


class JambaMLP(nn.Module):
    """down(SiLU(gate(x)) * up(x)), no biases."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False)
        self.up_proj = nn.Linear(hidden, width, bias=False)
        self.down_proj = nn.Linear(width, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def _causal_attention(q, k, v):
    """SDPA, causal. On the card pinned to the memory-efficient backend: it
    takes fp32 (flash and cuDNN do not), runs its fp32 products as 3xTF32 on
    the tensor cores, and never writes the (L, L) scores, which the math
    backend would (2 x 32 x 16384^2 fp32 scores are 68 GB)."""
    if q.device.type != "cuda":
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)


class JambaAttention(nn.Module):
    """Causal GQA self-attention without positional encoding: q, k, v and o
    projections without bias; each key-value head serves heads / kv_heads
    query heads (k and v expanded to every head, a copy counted under
    `jamba.attention`)."""

    def __init__(self, hidden: int, heads: int, kv_heads: int):
        super().__init__()
        if hidden % heads or heads % kv_heads:
            raise ValueError(f"{heads} heads over {kv_heads} key-value heads at width {hidden}")
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, hidden // heads
        self.q_proj = nn.Linear(hidden, heads * self.head_dim, bias=False)
        self.k_proj = nn.Linear(hidden, kv_heads * self.head_dim, bias=False)
        self.v_proj = nn.Linear(hidden, kv_heads * self.head_dim, bias=False)
        self.o_proj = nn.Linear(heads * self.head_dim, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, _ = x.shape
        d, rep = self.head_dim, self.heads // self.kv_heads
        q = self.q_proj(x).view(b, length, self.heads, d).transpose(1, 2)
        k, v = (p(x).view(b, length, self.kv_heads, d).transpose(1, 2)
                for p in (self.k_proj, self.v_proj))
        if rep > 1:
            k, v = (tracing.copied(ATTENTION_SITE, t.repeat_interleave(rep, dim=1))
                    for t in (k, v))
        o = _causal_attention(q, k, v)
        return self.o_proj(o.transpose(1, 2).reshape(b, length, self.heads * d))


class JambaSparseMoeBlock(nn.Module):
    """The expert layer: a router over `num_experts` outputs, a softmax over
    all of them, the top-k (`route`), and the held experts' part of the
    result. The held experts' rows are gathered in one copy, grouped by
    expert; each expert runs its SiLU-gated MLP on its rows, weighs them and
    adds them back (a scatter-add an expert). No capacity limit, no row
    dropped. Counted: `moe_rows:routed`, `moe_rows:held`, and the gather and
    the scatters under `copies:jamba.moe`. The layer waits once for the device,
    for the number of rows of each expert."""

    def __init__(self, hidden: int, width: int, num_experts: int, top_k: int, experts_held):
        super().__init__()
        held = sorted({int(e) for e in experts_held})
        if not held or held[0] < 0 or held[-1] >= num_experts or not 0 < top_k <= num_experts:
            raise ValueError(f"experts {held} held, top {top_k} of {num_experts}")
        self.num_experts, self.top_k, self.held = num_experts, top_k, tuple(held)
        self.router = nn.Linear(hidden, num_experts, bias=False)
        self.experts = nn.ModuleDict({str(e): JambaMLP(hidden, width) for e in held})
        # each expert's place among the held ones; len(held) where not held
        slot = torch.full((num_experts,), len(held), dtype=torch.long)
        slot[list(held)] = torch.arange(len(held))
        self.register_buffer("slot", slot, persistent=False)

    def forward(self, x: torch.Tensor):
        """x (..., hidden) -> (the held experts' part of the result, shaped as
        x; the router's logits (rows, num_experts))."""
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        router_logits = self.router(x)
        weights, experts = route(router_logits, self.top_k)
        slots = self.slot[experts.reshape(-1)]
        order = torch.argsort(slots, stable=True)
        per_slot = torch.bincount(slots, minlength=len(self.held) + 1).tolist()
        held_rows = sum(per_slot[:-1])
        picks = order[:held_rows]                       # (token, choice) pairs, by expert
        tokens = picks // self.top_k
        rows = tracing.copied(MOE_SITE, x[tokens])
        scale = weights.reshape(-1)[picks, None].to(x.dtype)
        out = torch.zeros_like(x)
        start = 0
        for e, n in zip(self.held, per_slot):
            if n:
                y = self.experts[str(e)](rows[start:start + n]).mul_(scale[start:start + n])
                out.index_add_(0, tokens[start:start + n], tracing.copied(MOE_SITE, y))
            start += n
        tracing.counts["moe_rows:routed"] += experts.numel()
        tracing.counts["moe_rows:held"] += held_rows
        return out.reshape(shape), router_logits


class JambaDecoderLayer(nn.Module):
    """x + mixer(RMSNorm(x)), then + feed_forward(RMSNorm(.)); the two halves
    under the spans of their kinds (`jamba.mamba` or `jamba.attention`,
    `jamba.moe` or `jamba.mlp`), norms and residual adds included."""

    def __init__(self, cfg: dict, mixer: str, ff: str, experts_held):
        super().__init__()
        h, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.mixer_kind, self.ff_kind = mixer, ff
        self.input_layernorm = Norm(h, eps, rms=True)
        if mixer == "attention":
            self.self_attn = JambaAttention(h, cfg["num_attention_heads"],
                                            cfg["num_key_value_heads"])
        else:
            rank = cfg["mamba_dt_rank"]
            self.mamba = MambaBlock(h, cfg["mamba_d_state"], cfg["mamba_d_conv"],
                                    cfg["mamba_expand"],
                                    math.ceil(h / 16) if rank == "auto" else int(rank),
                                    inner_norm_eps=eps)
        self.pre_ff_layernorm = Norm(h, eps, rms=True)
        if ff == "moe":
            self.feed_forward = JambaSparseMoeBlock(h, cfg["intermediate_size"],
                                                    cfg["num_experts"],
                                                    cfg["num_experts_per_tok"], experts_held)
        else:
            self.feed_forward = JambaMLP(h, cfg["intermediate_size"])

    def forward(self, x: torch.Tensor):
        """x (B, L, hidden) -> (x after the layer, the router's logits or None)."""
        with tracing.span("jamba." + self.mixer_kind):
            h = self.input_layernorm(x)
            h = self.self_attn(h) if self.mixer_kind == "attention" else self.mamba(h)[0]
            x = x + h
        with tracing.span("jamba." + self.ff_kind):
            h = self.feed_forward(self.pre_ff_layernorm(x))
            router_logits = None
            if self.ff_kind == "moe":
                h, router_logits = h
            return x + h, router_logits


class JambaForCausalLM(nn.Module):
    """Jamba of a transformers config.json dict, holding `experts_held` of
    each expert layer's experts (all of them by default)."""

    def __init__(self, config: dict, experts_held=None):
        super().__init__()
        cfg = self.config = full_config(config)
        held = range(cfg["num_experts"]) if experts_held is None else experts_held
        h, vocab = cfg["hidden_size"], cfg["vocab_size"]
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(vocab, h)
        self.model.layers = nn.ModuleList(JambaDecoderLayer(cfg, mixer, ff, held)
                                          for mixer, ff in layer_kinds(cfg))
        self.model.final_layernorm = Norm(h, cfg["rms_norm_eps"], rms=True)
        self.lm_head = nn.Linear(h, vocab, bias=False)
        if cfg["tie_word_embeddings"]:
            self.lm_head.weight = self.model.embed_tokens.weight

    def forward(self, input_ids: torch.Tensor):
        """input_ids (B, L) int -> (logits (B, L, vocab), the router's logits
        of each expert layer in order, (B * L, num_experts) each). Spans
        `jamba.forward`: `jamba.embed`, the layers' (`JambaDecoderLayer`),
        `jamba.head` (the final norm and the head)."""
        with tracing.span("jamba.forward"):
            with tracing.span("jamba.embed"):
                x = self.model.embed_tokens(input_ids)
            router_logits = []
            for layer in self.model.layers:
                x, r = layer(x)
                if r is not None:
                    router_logits.append(r)
            with tracing.span("jamba.head"):
                return self.lm_head(self.model.final_layernorm(x)), tuple(router_logits)
