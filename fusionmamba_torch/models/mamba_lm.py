"""The Mamba language model: the port of `fusionmamba_tpu/models/mamba_lm.py`
(the reference vendors it as `mamba_ssm/`: `modules/mamba_simple.py:119-353`,
`models/mixer_seq_simple.py`, `utils/generation.py`).

Parameter names and layouts are mamba_ssm's (`backbone.embedding`,
`backbone.layers.{i}.norm`, `backbone.layers.{i}.mixer.{in_proj, conv1d,
x_proj, dt_proj, A_log, D, out_proj}`, `backbone.norm_f`; the head is tied to
the embedding), so a released state dict loads with `load_state_dict` once its
tied `lm_head.weight` is dropped (`checkpoints/hf_import.py`).

The full-sequence forward runs the selective scan at K = 1 direction with a
full-rank dt (the kernel on the card, its plain version on the CPU), and its
four projections and the tied head through `ops.linear` (the 3xTF32 kernel
on the card where it engages, `F.linear` otherwise). The
cached single-token step, the `selective_state_update` equivalent, is plain
torch, as it is plain jnp in the JAX package, and updates the caches in place.
`generate` prefills through that step token by token, as the JAX package
does, so generation never reaches the scan kernel; on the card its
`compiled=True` replays one decode step captured in a CUDA graph.
"""
from __future__ import annotations

import math
import weakref

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.linear import linear
from ..ops.selective_scan import selective_scan, softplus
from ..utils import tracing


def _scan_input(t: torch.Tensor) -> torch.Tensor:
    """t in fp32 and row-major, as the scan takes it; each copy made is
    counted under `lm.scan_inputs` (`tracing.counts`)."""
    return tracing.contiguous(tracing.cast(t, torch.float32, "lm.scan_inputs"), "lm.scan_inputs")


class MambaBlock(nn.Module):
    """`Mamba` (`mamba_simple.py:119-294`): in_proj -> causal depthwise conv1d
    + SiLU -> x_proj -> (dt, B, C) -> selective scan -> z gate -> out_proj.
    With `inner_norm_eps`, Jamba's mixer: RMSNorms of that eps on dt, B and C
    after x_proj."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: int | None = None, inner_norm_eps: float | None = None):
        super().__init__()
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.d_inner = expand * d_model
        self.dt_rank = math.ceil(d_model / 16) if dt_rank is None else dt_rank
        d_in, R, N = self.d_inner, self.dt_rank, d_state
        self.in_proj = nn.Linear(d_model, 2 * d_in, bias=False)
        self.conv1d = nn.Conv1d(d_in, d_in, d_conv, groups=d_in, padding=d_conv - 1)
        self.x_proj = nn.Linear(d_in, R + 2 * N, bias=False)
        self.dt_proj = nn.Linear(R, d_in)
        # S4D-real A and unit D, as `nn/initializers.py::init_lm_weights` sets them
        self.A_log = nn.Parameter(torch.log(torch.arange(1.0, N + 1)).repeat(d_in, 1))
        self.D = nn.Parameter(torch.ones(d_in))
        self.out_proj = nn.Linear(d_in, d_model, bias=False)
        # Jamba's RMSNorms on dt, B and C between x_proj and dt_proj
        # (transformers' `JambaMambaMixer`), with its names; off for mamba_ssm
        self.inner_norms = inner_norm_eps is not None
        if self.inner_norms:
            self.dt_layernorm = Norm(R, inner_norm_eps, rms=True)
            self.b_layernorm = Norm(N, inner_norm_eps, rms=True)
            self.c_layernorm = Norm(N, inner_norm_eps, rms=True)

    def _dt_b_c(self, dbc: torch.Tensor):
        """x_proj's output split into (dt before dt_proj, B, C), each through
        its inner norm where the block has them."""
        R, N = self.dt_rank, self.d_state
        dt, Bm, Cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
        if self.inner_norms:
            dt, Bm, Cm = self.dt_layernorm(dt), self.b_layernorm(Bm), self.c_layernorm(Cm)
        return dt, Bm, Cm

    def forward(self, x: torch.Tensor, cache: dict | None = None):
        """x (B, L, d_model) -> (out, None); with `cache`, L must be 1 (a
        decode step): the cache is updated in place and returned."""
        if cache is not None:
            return self.step(x, cache), cache
        L = x.shape[1]
        xpart, z = linear(x, self.in_proj.weight).chunk(2, dim=-1)
        # causal: pad d_conv - 1 on both sides, keep the first L outputs
        xc = F.silu(self.conv1d(xpart.transpose(1, 2))[..., :L].transpose(1, 2))
        # x_proj reads the scan's row-major copy of xc, not xc's transposed layout
        u = _scan_input(xc[:, None])
        dt, Bm, Cm = self._dt_b_c(linear(u[:, 0], self.x_proj.weight))
        dt = linear(dt, self.dt_proj.weight)
        A = -torch.exp(self.A_log.float())
        dt, Bm, Cm = map(_scan_input, (dt[:, None], Bm[:, None], Cm[:, None]))
        y = selective_scan(u, dt, A[None], Bm, Cm, self.D[None].float(),
                           self.dt_proj.bias[None].float(), delta_softplus=True)[:, 0]
        return linear(y.to(x.dtype) * F.silu(z), self.out_proj.weight), None

    def step(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        """One token (`mamba_simple.py:208-253`): x (B, 1, d_model) -> (B, 1,
        d_model); `cache["conv_state"]` (B, d_conv, d_inner) and
        `cache["ssm_state"]` (B, d_inner, N) are updated in place."""
        if x.shape[1] != 1:
            raise ValueError(f"a decode step takes one token, got {x.shape[1]}")
        conv_state, ssm_state = cache["conv_state"], cache["ssm_state"]
        xpart, z = self.in_proj(x[:, 0]).chunk(2, dim=-1)
        conv_state.copy_(torch.cat([conv_state[:, 1:], xpart[:, None]], dim=1))
        xc = (conv_state * self.conv1d.weight[:, 0].t()[None]).sum(1) + self.conv1d.bias
        xc = F.silu(xc)
        dt, Bm, Cm = self._dt_b_c(self.x_proj(xc))
        dt = softplus(self.dt_proj(dt))
        A = -torch.exp(self.A_log.float())
        dA = torch.exp(dt[..., None] * A[None])                    # (B, d_inner, N)
        dBx = (dt * xc)[..., None] * Bm[:, None]
        ssm_state.copy_(ssm_state * dA + dBx)
        y = torch.einsum("bdn,bn->bd", ssm_state, Cm) + self.D * xc
        return self.out_proj(y * F.silu(z))[:, None]

    def init_cache(self, batch: int, device=None, dtype=torch.float32) -> dict:
        return make_cache(batch, self.d_inner, self.d_state, self.d_conv, device, dtype)


def make_cache(batch: int, d_inner: int, d_state: int, d_conv: int = 4, device=None,
               dtype=torch.float32) -> dict:
    """The zeroed decode cache of one block."""
    return {"conv_state": torch.zeros(batch, d_conv, d_inner, device=device, dtype=dtype),
            "ssm_state": torch.zeros(batch, d_inner, d_state, device=device, dtype=dtype)}


class Norm(nn.Module):
    """flax's `nn.LayerNorm` (the fast variance E[x^2] - E[x]^2, floored at
    0) or, with `rms`, `nn.RMSNorm`, over the last axis; mamba_ssm's names
    (`weight`, and `bias` for the LayerNorm)."""

    def __init__(self, dim: int, eps: float = 1e-5, rms: bool = False):
        super().__init__()
        self.eps, self.rms = eps, rms
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = None if rms else nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean2 = (x * x).mean(-1, keepdim=True)
        if self.rms:
            return x * torch.rsqrt(mean2 + self.eps) * self.weight
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class ResidualBlock(nn.Module):
    """Prenorm block (`mamba_simple.py:297-353`): x + mixer(norm(x))."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: int | None = None, norm_eps: float = 1e-5, rms_norm: bool = False):
        super().__init__()
        self.norm = Norm(d_model, norm_eps, rms_norm)
        self.mixer = MambaBlock(d_model, d_state, d_conv, expand, dt_rank)

    def forward(self, x, cache=None):
        h, cache = self.mixer(self.norm(x), cache)
        return x + h, cache


class MambaLMHeadModel(nn.Module):
    """`MambaLMHeadModel` (`models/mixer_seq_simple.py`): embedding -> n_layer
    prenorm Mamba blocks -> final norm -> the head tied to the embedding.
    Its defaults are mamba-130m's widths but the vocabulary, which has no
    default."""

    def __init__(self, vocab_size: int, d_model: int = 768, n_layer: int = 24,
                 d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: int | None = None, norm_eps: float = 1e-5, rms_norm: bool = False):
        super().__init__()
        self.vocab_size, self.d_model, self.n_layer = vocab_size, d_model, n_layer
        self.d_state, self.d_conv, self.expand = d_state, d_conv, expand
        self.dt_rank, self.rms_norm = dt_rank, rms_norm
        self.backbone = nn.Module()
        self.backbone.embedding = nn.Embedding(vocab_size, d_model)
        self.backbone.layers = nn.ModuleList(
            ResidualBlock(d_model, d_state, d_conv, expand, dt_rank, norm_eps, rms_norm)
            for _ in range(n_layer))
        self.backbone.norm_f = Norm(d_model, norm_eps, rms_norm)

    def forward(self, tokens: torch.Tensor, caches: list | None = None):
        """tokens (B, L) int -> (logits (B, L, vocab), caches). With `caches`
        (from `init_caches`), L must be 1; they are updated in place. Spans
        `lm.forward`: `lm.embed`, `lm.layers`, `lm.head` (the final norm and
        the tied head)."""
        with tracing.span("lm.forward"):
            with tracing.span("lm.embed"):
                x = self.backbone.embedding(tokens)
            with tracing.span("lm.layers"):
                for i, layer in enumerate(self.backbone.layers):
                    x, _ = layer(x, None if caches is None else caches[i])
            with tracing.span("lm.head"):
                return linear(self.backbone.norm_f(x), self.backbone.embedding.weight), caches

    def init_caches(self, batch: int, device=None) -> list[dict]:
        device = self.backbone.embedding.weight.device if device is None else device
        return [make_cache(batch, self.expand * self.d_model, self.d_state, self.d_conv, device)
                for _ in range(self.n_layer)]


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask the logits outside the top-p nucleus to -inf
    (`utils/generation.py:53-68`): sort ascending, keep the tokens whose
    cumulative softmax is above 1 - top_p, and every logit not below the
    smallest kept one."""
    if top_p <= 0.0 or top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    min_keep = torch.where(cum > 1.0 - top_p, sorted_logits,
                           torch.full_like(sorted_logits, math.inf)).amin(-1, keepdim=True)
    return logits.masked_fill(logits < min_keep, -math.inf)


def min_p_filter(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """Drop the tokens whose probability is below min_p times the largest:
    the documented min-p semantics (`utils/generation.py:37-42`), not the
    reference's in-place variant, which compares raw logits."""
    if min_p <= 0.0 or min_p >= 1.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    return logits.masked_fill(probs < min_p * probs.amax(-1, keepdim=True), -math.inf)


def seen_mask(prev_tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(B, S) token history -> (B, V) bool membership mask."""
    mask = torch.zeros(prev_tokens.shape[0], vocab_size, dtype=torch.bool,
                       device=prev_tokens.device)
    return mask.scatter_(1, prev_tokens.long(), True)


def apply_repetition_penalty_mask(logits: torch.Tensor, seen: torch.Tensor,
                                  penalty: float) -> torch.Tensor:
    """CTRL-style penalty against a (B, V) seen mask
    (`utils/generation.py:71-84`): a seen token's negative logit is
    multiplied by the penalty, its positive one divided."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


def apply_repetition_penalty(logits: torch.Tensor, prev_tokens: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """`apply_repetition_penalty_mask` against a (B, S) token history."""
    if penalty == 1.0:
        return logits
    return apply_repetition_penalty_mask(logits, seen_mask(prev_tokens, logits.shape[-1]),
                                         penalty)


def _categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw from softmax(logits) a row, by the Gumbel-max trick (as
    `jax.random.categorical`): argmax of the logits plus Gumbel noise from
    `gen`. A -inf logit is never drawn."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=logits.dtype).clamp_min(torch.finfo(logits.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_logits(logits: torch.Tensor, gen: torch.Generator | None = None,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                  min_p: float = 0.0) -> torch.Tensor:
    """One sampling step over (B, V) logits, as the reference's `sample`
    (`utils/generation.py:87-133`): top_k == 1 or temperature 0 is greedy;
    top_k > 0 keeps the k best, then the temperature and top-p; top_k == 0
    applies min-p, or else top-p, on the whole vocabulary. The noise comes
    from `gen`, which lies on the logits' device."""
    if top_k == 1 or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if gen is None:
        raise ValueError("sampling needs a torch.Generator")
    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = logits.masked_fill(logits < kth, -math.inf)
        if temperature != 1.0:
            logits = logits / temperature
        return _categorical(top_p_filter(logits, top_p), gen)
    if min_p > 0.0:
        logits = min_p_filter(logits, min_p)
        if temperature != 1.0:
            logits = logits / temperature
        return _categorical(logits, gen)
    if temperature != 1.0:
        logits = logits / temperature
    return _categorical(top_p_filter(logits, top_p), gen)


class _DecodeGraph:
    """One decode step of a CUDA model at one batch, captured in a CUDA graph:
    the token in a static buffer, the caches updated in place, the logits in
    a static output. `run(tok)` copies the token in and replays."""

    @torch.no_grad()
    def __init__(self, model: MambaLMHeadModel, batch: int):
        dev = model.backbone.embedding.weight.device
        self.tok = torch.zeros(batch, 1, dtype=torch.long, device=dev)
        self.caches = model.init_caches(batch, dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):      # warm-up outside the capture
            for _ in range(2):
                model(self.tok, self.caches)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = model(self.tok, self.caches)

    def reset(self) -> None:
        for c in self.caches:
            for t in c.values():
                t.zero_()

    def run(self, tok: torch.Tensor) -> torch.Tensor:
        self.tok.copy_(tok)
        self.graph.replay()
        return self.logits


# model -> {batch: _DecodeGraph}; weak, so a graph lives no longer than its model
_GRAPHS: "weakref.WeakKeyDictionary[MambaLMHeadModel, dict]" = weakref.WeakKeyDictionary()


def decode_graph(model: MambaLMHeadModel, batch: int) -> _DecodeGraph:
    """The captured decode step of `model` at `batch`, captured at first use.
    A failed capture raises."""
    graphs = _GRAPHS.setdefault(model, {})
    if batch not in graphs:
        graphs[batch] = _DecodeGraph(model, batch)
    return graphs[batch]


@torch.no_grad()
def generate(model: MambaLMHeadModel, prompt: torch.Tensor, max_new_tokens: int,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0, min_p: float = 0.0,
             repetition_penalty: float = 1.0, generator: torch.Generator | None = None,
             compiled: bool = True) -> torch.Tensor:
    """Autoregressive sampling with cached single-token steps
    (`utils/generation.py:121-242`; greedy when temperature == 0 or
    top_k == 1). prompt (B, S >= 1) int on the model's device -> (B, S +
    max_new_tokens). The prompt is fed one token at a time through the
    decode step; the repetition penalty applies against the prompt and every
    token emitted.

    `compiled=True` on a CUDA model replays one decode step captured in a
    CUDA graph (`decode_graph`, cached per model and batch) for every prompt
    token and every new token, the counterpart of the reference's captured
    decode (`utils/generation.py:269-379`); on a CPU model it runs the same
    per-token loop as `compiled=False`. Sampling stays outside the graph,
    drawn from `generator`, so both give the same tokens."""
    if prompt.ndim != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be (B, S>=1) int tokens, got shape {tuple(prompt.shape)}")
    B, dev = prompt.shape[0], prompt.device
    if compiled and dev.type == "cuda":
        graph = decode_graph(model, B)
        graph.reset()
        step = graph.run
    else:
        caches = model.init_caches(B, dev)

        def step(tok):
            return model(tok, caches)[0]

    prompt = prompt.long()
    for i in range(prompt.shape[1]):
        logits = step(prompt[:, i:i + 1])
    out = [prompt]
    seen = seen_mask(prompt, logits.shape[-1]) if repetition_penalty != 1.0 else None
    for _ in range(max_new_tokens):
        stepped = logits[:, -1] if seen is None else apply_repetition_penalty_mask(
            logits[:, -1], seen, repetition_penalty)
        tok = sample_logits(stepped, generator, temperature=temperature, top_k=top_k,
                            top_p=top_p, min_p=min_p)[:, None]
        out.append(tok)
        if seen is not None:
            seen.scatter_(1, tok, True)
        logits = step(tok)
    return torch.cat(out, dim=1)
