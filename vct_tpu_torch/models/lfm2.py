"""LFM2 as the caption LM (the port's own; the JAX package has no such
decoder): Liquid AI's hybrid of gated short convolutions and grouped-query
attention, with sigmoid-routed SwiGLU experts after its first dense layers
(``model_type`` ``lfm2_moe``, as in LFM2-8B-A1B), put over the MME encoder
as a prefix LM.

The config: an empty section ``model.caption_lm`` switches it on. LFM2's own
keys (``ARCH_KEYS``, named as in the model's published ``config.json``) are
read from the top level of the config, so the published ``config.json``
copies in unchanged. Only the first ``num_hidden_layers`` entries of
``layer_types`` are built, so a model cut in depth keeps the published list
whole. The tokenizer's vocabulary must have ``vocab_size`` ids.

The model (``Lfm2CaptionLM``, under ``cap_decoder``), per caption row:
* the prefix: the encoder's memory (its average token and frame slots)
  through the projector (one linear layer with a bias, from the encoder's
  width to the LM's), its real slots moved to the end (left padding), the
  projector's output zeroed at pad slots, which are masked as attention keys
  and zeroed as short-convolution inputs; positions count from the first
  real slot and run on through the caption;
* the caption's tokens through the token embedding (the embedding kernel
  pair; [PAD] embeds to zero);
* ``num_hidden_layers`` layers ``h = x + op(norm_op(x))``,
  ``out = h + ff(norm_ff(h))`` with RMSNorm; ``op`` a gated short
  convolution (``B, C, x' = split3(in_proj(x))``, ``y = out_proj(C *
  causal_depthwise_conv(B * x'))``) or attention (grouped-query, RMSNorm on
  each head's query and key, rotary positions); ``ff`` a dense SwiGLU in the
  first ``num_dense_layers`` layers, else a sparse MoE block: ``s =
  sigmoid(x W_r)``, the top ``num_experts_per_tok`` of ``s + expert_bias``,
  their ``s`` divided by their sum + 1e-6 (``norm_topk_prob``) times
  ``routed_scaling_factor``, each a SwiGLU expert (``ops/moe_kernels.py``);
* a final RMSNorm and the LM head tied to the token embedding, without a
  bias; the SCE caption loss over the caption positions only.

Departures from the published model, for training it as a captioner:
``expert_bias`` is a buffer, fixed in training (the published model updates
it by a balancing rule the config does not give); the residual stream is
float32 with every product in the compute dtype. Serving, beam search and the
fused decode routes refuse this decoder; ``decode.make_auto_greedy_fn`` runs
its eager greedy decode (``decode.lm_greedy_generate``: a prefill, then one
token at a time through a cache holding each convolution layer's last
``conv_L_cache`` inputs and each attention layer's keys and values).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vct_tpu_torch import tracing
from vct_tpu_torch.models.layers import linear
from vct_tpu_torch.models.losses import sce_loss_parts
from vct_tpu_torch.ops import moe_kernels
from vct_tpu_torch.ops.embedding_kernels import embedding
from vct_tpu_torch.ops.fused_loss import linear_sce_parts

SECTION = "caption_lm"
MODEL_TYPE = "lfm2_moe"
NEG_INF = -1e30
ROUTE_EPS = 1e-6           # added to the chosen scores' sum (norm_topk_prob)
EXPERT_BIAS_STD = 0.05     # the fixed expert bias a fresh model draws
ARCH_KEYS = {
    "model_type": str, "hidden_size": int, "intermediate_size": int,
    "moe_intermediate_size": int, "num_hidden_layers": int, "layer_types": list,
    "num_attention_heads": int, "num_key_value_heads": int, "num_dense_layers": int,
    "num_experts": int, "num_experts_per_tok": int, "conv_L_cache": int, "conv_bias": bool,
    "norm_eps": float, "rope_theta": float, "norm_topk_prob": bool,
    "routed_scaling_factor": float, "use_expert_bias": bool, "vocab_size": int,
    "max_position_embeddings": int,
}


@dataclass(frozen=True)
class LMConfig:
    model_type: str
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_hidden_layers: int
    layer_types: Tuple[str, ...]
    num_attention_heads: int
    num_key_value_heads: int
    num_dense_layers: int
    num_experts: int
    num_experts_per_tok: int
    conv_L_cache: int
    conv_bias: bool
    norm_eps: float
    rope_theta: float
    norm_topk_prob: bool
    routed_scaling_factor: float
    use_expert_bias: bool
    vocab_size: int
    max_position_embeddings: int

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kinds(self) -> Tuple[str, ...]:
        """The built layers' kinds: ``conv`` or ``full_attention``."""
        return self.layer_types[:self.num_hidden_layers]

    def is_moe(self, layer: int) -> bool:
        return layer >= self.num_dense_layers


def caption_lm_config(raw: Dict[str, Any]) -> Optional[LMConfig]:
    """The LM of ``raw`` (a config as loaded, ``Config.raw``), or None when
    it has no ``model.caption_lm`` section."""
    section = (raw.get("model") or {}).get(SECTION)
    if section is None:
        return None
    if section != {}:
        raise ValueError(f"model.{SECTION} must be an empty object: the LM's keys go at the "
                         f"config's top level")
    missing = sorted(set(ARCH_KEYS) - set(raw))
    if missing:
        raise ValueError(f"model.{SECTION}: the LM's keys {missing} are not at the top level "
                         f"of the config")
    vals = {k: (tuple(str(t) for t in raw[k]) if kind is list else kind(raw[k]))
            for k, kind in ARCH_KEYS.items()}
    cfg = LMConfig(**vals)
    _check(cfg)
    return cfg


def _check(c: LMConfig) -> None:
    where = f"model.{SECTION}"
    if c.model_type != MODEL_TYPE:
        raise ValueError(f"{where}: model_type {c.model_type!r}; the port builds {MODEL_TYPE!r}")
    if not 1 <= c.num_hidden_layers <= len(c.layer_types):
        raise ValueError(f"{where}: num_hidden_layers {c.num_hidden_layers} of "
                         f"{len(c.layer_types)} layer_types")
    bad = sorted(set(c.kinds) - {"conv", "full_attention"})
    if bad:
        raise ValueError(f"{where}: layer types {bad}")
    if c.hidden_size % c.num_attention_heads or c.num_attention_heads % c.num_key_value_heads:
        raise ValueError(f"{where}: {c.num_attention_heads} heads, {c.num_key_value_heads} KV "
                         f"heads over a width of {c.hidden_size}")
    if c.head_dim % 2 or c.conv_L_cache < 1:
        raise ValueError(f"{where}: head width {c.head_dim}, conv_L_cache {c.conv_L_cache}")
    if not 1 <= c.num_experts_per_tok <= c.num_experts:
        raise ValueError(f"{where}: top {c.num_experts_per_tok} of {c.num_experts} experts")


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """float32 statistics and scale, the result in ``dtype``."""
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(dtype)


def rotary(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions on ``x`` [B, S, heads, D] at ``pos`` [B, S] (the
    halves rotated, as in the published model), in float32, result in
    ``x``'s dtype."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d))
    ang = pos.float()[..., None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)[:, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)[:, :, None, :]
    xf = x.float()
    half = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos + half * sin).to(x.dtype)


class ShortConv(nn.Module):
    """The gated short convolution; keys ``in_proj``, ``conv`` (depthwise,
    [H, 1, L]) and ``out_proj`` as in the published model."""

    def __init__(self, c: LMConfig, device=None):
        super().__init__()
        h, self.size = c.hidden_size, c.conv_L_cache
        self.in_proj = nn.Linear(h, 3 * h, bias=c.conv_bias, device=device)
        self.conv = nn.Conv1d(h, h, c.conv_L_cache, groups=h, bias=c.conv_bias,
                              padding=c.conv_L_cache - 1, device=device)
        self.out_proj = nn.Linear(h, h, bias=c.conv_bias, device=device)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor], dtype,
                state: Optional[torch.Tensor] = None):
        """``x`` [B, S, H] normed; ``keep`` [B, S] (0 at pad slots) ->
        ([B, S, H], the last ``conv_L_cache`` inputs [B, L, H] float32).
        ``state`` is the previous call's, for the positions before these."""
        b, c, xx = linear(x, self.in_proj.weight, self.in_proj.bias, dtype).chunk(3, dim=-1)
        bx = (b * xx).float()
        if keep is not None:
            bx = bx * keep[..., None]
        size, s = self.size, x.shape[1]
        before = (bx.new_zeros((bx.shape[0], size - 1, bx.shape[2])) if state is None
                  else state[:, 1:])
        seq = torch.cat([before, bx], dim=1)   # the L - 1 inputs before, then these
        w = self.conv.weight[:, 0, :].float()
        y = seq[:, 0:s] * w[:, 0]
        for j in range(1, size):
            y = y + seq[:, j:j + s] * w[:, j]
        if self.conv.bias is not None:
            y = y + self.conv.bias.float()
        y = (c.float() * y).to(dtype)
        return linear(y, self.out_proj.weight, self.out_proj.bias, dtype), seq[:, -size:]


class Attention(nn.Module):
    """Grouped-query attention with RMSNorm on each head's query and key and
    rotary positions; keys ``q_proj`` / ``k_proj`` / ``v_proj`` / ``out_proj``,
    ``q_layernorm`` / ``k_layernorm`` as in the published model."""

    def __init__(self, c: LMConfig, device=None):
        super().__init__()
        h, d = c.hidden_size, c.head_dim
        self.heads, self.kv_heads, self.d, self.theta = (c.num_attention_heads,
                                                         c.num_key_value_heads, d, c.rope_theta)
        self.q_proj = nn.Linear(h, h, bias=False, device=device)
        self.k_proj = nn.Linear(h, self.kv_heads * d, bias=False, device=device)
        self.v_proj = nn.Linear(h, self.kv_heads * d, bias=False, device=device)
        self.out_proj = nn.Linear(h, h, bias=False, device=device)
        self.q_layernorm = RMSNorm(d, c.norm_eps, device=device)
        self.k_layernorm = RMSNorm(d, c.norm_eps, device=device)

    def forward(self, x, pos, bias, dtype, cache: Optional[Dict[str, torch.Tensor]] = None,
                at: int = 0):
        """``x`` [B, S, H] normed, ``pos`` [B, S], ``bias`` additive float32
        broadcastable to [B, heads, S, keys]. With ``cache`` ({"k", "v"}:
        [B, kv_heads, T_max, D]) these positions' keys and values are
        written at ``at`` and the keys are the cache's first ``at + S``."""
        bsz, s, _ = x.shape
        q = linear(x, self.q_proj.weight, None, dtype).view(bsz, s, self.heads, self.d)
        k = linear(x, self.k_proj.weight, None, dtype).view(bsz, s, self.kv_heads, self.d)
        v = linear(x, self.v_proj.weight, None, dtype).view(bsz, s, self.kv_heads, self.d)
        q = rotary(self.q_layernorm(q, dtype), pos, self.theta).transpose(1, 2)
        k = rotary(self.k_layernorm(k, dtype), pos, self.theta).transpose(1, 2)
        v = v.transpose(1, 2)
        if cache is not None:
            cache["k"][:, :, at:at + s] = k
            cache["v"][:, :, at:at + s] = v
            k, v = cache["k"][:, :, :at + s], cache["v"][:, :, :at + s]
        rep = self.heads // self.kv_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(self.d)
        probs = torch.softmax(scores + bias, dim=-1).to(dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(bsz, s, -1)
        return linear(out, self.out_proj.weight, None, dtype)


class DenseMLP(nn.Module):
    """SwiGLU ``w2(silu(w1 x) * w3 x)``."""

    def __init__(self, h: int, f: int, device=None):
        super().__init__()
        self.w1 = nn.Linear(h, f, bias=False, device=device)
        self.w3 = nn.Linear(h, f, bias=False, device=device)
        self.w2 = nn.Linear(f, h, bias=False, device=device)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        g = linear(x, self.w1.weight, None, dtype).float()
        u = linear(x, self.w3.weight, None, dtype).float()
        return linear((F.silu(g) * u).to(dtype), self.w2.weight, None, dtype)


class SparseMoE(nn.Module):
    """The routed experts: ``gate`` (the router, no bias), the fixed buffer
    ``expert_bias``, and every expert's SwiGLU in ``experts.w13`` [E, 2I, H]
    (gate rows, then up rows) and ``experts.w2`` [E, H, I]. Each call
    copies its choice into device tensors that outlive it, which a CUDA
    graph's replays rewrite in place: ``rows_per_expert`` [E] int32 (the
    last call's rows of each expert) and ``last_idx[T]`` [T, k] int32 (the
    last call over T tokens: each token's experts, best first)."""

    KEEP_FLOAT32 = ("expert_bias",)   # ``MMT4Caption.to_compute_dtype`` leaves it

    def __init__(self, c: LMConfig, device=None):
        super().__init__()
        h, i, e = c.hidden_size, c.moe_intermediate_size, c.num_experts
        self.k, self.norm_topk, self.scale = (c.num_experts_per_tok, c.norm_topk_prob,
                                              c.routed_scaling_factor)
        self.gate = nn.Linear(h, e, bias=False, device=device)
        self.register_buffer("expert_bias", torch.zeros(e, device=device))
        self.use_bias = c.use_expert_bias
        self.experts = nn.Module()
        self.experts.w13 = nn.Parameter(torch.empty((e, 2 * i, h), device=device))
        self.experts.w2 = nn.Parameter(torch.empty((e, h, i), device=device))
        self.rows_per_expert: Optional[torch.Tensor] = None
        self.last_idx: Dict[int, torch.Tensor] = {}

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """``x`` [T, H] normed -> [T, H] float32."""
        capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
        span = contextlib.nullcontext() if capturing else tracing.span("moe.layer")
        with span:
            logits = linear(x, self.gate.weight, None, dtype).float()
            bias = self.expert_bias.float() if self.use_bias else torch.zeros_like(
                self.expert_bias, dtype=torch.float32)
            route = moe_kernels.moe_route(logits.detach().contiguous(), bias.contiguous(),
                                          self.k)
            self._keep(route)
            w = torch.sigmoid(logits).gather(1, route.idx.long())
            if self.norm_topk:
                w = w / (w.sum(dim=-1, keepdim=True) + ROUTE_EPS)
            w = w * self.scale
            y = moe_kernels.experts(x.to(dtype), self.experts.w13, self.experts.w2, route, dtype)
            t = x.shape[0]
            picked = y.index_select(0, route.dest.reshape(-1).long()).view(t, self.k, -1)
            return (picked.float() * w[..., None]).sum(dim=1)

    def _keep(self, route: moe_kernels.Route) -> None:
        if self.rows_per_expert is None or self.rows_per_expert.device != route.counts.device:
            self.rows_per_expert, self.last_idx = torch.zeros_like(route.counts), {}
        self.rows_per_expert.copy_(route.counts)
        t = route.idx.shape[0]
        if t not in self.last_idx:
            self.last_idx[t] = torch.empty_like(route.idx)
        self.last_idx[t].copy_(route.idx)


class Lfm2Layer(nn.Module):
    def __init__(self, c: LMConfig, index: int, device=None):
        super().__init__()
        self.kind = c.kinds[index]
        self.operator_norm = RMSNorm(c.hidden_size, c.norm_eps, device=device)
        self.ffn_norm = RMSNorm(c.hidden_size, c.norm_eps, device=device)
        if self.kind == "conv":
            self.conv = ShortConv(c, device=device)
        else:
            self.self_attn = Attention(c, device=device)
        self.feed_forward = (SparseMoE(c, device=device) if c.is_moe(index)
                             else DenseMLP(c.hidden_size, c.intermediate_size, device=device))

    def forward(self, x: torch.Tensor, keep, pos, bias, dtype, state=None, at: int = 0):
        """``x`` [B, S, H] float32 -> (float32 [B, S, H], the layer's new
        cache state: a convolution's last inputs; an attention layer's
        cache is written in place)."""
        h = self.operator_norm(x, dtype)
        if self.kind == "conv":
            a, state = self.conv(h, keep, dtype, state)
        else:
            a = self.self_attn(h, pos, bias, dtype, state, at)
        x = x + a.float()
        h = self.ffn_norm(x, dtype)
        if isinstance(self.feed_forward, SparseMoE):
            bsz, s, width = h.shape
            f = self.feed_forward(h.reshape(bsz * s, width), dtype).view(bsz, s, width)
        else:
            f = self.feed_forward(h, dtype).float()
        return x + f, state


# ---------------------------------------------------------------------------
# the caption LM
# ---------------------------------------------------------------------------


class Lfm2CaptionLM(nn.Module):
    """The caption decoder's place in ``MMT4Caption`` (``cap_decoder``), with
    ``CapDecoder``'s teacher-forced ``forward`` and loss; ``prefill`` and
    ``decode_step`` for the greedy decode."""

    def __init__(self, c: LMConfig, memory_dim: int, vocab_size: int, *, pad_id: int = 0,
                 sce_loss_alpha: float = 0.5, use_fused_loss: bool = True,
                 fused_loss_kernels: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        if vocab_size != c.vocab_size:
            raise ValueError(f"model.{SECTION}: vocab_size {c.vocab_size}, but the tokenizer "
                             f"has {vocab_size} ids")
        self.c, self.pad_id, self.dtype = c, pad_id, dtype
        self.embed_dim, self.vocab_size = c.hidden_size, vocab_size
        self.sce_loss_alpha = sce_loss_alpha
        self.use_fused_loss, self.fused_loss_kernels = use_fused_loss, fused_loss_kernels
        self.projector = nn.Linear(memory_dim, c.hidden_size, device=device)
        self.embed_tokens = nn.Embedding(vocab_size, c.hidden_size, device=device)
        self.layers = nn.ModuleList(Lfm2Layer(c, i, device=device)
                                    for i in range(c.num_hidden_layers))
        self.embedding_norm = RMSNorm(c.hidden_size, c.norm_eps, device=device)
        # the tied head has no bias; the fused loss takes a zero one
        self.register_buffer("head_bias", torch.zeros(vocab_size, device=device),
                             persistent=False)

    def moe_layers(self) -> List[SparseMoE]:
        return [l.feed_forward for l in self.layers if isinstance(l.feed_forward, SparseMoE)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (a CPU generator, drawn on the
        host): Xavier-uniform matrices (each expert's alone), uniform
        depthwise filters over their fan-in, N(0, 1 / H) token embeddings,
        unit RMSNorms, zero biases, and an N(0, ``EXPERT_BIAS_STD``) expert
        bias."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                val = torch.zeros(p.shape)
            elif p.ndim == 1:
                val = torch.ones(p.shape)
            elif name == "embed_tokens.weight":
                val = torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[1])
            elif name.endswith("conv.conv.weight"):
                a = 1.0 / math.sqrt(p.shape[-1])
                val = (torch.rand(p.shape, generator=generator) * 2 - 1) * a
            else:
                fan_out, fan_in = p.shape[-2:]
                a = math.sqrt(6.0 / (fan_in + fan_out))
                val = (torch.rand(p.shape, generator=generator) * 2 - 1) * a
            p.copy_(val.to(p.dtype))
        for moe in self.moe_layers():
            moe.expert_bias.copy_(torch.randn(moe.expert_bias.shape, generator=generator)
                                  * EXPERT_BIAS_STD)

    # ---- the sequence --------------------------------------------------------

    def prefix(self, memory: torch.Tensor, memory_padding_mask: Optional[torch.Tensor]):
        """memory [B, M, E_mem] -> (projected prefix [B, M, H] float32 with
        the real slots last and zeros at pad slots, pad mask [B, M])."""
        b, m = memory.shape[:2]
        pad = (torch.zeros((b, m), dtype=torch.bool, device=memory.device)
               if memory_padding_mask is None else memory_padding_mask.bool())
        order = torch.sort(pad.logical_not().to(torch.int8), dim=1, stable=True).indices
        pad = pad.gather(1, order)
        mem = memory.gather(1, order[..., None].expand(-1, -1, memory.shape[2]))
        x = linear(mem, self.projector.weight, self.projector.bias, self.dtype).float()
        return x.masked_fill(pad[..., None], 0.0), pad

    def _run(self, x, keep, pos, bias, states=None, at: int = 0):
        new = []
        for i, layer in enumerate(self.layers):
            x, st = layer(x, keep, pos, bias, self.dtype, None if states is None else states[i],
                          at)
            new.append(st)
        return x, new

    def hidden(self, memory, tgt_input, memory_padding_mask=None) -> torch.Tensor:
        """Teacher-forced final hidden states of the caption positions:
        ``tgt_input`` [B, S] -> [B, S, H] in the compute dtype."""
        pre, pad = self.prefix(memory, memory_padding_mask)
        m = pre.shape[1]
        emb = embedding(self.embed_tokens.weight, tgt_input, self.pad_id, self.dtype)
        x = torch.cat([pre, emb.float()], dim=1)
        keep = torch.cat([pad.logical_not(), torch.ones_like(tgt_input, dtype=torch.bool)], 1)
        pos = (keep.long().cumsum(dim=1) - 1).clamp(min=0)
        n = x.shape[1]
        causal = torch.triu(torch.full((n, n), NEG_INF, device=x.device), diagonal=1)
        bias = causal[None, None] + torch.where(keep, 0.0, NEG_INF)[:, None, None, :]
        x, _ = self._run(x, keep.float(), pos, bias)
        return self.embedding_norm(x[:, m:], self.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return linear(hidden, self.embed_tokens.weight, None, self.dtype)

    def forward(self, memory: torch.Tensor, tgt: torch.Tensor, tgt_padding_mask: torch.Tensor,
                memory_padding_mask: Optional[torch.Tensor] = None, *,
                return_attn: bool = False, row_valid: Optional[torch.Tensor] = None,
                return_parts: bool = False, loss_only: bool = False,
                rect_len: Optional[torch.Tensor] = None):
        """``CapDecoder.forward``'s contract: -> (logits [B, S-1, V] or None
        with ``loss_only`` and the fused loss, the loss or its four parts,
        None). Attention maps are not kept."""
        if return_attn:
            raise ValueError(f"model.{SECTION}: the LM decoder keeps no attention maps")
        tgt_out = tgt[:, 1:]
        outs = self.hidden(memory, tgt[:, :-1], memory_padding_mask)
        flat_labels = tgt_out.reshape(-1)
        valid_flat = None
        if row_valid is not None:
            valid_flat = row_valid[:, None].expand(tgt_out.shape).reshape(-1)
        batch_max = (~tgt_padding_mask).sum(dim=1).max() if rect_len is None else rect_len
        pos = torch.arange(tgt_out.shape[1], device=tgt.device)[None, :]
        rect = (pos < batch_max - 1).expand(tgt_out.shape).reshape(-1)
        with_rce = self.sce_loss_alpha != 1.0
        if loss_only and self.use_fused_loss:
            logits = None
            keep_ce = (flat_labels != self.pad_id).float()
            m_rce = rect.float()
            if valid_flat is not None:
                keep_ce = keep_ce * valid_flat.float()
                m_rce = m_rce * valid_flat.float()
            parts = linear_sce_parts(outs.reshape(-1, self.embed_dim), self.embed_tokens.weight,
                                     self.head_bias, flat_labels, keep_ce, m_rce, self.dtype,
                                     with_rce=with_rce, use_kernels=self.fused_loss_kernels)
        else:
            logits = self.logits(outs)
            parts = sce_loss_parts(logits.reshape(-1, logits.shape[-1]), flat_labels,
                                   ignore_index=self.pad_id, rect_mask=rect, valid=valid_flat)
            if not with_rce:
                zero = torch.zeros((), device=tgt.device)
                parts = (parts[0], parts[1], zero, zero)
        ce_sum, ce_n, rce_sum, rce_n = parts
        loss = (self.sce_loss_alpha * ce_sum / ce_n.clamp(min=1.0)
                + (1.0 - self.sce_loss_alpha) * rce_sum / rce_n.clamp(min=1.0))
        return logits, (parts if return_parts else loss), None

    # ---- greedy decode ---------------------------------------------------------

    def prefill(self, memory, memory_padding_mask, start: torch.Tensor, max_len: int):
        """The prefix and the start tokens [B] in one pass -> (logits [B, V]
        of the start position, the cache for ``decode_step``). The cache
        holds the keys and values of every attention layer for the prefix
        and ``max_len`` tokens, and every convolution layer's last inputs."""
        pre, pad = self.prefix(memory, memory_padding_mask)
        b, m = pad.shape
        emb = embedding(self.embed_tokens.weight, start[:, None], self.pad_id, self.dtype)
        x = torch.cat([pre, emb.float()], dim=1)
        keep = torch.cat([pad.logical_not(), torch.ones((b, 1), dtype=torch.bool,
                                                        device=pad.device)], dim=1)
        pos = (keep.long().cumsum(dim=1) - 1).clamp(min=0)
        total = m + max_len
        key_ok = torch.zeros((b, total), dtype=torch.bool, device=pad.device)
        key_ok[:, :m + 1] = keep
        c = self.c
        states = [None if layer.kind == "conv" else
                  {"k": torch.zeros((b, c.num_key_value_heads, total, c.head_dim),
                                    dtype=self.dtype, device=pad.device),
                   "v": torch.zeros((b, c.num_key_value_heads, total, c.head_dim),
                                    dtype=self.dtype, device=pad.device)}
                  for layer in self.layers]
        n = m + 1
        causal = torch.triu(torch.full((n, n), NEG_INF, device=x.device), diagonal=1)
        bias = causal[None, None] + torch.where(keep, 0.0, NEG_INF)[:, None, None, :]
        x, states = self._run(x, keep.float(), pos, bias, states, 0)
        cache = {"states": states, "key_ok": key_ok, "at": n, "pos": pos[:, -1] + 1}
        return self.logits(self.embedding_norm(x[:, -1], self.dtype)), cache

    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, Any]):
        """tokens [B] at the cache's next position -> (logits [B, V], the
        cache advanced by one)."""
        at = cache["at"]
        emb = embedding(self.embed_tokens.weight, tokens[:, None], self.pad_id, self.dtype)
        pos = cache["pos"][:, None]
        key_ok = cache["key_ok"]
        key_ok[:, at] = True
        bias = torch.where(key_ok[:, :at + 1], 0.0, NEG_INF)[:, None, None, :]
        x, states = self._run(emb.float(), None, pos, bias, cache["states"], at)
        cache.update(states=states, at=at + 1, pos=cache["pos"] + 1)
        return self.logits(self.embedding_norm(x[:, -1], self.dtype)), cache
