"""Transformer building blocks (port of ``vct_tpu/models/layers.py``).

Torch ``nn.Transformer*`` numerics as the reference uses them: post-norm,
exact-erf GELU, ``layer_norm_eps=1e-5``, packed QKV in ``in_proj_weight``
[3E, E]. Parameters are created in float32 (the reference's dtype) and every
product runs in the module's compute ``dtype``; LayerNorm statistics stay in
float32 and its result is rounded to the compute dtype, as in the reference.
``MMT4Caption.to_compute_dtype`` casts the weights once so the per-call casts
here become no-ops.

``decode_step`` writes the fresh K/V row into the cache tensors in place (the
reference returns new caches; in place saves a copy of every cache per token).

Training mode (``module.train()``) turns on dropout at the reference's places:
the attention weights, each sub-layer's output before its residual add, and
the FFN's hidden activation. The masks come from an explicit
``torch.Generator`` shared through a ``DropoutRng``; ``decode_step`` never
drops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vct_tpu_torch.ops.attention import NEG_INF, dot_product_attention
from vct_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model

Cache = Dict[str, torch.Tensor]
LN_EPS = 1e-5


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           dtype: torch.dtype) -> torch.Tensor:
    """``x @ w.T + b`` in the compute dtype (torch weight layout [out, in])."""
    return F.linear(x.to(dtype), w.to(dtype), None if b is None else b.to(dtype))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """float32-statistics LayerNorm, result in the compute dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), ln.weight.float(),
                     ln.bias.float(), LN_EPS)
    return y.to(dtype)


class DropoutRng:
    """The generator every ``Dropout`` of one model draws from. ``None`` means
    torch's default generator of the tensor's device."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator


class Dropout(nn.Module):
    """Inverted dropout with an explicit generator: identity in ``eval()`` or
    at rate 0; otherwise keep with probability 1 - rate and scale the kept
    values by 1 / (1 - rate)."""

    def __init__(self, rate: float, rng: Optional[DropoutRng] = None):
        super().__init__()
        self.rate = float(rate)
        self.rng = rng or DropoutRng()

    @property
    def active(self) -> bool:
        return self.training and self.rate > 0.0

    def draw_keep(self, shape, device) -> torch.Tensor:
        """The next keep mask (bool, True = kept) from the generator."""
        return torch.rand(tuple(shape), device=device,
                          generator=self.rng.generator) >= self.rate

    def forward(self, x: torch.Tensor, shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``shard=(index, count)``: ``x`` is block ``index`` of ``count``
        along its last dim; the mask is drawn for the whole width and this
        block kept, so every shard draws the same stream as one device."""
        if not self.active:
            return x
        if shard is None:
            keep = self.draw_keep(x.shape, x.device)
        else:
            w = x.shape[-1]
            keep = self.draw_keep(x.shape[:-1] + (w * shard[1],), x.device)
            keep = keep[..., shard[0] * w:(shard[0] + 1) * w]
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def feed_forward(layer, x: torch.Tensor, dropout: bool) -> torch.Tensor:
    """``linear2(dropout(act(linear1(x))))`` of an encoder or decoder layer.
    With ``layer.tp`` set (``parallel.mesh.shard_train_state``) the layer
    holds column-split ``linear1`` and row-split ``linear2`` shards: the
    activation stays local and one all-reduce over the model group sums the
    partial outputs, then ``linear2``'s bias is added once."""
    dt, tp = layer.dtype, layer.tp
    if tp is not None:
        x = copy_to_model(x, tp)
    h = layer.act(linear(x, layer.linear1.weight, layer.linear1.bias, dt))
    if dropout:
        h = layer.dropout(h, None if tp is None else (tp.model_index, tp.model))
    if tp is None:
        return linear(h, layer.linear2.weight, layer.linear2.bias, dt)
    return (reduce_from_model(linear(h, layer.linear2.weight, None, dt), tp)
            + layer.linear2.bias.to(dt))


def activation_fn(name: str):
    if name == "gelu":
        return F.gelu  # exact erf form, as torch's default and the reference
    if name == "relu":
        return F.relu
    raise ValueError(f"unsupported activation: {name}")


class MultiHeadAttention(nn.Module):
    """Packed-QKV multi-head attention in torch ``nn.MultiheadAttention``
    layout: ``in_proj_weight`` [3E, E] with q/k/v stacked on the output dim."""

    def __init__(self, embed_dim: int, num_heads: int, dropout_rate: float = 0.0, *,
                 rng: Optional[DropoutRng] = None, use_kernels: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        e = embed_dim
        self.embed_dim, self.num_heads, self.dtype = e, num_heads, dtype
        self.use_kernels = use_kernels  # the fused attention kernels, where eligible
        self.attn_dropout = Dropout(dropout_rate, rng)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e, device=device))
        self.out_proj = nn.Linear(e, e, device=device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.embed_dim // self.num_heads)

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        e = self.embed_dim
        return self._heads(linear(x, self.in_proj_weight[:e],
                                  self.in_proj_bias[:e], self.dtype))

    def project_kv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        e = self.embed_dim
        kv = linear(x, self.in_proj_weight[e:], self.in_proj_bias[e:], self.dtype)
        return self._heads(kv[..., :e]), self._heads(kv[..., e:])

    def project_qkv(self, x: torch.Tensor):
        e = self.embed_dim
        qkv = linear(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
        return (self._heads(qkv[..., :e]), self._heads(qkv[..., e:2 * e]),
                self._heads(qkv[..., 2 * e:]))

    def attend(self, q, k, v, bias, *, dropout: bool = False,
               return_weights: bool = False):
        drop = self.attn_dropout if dropout and self.attn_dropout.active else None
        out, weights = dot_product_attention(q, k, v, bias, dropout=drop,
                                             return_weights=return_weights,
                                             use_kernels=self.use_kernels)
        b, t = out.shape[:2]
        out = linear(out.reshape(b, t, self.embed_dim), self.out_proj.weight,
                     self.out_proj.bias, self.dtype)
        return out, weights

    def forward(self, query, key_value=None, bias=None, *, return_weights=False):
        if key_value is None:
            q, k, v = self.project_qkv(query)
        else:
            q = self.project_q(query)
            k, v = self.project_kv(key_value)
        return self.attend(q, k, v, bias, dropout=True, return_weights=return_weights)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: ``x = norm1(x + attn(x)); x = norm2(x + ff(x))``."""

    TP_PARAM = "linear1.weight"  # split by tensor parallelism: see feed_forward

    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout_rate: float = 0.0, *,
                 rng: Optional[DropoutRng] = None, use_kernels: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout_rate, rng=rng,
                                            use_kernels=use_kernels, dtype=dtype,
                                            device=device)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim, device=device)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.dropout = Dropout(dropout_rate, rng)
        self.dropout1 = Dropout(dropout_rate, rng)
        self.dropout2 = Dropout(dropout_rate, rng)
        self.act = activation_fn(activation)
        self.tp = None

    def _ffn(self, x):
        return feed_forward(self, x, dropout=True)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None):
        attn_out, _ = self.self_attn(x, bias=bias)
        x = layer_norm(x + self.dropout1(attn_out), self.norm1, self.dtype)
        return layer_norm(x + self.dropout2(self._ffn(x)), self.norm2, self.dtype)


class TransformerEncoder(nn.Module):
    """Layer stack + final LayerNorm."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 dim_feedforward: int = 2048, activation: str = "gelu",
                 dropout_rate: float = 0.0, *, rng: Optional[DropoutRng] = None,
                 use_kernels: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, dim_feedforward,
                                    activation, dropout_rate, rng=rng,
                                    use_kernels=use_kernels, dtype=dtype, device=device)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)

    def forward(self, x, bias=None):
        for layer in self.layers:
            x = layer(x, bias)
        return layer_norm(x, self.norm, self.dtype)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attn -> norm1 -> cross-attn -> norm2 ->
    FFN -> norm3, with a KV-cached single-token ``decode_step``."""

    TP_PARAM = "linear1.weight"

    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int = 2048,
                 activation: str = "gelu", dropout_rate: float = 0.0, *,
                 rng: Optional[DropoutRng] = None, use_kernels: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.embed_dim, self.num_heads, self.dtype = embed_dim, num_heads, dtype
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout_rate, rng=rng,
                                            use_kernels=use_kernels, dtype=dtype,
                                            device=device)
        self.multihead_attn = MultiHeadAttention(embed_dim, num_heads, dropout_rate,
                                                 rng=rng, use_kernels=use_kernels,
                                                 dtype=dtype, device=device)
        self.dropout = Dropout(dropout_rate, rng)
        self.dropout1 = Dropout(dropout_rate, rng)
        self.dropout2 = Dropout(dropout_rate, rng)
        self.dropout3 = Dropout(dropout_rate, rng)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim, device=device)
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.norm3 = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.act = activation_fn(activation)
        self.tp = None

    def _ffn(self, x, dropout: bool = False):
        return feed_forward(self, x, dropout)

    def forward(self, tgt, memory, tgt_bias=None, memory_bias=None, *,
                return_attn: bool = False):
        dt = self.dtype
        sa, _ = self.self_attn(tgt, bias=tgt_bias)
        x = layer_norm(tgt + self.dropout1(sa), self.norm1, dt)
        ca, attn = self.multihead_attn(x, memory, bias=memory_bias,
                                       return_weights=return_attn)
        x = layer_norm(x + self.dropout2(ca), self.norm2, dt)
        x = layer_norm(x + self.dropout3(self._ffn(x, dropout=True)), self.norm3, dt)
        if attn is not None:
            attn = attn.mean(dim=1)  # torch averages attention over heads
        return x, attn

    def init_cache(self, batch: int, max_len: int, memory: torch.Tensor) -> Cache:
        """Cross K/V computed once from the memory; zeroed self-attention
        cache rows [B, max_len, H, D] that ``decode_step`` fills."""
        h, d = self.num_heads, self.embed_dim // self.num_heads
        ck, cv = self.multihead_attn.project_kv(memory)
        shape = (batch, max_len, h, d)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=memory.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=memory.device),
            "ck": ck,
            "cv": cv,
        }

    def decode_step(self, tgt_tok: torch.Tensor, cache: Cache, idx: int,
                    memory_bias: Optional[torch.Tensor] = None, *,
                    return_attn: bool = False):
        """One token [B, 1, E] at position ``idx`` -> (x, cache, attn). Row
        ``idx`` of the cache is written in place."""
        dt = self.dtype
        max_len = cache["k"].shape[1]
        q, k1, v1 = self.self_attn.project_qkv(tgt_tok)
        cache["k"][:, idx] = k1[:, 0]
        cache["v"][:, idx] = v1[:, 0]
        pos = torch.arange(max_len, device=tgt_tok.device)
        zero = torch.zeros((), dtype=torch.float32, device=tgt_tok.device)
        step_bias = torch.where(pos <= idx, zero, NEG_INF)[None, None, None, :]
        sa, _ = self.self_attn.attend(q, cache["k"], cache["v"], step_bias)
        x = layer_norm(tgt_tok + sa, self.norm1, dt)
        cq = self.multihead_attn.project_q(x)
        ca, attn = self.multihead_attn.attend(cq, cache["ck"], cache["cv"],
                                              memory_bias, return_weights=return_attn)
        x = layer_norm(x + ca, self.norm2, dt)
        x = layer_norm(x + self._ffn(x), self.norm3, dt)
        if attn is not None:
            attn = attn.mean(dim=1)
        return x, cache, attn


class TransformerDecoder(nn.Module):
    """Decoder stack + final LayerNorm."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 dim_feedforward: int = 2048, activation: str = "gelu",
                 dropout_rate: float = 0.0, *, rng: Optional[DropoutRng] = None,
                 use_kernels: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(embed_dim, num_heads, dim_feedforward,
                                    activation, dropout_rate, rng=rng,
                                    use_kernels=use_kernels, dtype=dtype, device=device)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)

    def forward(self, tgt, memory, tgt_bias=None, memory_bias=None, *,
                return_attn: bool = False):
        attns: List[torch.Tensor] = []
        x = tgt
        for layer in self.layers:
            x, attn = layer(x, memory, tgt_bias, memory_bias, return_attn=return_attn)
            if return_attn:
                attns.append(attn)
        x = layer_norm(x, self.norm, self.dtype)
        return x, (torch.stack(attns) if return_attn else None)

    def init_cache(self, batch: int, max_len: int, memory: torch.Tensor):
        return tuple(layer.init_cache(batch, max_len, memory) for layer in self.layers)

    def decode_step(self, tgt_tok, caches, idx: int, memory_bias=None, *,
                    return_attn: bool = False):
        x = tgt_tok
        attns = []
        for layer, cache in zip(self.layers, caches):
            x, _, attn = layer.decode_step(x, cache, idx, memory_bias,
                                           return_attn=return_attn)
            if return_attn:
                attns.append(attn)
        x = layer_norm(x, self.norm, self.dtype)
        return x, caches, (torch.stack(attns) if return_attn else None)
