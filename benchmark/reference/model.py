"""The plain reference of MMT4Caption's caption path, in float32 PyTorch.

A straightforward implementation of the published model (Kamino666's
Video-Captioning-Transformer, the MSVD recipe): an MME video encoder (a
linear unify per modality, a masked average token in front, the fixed
sinusoid temporal encoding, post-norm Transformer encoder layers and a final
LayerNorm), a post-norm Transformer caption decoder with a final LayerNorm and
the LM head, and the SCE caption loss. Weights come as a dict under the
reference's ``state_dict`` key names, in float32.

It imports nothing of the program under test. Every linear layer goes through
a ``Precision``: float32 with TF32 off (the reference), or fp8 as fp8
training runs it (the control: the nearest precision below the bf16 that the
configuration states). Dropout, where asked for, draws its masks
from a ``Dropout`` of its own, in the order the forward pass meets them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30
LN_EPS = 1e-5


def no_tf32() -> None:
    """Products in true float32 on a card (TF32 is a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (an fp8 type) after scaling so that its
    largest magnitude is the type's largest finite value, and back."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float() * scale


class FP8Linear(torch.autograd.Function):
    """A linear layer as fp8 training runs it: inputs and weights in e4m3,
    the incoming gradient in e5m2, every product accumulated in float32."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = fp8_round(x, torch.float8_e4m3fn), fp8_round(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        ctx.has_bias = b is not None
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dq = fp8_round(dy, torch.float8_e5m2)
        dx = dq @ wq
        dw = dq.reshape(-1, dq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        db = dy.reshape(-1, dy.shape[-1]).sum(0) if ctx.has_bias else None
        return dx, dw, db


class Precision:
    """How the linear layers multiply: ``"float32"``, or ``"fp8"`` as fp8
    training runs them (``FP8Linear``: e4m3 inputs and weights, e5m2
    gradients, per-tensor scales, float32 accumulation)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        if self.name == "fp8":
            return FP8Linear.apply(x, w, b)
        return F.linear(x, w, b)


class Dropout:
    """Inverted dropout whose keep masks (``rand >= rate``) come from one
    generator, drawn in call order. ``rate`` 0 or no generator: identity."""

    def __init__(self, rate: float, generator: Optional[torch.Generator]):
        self.rate, self.generator = float(rate), generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None or self.rate == 0.0:
            return x
        keep = torch.rand(tuple(x.shape), device=x.device, generator=self.generator) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


NO_DROP = Dropout(0.0, None)


def sinusoid(max_len: int, dim: int, device=None) -> torch.Tensor:
    """[max_len, dim] sin / cos table of the published formula."""
    pos = torch.arange(max_len, dtype=torch.float64)[:, None]
    den = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float64) * (math.log(10000.0) / dim))
    table = torch.zeros((max_len, dim), dtype=torch.float64)
    table[:, 0::2] = torch.sin(pos * den)
    table[:, 1::2] = torch.cos(pos * den)
    return table.float().to(device)


def fit_frames(feat: np.ndarray, max_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    """One video's (T, E) features -> ((max_frames, E), pad mask True = pad):
    longer videos are sampled at ``linspace(0, T - 1, max_frames)`` (indices
    truncated), shorter ones padded with zeros."""
    t, e = feat.shape
    if t > max_frames:
        feat = feat[np.linspace(0, t - 1, max_frames).astype(np.int64)]
        t = max_frames
    out = np.zeros((max_frames, e), dtype=np.float32)
    out[:t] = feat
    pad = np.ones((max_frames,), dtype=bool)
    pad[:t] = False
    return out, pad


def layer_norm(x: torch.Tensor, W: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], LN_EPS)


def pad_bias(pad: torch.Tensor) -> torch.Tensor:
    """[B, Tk] True = pad -> additive [B, 1, 1, Tk]."""
    return torch.where(pad, NEG_INF, 0.0)[:, None, None, :].float()


def attention(W, name: str, x: torch.Tensor, kv: Optional[torch.Tensor], bias, heads: int,
              prec: Precision, drop: Dropout) -> torch.Tensor:
    """Multi-head attention with packed in-projections (``in_proj_weight``
    [3E, E]); ``kv`` None is self-attention. Softmax in float32; dropout on
    the attention weights."""
    e = x.shape[-1]
    w, b = W[name + ".in_proj_weight"], W[name + ".in_proj_bias"]
    src = x if kv is None else kv
    q = prec.linear(x, w[:e], b[:e])
    k = prec.linear(src, w[e:2 * e], b[e:2 * e])
    v = prec.linear(src, w[2 * e:], b[2 * e:])
    bsz, tq, tk, d = x.shape[0], x.shape[1], src.shape[1], e // heads
    q = q.reshape(bsz, tq, heads, d).transpose(1, 2)
    k = k.reshape(bsz, tk, heads, d).transpose(1, 2)
    v = v.reshape(bsz, tk, heads, d).transpose(1, 2)
    logits = q @ k.transpose(-1, -2) / math.sqrt(d)
    if bias is not None:
        logits = logits + bias
    weights = drop(torch.softmax(logits, dim=-1))
    out = (weights @ v).transpose(1, 2).reshape(bsz, tq, e)
    return prec.linear(out, W[name + ".out_proj.weight"], W[name + ".out_proj.bias"])


def feed_forward(W, name: str, x, prec: Precision, drop: Dropout) -> torch.Tensor:
    h = F.gelu(prec.linear(x, W[name + ".linear1.weight"], W[name + ".linear1.bias"]))
    return prec.linear(drop(h), W[name + ".linear2.weight"], W[name + ".linear2.bias"])


def encode(W, dims: Dict[str, int], feats: torch.Tensor, pad: torch.Tensor,
           prec: Precision, drop: Dropout = NO_DROP) -> Tuple[torch.Tensor, torch.Tensor]:
    """One modality's features [B, T, E_in] (pad [B, T] True = pad) ->
    (memory [B, 1 + T, E], memory pad mask [B, 1 + T])."""
    pre = "video_encoder."
    x = prec.linear(feats, W[pre + "unify.0.weight"], W[pre + "unify.0.bias"])
    keep = (~pad).float()[..., None]
    avg = (x * keep).sum(dim=1, keepdim=True) / keep.sum(dim=1, keepdim=True).clamp(min=1.0)
    x = torch.cat([avg, x], dim=1)
    t = feats.shape[1]
    table = sinusoid(512, dims["embed_dim"], x.device)
    rows = torch.as_tensor(np.linspace(0, t - 1, t).astype(np.int64), device=x.device)
    temporal = torch.cat([torch.zeros_like(table[:1]), table[rows]], dim=0)
    x = x + temporal[None]
    mem_pad = torch.cat([torch.zeros_like(pad[:, :1]), pad], dim=1)
    bias = pad_bias(mem_pad)
    for i in range(dims["encoder_layers"]):
        name = f"{pre}transformer_encoder.layers.{i}"
        a = attention(W, name + ".self_attn", x, None, bias, dims["encoder_heads"], prec, drop)
        x = layer_norm(x + drop(a), W, name + ".norm1")
        f = feed_forward(W, name, x, prec, drop)
        x = layer_norm(x + drop(f), W, name + ".norm2")
    return layer_norm(x, W, pre + "transformer_encoder.norm"), mem_pad


def decode_hidden(W, dims, memory, mem_pad, tokens: torch.Tensor, prec: Precision,
                  drop: Dropout = NO_DROP, key_pad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced decoder: tokens [B, S] -> final hidden [B, S, E].
    ``key_pad`` [B, S] masks padded tokens as keys (training); without it
    every earlier position is attended, as the incremental decode does.
    [PAD] tokens embed to zero."""
    pre = "cap_decoder."
    s = tokens.shape[1]
    emb = W[pre + "tgt_to_emb.weight"][tokens.long()]
    emb = emb.masked_fill((tokens == dims["pad_id"])[..., None], 0.0)
    x = drop(emb + sinusoid(s, dims["embed_dim"], emb.device)[None])
    causal = torch.triu(torch.full((s, s), NEG_INF, device=x.device), diagonal=1)[None, None]
    self_bias = causal if key_pad is None else causal + pad_bias(key_pad)
    mem_bias = pad_bias(mem_pad)
    for i in range(dims["decoder_layers"]):
        name = f"{pre}decoder.layers.{i}"
        a = attention(W, name + ".self_attn", x, None, self_bias, dims["decoder_heads"], prec,
                      drop)
        x = layer_norm(x + drop(a), W, name + ".norm1")
        c = attention(W, name + ".multihead_attn", x, memory, mem_bias, dims["decoder_heads"],
                      prec, drop)
        x = layer_norm(x + drop(c), W, name + ".norm2")
        f = feed_forward(W, name, x, prec, drop)
        x = layer_norm(x + drop(f), W, name + ".norm3")
    return layer_norm(x, W, pre + "decoder.norm")


def logits_of(W, hidden: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.linear(hidden, W["cap_decoder.generator.weight"], W["cap_decoder.generator.bias"])


def sce_loss(logits: torch.Tensor, labels: torch.Tensor, n_real: torch.Tensor, pad_id: int,
             alpha: float) -> torch.Tensor:
    """The SCE caption loss: ``alpha * CE + (1 - alpha) * RCE``. CE averages
    -log p[label] over the non-[PAD] labels; RCE is -log(1e-4) * (sum of the
    clipped probabilities - the label's), averaged over the rectangle of the
    batch's longest caption (``n_real``: tokens per caption), pads included."""
    v = logits.shape[-1]
    z = logits.reshape(-1, v)
    y = labels.reshape(-1).long()
    logp = torch.log_softmax(z, dim=-1)
    keep = (y != pad_id).float()
    ce = -(logp.gather(1, y[:, None])[:, 0] * keep).sum() / keep.sum().clamp(min=1.0)
    p = logp.exp().clamp(1e-7, 1.0)
    rce_rows = -(p.sum(dim=-1) - p.gather(1, y[:, None])[:, 0]) * math.log(1e-4)
    pos = torch.arange(labels.shape[1], device=labels.device)[None, :]
    rect = (pos < n_real.max() - 1).expand(labels.shape).reshape(-1).float()
    rce = (rce_rows * rect).sum() / rect.sum().clamp(min=1.0)
    return alpha * ce + (1.0 - alpha) * rce


def caption_loss(W, dims, feats, pad, tokens, prec: Precision,
                 drop: Dropout = NO_DROP) -> torch.Tensor:
    """Training forward: features, pad mask and caption ids [B, S] -> loss."""
    memory, mem_pad = encode(W, dims, feats, pad, prec, drop)
    tok_pad = tokens == dims["pad_id"]
    hidden = decode_hidden(W, dims, memory, mem_pad, tokens[:, :-1], prec, drop,
                           key_pad=tok_pad[:, :-1])
    return sce_loss(logits_of(W, hidden, prec), tokens[:, 1:], (~tok_pad).sum(dim=1),
                    dims["pad_id"], dims["sce_alpha"])


def topk_first_win(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row by value; among equal values the lowest index."""
    order = torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]
    return x.gather(1, order), order


def beam_search(W, dims, memory, mem_pad, *, beam: int, max_len: int, start_id: int,
                end_id: int, length_penalty: float, prec: Precision
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width beam search: only beam 0 is live at first; a finished beam
    is frozen (it can only add [PAD] at zero cost); candidates ranked by
    value, ties to the lowest flat index; the result maximises score /
    max(length ** length_penalty, 1), length counted with the start token
    and the end token. -> (tokens [B, max_len], normalised scores [B])."""
    b, t_mem, e = memory.shape
    k, pad_id = beam, dims["pad_id"]
    dev = memory.device
    mem_k = memory[:, None].expand(b, k, t_mem, e).reshape(b * k, t_mem, e)
    pad_k = mem_pad[:, None].expand(b, k, t_mem).reshape(b * k, t_mem)
    tokens = torch.full((b, k, max_len), pad_id, dtype=torch.long, device=dev)
    tokens[:, :, 0] = start_id
    scores = torch.full((b, k), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.ones((b, k), dtype=torch.long, device=dev)
    vocab = W["cap_decoder.generator.weight"].shape[0]
    frozen = torch.full((vocab,), NEG_INF, device=dev)
    frozen[pad_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None]
    for i in range(max_len - 1):
        hidden = decode_hidden(W, dims, mem_k, pad_k, tokens.reshape(b * k, max_len)[:, :i + 1],
                               prec)
        logp = torch.log_softmax(logits_of(W, hidden[:, -1], prec), dim=-1).reshape(b, k, vocab)
        logp = torch.where(finished[..., None], frozen, logp)
        scores, flat = topk_first_win((scores[..., None] + logp).reshape(b, k * vocab), k)
        src, tok = flat // vocab, flat % vocab
        tokens, finished, lengths = tokens[rows, src], finished[rows, src], lengths[rows, src]
        tokens[:, :, i + 1] = tok
        lengths = torch.where(finished, lengths, lengths + 1)
        finished = finished | (tok == end_id)
        if bool(finished.all()):
            break
    final = scores / lengths.float().pow(length_penalty).clamp(min=1.0)
    best = torch.argmax(final, dim=1)
    return tokens[rows[:, 0], best], final[rows[:, 0], best]


def hypothesis_scores(W, dims, memory, mem_pad, tokens: torch.Tensor, *, end_id: int,
                      length_penalty: float, prec: Precision, rank: Optional[int] = None):
    """Each row's caption [B, L] (start token first) scored as the beam search
    scores it: the sum of its tokens' log-probabilities through its first end
    token (all of them without one), over max(length ** penalty, 1). With
    ``rank`` k also -> per row, the most by which one of those tokens'
    log-probability lies below the k-th best of its prefix (0 where every
    token is among its prefix's k best)."""
    hidden = decode_hidden(W, dims, memory, mem_pad, tokens[:, :-1], prec)
    logp = torch.log_softmax(logits_of(W, hidden, prec), dim=-1)
    tok_logp = logp.gather(2, tokens[:, 1:, None].long())[..., 0]
    is_end = (tokens[:, 1:] == end_id).long()
    before_end = (is_end.cumsum(dim=1) - is_end) == 0  # through the first end token
    total = (tok_logp * before_end).sum(dim=1)
    length = 1 + before_end.sum(dim=1)
    score = total / length.float().pow(length_penalty).clamp(min=1.0)
    if rank is None:
        return score
    kth = logp.topk(rank, dim=-1).values[..., -1]
    below = ((kth - tok_logp).clamp(min=0.0) * before_end).amax(dim=1)
    return score, below
