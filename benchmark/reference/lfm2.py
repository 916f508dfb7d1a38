"""The plain reference of the LFM2 caption LM over the MME encoder, in float32
PyTorch.

A straightforward implementation, from their published descriptions, of the
MME video encoder (the MSVD recipe's: a linear unify, a masked average token
in front, the fixed sinusoid temporal encoding, post-norm encoder layers and
a final LayerNorm) and of LFM2-8B-A1B's layers (Liquid AI's ``lfm2_moe``
model): RMSNorm, the gated short convolution (``B, C, x = split3(in_proj
h)``, ``out_proj(C * causal_depthwise_conv(B * x))``), grouped-query
attention with RMSNorm on each head's query and key and rotary positions
(the halves rotated), dense SwiGLU layers, and the sparse MoE block (``s =
sigmoid(h W_r)``, the top k of ``s + expert_bias``, their ``s`` over their
sum + 1e-6 times the scaling factor, one SwiGLU per expert), a final RMSNorm
and the head tied to the token embedding. The encoder's memory goes in front
of the caption as a prefix through a linear projector, left-padded: a row's
sequence is its real memory slots, then its caption; pad slots are zeros,
masked as attention keys and as convolution inputs, and positions count from
the row's first real slot. Loss: the SCE caption loss over the caption
positions. Weights come as a dict under the program's ``state_dict`` key
names.

It imports nothing of the program under test. Every product goes through a
``Precision``: float32 with TF32 off (the reference), or fp8 as fp8 training
runs it (the control: the precision below the configuration's bf16). The
experts a token uses may be given (``choice``: the program's, so that a
near-tie the two break apart does not move the loss); each MoE layer's own
top k and the gap between its k-th and (k+1)-th scores can be kept
(``record``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

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
    """How the linear layers multiply: ``"float32"`` or ``"fp8"``."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        if self.name == "fp8":
            return FP8Linear.apply(x, w, b)
        return F.linear(x, w, b)


# ---- the MME encoder ---------------------------------------------------------------


def sinusoid(max_len: int, dim: int, device=None) -> torch.Tensor:
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


def _layer_norm(x, W, name):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], LN_EPS)


def _mha(W, name, x, bias, heads, prec):
    e = x.shape[-1]
    w, b = W[name + ".in_proj_weight"], W[name + ".in_proj_bias"]
    q, k, v = (prec.linear(x, w[i * e:(i + 1) * e], b[i * e:(i + 1) * e]) for i in range(3))
    bsz, t, d = x.shape[0], x.shape[1], e // heads
    q, k, v = (z.reshape(bsz, t, heads, d).transpose(1, 2) for z in (q, k, v))
    weights = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d) + bias, dim=-1)
    out = (weights @ v).transpose(1, 2).reshape(bsz, t, e)
    return prec.linear(out, W[name + ".out_proj.weight"], W[name + ".out_proj.bias"])


def encode(W, dims, feats, pad, prec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Features [B, T, E_in] (pad [B, T] True = pad) -> (memory [B, 1 + T,
    E], its pad mask)."""
    pre = "video_encoder."
    x = prec.linear(feats, W[pre + "unify.0.weight"], W[pre + "unify.0.bias"])
    keep = (~pad).float()[..., None]
    avg = (x * keep).sum(dim=1, keepdim=True) / keep.sum(dim=1, keepdim=True).clamp(min=1.0)
    x = torch.cat([avg, x], dim=1)
    t = feats.shape[1]
    table = sinusoid(512, dims["embed_dim"], x.device)
    rows = torch.as_tensor(np.linspace(0, t - 1, t).astype(np.int64), device=x.device)
    x = x + torch.cat([torch.zeros_like(table[:1]), table[rows]], dim=0)[None]
    mem_pad = torch.cat([torch.zeros_like(pad[:, :1]), pad], dim=1)
    bias = torch.where(mem_pad, NEG_INF, 0.0)[:, None, None, :]
    for i in range(dims["encoder_layers"]):
        name = f"{pre}transformer_encoder.layers.{i}"
        x = _layer_norm(x + _mha(W, name + ".self_attn", x, bias, dims["encoder_heads"], prec),
                        W, name + ".norm1")
        h = F.gelu(prec.linear(x, W[name + ".linear1.weight"], W[name + ".linear1.bias"]))
        f = prec.linear(h, W[name + ".linear2.weight"], W[name + ".linear2.bias"])
        x = _layer_norm(x + f, W, name + ".norm2")
    return _layer_norm(x, W, pre + "transformer_encoder.norm"), mem_pad


# ---- LFM2 --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, heads, S, D] at positions pos [B, S]: pairs (i, i + D/2) rotated
    by pos * theta^(-2i/D)."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d // 2, device=x.device, dtype=torch.float32) * 2.0 / d)
    ang = pos[:, None, :, None].float() * freq
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(), x2 * ang.cos() + x1 * ang.sin()], dim=-1)


def short_conv(W, name, h, keep, prec) -> torch.Tensor:
    width = h.shape[-1]
    b, c, x = prec.linear(h, W[name + ".in_proj.weight"]).split(width, dim=-1)
    bx = (b * x) * keep[..., None]
    w = W[name + ".conv.weight"]                     # [H, 1, L]
    size = w.shape[-1]
    y = F.conv1d(bx.transpose(1, 2), w, padding=size - 1, groups=width)[..., :h.shape[1]]
    return prec.linear(c * y.transpose(1, 2), W[name + ".out_proj.weight"])


def gqa(W, name, h, pos, bias, dims, prec) -> torch.Tensor:
    bsz, s, _ = h.shape
    nh, nkv, d = dims["heads"], dims["kv_heads"], dims["head_dim"]
    q = prec.linear(h, W[name + ".q_proj.weight"]).view(bsz, s, nh, d)
    k = prec.linear(h, W[name + ".k_proj.weight"]).view(bsz, s, nkv, d)
    v = prec.linear(h, W[name + ".v_proj.weight"]).view(bsz, s, nkv, d).transpose(1, 2)
    q = rope(rms_norm(q, W[name + ".q_layernorm.weight"], dims["eps"]).transpose(1, 2), pos,
             dims["theta"])
    k = rope(rms_norm(k, W[name + ".k_layernorm.weight"], dims["eps"]).transpose(1, 2), pos,
             dims["theta"])
    q = q.reshape(bsz, nkv, nh // nkv, s, d)          # query heads grouped by their KV head
    scores = q @ k[:, :, None].transpose(-1, -2) / math.sqrt(d) + bias[:, :, None]
    out = torch.softmax(scores, dim=-1) @ v[:, :, None]
    out = out.reshape(bsz, nh, s, d).transpose(1, 2).reshape(bsz, s, nh * d)
    return prec.linear(out, W[name + ".out_proj.weight"])


def swiglu(x, w_gate, w_up, w_down, prec) -> torch.Tensor:
    return prec.linear(F.silu(prec.linear(x, w_gate)) * prec.linear(x, w_up), w_down)


def moe(W, name, x, dims, prec, choice: Optional[torch.Tensor] = None,
        record: Optional[List] = None) -> torch.Tensor:
    """x [T, H] -> [T, H]. ``choice`` [T, k]: the experts to use (else this
    layer's own top k); ``record`` gets (own top k [T, k], the gap between
    the k-th and (k+1)-th routing scores [T])."""
    k, n_e, inter = dims["top_k"], dims["experts"], dims["moe_width"]
    s = torch.sigmoid(prec.linear(x, W[name + ".gate.weight"]))
    score = s + W[name + ".expert_bias"] if dims["use_expert_bias"] else s
    top = torch.topk(score.detach(), k + 1, dim=-1)
    if record is not None:
        record.append((top.indices[:, :k], top.values[:, k - 1] - top.values[:, k]))
    idx = top.indices[:, :k] if choice is None else choice.long()
    w = s.gather(1, idx)
    if dims["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
    w = w * dims["scaling"]
    out = torch.zeros_like(x)
    w13, w2 = W[name + ".experts.w13"], W[name + ".experts.w2"]
    for e in range(n_e):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x[tok], w13[e, :inter], w13[e, inter:], w2[e], prec)
        out = out.index_add(0, tok, y * w[tok, slot][:, None])
    return out


def lm_hidden(W, dims, memory, mem_pad, tokens, prec, choice=None, record=None):
    """Teacher-forced LM over [prefix, tokens]: tokens [B, S] -> final
    hidden [B, S, H] of the caption positions. ``choice``: a [T, k] per MoE
    layer, T = B x (prefix + S) in row-major order."""
    pre = "cap_decoder."
    bsz, m = mem_pad.shape
    s = tokens.shape[1]
    proj = prec.linear(memory, W[pre + "projector.weight"], W[pre + "projector.bias"])
    width = proj.shape[-1]
    # the left-padded prefix, row by row: the real slots at the end
    prefix = torch.zeros((bsz, m, width), device=proj.device)
    prefix_keep = torch.zeros((bsz, m), dtype=torch.bool, device=proj.device)
    for r in range(bsz):
        real = proj[r][~mem_pad[r]]
        n = real.shape[0]
        prefix = prefix.index_put((torch.tensor([r], device=proj.device),
                                   torch.arange(m - n, m, device=proj.device)), real)
        prefix_keep[r, m - n:] = True
    emb = W[pre + "embed_tokens.weight"][tokens.long()]
    emb = emb * (tokens != dims["pad_id"])[..., None]
    x = torch.cat([prefix, emb], dim=1)
    keep = torch.cat([prefix_keep, torch.ones_like(tokens, dtype=torch.bool)], dim=1)
    n = m + s
    pos = (torch.cumsum(keep.long(), dim=1) - 1).clamp(min=0)
    allowed = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))[None] & keep[:, None]
    bias = torch.where(allowed, 0.0, NEG_INF)[:, None]
    keep_f = keep.float()
    moe_i = 0
    for i, kind in enumerate(dims["kinds"]):
        name = f"{pre}layers.{i}"
        h = rms_norm(x, W[name + ".operator_norm.weight"], dims["eps"])
        if kind == "conv":
            x = x + short_conv(W, name + ".conv", h, keep_f, prec)
        else:
            x = x + gqa(W, name + ".self_attn", h, pos, bias, dims, prec)
        h = rms_norm(x, W[name + ".ffn_norm.weight"], dims["eps"])
        ff = name + ".feed_forward"
        if i < dims["dense_layers"]:
            f = swiglu(h, W[ff + ".w1.weight"], W[ff + ".w3.weight"], W[ff + ".w2.weight"], prec)
        else:
            c = None if choice is None else choice[moe_i]
            f = moe(W, ff, h.reshape(bsz * n, width), dims, prec, c, record).view(bsz, n, width)
            moe_i += 1
        x = x + f
    return rms_norm(x[:, m:], W[pre + "embedding_norm.weight"], dims["eps"])


def logits_of(W, hidden, prec) -> torch.Tensor:
    return prec.linear(hidden, W["cap_decoder.embed_tokens.weight"])


def sce_loss(logits, labels, n_real, pad_id: int, alpha: float) -> torch.Tensor:
    """``alpha * CE + (1 - alpha) * RCE``: CE over the non-[PAD] labels; RCE
    -log(1e-4) * (sum of the probabilities clipped to [1e-7, 1] - the
    label's), averaged over the rectangle of the batch's longest caption."""
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


def caption_loss(W, dims, feats, pad, tokens, prec, choice=None, record=None) -> torch.Tensor:
    """Features, their pad mask and caption ids [B, S] -> the loss."""
    memory, mem_pad = encode(W, dims, feats, pad, prec)
    tok_pad = tokens == dims["pad_id"]
    hidden = lm_hidden(W, dims, memory, mem_pad, tokens[:, :-1], prec, choice, record)
    return sce_loss(logits_of(W, hidden, prec), tokens[:, 1:], (~tok_pad).sum(dim=1),
                    dims["pad_id"], dims["sce_alpha"])


def real_positions(mem_pad: torch.Tensor, tokens: torch.Tensor, pad_id: int) -> torch.Tensor:
    """[B x (prefix + S)] True where a position carries a real slot or a
    caption token (the order of ``choice``'s rows), for tokens [B, S] fed to
    the LM."""
    m = mem_pad.shape[1]
    n_real = (~mem_pad).sum(dim=1)
    slots = torch.arange(m, device=mem_pad.device)[None] >= (m - n_real)[:, None]
    return torch.cat([slots, tokens != pad_id], dim=1).reshape(-1)
