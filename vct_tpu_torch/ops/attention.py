"""Scaled dot-product attention core (port of ``vct_tpu/ops/attention.py``).

Semantics of ``torch.nn.functional.multi_head_attention_forward`` as the
reference uses it: ``softmax(q @ k^T / sqrt(d_head) + bias) @ v``. Logits and
softmax are float32 whatever the compute dtype; masks are a large finite
negative (``NEG_INF``) so a fully masked row gives a uniform distribution
instead of NaN. Inference only: the dropout and the fused-kernel branch of the
reference belong to training, which is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def padding_bias(key_padding_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, Tk] bool (True = PAD) -> additive [B, 1, 1, Tk] float32 bias."""
    if key_padding_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=key_padding_mask.device)
    bias = torch.where(key_padding_mask, NEG_INF, zero)
    return bias[:, None, None, :]


def causal_bias(length: int, device=None) -> torch.Tensor:
    """Additive [1, 1, T, T] causal bias."""
    mask = torch.tril(torch.ones((length, length), dtype=torch.bool, device=device))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(mask, zero, NEG_INF)[None, None]


def combine_bias(*biases: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for b in biases:
        if b is None:
            continue
        out = b if out is None else out + b
    return out


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    return_weights: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention over [B, T, H, D] tensors -> (out [B, Tq, H, D] in q's dtype,
    weights [B, H, Tq, Tk] float32 or None). The weights are rounded to the
    compute dtype before the value product, as in the reference."""
    dtype = q.dtype
    d_head = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d_head), dtype=torch.float32))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale.to(q.device)
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", weights.to(dtype).float(), v.float()
    ).to(dtype)
    return out, (weights if return_weights else None)
