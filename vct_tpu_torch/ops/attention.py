"""Scaled dot-product attention core (port of ``vct_tpu/ops/attention.py``).

Semantics of ``torch.nn.functional.multi_head_attention_forward`` as the
reference uses it: ``softmax(q @ k^T / sqrt(d_head) + bias) @ v``. Logits and
softmax are float32 whatever the compute dtype; masks are a large finite
negative (``NEG_INF``) so a fully masked row gives a uniform distribution
instead of NaN. Dropout acts on the attention weights (keep mask drawn over
[B, H, Tq, Tk], kept weights scaled by 1 / (1 - rate)) and the weights
returned are the pre-dropout ones, as in torch.

Two routes, as in the reference: the fused kernels (``ops.attention_kernels``)
for a model that has them on, from Tq * Tk >= 128 * 128 on a CUDA device, when
no weights are asked for; the math path below for everything else. Both draw
their dropout mask with the same call and shape, so under one generator state
they drop the same weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
# The reference's gate: below it the score tile is too small for the fused
# kernel to pay. Where it should sit on this card is an open question (PERF.md).
KERNEL_MIN_SCORES = 128 * 128
# Test hook: take the kernel route on CPU tensors too (the kernels' plain
# versions then stand in).
KERNEL_ROUTE_ON_CPU = False


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


def _kernel_eligible(q: torch.Tensor, k: torch.Tensor, use_kernels: bool,
                     return_weights: bool) -> bool:
    """The reference's dispatch rule (``vct_tpu/ops/attention.py:63``): the
    kernels return no weights, a single-query decode step is a matrix-vector
    product, and a small score tile does not pay. An eligible shape that the
    CUDA kernels cannot carry raises in their wrappers; it does not fall to
    the math path."""
    return (use_kernels
            and not return_weights
            and q.shape[1] > 1
            and q.shape[1] * k.shape[1] >= KERNEL_MIN_SCORES
            and q.dtype in (torch.bfloat16, torch.float32)
            and (q.is_cuda or KERNEL_ROUTE_ON_CPU))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    dropout=None,
    return_weights: bool = False,
    use_kernels: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention over [B, T, H, D] tensors -> (out [B, Tq, H, D] in q's dtype,
    weights [B, H, Tq, Tk] float32 or None). ``dropout`` (training only) is
    the ``models.layers.Dropout`` of the attention weights: the math path
    applies it, the kernel route takes its rate and a keep mask from its
    ``draw_keep``. The weights are rounded to the compute dtype before the
    value product, as in the reference. ``use_kernels`` is the model's
    ``tpu.use_pallas_attention``. Without dropout the trainable kernel runs
    at rate 0 and stays differentiable; where no gradient can be asked for
    (``torch.no_grad()``, inputs that require none) the inference kernel
    runs instead."""
    if _kernel_eligible(q, k, use_kernels, return_weights):
        from vct_tpu_torch.ops.attention_kernels import (
            fused_attention,
            fused_attention_trainable,
        )

        differentiable = torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)
        if dropout is None and not differentiable:
            # nothing can ask for a gradient (validation, the eval decode's
            # encoder): the inference kernel, which saves no statistics
            return fused_attention(q, k, v, bias), None
        keep, rate = None, 0.0
        if dropout is not None:
            rate = dropout.rate
            keep = dropout.draw_keep((q.shape[0], q.shape[2], q.shape[1], k.shape[1]),
                                     q.device)
        # the kernels' backward gives the bias no gradient: say so here
        return fused_attention_trainable(
            q, k, v, None if bias is None else bias.detach(), keep, rate), None
    dtype = q.dtype
    d_head = q.shape[-1]
    # a float32 0-d host tensor: a scalar operand of the product, never copied
    # to the device (a CUDA graph may be capturing, ``decode_fast``)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d_head), dtype=torch.float32))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    dropped = weights if dropout is None else dropout(weights)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", dropped.to(dtype).float(), v.float()
    ).to(dtype)
    return out, (weights if return_weights else None)
