"""Caption decoder (port of ``vct_tpu/models/decoder.py``): token embedding
with the pad row zeroed, sinusoidal positional table, Transformer decoder, LM
head, the teacher-forced training/validation ``forward`` with the SCE loss,
and the KV-cached ``decode_step``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vct_tpu_torch.models.embeddings import PositionalEmbedding
from vct_tpu_torch.models.layers import TransformerDecoder, linear
from vct_tpu_torch.models.losses import cross_entropy_parts, sce_loss_parts
from vct_tpu_torch.ops.attention import causal_bias, combine_bias, padding_bias
from vct_tpu_torch.ops.fused_loss import linear_sce_parts


class LMHead(nn.Module):
    """Vocab projection; keys ``generator.{weight [V, E], bias [V]}``."""

    def __init__(self, in_dim: int, vocab_size: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(vocab_size, in_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.dtype)


class CapDecoder(nn.Module):
    def __init__(self, num_layers: int, embed_dim: int, nhead: int,
                 dim_feedforward: int, vocab_size: int, *, pad_id: int = 0,
                 activation: str = "gelu", quirk_no_memory_mask: bool = False,
                 dropout_rate: float = 0.0, rng=None, sce_loss_alpha: float = 0.5,
                 use_fused_loss: bool = True, fused_loss_kernels: bool = True,
                 use_kernels: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.pad_id, self.dtype = pad_id, dtype
        self.embed_dim, self.vocab_size = embed_dim, vocab_size
        self.quirk_no_memory_mask = quirk_no_memory_mask
        self.sce_loss_alpha = sce_loss_alpha
        self.use_fused_loss = use_fused_loss
        self.fused_loss_kernels = fused_loss_kernels
        self.decoder = TransformerDecoder(num_layers, embed_dim, nhead,
                                          dim_feedforward, activation, dropout_rate,
                                          rng=rng, use_kernels=use_kernels, dtype=dtype,
                                          device=device)
        self.generator = LMHead(embed_dim, vocab_size, dtype=dtype, device=device)
        self.tgt_to_emb = nn.Embedding(vocab_size, embed_dim, device=device)
        self.positional_encoding = PositionalEmbedding(embed_dim, 5000, dropout_rate,
                                                       rng=rng, device=device)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] ids -> [B, S, E]; pad tokens embed to zero (padding_idx)."""
        emb = self.tgt_to_emb.weight.to(self.dtype)[tokens.long()]
        return emb.masked_fill((tokens == self.pad_id)[..., None], 0.0)

    def memory_bias(self, memory_padding_mask: Optional[torch.Tensor]):
        if memory_padding_mask is None or self.quirk_no_memory_mask:
            return None
        return padding_bias(memory_padding_mask)

    def forward(self, memory: torch.Tensor, tgt: torch.Tensor,
                tgt_padding_mask: torch.Tensor,
                memory_padding_mask: Optional[torch.Tensor] = None, *,
                return_attn: bool = False, row_valid: Optional[torch.Tensor] = None,
                return_parts: bool = False, loss_only: bool = False):
        """Teacher-forced forward. memory [B, T, E]; tgt [B, S] ids;
        tgt_padding_mask [B, S] True = pad; ``row_valid`` [B] bool excludes
        collate filler rows from the loss. -> (logits [B, S-1, V], loss, attn
        or None); with ``return_parts`` the loss slot is (ce_sum, ce_n,
        rce_sum, rce_n). With ``loss_only`` and the fused loss on, the logits
        are never stored and their slot is None. Dropout follows
        ``self.training``."""
        tgt_input, tgt_out = tgt[:, :-1], tgt[:, 1:]
        tgt_bias = combine_bias(causal_bias(tgt_input.shape[1], device=tgt.device),
                                padding_bias(tgt_padding_mask[:, :-1]))
        x = self.positional_encoding(self.embed(tgt_input))
        outs, attn = self.decoder(x, memory, tgt_bias,
                                  self.memory_bias(memory_padding_mask),
                                  return_attn=return_attn)
        flat_labels = tgt_out.reshape(-1)
        valid_flat = None
        if row_valid is not None:
            valid_flat = row_valid[:, None].expand(tgt_out.shape).reshape(-1)
        # positions inside the rectangle of the batch's longest caption: the
        # RCE term averages over that rectangle, pads included. Filler rows
        # copy real rows, so they never lengthen it.
        batch_max = (~tgt_padding_mask).sum(dim=1).max()
        pos = torch.arange(tgt_out.shape[1], device=tgt.device)[None, :]
        rect = (pos < batch_max - 1).expand(tgt_out.shape).reshape(-1)

        if loss_only and self.use_fused_loss:
            logits = None
            keep_ce = (flat_labels != self.pad_id).float()
            m_rce = rect.float()
            if valid_flat is not None:
                keep_ce = keep_ce * valid_flat.float()
                m_rce = m_rce * valid_flat.float()
            parts = linear_sce_parts(
                outs.reshape(-1, self.embed_dim), self.generator.weight,
                self.generator.bias, flat_labels, keep_ce, m_rce, self.dtype,
                with_rce=self.sce_loss_alpha != 1.0, use_kernels=self.fused_loss_kernels)
        else:
            logits = self.generator(outs)
            flat_logits = logits.reshape(-1, self.vocab_size)
            if self.sce_loss_alpha == 1.0:
                ce_sum, ce_n = cross_entropy_parts(flat_logits, flat_labels, self.pad_id,
                                                   valid_flat)
                zero = torch.zeros((), device=tgt.device)
                parts = (ce_sum, ce_n, zero, zero)
            else:
                parts = sce_loss_parts(flat_logits, flat_labels, ignore_index=self.pad_id,
                                       rect_mask=rect, valid=valid_flat)
        ce_sum, ce_n, rce_sum, rce_n = parts
        loss = (self.sce_loss_alpha * ce_sum / ce_n.clamp(min=1.0)
                + (1.0 - self.sce_loss_alpha) * rce_sum / rce_n.clamp(min=1.0))
        return logits, (parts if return_parts else loss), attn

    def init_cache(self, batch: int, max_len: int, memory: torch.Tensor):
        return self.decoder.init_cache(batch, max_len, memory)

    def decode_step(self, tokens: torch.Tensor, caches, idx: int,
                    memory_padding_mask: Optional[torch.Tensor] = None, *,
                    return_attn: bool = False):
        """One cached step: tokens [B] at position ``idx`` -> (logits [B, V],
        caches, attn)."""
        tok = self.positional_encoding.at_position(self.embed(tokens[:, None]), idx)
        out, caches, attn = self.decoder.decode_step(
            tok, caches, idx, self.memory_bias(memory_padding_mask),
            return_attn=return_attn)
        return self.generator(out[:, 0]), caches, attn
