"""Caption decoder, inference side (port of ``vct_tpu/models/decoder.py``):
token embedding with the pad row zeroed, sinusoidal positional table,
Transformer decoder, LM head, and the KV-cached ``decode_step``. The
teacher-forced loss path comes with training."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vct_tpu_torch.models.embeddings import PositionalEmbedding
from vct_tpu_torch.models.layers import TransformerDecoder, linear
from vct_tpu_torch.ops.attention import padding_bias


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
                 dtype=torch.float32, device=None):
        super().__init__()
        self.pad_id, self.dtype = pad_id, dtype
        self.quirk_no_memory_mask = quirk_no_memory_mask
        self.decoder = TransformerDecoder(num_layers, embed_dim, nhead,
                                          dim_feedforward, activation,
                                          dtype=dtype, device=device)
        self.generator = LMHead(embed_dim, vocab_size, dtype=dtype, device=device)
        self.tgt_to_emb = nn.Embedding(vocab_size, embed_dim, device=device)
        self.positional_encoding = PositionalEmbedding(embed_dim, 5000, device=device)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] ids -> [B, S, E]; pad tokens embed to zero (padding_idx)."""
        emb = self.tgt_to_emb.weight.to(self.dtype)[tokens.long()]
        return emb.masked_fill((tokens == self.pad_id)[..., None], 0.0)

    def memory_bias(self, memory_padding_mask: Optional[torch.Tensor]):
        if memory_padding_mask is None or self.quirk_no_memory_mask:
            return None
        return padding_bias(memory_padding_mask)

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
