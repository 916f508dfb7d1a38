"""Positional / temporal / modal embeddings and global aggregation (port of
``vct_tpu/models/embeddings.py``).

Ported now: the sinusoid table, the non-separate fixed ``temporal_encoding``,
``ModalEmbedding``, the decoder's ``PositionalEmbedding`` (a 5000-row buffer)
and ``GlobalAggregation`` in ``avg`` mode. The learned ``TemporalEmbedding``
and the max/GRU aggregations come with the remaining encoders.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn


def sinusoid_table(max_len: int, dim: int) -> np.ndarray:
    """float32 [max_len, dim] sin/cos table (reference formula)."""
    den = np.exp(-np.arange(0, dim, 2, dtype=np.float32) * (math.log(10000.0) / dim))
    pos = np.arange(0, max_len, dtype=np.float32)[:, None]
    table = np.zeros((max_len, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * den)
    table[:, 1::2] = np.cos(pos * den)
    return table


def temporal_encoding(modal_lengths: Sequence[int], dim: int,
                      max_len: int = 512) -> np.ndarray:
    """Fixed non-separate temporal encoding -> float32 [sum(lengths), dim].

    Each modality's length includes its prepended global token: position 0
    gets zeros, positions 1..t get ``pe[linspace(0, D-1, t)]`` with D the
    primary modality's frame count (the reference's timeline alignment)."""
    pe = sinusoid_table(max_len, dim)
    d_primary = modal_lengths[0] - 1
    parts = []
    for length in modal_lengths:
        t = length - 1
        block = np.zeros((t + 1, dim), dtype=np.float32)
        block[1:] = pe[np.linspace(0, d_primary - 1, t).astype(np.int32)]
        parts.append(block)
    return np.concatenate(parts, axis=0)


class ModalEmbedding(nn.Module):
    """Learned modality-id embedding; key ``modal_emb.modal_emb.weight``."""

    def __init__(self, num_modal: int, dim: int, modal_different: bool = True,
                 *, device=None):
        super().__init__()
        self.num_modal, self.modal_different = num_modal, modal_different
        n = num_modal * 2 if modal_different else num_modal
        self.modal_emb = nn.Embedding(n, dim, device=device)

    def labels(self, modal_lengths: Sequence[int]) -> List[int]:
        lab: List[int] = []
        for i, length in enumerate(modal_lengths):
            lab.append(i + self.num_modal if self.modal_different else i)
            lab.extend([i] * (length - 1))
        return lab

    def forward(self, modal_lengths: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        w = self.modal_emb.weight
        idx = torch.tensor(self.labels(modal_lengths), device=w.device)
        return w.to(dtype)[idx]


class PositionalEmbedding(nn.Module):
    """Decoder positional table as a buffer (importers may overwrite it with
    learned rows, so it is part of the ``state_dict``)."""

    def __init__(self, dim: int, max_len: int = 5000, *, device=None):
        super().__init__()
        self.register_buffer(
            "pos_embedding",
            torch.as_tensor(sinusoid_table(max_len, dim), device=device))

    def forward(self, token_embedding: torch.Tensor) -> torch.Tensor:
        s = token_embedding.shape[1]
        return token_embedding + self.pos_embedding[:s].to(token_embedding.dtype)

    def at_position(self, token_embedding: torch.Tensor, idx: int) -> torch.Tensor:
        """PE for one decode step at position ``idx`` ([B, 1, E])."""
        row = self.pos_embedding[idx].to(token_embedding.dtype)
        return token_embedding + row


class GlobalAggregation(nn.Module):
    """Per-modality global feature [B, T, E] -> [B, 1, E]; ``avg`` mode,
    masked over padding unless ``quirk_unmasked`` (the reference pools over
    padded steps)."""

    def __init__(self, method: str, quirk_unmasked: bool = False):
        super().__init__()
        if method != "avg":
            raise NotImplementedError(
                f"aggregation {method!r} is not ported yet (only 'avg')")
        self.quirk_unmasked = quirk_unmasked

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.quirk_unmasked or padding_mask is None:
            return x.mean(dim=1, keepdim=True)
        keep = (~padding_mask)[..., None].to(x.dtype)
        return (x * keep).sum(dim=1, keepdim=True) / torch.clamp(
            keep.sum(dim=1, keepdim=True), min=1.0)
