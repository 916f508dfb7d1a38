"""Positional / temporal / modal embeddings and global aggregation (port of
``vct_tpu/models/embeddings.py``).

The sinusoid table, the fixed ``temporal_encoding`` (joint and per-modality),
the learned ``TemporalEmbedding`` with its index map, ``ModalEmbedding``, the
decoder's ``PositionalEmbedding`` (a 5000-row buffer), a ``GRU`` in
``nn.GRU``'s parameter layout and ``GlobalAggregation`` (max / avg / GRU /
biGRU). Module and parameter names are the reference ``state_dict``'s.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from vct_tpu_torch.models.layers import Dropout


def sinusoid_table(max_len: int, dim: int) -> np.ndarray:
    """float32 [max_len, dim] sin/cos table (reference formula)."""
    den = np.exp(-np.arange(0, dim, 2, dtype=np.float32) * (math.log(10000.0) / dim))
    pos = np.arange(0, max_len, dtype=np.float32)[:, None]
    table = np.zeros((max_len, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * den)
    table[:, 1::2] = np.cos(pos * den)
    return table


def _align_indices(primary_len: int, t: int) -> np.ndarray:
    """``linspace(0, primary_len - 1, t)`` as int32: the reference's
    alignment of every modality's timeline onto the primary one's."""
    return np.linspace(0, primary_len - 1, t).astype(np.int32)


def temporal_encoding(modal_lengths: Sequence[int], dim: int,
                      max_len: int = 512, separate: bool = False):
    """Fixed temporal encoding.

    Joint -> float32 [sum(lengths), dim]: each modality's length includes its
    prepended global token; position 0 gets zeros, positions 1..t get
    ``pe[linspace(0, D-1, t)]`` with D the primary modality's frame count.
    ``separate`` (no global token) -> a list of [t_i, dim] arrays."""
    pe = sinusoid_table(max_len, dim)
    if separate:
        return [pe[_align_indices(modal_lengths[0], t)] for t in modal_lengths]
    d_primary = modal_lengths[0] - 1
    parts = []
    for length in modal_lengths:
        t = length - 1
        block = np.zeros((t + 1, dim), dtype=np.float32)
        block[1:] = pe[_align_indices(d_primary, t)]
        parts.append(block)
    return np.concatenate(parts, axis=0)


def temporal_embedding_indices(modal_lengths: Sequence[int]) -> np.ndarray:
    """Index map of the learned ``TemporalEmbedding`` -> int64 [sum(lengths)]:
    per modality ``concat([0], linspace(1, D, t))`` with D the primary
    modality's frame count; the global token sits at index 0."""
    d_primary = modal_lengths[0] - 1
    parts = []
    for length in modal_lengths:
        parts.append(np.concatenate(
            [np.zeros(1, dtype=np.int64),
             np.linspace(1, d_primary, length - 1).astype(np.int64)]))
    return np.concatenate(parts, axis=0)


class TemporalEmbedding(nn.Module):
    """Learned temporal table (512 rows); key ``temp_emb.embedding.weight``."""

    def __init__(self, dim: int, max_len: int = 512, *, device=None):
        super().__init__()
        self.embedding = nn.Embedding(max_len, dim, device=device)

    def forward(self, indices: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        w = self.embedding.weight
        return w.to(dtype)[torch.as_tensor(indices, device=w.device)]


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
    learned rows, so it is part of the ``state_dict``), then dropout in
    training mode."""

    def __init__(self, dim: int, max_len: int = 5000, dropout_rate: float = 0.0, *,
                 rng=None, device=None):
        super().__init__()
        self.register_buffer(
            "pos_embedding",
            torch.as_tensor(sinusoid_table(max_len, dim), device=device))
        self.dropout = Dropout(dropout_rate, rng)

    def forward(self, token_embedding: torch.Tensor) -> torch.Tensor:
        s = token_embedding.shape[1]
        return self.dropout(
            token_embedding + self.pos_embedding[:s].to(token_embedding.dtype))

    def at_position(self, token_embedding: torch.Tensor, idx: int) -> torch.Tensor:
        """PE for one decode step at position ``idx`` ([B, 1, E])."""
        row = self.pos_embedding[idx].to(token_embedding.dtype)
        return token_embedding + row


class GRU(nn.Module):
    """One-layer GRU that returns its final hidden state, with ``nn.GRU``'s
    parameter names, layout and gate math (gate order r, z, n):

      r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
      z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
      n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
      h' = (1 - z) * n + z * h

    ``bidirectional`` adds the ``*_reverse`` parameters of the backward
    direction, which runs over the flipped sequence."""

    def __init__(self, dim: int, hidden: int, bidirectional: bool = False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.hidden, self.dtype, self.bidirectional = hidden, dtype, bidirectional
        for suffix in ("", "_reverse") if bidirectional else ("",):
            for name, shape in (("weight_ih_l0", (3 * hidden, dim)),
                                ("weight_hh_l0", (3 * hidden, hidden)),
                                ("bias_ih_l0", (3 * hidden,)),
                                ("bias_hh_l0", (3 * hidden,))):
                p = torch.empty(shape, device=device)
                nn.init.uniform_(p, -1.0 / math.sqrt(hidden), 1.0 / math.sqrt(hidden))
                self.register_parameter(name + suffix, nn.Parameter(p))

    def forward(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """x [B, T, E] -> the final hidden state [B, hidden] of one direction."""
        dt = self.dtype
        suffix = "_reverse" if reverse else ""
        w_ih, w_hh, b_ih, b_hh = (getattr(self, n + suffix).to(dt) for n in
                                  ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                                   "bias_hh_l0"))
        xw = torch.nn.functional.linear(x.to(dt), w_ih, b_ih)  # [B, T, 3H]
        if reverse:
            xw = xw.flip(1)
        h = torch.zeros((x.shape[0], self.hidden), dtype=dt, device=x.device)
        for t in range(xw.shape[1]):
            hw = torch.nn.functional.linear(h, w_hh, b_hh)
            xr, xz, xn = xw[:, t].chunk(3, dim=-1)
            hr, hz, hn = hw.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
        return h


class GlobalAggregation(nn.Module):
    """Per-modality global feature [B, T, E] -> [B, 1, E]: ``avg`` / ``max``
    pooling, masked over padding unless ``quirk_unmasked`` (the reference
    pools over padded steps), or the final state of a GRU (key ``agg``) run
    over the whole padded sequence, as in the reference; ``biGRU`` sums the
    final states of the two directions."""

    def __init__(self, method: str, dim: int = 0, quirk_unmasked: bool = False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        if method not in ("max", "avg", "GRU", "biGRU"):
            raise ValueError(f"unsupported aggregation: {method}")
        self.method, self.quirk_unmasked = method, quirk_unmasked
        if method in ("GRU", "biGRU"):
            self.agg = GRU(dim, dim, bidirectional=method == "biGRU", dtype=dtype,
                           device=device)

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.quirk_unmasked:
            padding_mask = None
        if self.method == "avg":
            if padding_mask is None:
                return x.mean(dim=1, keepdim=True)
            keep = (~padding_mask)[..., None].to(x.dtype)
            return (x * keep).sum(dim=1, keepdim=True) / torch.clamp(
                keep.sum(dim=1, keepdim=True), min=1.0)
        if self.method == "max":
            if padding_mask is not None:
                x = x.masked_fill(padding_mask[..., None], torch.finfo(x.dtype).min)
            return x.max(dim=1, keepdim=True).values
        if self.method == "GRU":
            return self.agg(x)[:, None, :]
        return (self.agg(x) + self.agg(x, reverse=True))[:, None, :]
