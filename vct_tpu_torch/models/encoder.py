"""Video encoders: MME (default), HMME, SimpleSep (port of
``vct_tpu/models/encoder.py``).

Shared recipe: per-modality Linear dim-unify -> prepend a global-aggregation
token -> add temporal (+ modal) embeddings -> concatenate modalities ->
Transformer encoder -> (memory, pad mask, aggregate feature). Masks are True =
padding; the prepended global slot is always valid. SimpleSep runs one
independent encoder per modality with no global token and returns no mask and
no aggregate feature (caption task only). HMME's aggregate feature is the sum
of the per-modality global tokens [B, E], the reference's documented intent.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from vct_tpu_torch.models.embeddings import (
    GlobalAggregation,
    ModalEmbedding,
    TemporalEmbedding,
    temporal_embedding_indices,
    temporal_encoding,
)
from vct_tpu_torch.models.layers import (
    Dropout,
    TransformerEncoder,
    TransformerEncoderLayer,
    layer_norm,
    linear,
)
from vct_tpu_torch.ops.attention import padding_bias


class _MMEBase(nn.Module):
    """The unify / aggregate / embed front end shared by MME and HMME."""

    def __init__(self, d_feats: Sequence[int], d_model: int, *,
                 global_type: str = "avg", modal_different: bool = True,
                 temporal_type: str = "encoding", do_norm: bool = False,
                 quirk_unmasked_agg: bool = False, dropout_rate: float = 0.0, rng=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if temporal_type not in ("encoding", "embedding"):
            raise ValueError(f"unsupported temporal type: {temporal_type}")
        self.d_model, self.dtype, self.do_norm = d_model, dtype, do_norm
        self.temporal_type = temporal_type
        self.num_modal = len(d_feats)
        self.unify = nn.ModuleList(nn.Linear(d, d_model, device=device)
                                   for d in d_feats)
        self.global_agg = GlobalAggregation(global_type, d_model, quirk_unmasked_agg,
                                            dtype=dtype, device=device)
        if temporal_type == "embedding":
            self.temp_emb = TemporalEmbedding(d_model, device=device)
        if self.num_modal > 1:
            self.modal_emb = ModalEmbedding(self.num_modal, d_model,
                                            modal_different, device=device)
        if do_norm:
            # the reference's pre-encoder LayerNorm (key ``norm``)
            self.norm = nn.LayerNorm(d_model, eps=1e-5, device=device)
            self.pre_dropout = Dropout(dropout_rate, rng)

    def _front_end(self, srcs: List[torch.Tensor],
                   padding_masks: Optional[List[torch.Tensor]]):
        """-> (fused [B, sum(1 + T_m), E], pad mask or None, per-modal lengths)."""
        dt = self.dtype
        uni = [linear(src, lin.weight, lin.bias, dt)
               for src, lin in zip(srcs, self.unify)]
        per_modal = []
        for i, f in enumerate(uni):
            mask_i = padding_masks[i] if padding_masks is not None else None
            per_modal.append(torch.cat([self.global_agg(f, mask_i), f], dim=1))
        lengths = [int(f.shape[1]) for f in per_modal]

        fused_mask = None
        if padding_masks is not None:
            fused_mask = torch.cat(
                [torch.cat([torch.zeros_like(m[:, :1]), m], dim=1)
                 for m in padding_masks], dim=1)

        if self.temporal_type == "embedding":
            temp = self.temp_emb(temporal_embedding_indices(lengths), dt)
        else:
            temp = torch.as_tensor(temporal_encoding(lengths, self.d_model),
                                   device=uni[0].device).to(dt)
        fused = torch.cat(per_modal, dim=1) + temp[None]
        if self.num_modal > 1:
            fused = fused + self.modal_emb(lengths, dt)[None]
        if self.do_norm:
            fused = self.pre_dropout(layer_norm(fused, self.norm, dt))
        return fused, fused_mask, lengths


class MultiModalEncoder(_MMEBase):
    """MME -> (memory [B, sum(1 + T), E], pad mask, memory[:, 0])."""

    def __init__(self, d_feats: Sequence[int], d_model: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "gelu", *,
                 num_encoder_layers: int = 1, dropout_rate: float = 0.0, rng=None,
                 use_kernels: bool = False, dtype=torch.float32, device=None, **front):
        super().__init__(d_feats, d_model, dropout_rate=dropout_rate, rng=rng, dtype=dtype,
                         device=device, **front)
        self.transformer_encoder = TransformerEncoder(
            num_encoder_layers, d_model, nhead, dim_feedforward, activation,
            dropout_rate, rng=rng, use_kernels=use_kernels, dtype=dtype, device=device)

    def forward(self, srcs: List[torch.Tensor],
                padding_masks: Optional[List[torch.Tensor]] = None):
        fused, fused_mask, _ = self._front_end(srcs, padding_masks)
        memory = self.transformer_encoder(fused, padding_bias(fused_mask))
        return memory, fused_mask, memory[:, 0]


class HMMEncoder(_MMEBase):
    """Hierarchical MME: one shared stack of ``max(layers)`` bare layers (key
    ``trans_enc_layers``, no final LayerNorm); modality j's input is reset to
    its embedded original until its entry layer ``max(layers) - layers[j]``,
    then flows through the remaining layers."""

    def __init__(self, d_feats: Sequence[int], d_model: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "gelu", *,
                 num_encoder_layers: Sequence[int] = (1,), dropout_rate: float = 0.0,
                 rng=None, use_kernels: bool = False, dtype=torch.float32, device=None,
                 **front):
        super().__init__(d_feats, d_model, dropout_rate=dropout_rate, rng=rng, dtype=dtype,
                         device=device, **front)
        self.num_encoder_layers = tuple(int(n) for n in num_encoder_layers)
        self.trans_enc_layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, activation,
                                    dropout_rate, rng=rng, use_kernels=use_kernels,
                                    dtype=dtype, device=device)
            for _ in range(max(self.num_encoder_layers)))

    def forward(self, srcs: List[torch.Tensor],
                padding_masks: Optional[List[torch.Tensor]] = None):
        fused, fused_mask, lengths = self._front_end(srcs, padding_masks)
        bias = padding_bias(fused_mask)
        depth = max(self.num_encoder_layers)
        target_layer = [depth - n for n in self.num_encoder_layers]
        ori_parts = list(torch.split(fused, lengths, dim=1))
        last_parts = list(ori_parts)
        for i, layer in enumerate(self.trans_enc_layers):
            inputs = [last_parts[j] if target_layer[j] < i else ori_parts[j]
                      for j in range(self.num_modal)]
            last_parts = list(torch.split(layer(torch.cat(inputs, dim=1), bias), lengths,
                                          dim=1))
        memory = torch.cat(last_parts, dim=1)
        agg = sum(part[:, 0] for part in last_parts)
        return memory, fused_mask, agg


class SimpleSepEncoder(nn.Module):
    """One independent encoder per modality (key ``transformer_encoders``)
    -> (concatenated memories, None, None)."""

    def __init__(self, d_feats: Sequence[int], d_model: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "gelu", *,
                 num_encoder_layers: int = 1, dropout_rate: float = 0.0, rng=None,
                 use_kernels: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        self.num_modal = len(d_feats)
        self.unify = nn.ModuleList(nn.Linear(d, d_model, device=device)
                                   for d in d_feats)
        self.transformer_encoders = nn.ModuleList(
            TransformerEncoder(num_encoder_layers, d_model, nhead, dim_feedforward,
                               activation, dropout_rate, rng=rng, use_kernels=use_kernels,
                               dtype=dtype, device=device)
            for _ in d_feats)

    def forward(self, srcs: List[torch.Tensor],
                padding_masks: Optional[List[torch.Tensor]] = None):
        dt = self.dtype
        uni = [linear(src, lin.weight, lin.bias, dt)
               for src, lin in zip(srcs, self.unify)]
        temp = temporal_encoding([int(f.shape[1]) for f in uni], self.d_model,
                                 separate=True)
        memories = []
        for i, (f, te) in enumerate(zip(uni, temp)):
            bias = padding_bias(padding_masks[i]) if padding_masks is not None else None
            te = torch.as_tensor(te, device=f.device).to(dt)
            memories.append(self.transformer_encoders[i](f + te[None], bias))
        return torch.cat(memories, dim=1), None, None
