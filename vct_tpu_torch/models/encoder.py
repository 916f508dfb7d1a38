"""The MME video encoder (port of ``vct_tpu/models/encoder.py:56-179``).

per-modality Linear dim-unify -> prepend a global-aggregation token -> add the
fixed temporal (+ modal) embeddings -> concatenate modalities -> Transformer
encoder -> (memory, pad mask, memory[:, 0]). Masks are True = padding; the
prepended global slot is always valid. SimpleSep and HMME come later.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from vct_tpu_torch.models.embeddings import (
    GlobalAggregation,
    ModalEmbedding,
    temporal_encoding,
)
from vct_tpu_torch.models.layers import Dropout, TransformerEncoder, layer_norm, linear
from vct_tpu_torch.ops.attention import padding_bias


class MultiModalEncoder(nn.Module):
    def __init__(self, d_feats: Sequence[int], d_model: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "gelu", *,
                 global_type: str = "avg", modal_different: bool = True,
                 temporal_type: str = "encoding", do_norm: bool = False,
                 quirk_unmasked_agg: bool = False, num_encoder_layers: int = 1,
                 dropout_rate: float = 0.0, rng=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if temporal_type != "encoding":
            raise NotImplementedError(
                f"temporal type {temporal_type!r} is not ported yet")
        self.d_model, self.dtype, self.do_norm = d_model, dtype, do_norm
        self.num_modal = len(d_feats)
        self.unify = nn.ModuleList(nn.Linear(d, d_model, device=device)
                                   for d in d_feats)
        self.global_agg = GlobalAggregation(global_type, quirk_unmasked_agg)
        if self.num_modal > 1:
            self.modal_emb = ModalEmbedding(self.num_modal, d_model,
                                            modal_different, device=device)
        if do_norm:
            # the reference's pre-encoder LayerNorm (key ``norm``)
            self.norm = nn.LayerNorm(d_model, eps=1e-5, device=device)
            self.pre_dropout = Dropout(dropout_rate, rng)
        self.transformer_encoder = TransformerEncoder(
            num_encoder_layers, d_model, nhead, dim_feedforward, activation,
            dropout_rate, rng=rng, dtype=dtype, device=device)

    def _front_end(self, srcs: List[torch.Tensor],
                   padding_masks: Optional[List[torch.Tensor]]):
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

        device = uni[0].device
        temp = torch.as_tensor(temporal_encoding(lengths, self.d_model),
                               device=device).to(dt)
        fused = torch.cat(per_modal, dim=1) + temp[None]
        if self.num_modal > 1:
            fused = fused + self.modal_emb(lengths, dt)[None]
        if self.do_norm:
            fused = self.pre_dropout(layer_norm(fused, self.norm, dt))
        return fused, fused_mask

    def forward(self, srcs: List[torch.Tensor],
                padding_masks: Optional[List[torch.Tensor]] = None):
        fused, fused_mask = self._front_end(srcs, padding_masks)
        memory = self.transformer_encoder(fused, padding_bias(fused_mask))
        return memory, fused_mask, memory[:, 0]
