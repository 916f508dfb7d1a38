"""MMT4Caption, caption task (port of ``vct_tpu/models/mmt4caption.py``):
the MME video encoder plus the caption decoder, with the decoding primitives
``encode`` / ``init_cache`` / ``decode_step``. The matching head and the
match/cross task forwards come later."""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from vct_tpu.config import ModelConfig, TPUConfig
from vct_tpu_torch.models.decoder import CapDecoder
from vct_tpu_torch.models.encoder import MultiModalEncoder

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MMT4Caption(nn.Module):
    def __init__(self, config: ModelConfig, tpu: TPUConfig = TPUConfig(), *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.config, self.tpu, self.dtype = config, tpu, dtype
        ve, cd = config.video_encoder, config.caption_decoder
        if ve.type != "mme":
            raise NotImplementedError(
                f"video encoder {ve.type!r} is not ported yet (only 'mme')")
        self.video_encoder = MultiModalEncoder(
            config.modal_shape, config.embed_dim, ve.nhead, ve.feedforward,
            config.activation, global_type=ve.mme.aggregation,
            modal_different=ve.mme.modal_different,
            temporal_type=ve.mme.temporal, do_norm=ve.mme.do_norm,
            quirk_unmasked_agg=tpu.quirk_unmasked_aggregation,
            num_encoder_layers=int(ve.layer), dtype=dtype, device=device)
        self.cap_decoder = CapDecoder(
            cd.layer, config.embed_dim, cd.nhead, cd.feedforward,
            config.vocab_size, pad_id=config.pad_id,
            activation=config.activation,
            quirk_no_memory_mask=tpu.quirk_no_memory_mask_in_decoder,
            dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MMT4Caption":
        """Random weights from ``generator`` (a CPU generator; values are
        drawn on the host and copied, so a seed gives the same weights on
        every device). Xavier-uniform matrices, LeCun-normal vocab
        projection, N(0, 1) embeddings, zero biases, unit LayerNorms."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            parent = self.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(parent, nn.LayerNorm):
                val = torch.ones(p.shape) if leaf == "weight" else torch.zeros(p.shape)
            elif "bias" in leaf:
                val = torch.zeros(p.shape)
            elif isinstance(parent, nn.Embedding):
                val = torch.randn(p.shape, generator=generator)
            elif name == "cap_decoder.generator.weight":
                val = torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[1])
            else:
                fan_out, fan_in = p.shape  # torch layout [out, in]
                a = math.sqrt(6.0 / (fan_in + fan_out))
                val = (torch.rand(p.shape, generator=generator) * 2 - 1) * a
            p.copy_(val.to(p.dtype))
        return self

    @torch.no_grad()
    def to_compute_dtype(self) -> "MMT4Caption":
        """Cast every weight except the LayerNorm parameters to the compute
        dtype once (the reference casts them at each use; the values are the
        same), so inference does not re-cast weights every token."""
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                continue
            for name, p in mod.named_parameters(recurse=False):
                p.data = p.data.to(self.dtype)
            for name, b in mod.named_buffers(recurse=False):
                setattr(mod, name, b.to(self.dtype))
        return self

    def encode(self, video_feats: List[torch.Tensor],
               video_masks: Optional[List[torch.Tensor]] = None):
        """Encoder-only forward -> (memory, memory_pad_mask, agg)."""
        return self.video_encoder(video_feats, video_masks)

    def init_cache(self, batch: int, max_len: int, memory: torch.Tensor):
        return self.cap_decoder.init_cache(batch, max_len, memory)

    def decode_step(self, tokens, caches, idx: int, memory_padding_mask=None, *,
                    return_attn: bool = False):
        return self.cap_decoder.decode_step(tokens, caches, idx, memory_padding_mask,
                                            return_attn=return_attn)
