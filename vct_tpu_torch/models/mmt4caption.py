"""MMT4Caption (port of ``vct_tpu/models/mmt4caption.py``): a video encoder
(MME, HMME or SimpleSep by ``video_encoder.type``), the caption decoder and,
when ``model.matching`` is configured, the matching head, built eagerly as
the reference builds it (its checkpoints carry ``matching.*`` whatever the
task). Task forwards: ``caption_loss`` / ``caption_loss_parts`` /
``caption_logits``, ``match_loss``, ``cross_loss`` / ``cross_loss_parts``
(``beta * cap + (1 - beta) * match``, ``MMT4Caption.py:143``); the text
features of the match and cross tasks come from a frozen encoder outside the
model (``vct_tpu_torch.clip.text.build_text_encoder``). Decoding primitives:
``encode`` / ``init_cache`` / ``decode_step``. ``model.train()`` turns
dropout on (rate ``config.dropout``) and ``set_dropout_generator`` says where
its masks come from."""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from vct_tpu_torch.config import ModelConfig, TPUConfig
from vct_tpu_torch.models.decoder import CapDecoder
from vct_tpu_torch.models.encoder import HMMEncoder, MultiModalEncoder, SimpleSepEncoder
from vct_tpu_torch.models.layers import DropoutRng
from vct_tpu_torch.models.matching import Matching

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def text_encoder_dim(text_enc_type: str) -> int:
    """The frozen text encoder's feature width: CLIP ViT-B/32's text dim or
    BERT's CLS dim (reference ``TextEncoder.py:16,22``)."""
    if "CLIP" in text_enc_type:
        return 512
    if "bert" in text_enc_type:
        return 768
    raise ValueError(f"unsupported text_enc_type: {text_enc_type}")


class MMT4Caption(nn.Module):
    def __init__(self, config: ModelConfig, tpu: TPUConfig = TPUConfig(), *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.config, self.tpu, self.dtype = config, tpu, dtype
        ve, cd = config.video_encoder, config.caption_decoder
        self.dropout_rng = DropoutRng()
        common = dict(dropout_rate=config.dropout, rng=self.dropout_rng,
                      use_kernels=tpu.use_pallas_attention, dtype=dtype, device=device)
        args = (config.modal_shape, config.embed_dim, ve.nhead, ve.feedforward,
                config.activation)
        if ve.type == "simple":
            self.video_encoder = SimpleSepEncoder(*args, num_encoder_layers=int(ve.layer),
                                                  **common)
        else:
            front = dict(global_type=ve.mme.aggregation,
                         modal_different=ve.mme.modal_different,
                         temporal_type=ve.mme.temporal, do_norm=ve.mme.do_norm,
                         quirk_unmasked_agg=tpu.quirk_unmasked_aggregation)
            if ve.type == "hmme":
                layers = ve.layer if isinstance(ve.layer, (tuple, list)) else (ve.layer,)
                self.video_encoder = HMMEncoder(*args, num_encoder_layers=tuple(layers),
                                                **front, **common)
            else:
                self.video_encoder = MultiModalEncoder(
                    *args, num_encoder_layers=int(ve.layer), **front, **common)
        self.cap_decoder = CapDecoder(
            cd.layer, config.embed_dim, cd.nhead, cd.feedforward,
            config.vocab_size, pad_id=config.pad_id,
            activation=config.activation,
            quirk_no_memory_mask=tpu.quirk_no_memory_mask_in_decoder,
            dropout_rate=config.dropout, rng=self.dropout_rng,
            sce_loss_alpha=cd.sce_loss_alpha, use_fused_loss=tpu.use_fused_loss,
            fused_loss_kernels=tpu.fused_loss_pallas,
            use_kernels=tpu.use_pallas_attention, dtype=dtype, device=device)
        self.matching = None
        if config.matching is not None:
            m = config.matching
            self.matching = Matching(config.embed_dim, text_encoder_dim(config.text_enc_type),
                                     m.matching_loss, m.enable_tem, m.temperature,
                                     dtype=dtype, device=device)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Every dropout mask of this model is drawn from ``generator`` (on
        the model's device); ``None`` means torch's default generator."""
        self.dropout_rng.generator = generator

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MMT4Caption":
        """Random weights from ``generator`` (a CPU generator; values are
        drawn on the host and copied, so a seed gives the same weights on
        every device). Xavier-uniform matrices, LeCun-normal vocab
        projection, N(0, 1) embeddings, zero biases, unit LayerNorms and
        matching temperature."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            parent = self.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(parent, nn.LayerNorm):
                val = torch.ones(p.shape) if leaf == "weight" else torch.zeros(p.shape)
            elif "bias" in leaf:
                val = torch.zeros(p.shape)
            elif leaf == "temperature":
                val = torch.ones(p.shape)
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

    # ---- task forwards -------------------------------------------------------

    def caption_loss(self, video_feats: List[torch.Tensor],
                     video_masks: Optional[List[torch.Tensor]], token_ids: torch.Tensor,
                     token_pad_mask: torch.Tensor, *,
                     row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Caption task -> scalar loss; ``row_valid`` [B] bool excludes
        collate filler rows."""
        memory, mem_mask, _ = self.video_encoder(video_feats, video_masks)
        _, loss, _ = self.cap_decoder(memory, token_ids, token_pad_mask, mem_mask,
                                      row_valid=row_valid, loss_only=True)
        return loss

    def caption_loss_parts(self, video_feats, video_masks, token_ids, token_pad_mask, *,
                           row_valid=None):
        """-> (ce_sum, ce_n, rce_sum, rce_n), for a validation loss that does
        not depend on how the split was batched."""
        memory, mem_mask, _ = self.video_encoder(video_feats, video_masks)
        _, parts, _ = self.cap_decoder(memory, token_ids, token_pad_mask, mem_mask,
                                       row_valid=row_valid, return_parts=True,
                                       loss_only=True)
        return parts

    def caption_logits(self, video_feats, video_masks, token_ids, token_pad_mask, *,
                       return_attn: bool = False):
        """-> (logits [B, S-1, V], loss, attn or None)."""
        memory, mem_mask, _ = self.video_encoder(video_feats, video_masks)
        return self.cap_decoder(memory, token_ids, token_pad_mask, mem_mask,
                                return_attn=return_attn)

    def _matching(self) -> Matching:
        if self.matching is None:
            raise ValueError("the match and cross tasks need model.matching in the config")
        return self.matching

    def match_loss(self, video_feats, video_masks, text_feat: torch.Tensor, *,
                   row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Match task (``MMT4Caption.py:123-130``): contrastive loss between
        the frozen text features and the encoder's aggregate feature.
        ``row_valid`` restricts anchors and negatives to the real sub-batch."""
        matching = self._matching()
        _, _, agg = self.video_encoder(video_feats, video_masks)
        return matching(text_feat, agg, valid=row_valid)

    def cross_loss(self, video_feats, video_masks, token_ids, token_pad_mask,
                   text_feat: torch.Tensor, *, row_valid: Optional[torch.Tensor] = None):
        """Cross task (``MMT4Caption.py:132-144``) -> (loss, cap_loss, match_loss)."""
        matching = self._matching()
        memory, mem_mask, agg = self.video_encoder(video_feats, video_masks)
        _, cap_loss, _ = self.cap_decoder(memory, token_ids, token_pad_mask, mem_mask,
                                          row_valid=row_valid, loss_only=True)
        match_loss = matching(text_feat, agg, valid=row_valid)
        beta = self.config.loss_beta
        return beta * cap_loss + (1.0 - beta) * match_loss, cap_loss, match_loss

    def cross_loss_parts(self, video_feats, video_masks, token_ids, token_pad_mask,
                         text_feat: torch.Tensor, *, row_valid=None):
        """-> (ce_sum, ce_n, rce_sum, rce_n, match_loss), for validation."""
        matching = self._matching()
        memory, mem_mask, agg = self.video_encoder(video_feats, video_masks)
        _, parts, _ = self.cap_decoder(memory, token_ids, token_pad_mask, mem_mask,
                                       row_valid=row_valid, return_parts=True,
                                       loss_only=True)
        return tuple(parts) + (matching(text_feat, agg, valid=row_valid),)

    # ---- decoding primitives ---------------------------------------------------

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
