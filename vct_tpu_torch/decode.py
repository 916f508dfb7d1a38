"""Greedy caption decoding (port of the greedy part of ``vct_tpu/decode.py``).

Semantics kept for metric parity: start token [CLS], stop token [SEP];
finished rows keep receiving argmax tokens until every row has finished
(truncation at the first [SEP] happens at detokenization), and from then on
every token is [PAD] — the reference's early exit. The host checks for that
early exit once per 8 steps, so the device is not stalled every token.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


@torch.no_grad()
def greedy_generate(model, video_feats: Sequence[torch.Tensor],
                    video_masks: Optional[Sequence[torch.Tensor]], *,
                    max_len: int = 30, start_id: int = 101, end_id: int = 102,
                    pad_id: Optional[int] = None, collect_attn: bool = False):
    """The module path -> (tokens [B, max_len] int32, attn or None); attn is
    [max_len-1, num_layers, B, T_mem] cross-attention per generated token."""
    if pad_id is None:
        pad_id = model.config.pad_id
    memory, mem_mask, _ = model.encode(list(video_feats),
                                       list(video_masks) if video_masks else None)
    b, t_mem = memory.shape[:2]
    dev = memory.device
    caches = model.init_cache(b, max_len, memory)
    tokens = torch.full((b, max_len), pad_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = start_id
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    all_done = torch.zeros((), dtype=torch.bool, device=dev)
    n_layers = model.config.caption_decoder.layer
    attn_buf = (torch.zeros((max_len - 1, n_layers, b, t_mem), device=dev)
                if collect_attn else None)
    for i in range(max_len - 1):
        logits, caches, attn = model.decode_step(tokens[:, i], caches, i, mem_mask,
                                                 return_attn=collect_attn)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(all_done, pad_id, nxt)
        if collect_attn:
            attn_buf[i] = torch.where(all_done, 0.0, attn[:, :, 0, :].float())
        tokens[:, i + 1] = nxt
        done |= nxt == end_id
        all_done = done.all()
        if i % 8 == 7 and bool(all_done):
            break
    return tokens, attn_buf


def make_auto_greedy_fn(model, max_len: int, start_id: int, end_id: int,
                        collect_attn: bool = False) -> Callable:
    """fn(feats, masks) -> (tokens, attn): the decode kernels
    (``decode_fast``; on CPU tensors their plain versions), or the module
    path when attention maps are collected. The kernel weights are extracted
    once, at the first call: load the checkpoint before decoding."""

    def module_fn(video_feats, video_masks):
        return greedy_generate(model, video_feats, video_masks, max_len=max_len,
                               start_id=start_id, end_id=end_id,
                               collect_attn=collect_attn)

    if collect_attn:
        return module_fn

    from vct_tpu_torch.decode_fast import extract_fast_weights, greedy_generate_fused

    weights = {}

    def fused_fn(video_feats, video_masks):
        if "fw" not in weights:
            weights["fw"] = extract_fast_weights(model)
        return greedy_generate_fused(model, video_feats, video_masks, max_len=max_len,
                                     start_id=start_id, end_id=end_id,
                                     fw=weights["fw"])

    return fused_fn


@torch.no_grad()
def first_mismatch_gaps(model, video_feats, video_masks, got: torch.Tensor,
                        want: torch.Tensor) -> List[Tuple[int, int, float]]:
    """For each row where two greedy decodes differ -> (row, position, gap):
    the top-2 logit gap of the module path at the first differing position,
    teacher-forced on the shared prefix. Two correct decodes that sum in
    different orders may part only where this gap is a rounding-sized
    near-tie."""
    got, want = got.to(torch.int64), want.to(torch.int64)
    diff = (got != want).to(torch.int32)
    rows = torch.nonzero(diff.any(dim=1)).flatten().tolist()
    if not rows:
        return []
    first = diff.argmax(dim=1)
    memory, mem_mask, _ = model.encode(list(video_feats),
                                       list(video_masks) if video_masks else None)
    max_len = got.shape[1]
    caches = model.init_cache(memory.shape[0], max_len, memory)
    gaps: Dict[int, float] = {}
    for i in range(max(int(first[r]) for r in rows)):
        logits, caches, _ = model.decode_step(want[:, i], caches, i, mem_mask)
        top = torch.topk(logits.float(), 2, dim=-1).values
        for r in rows:
            if int(first[r]) == i + 1:
                gaps[r] = float(top[r, 0] - top[r, 1])
    return [(r, int(first[r]), gaps[r]) for r in rows]


def detokenize_batch(tokenizer, tokens) -> List[str]:
    """Token-id matrix -> caption strings (reference truncation semantics)."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    return [tokenizer.decode_caption(row) for row in tokens]
