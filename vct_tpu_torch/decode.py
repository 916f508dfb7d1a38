"""Autoregressive caption decoding: greedy and beam search (port of
``vct_tpu/decode.py``).

Semantics kept for metric parity: start token [CLS], stop token [SEP];
finished rows keep receiving argmax tokens until every row has finished
(truncation at the first [SEP] happens at detokenization), and from then on
every token is [PAD] — the reference's early exit. The host checks for that
early exit once per 8 steps, so the device is not stalled every token.

Beam search is fixed-width with frozen finished beams and the GNMT length
penalty; among equal candidates the lowest flat index wins, as
``jax.lax.top_k`` has it (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

from vct_tpu_torch.ops.decode_kernels import NEG_INF, topk_first_win


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
    path when attention maps are collected or the model has its kernels off
    (``tpu.use_pallas_attention`` false). The kernel weights are extracted
    once, at the first call: load the checkpoint before decoding."""

    def module_fn(video_feats, video_masks):
        return greedy_generate(model, video_feats, video_masks, max_len=max_len,
                               start_id=start_id, end_id=end_id,
                               collect_attn=collect_attn)

    if collect_attn or not model.tpu.use_pallas_attention:
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


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------


def _flatten_beam(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + x.shape[2:])


def _unflatten_beam(x: torch.Tensor, b: int, k: int) -> torch.Tensor:
    return x.reshape((b, k) + x.shape[1:])


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...], idx [B, K'] -> [B, K', ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def beam_start(b: int, k: int, max_len: int, start_id: int, pad_id: int, dev):
    """-> (tokens [B, K, max_len], scores [B, K], finished, lengths): only
    beam 0 is live at first (all beams are identical at step 0)."""
    tokens = torch.full((b, k, max_len), pad_id, dtype=torch.int32, device=dev)
    tokens[:, :, 0] = start_id
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lengths = torch.ones((b, k), dtype=torch.int32, device=dev)  # token count incl. start
    return tokens, scores, finished, lengths


def beam_advance(tokens, finished, lengths, beam_idx, tok_idx, i: int, end_id: int):
    """One step's bookkeeping: the three states are gathered by ``beam_idx``
    BEFORE the new token is written and ``finished`` is updated."""
    tokens = _gather_beams(tokens, beam_idx)
    finished = _gather_beams(finished, beam_idx)
    lengths = _gather_beams(lengths, beam_idx)
    tokens[:, :, i + 1] = tok_idx
    lengths = torch.where(finished, lengths, lengths + 1)
    finished = finished | (tok_idx == end_id)
    return tokens, finished, lengths


def beam_select(tokens, scores, lengths, length_penalty: float):
    """The beam that maximises score / length**length_penalty (GNMT;
    ``length_penalty=0`` is the raw log-probability) -> (tokens [B, max_len],
    scores [B])."""
    norm = torch.pow(lengths.float(), length_penalty)
    final = scores / norm.clamp(min=1.0)
    best = torch.argmax(final, dim=1, keepdim=True)  # first index of the max
    return _gather_beams(tokens, best)[:, 0], torch.gather(final, 1, best)[:, 0]


@torch.no_grad()
def beam_generate(model, video_feats: Sequence[torch.Tensor],
                  video_masks: Optional[Sequence[torch.Tensor]], *, beam_size: int = 4,
                  max_len: int = 30, start_id: int = 101, end_id: int = 102,
                  pad_id: Optional[int] = None, length_penalty: float = 0.6):
    """Fixed-width beam search on the module path -> (tokens [B, max_len]
    int32, scores [B]).

    Finished beams are frozen: they can only emit [PAD] with log-prob 0, so
    their score is kept while live beams go on. The host tests "every beam
    has finished" once per 8 steps, not every token as the reference does;
    that is exact, because in the extra steps every beam is frozen and adds
    [PAD] at zero cost: scores, lengths and the tokens up to there do not
    change, and the positions past them hold [PAD] either way."""
    if pad_id is None:
        pad_id = model.config.pad_id
    k = beam_size
    memory, mem_mask, _ = model.encode(list(video_feats),
                                       list(video_masks) if video_masks else None)
    b, t_mem, e = memory.shape
    dev = memory.device
    # the memory once per beam; one video's beams are contiguous rows
    memory_k = _flatten_beam(memory[:, None].expand(b, k, t_mem, e))
    mem_mask_k = None
    if mem_mask is not None:
        mem_mask_k = _flatten_beam(mem_mask[:, None].expand(b, k, t_mem))
    caches = model.init_cache(b * k, max_len, memory_k)
    tokens, scores, finished, lengths = beam_start(b, k, max_len, start_id, pad_id, dev)
    vocab = model.config.vocab_size
    frozen = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=dev)
    frozen[pad_id] = 0.0
    batch_base = torch.arange(b, device=dev)[:, None] * k

    for i in range(max_len - 1):
        logits, caches, _ = model.decode_step(_flatten_beam(tokens)[:, i], caches, i,
                                              mem_mask_k)
        logp = _unflatten_beam(torch.log_softmax(logits.float(), dim=-1), b, k)
        logp = torch.where(finished[..., None], frozen, logp)
        cand = scores[..., None] + logp  # [B, K, V]
        scores, top_idx = topk_first_win(cand.reshape(b, k * vocab), k)
        beam_idx = top_idx // vocab
        tok_idx = (top_idx % vocab).to(torch.int32)
        tokens, finished, lengths = beam_advance(tokens, finished, lengths, beam_idx,
                                                 tok_idx, i, end_id)
        # only the self-attention cache depends on the beam's identity; the
        # cross K/V are the same for every beam of a video
        flat = (batch_base + beam_idx).reshape(-1)
        for cache in caches:
            cache["k"] = cache["k"].index_select(0, flat)
            cache["v"] = cache["v"].index_select(0, flat)
        if i % 8 == 7 and bool(finished.all()):
            break
    return beam_select(tokens, scores, lengths, length_penalty)


def make_beam_fn(model, max_len: int, start_id: int, end_id: int, beam_size: int,
                 length_penalty: float = 0.6) -> Callable:
    """fn(feats, masks) -> (tokens, scores) on the module path."""

    def fn(video_feats, video_masks):
        return beam_generate(model, video_feats, video_masks, beam_size=beam_size,
                             max_len=max_len, start_id=start_id, end_id=end_id,
                             length_penalty=length_penalty)

    return fn


def make_auto_beam_fn(model, max_len: int, start_id: int, end_id: int, beam_size: int,
                      length_penalty: float = 0.6) -> Callable:
    """fn(feats, masks) -> (tokens, scores): beam search on the decode kernels
    (``decode_fast.beam_generate_fused``: one stack launch and one
    norm/generator/top-k launch per token; on CPU tensors their plain
    versions), or on the module path when the model has its kernels off
    (``tpu.use_pallas_attention`` false). On a card a beam wider than the
    top-k kernel carries raises ``ValueError``; it never falls to the module
    path. The kernel weights are extracted once, at the first call: load the
    checkpoint before decoding. One process drives one device; the sharded
    variants come with the multi-device slice."""
    if not model.tpu.use_pallas_attention:
        return make_beam_fn(model, max_len, start_id, end_id, beam_size, length_penalty)

    from vct_tpu_torch.decode_fast import extract_fast_weights, make_fused_beam_fn

    weights = {}

    def fn(video_feats, video_masks):
        if "fn" not in weights:
            weights["fn"] = make_fused_beam_fn(model, max_len, start_id, end_id, beam_size,
                                               length_penalty,
                                               fw=extract_fast_weights(model))
        return weights["fn"](video_feats, video_masks)

    return fn


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


def pipelined_map(launch: Callable, batches: Iterable, *, depth: int = 2) -> Iterator:
    """Map ``launch(batch) -> device tensor`` over ``batches``, keeping
    ``depth`` launched results unfetched after each yield (so ``depth + 1``
    are briefly in flight); yields ``(batch, host tensor)`` in submission
    order. Each result's copy to pinned host memory is enqueued right behind
    its launch (non-blocking), and waited for only when its turn to be
    yielded comes, so the host detokenises one batch while the device decodes
    the next. On CPU tensors the results pass through as they are."""
    q: deque = deque()

    def enqueue(b):
        r = launch(b)
        if not r.is_cuda:
            return b, r, None
        host = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
        host.copy_(r, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(r.device))
        return b, host, done

    def fetch(item):
        b, host, done = item
        if done is not None:
            done.synchronize()
        return b, host

    for b in batches:
        q.append(enqueue(b))
        if len(q) > depth:
            yield fetch(q.popleft())
    while q:
        yield fetch(q.popleft())
