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

Over a mesh (``parallel.mesh``): with ``mesh`` given, each data rank decodes
its rows of the batch on the single-device route, with no collective inside
the decode, and the tokens are gathered in batch order. A model whose LM head
is split by vocab (tensor parallelism) decodes on the module path: greedy
merges the shards' (max, argmax) with ties to the lowest vocab index, beam
search the shards' top-k with the same rule, and the log-softmax takes its
normaliser from every shard.

A model with the LFM2 caption LM (``model.caption_lm``, ``models/lfm2.py``)
decodes greedily on its own eager loop (``lm_greedy_generate``: one prefill
of the video prefix and the start token, then a token at a time through its
cache); beam search and the fused routes refuse it (``refuse_caption_lm``).
"""

from __future__ import annotations

import functools
from collections import deque
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

from vct_tpu_torch import tracing
from vct_tpu_torch.graphs import StagedDecode, run_stages, stage_bounds
from vct_tpu_torch.ops.decode_kernels import NEG_INF, topk_first_win
from vct_tpu_torch.parallel.mesh import (
    all_reduce_max,
    all_reduce_sum,
    gather_rows,
    gather_shards,
    shard_batch,
)


def _head_tp(model):
    """The mesh of a vocab-split LM head, or None."""
    return model.cap_decoder.generator.tp


def _is_split(model) -> bool:
    """Whether tensor parallelism split any of the model's weights (the
    kernels take whole weights)."""
    return bool(getattr(model, "tp_split", None))


def merge_argmax(vals: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """Per-shard (max [M, B], whole-vocab argmax [M, B]) in vocab order ->
    the whole vocab's argmax [B]; among equal maxima the lowest shard, so the
    lowest index, wins."""
    best = torch.argmax(vals, dim=0, keepdim=True)  # first index of the max
    return torch.gather(idxs, 0, best)[0]


def merge_topk(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """Candidates [B, N] (values, whole indices), each shard's top-k side by
    side -> the top k (values, indices) [B, k] by value, ties to the lowest
    index (``topk_first_win`` over the whole)."""
    order = torch.sort(idxs, dim=1, stable=True).indices
    vals, idxs = torch.gather(vals, 1, order), torch.gather(idxs, 1, order)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(vals, 1, order), torch.gather(idxs, 1, order)


def vocab_argmax(model, logits: torch.Tensor) -> torch.Tensor:
    """argmax over the whole vocab (first index wins) of ``logits``, this
    rank's vocab shard when the LM head is split."""
    tp = _head_tp(model)
    if tp is None:
        return torch.argmax(logits, dim=-1)
    val, idx = torch.max(logits.float(), dim=-1)  # first index of the max
    idx = (idx + model.cap_decoder.generator.vocab_start).double()
    return merge_argmax(gather_shards(val[None], 0, tp),
                        gather_shards(idx[None], 0, tp)).long()


def vocab_log_softmax(model, logits: torch.Tensor) -> torch.Tensor:
    """float32 log-softmax over the whole vocab, for this rank's shard."""
    tp = _head_tp(model)
    z = logits.float()
    if tp is None:
        return torch.log_softmax(z, dim=-1)
    m = all_reduce_max(z.max(dim=-1, keepdim=True).values, tp.model_group)
    s = all_reduce_sum(torch.exp(z - m).sum(dim=-1, keepdim=True), tp.model_group)
    return z - (m + torch.log(s))


def _sharded_topk(model, cand: torch.Tensor, k: int):
    """``topk_first_win`` over [B, K, V] candidates whose vocab axis is this
    rank's shard -> (values [B, k], flat indices [B, k] over K x V_whole)."""
    tp = _head_tp(model)
    b, kk, v = cand.shape
    vals, flat = topk_first_win(cand.reshape(b, kk * v), k)
    if tp is None:
        return vals, flat
    whole = (flat // v) * (v * tp.model) + model.cap_decoder.generator.vocab_start + flat % v
    return merge_topk(gather_shards(vals, 1, tp),
                      gather_shards(whole.double(), 1, tp).long(), k)


def has_caption_lm(model) -> bool:
    return getattr(model, "caption_lm", None) is not None


def refuse_caption_lm(model, what: str) -> None:
    """Raise if ``model`` carries the LFM2 caption LM, which ``what`` does
    not run."""
    if has_caption_lm(model):
        raise ValueError(f"{what} does not run the LFM2 caption LM (model.caption_lm): it "
                         f"decodes greedily, eagerly (decode.make_auto_greedy_fn)")


@torch.no_grad()
def lm_greedy_generate(model, video_feats: Sequence[torch.Tensor],
                       video_masks: Optional[Sequence[torch.Tensor]], *, max_len: int = 30,
                       start_id: int = 101, end_id: int = 102, pad_id: Optional[int] = None,
                       collect_attn: bool = False):
    """Greedy decode of the LFM2 caption LM -> (tokens [B, max_len] int32,
    None), eagerly: the encoder, one prefill (``lm.prefill``), then one
    token at a time through the LM's cache (``lm.decode``), with the module
    path's rule for finished rows and its early exit checked once per 8
    tokens."""
    if collect_attn:
        raise ValueError("the LFM2 caption LM (model.caption_lm) keeps no attention maps")
    pad_id = model.config.pad_id if pad_id is None else pad_id
    memory, mem_mask, _ = model.encode(list(video_feats),
                                       list(video_masks) if video_masks else None)
    lm = model.cap_decoder
    b = memory.shape[0]
    tokens = torch.full((b, max_len), pad_id, dtype=torch.int32, device=memory.device)
    tokens[:, 0] = start_id
    done = torch.zeros((b,), dtype=torch.bool, device=memory.device)
    all_done = torch.zeros((), dtype=torch.bool, device=memory.device)
    with tracing.span("lm.prefill"):
        logits, cache = lm.prefill(memory, mem_mask, tokens[:, 0], max_len)
    with tracing.span("lm.decode"):
        for i in range(max_len - 1):
            nxt = torch.where(all_done, pad_id, logits.argmax(dim=-1).to(torch.int32))
            tokens[:, i + 1] = nxt
            done |= nxt == end_id
            all_done = done.all()
            if i + 2 == max_len or (i % 8 == 7 and bool(all_done)):
                break
            logits, cache = lm.decode_step(tokens[:, i + 1], cache)
    return tokens, None


def _greedy_start(model, st: dict, *, max_len: int, start_id: int, pad_id: int,
                  collect_attn: bool) -> None:
    """The module path's greedy state in ``st``, beside its inputs
    ``feats``/``masks``: the encoder's memory turned into the decoder's
    caches, ``tokens`` [B, max_len] ([start] then [PAD]), the rows' ``done``
    flags, ``all_done`` and, with ``collect_attn``, the zeroed ``attn``
    [max_len-1, num_layers, B, T_mem]."""
    memory, st["mem_mask"], _ = model.encode(st["feats"], st["masks"])
    b, t_mem = memory.shape[:2]
    dev = memory.device
    st["caches"] = model.init_cache(b, max_len, memory)
    tokens = st["tokens"] = torch.full((b, max_len), pad_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = start_id
    st["done"] = torch.zeros((b,), dtype=torch.bool, device=dev)
    st["all_done"] = torch.zeros((), dtype=torch.bool, device=dev)
    n_layers = model.config.caption_decoder.layer
    st["attn"] = (torch.zeros((max_len - 1, n_layers, b, t_mem), device=dev)
                  if collect_attn else None)


def _greedy_stage(model, st: dict, lo: int, hi: int, *, end_id: int, pad_id: int) -> None:
    """Tokens ``lo + 1 .. hi`` of the module path's greedy loop on ``st``.
    Nothing here waits for the device, so a CUDA graph can capture it."""
    caches, tokens, done, all_done, attn_buf = (st["caches"], st["tokens"], st["done"],
                                                st["all_done"], st["attn"])
    collect_attn = attn_buf is not None
    for i in range(lo, hi):
        logits, caches, attn = model.decode_step(tokens[:, i], caches, i, st["mem_mask"],
                                                 return_attn=collect_attn)
        nxt = vocab_argmax(model, logits).to(torch.int32)
        nxt = torch.where(all_done, pad_id, nxt)
        if collect_attn:
            attn_buf[i] = torch.where(all_done, 0.0, attn[:, :, 0, :].float())
        tokens[:, i + 1] = nxt
        done |= nxt == end_id
        all_done = done.all()
    st["caches"], st["all_done"] = caches, all_done


def _inputs(video_feats, video_masks) -> dict:
    return {"feats": list(video_feats), "masks": list(video_masks) if video_masks else None}


def _greedy_parts(model, max_len: int, start_id: int, end_id: int, pad_id: int,
                  collect_attn: bool):
    """(prologue, stages) of the module path's greedy loop."""

    def prologue(st):
        _greedy_start(model, st, max_len=max_len, start_id=start_id, pad_id=pad_id,
                      collect_attn=collect_attn)

    return prologue, [functools.partial(_greedy_stage, model, lo=lo, hi=hi, end_id=end_id,
                                        pad_id=pad_id)
                      for lo, hi, _ in stage_bounds(max_len)]


@torch.no_grad()
def greedy_generate(model, video_feats: Sequence[torch.Tensor],
                    video_masks: Optional[Sequence[torch.Tensor]], *,
                    max_len: int = 30, start_id: int = 101, end_id: int = 102,
                    pad_id: Optional[int] = None, collect_attn: bool = False):
    """The module path -> (tokens [B, max_len] int32, attn or None); attn is
    [max_len-1, num_layers, B, T_mem] cross-attention per generated token.
    Eager: the stages that ``make_greedy_fn`` captures, run in turn."""
    if has_caption_lm(model):
        return lm_greedy_generate(model, video_feats, video_masks, max_len=max_len,
                                  start_id=start_id, end_id=end_id, pad_id=pad_id,
                                  collect_attn=collect_attn)
    prologue, stages = _greedy_parts(model, max_len, start_id, end_id,
                                     model.config.pad_id if pad_id is None else pad_id,
                                     collect_attn)
    st = _inputs(video_feats, video_masks)
    prologue(st)
    run_stages(st, stages)
    return st["tokens"], st["attn"]


def make_greedy_fn(model, max_len: int, start_id: int, end_id: int,
                   collect_attn: bool = False) -> Callable:
    """fn(feats, masks) -> (tokens, attn) on the module path (port of
    ``vct_tpu/decode.py:make_greedy_fn``, a ``jax.jit`` of
    ``greedy_generate``): a ``graphs.StagedDecode`` of the prologue
    (encoder, caches) and the 8-token stages, on CUDA tensors CUDA graphs
    captured once per input shape and replayed, with ``greedy_generate``'s
    tokens and attention bit for bit; ``attn`` lives in a static buffer and
    is cloned at the finish. A model whose weights tensor parallelism split
    decodes eagerly (its collectives are not captured), and so does the
    LFM2 caption LM (``lm_greedy_generate``)."""
    if _is_split(model) or has_caption_lm(model):
        return functools.partial(greedy_generate, model, max_len=max_len, start_id=start_id,
                                 end_id=end_id, collect_attn=collect_attn)

    def finish(st):
        return st["tokens"].clone(), None if st["attn"] is None else st["attn"].clone()

    return StagedDecode(*_greedy_parts(model, max_len, start_id, end_id, model.config.pad_id,
                                       collect_attn), finish)


def _over_rows(fn: Callable, mesh, batch_dim_of_second: Optional[int]) -> Callable:
    """``fn`` on this data rank's rows of the batch, its outputs gathered
    whole in batch order (the second output along ``batch_dim_of_second``,
    or passed as it is when None). A row's tokens up to its end token are
    the one-process tokens; after it they are not part of the result (the
    loop writes finished rows until every row of its own launch is done):
    compare two decodes through ``through_end``."""
    if mesh is None or mesh.data == 1:
        return fn

    def sharded(video_feats, video_masks):
        feats = shard_batch(mesh, list(video_feats))
        masks = shard_batch(mesh, list(video_masks)) if video_masks else video_masks
        first, second = fn(feats, masks)
        first = gather_rows(first.double(), mesh).to(first.dtype)
        if second is not None and batch_dim_of_second is not None:
            second = gather_rows(second.movedim(batch_dim_of_second, 0), mesh).movedim(
                0, batch_dim_of_second)
        return first, second

    return sharded


def make_auto_greedy_fn(model, max_len: int, start_id: int, end_id: int,
                        collect_attn: bool = False, mesh=None) -> Callable:
    """fn(feats, masks) -> (tokens, attn): the decode kernels
    (``decode_fast.make_fused_greedy_fn``: on CUDA tensors CUDA graphs of the
    kernel loop, encoder included, captured once per input shape; on CPU
    tensors the same stages on the kernels' plain versions), or the module
    path (``make_greedy_fn``, staged the same way) when attention maps are
    collected or the model has its kernels off (``tpu.use_pallas_attention``
    false). Either way ``fn.runner`` is the ``StagedDecode``. A model whose
    weights tensor parallelism split decodes on the module path eagerly, and
    has no runner. The kernel weights are extracted once, at the first call:
    load the checkpoint before decoding. With a ``mesh`` each data rank
    decodes its rows (the batch must divide; each rank captures its rows'
    shape) and every rank gets the whole batch's tokens. The LFM2 caption LM
    decodes eagerly on its own loop (``lm_greedy_generate``), with no
    runner."""
    if (collect_attn or not model.tpu.use_pallas_attention or _is_split(model)
            or has_caption_lm(model)):
        return _graphed(make_greedy_fn(model, max_len, start_id, end_id,
                                       collect_attn=collect_attn), mesh, 2)

    from vct_tpu_torch.decode_fast import make_fused_greedy_fn

    return _graphed(make_fused_greedy_fn(model, max_len, start_id, end_id), mesh, 2)


def _graphed(fn, mesh, batch_dim_of_second: Optional[int]) -> Callable:
    """``_over_rows`` of ``fn``; a ``graphs.StagedDecode`` stays
    readable as the result's ``runner`` (its counts of shapes, graphs and
    replays)."""
    out = _over_rows(fn, mesh, batch_dim_of_second)
    if out is not fn and isinstance(fn, StagedDecode):
        out.runner = fn
    return out


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


def _beam_module_start(model, st: dict, *, beam_size: int, max_len: int, start_id: int,
                       pad_id: int) -> None:
    """The module path's beam state in ``st``, beside ``feats``/``masks``:
    the memory once per beam in the caches, the beams (``beam_start``), the
    frozen beam's log-probabilities over this rank's vocab columns."""
    k = beam_size
    memory, mem_mask, _ = model.encode(st["feats"], st["masks"])
    b, t_mem, e = memory.shape
    dev = memory.device
    # the memory once per beam; one video's beams are contiguous rows
    memory_k = _flatten_beam(memory[:, None].expand(b, k, t_mem, e))
    st["mem_mask"] = None if mem_mask is None else _flatten_beam(
        mem_mask[:, None].expand(b, k, t_mem))
    st["caches"] = model.init_cache(b * k, max_len, memory_k)
    (st["tokens"], st["scores"], st["finished"],
     st["lengths"]) = beam_start(b, k, max_len, start_id, pad_id, dev)
    head = model.cap_decoder.generator
    start, width = head.vocab_start, head.weight.shape[0]  # this rank's vocab columns
    frozen = st["frozen"] = torch.full((width,), NEG_INF, dtype=torch.float32, device=dev)
    if start <= pad_id < start + width:
        # a slice fills on the device; an index would copy from the host
        frozen[pad_id - start:pad_id - start + 1] = 0.0
    st["batch_base"] = torch.arange(b, device=dev)[:, None] * k
    st["all_done"] = torch.zeros((), dtype=torch.bool, device=dev)


def _beam_module_stage(model, st: dict, lo: int, hi: int, *, beam_size: int,
                       end_id: int) -> None:
    """Tokens ``lo + 1 .. hi`` of the module path's beam loop on ``st``;
    then ``all_done`` says whether every beam has finished. Nothing here
    waits for the device, so a CUDA graph can capture it."""
    k, vocab = beam_size, model.config.vocab_size
    tokens, scores, finished, lengths, caches = (st["tokens"], st["scores"], st["finished"],
                                                 st["lengths"], st["caches"])
    b = tokens.shape[0]
    for i in range(lo, hi):
        logits, caches, _ = model.decode_step(_flatten_beam(tokens)[:, i], caches, i,
                                              st["mem_mask"])
        logp = _unflatten_beam(vocab_log_softmax(model, logits), b, k)
        logp = torch.where(finished[..., None], st["frozen"], logp)
        cand = scores[..., None] + logp  # [B, K, V] (V: this rank's vocab shard)
        scores, top_idx = _sharded_topk(model, cand, k)
        beam_idx = top_idx // vocab
        tok_idx = (top_idx % vocab).to(torch.int32)
        tokens, finished, lengths = beam_advance(tokens, finished, lengths, beam_idx,
                                                 tok_idx, i, end_id)
        # only the self-attention cache depends on the beam's identity; the
        # cross K/V are the same for every beam of a video
        flat = (st["batch_base"] + beam_idx).reshape(-1)
        caches = tuple({**c, "k": c["k"].index_select(0, flat),
                        "v": c["v"].index_select(0, flat)} for c in caches)
    st.update(tokens=tokens, scores=scores, finished=finished, lengths=lengths,
              caches=caches, all_done=finished.all())


def _beam_parts(model, max_len: int, start_id: int, end_id: int, beam_size: int,
                length_penalty: float, pad_id: Optional[int] = None):
    """(prologue, stages, finish) of the module path's beam search."""
    if pad_id is None:
        pad_id = model.config.pad_id

    def prologue(st):
        _beam_module_start(model, st, beam_size=beam_size, max_len=max_len,
                           start_id=start_id, pad_id=pad_id)

    def finish(st):
        return beam_select(st["tokens"], st["scores"], st["lengths"], length_penalty)

    return prologue, [functools.partial(_beam_module_stage, model, lo=lo, hi=hi,
                                        beam_size=beam_size, end_id=end_id)
                      for lo, hi, _ in stage_bounds(max_len)], finish


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
    change, and the positions past them hold [PAD] either way. Eager: the
    stages that ``make_beam_fn`` captures, run in turn."""
    refuse_caption_lm(model, "beam search")
    prologue, stages, finish = _beam_parts(model, max_len, start_id, end_id, beam_size,
                                           length_penalty, pad_id)
    st = _inputs(video_feats, video_masks)
    prologue(st)
    return finish(run_stages(st, stages))


def make_beam_fn(model, max_len: int, start_id: int, end_id: int, beam_size: int,
                 length_penalty: float = 0.6) -> Callable:
    """fn(feats, masks) -> (tokens, scores) on the module path (port of
    ``vct_tpu/decode.py:make_beam_fn``, a ``jax.jit`` of ``beam_generate``):
    a ``graphs.StagedDecode`` of its prologue and 8-token stages, on
    CUDA tensors CUDA graphs captured once per input shape and replayed, with
    ``beam_generate``'s tokens and scores bit for bit. A model whose weights
    tensor parallelism split searches eagerly."""
    refuse_caption_lm(model, "beam search")
    if _is_split(model):
        return functools.partial(beam_generate, model, beam_size=beam_size, max_len=max_len,
                                 start_id=start_id, end_id=end_id,
                                 length_penalty=length_penalty)
    return StagedDecode(*_beam_parts(model, max_len, start_id, end_id, beam_size,
                                     length_penalty))


def make_auto_beam_fn(model, max_len: int, start_id: int, end_id: int, beam_size: int,
                      length_penalty: float = 0.6, mesh=None) -> Callable:
    """fn(feats, masks) -> (tokens, scores): beam search on the decode kernels
    (``decode_fast.make_fused_beam_fn``: one stack launch and one
    norm/generator/top-k launch per token, on CUDA tensors in CUDA graphs
    captured once per input shape, ``fn.runner``; on CPU tensors their plain
    versions), or on the module path when the model has its kernels off
    (``tpu.use_pallas_attention`` false: ``make_beam_fn``, staged the same
    way). Either way ``fn.runner`` is the ``StagedDecode``. On a card a beam
    wider than the top-k kernel carries raises ``ValueError``; it never falls
    to the module path. The kernel weights are extracted once, at the first
    call: load the checkpoint before decoding. A model whose weights tensor
    parallelism split searches on the module path eagerly, with no runner.
    With a ``mesh`` each data rank searches its rows and every rank gets the
    whole batch's tokens and scores."""
    if not model.tpu.use_pallas_attention or _is_split(model):
        return _graphed(make_beam_fn(model, max_len, start_id, end_id, beam_size,
                                     length_penalty), mesh, 0)

    from vct_tpu_torch.decode_fast import make_fused_beam_fn

    return _graphed(make_fused_beam_fn(model, max_len, start_id, end_id, beam_size,
                                       length_penalty), mesh, 0)


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


def through_end(tokens: torch.Tensor, end_id: int, pad_id: int = 0) -> torch.Tensor:
    """``tokens`` with every position after a row's first ``end_id`` set to
    ``pad_id``: what a caption reads (``decode_caption`` stops there)."""
    ended = (tokens == end_id).to(torch.int32).cumsum(dim=1)
    after = (ended - (tokens == end_id).to(torch.int32)) > 0
    return tokens.masked_fill(after, pad_id)


def detokenize_batch(tokenizer, tokens) -> List[str]:
    """Token-id matrix -> caption strings (reference truncation semantics);
    a ``decode.detokenize`` span, the copy of device tokens to the host
    included."""
    with tracing.span("decode.detokenize"):
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
